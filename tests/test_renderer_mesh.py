"""Renderer bookkeeping: over a pixel-tile mesh, scene tables and
accumulators are replicated, so every sample after the first reuses the
first one's executable (a layout change between calls would recompile);
ray counts stay bounded in number however long the render runs."""

import numpy as np

import clive2 as c2
from clive2 import renderer as renderer_mod
from clive2.parallel.mesh import make_tile_mesh


def test_sharded_renderer_compiles_once(tmp_path):
    scene = c2.create_scene_from_preset("empty", pixel_width=16,
                                        pixel_height=8)
    r = c2.Renderer(scene, seed=2, mesh=make_tile_mesh(4))
    for _ in range(3):
        r.run_sample()
    ckpt = str(tmp_path / "c.npz")
    r.save_checkpoint(ckpt)
    r.load_checkpoint(ckpt)
    r.run_sample()
    assert r._step._cache_size() == 1
    assert r.rays_traced > 0 and np.isfinite(r.raw_image).all()
    for leaf in (r.state["summed_image"], r.scene.data["bvh"]["node_packed"]):
        assert leaf.sharding.is_fully_replicated
        assert len(leaf.sharding.device_set) == 4


def test_ray_counts_fold_into_host_total(monkeypatch):
    scene = c2.create_scene_from_preset("empty", pixel_width=16,
                                        pixel_height=8)
    whole = c2.Renderer(scene, seed=5, chunk_rows=2)
    for _ in range(2):
        whole.run_sample()
    monkeypatch.setattr(renderer_mod, "RAY_COUNTS_KEPT", 4)
    folded = c2.Renderer(scene, seed=5, chunk_rows=2)
    for _ in range(2):                  # 8 stripe programs
        folded.run_sample()
    assert len(folded._ray_counts) < 4 and folded._rays_folded > 0
    assert folded.rays_traced == whole.rays_traced > 0
