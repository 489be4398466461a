"""Multi-chip sharding tests on the 8-virtual-device CPU mesh.

The reference is single-device (SURVEY §2.3); these tests validate this
build's first-class data-parallel path: the pixel wavefront sharded
over a "tiles" mesh axis, BVH/material tables replicated, splat scatter
and filter halos handled by GSPMD collectives.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import clive2 as c2
from clive2.integrator.render import make_sharded_render, render_sample_jit

pytestmark = pytest.mark.slow  # render-based statistical oracle, minutes-scale (-m slow)


@pytest.fixture(scope="module")
def scene_64():
    return c2.create_scene_from_preset("empty", pixel_width=64, pixel_height=16)


@pytest.fixture(scope="module")
def scene_bvh():
    """A scene past the brute threshold: takes the gather-walk BVH path
    (miss-link while_loop + separate camtri merge) — the traversal GSPMD
    is most likely to partition badly, so it needs its own sharded
    equality proof (round-2 review: only the brute path was ever
    sharded)."""
    from clive2.geometry import TriangleSoup
    from clive2.models import icosphere

    v, f = icosphere(2)                       # 320 tris > BRUTE_FORCE_MAX
    soup = TriangleSoup.from_vertices(v[f] * 1.5 + np.array([0, 1.0, 0]),
                                      material=4)
    scene = c2.create_scene(pixel_width=64, pixel_height=16,
                            cam_center=np.array([0, 1.5, 6]),
                            cam_direction=np.array([0, 0, -1.0]),
                            extra_geometry=soup)
    assert "bvh" in scene.data and "brute" not in scene.data
    assert "camtri" in scene.data
    return scene


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_sharded_matches_single_device(scene_64):
    w, h = 64, 16
    mesh = Mesh(np.array(jax.devices()), ("tiles",))
    step = make_sharded_render(mesh, w, h)
    key = jax.random.key(11)
    sharded = step(key, scene_64.data)
    single = render_sample_jit(key, scene_64.data, w, h)
    np.testing.assert_allclose(
        np.asarray(sharded["image"]), np.asarray(single["image"]),
        rtol=1e-4, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(sharded["weight"]), np.asarray(single["weight"]),
        rtol=1e-4, atol=1e-6,
    )


def test_sharded_bvh_scene_matches_single(scene_bvh):
    """The gather-walk traversal (lax.while_loop over node pointers with
    per-ray gathers) and the camtri merge must partition over the tiles
    axis without changing results."""
    w, h = 64, 16
    mesh = Mesh(np.array(jax.devices()), ("tiles",))
    step = make_sharded_render(mesh, w, h)
    key = jax.random.key(7)
    sharded = step(key, scene_bvh.data)
    single = render_sample_jit(key, scene_bvh.data, w, h)
    np.testing.assert_allclose(
        np.asarray(sharded["image"]), np.asarray(single["image"]),
        rtol=1e-4, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(sharded["unidirectional"]),
        np.asarray(single["unidirectional"]), rtol=1e-4, atol=1e-6,
    )


def test_sharded_renderer_end_to_end(scene_64):
    mesh = Mesh(np.array(jax.devices()), ("tiles",))
    r = c2.Renderer(scene_64, seed=4, mesh=mesh)
    r.run_sample()
    r.run_sample()
    raw = r.raw_image
    assert np.isfinite(raw).all()
    assert raw.sum() > 0
