"""Threaded-BVH traversal against the unpacked oracle ``intersect_bvh``.

Both implementations of ``traverse_bvh`` — the XLA gather walk and the
per-ray Pallas kernel (here in interpret mode) — are checked on
closest-hit and any-hit casts, over scenes that stress different parts of
the walk, with every lane active or half of them active under a per-ray
``t_max``.  Ids must agree except on near-ties (the kernel's Möller–
Trumbore associates its sums differently, so a ray through a shared edge
may pick the other triangle): at most 0.2% of active lanes.
"""

import functools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

import clive2 as c2
from clive2.geometry import TriangleSoup, box_geometry
from clive2.models import icosphere
from clive2.ops.intersect import (
    INF,
    _merge_camtri,
    intersect_bvh,
    intersect_bvh_packed,
    moller_trumbore,
    unpack_gather_walk,
)
from clive2.ops.walk_kernel import BLOCK_RAYS, intersect_bvh_kernel

IMPLS = {
    "walk": intersect_bvh_packed,
    "kernel": functools.partial(intersect_bvh_kernel, interpret=True),
}
MAX_ID_MISMATCH = 2e-3


def _unit(v):
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _scene(name):
    """(scene data, origins, directions) — 1000 rays per scene."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n = 1000
    if name == "room_mesh_camtri":
        v, f = icosphere(2)
        mesh = TriangleSoup.from_vertices(v[f] * 1.2 + np.array([0, 1, 0]))
        scene = c2.create_scene(pixel_width=16, pixel_height=16,
                                cam_center=np.array([0, 1.5, 6]),
                                cam_direction=np.array([0, 0, -1.0]),
                                extra_geometry=mesh)
        assert "camtri" in scene.data
        o = rng.uniform([-4, -1, -4], [4, 4, 7], (n, 3))
        d = _unit(rng.normal(size=(n, 3)))
        return scene.data, o, d
    if name == "icosphere_320":
        v, f = icosphere(2)
        soup = TriangleSoup.from_vertices(v[f] * 2.0)
        o = _unit(rng.normal(size=(n, 3))) * 4.0
        d = _unit(rng.normal(size=(n, 3)) * 0.3 - o / 4.0)
    elif name == "soup_1k":
        base = rng.uniform(-3, 3, (1000, 1, 3))
        soup = TriangleSoup.from_vertices(base + rng.uniform(-.4, .4,
                                                             (1000, 3, 3)))
        o = rng.uniform(-4, 4, (n, 3))
        d = _unit(rng.normal(size=(n, 3)))
    else:   # axis-parallel and grazing rays in the Cornell room
        soup = box_geometry()
        o = rng.uniform([-2, 0, -2], [2, 3, 2], (n, 3))
        axis = rng.integers(0, 3, n)
        d = np.zeros((n, 3))
        d[np.arange(n), axis] = rng.choice([-1.0, 1.0], n)
        graze = np.arange(n) % 2 == 1
        # grazing: nearly in a wall's plane, starting on the wall
        d[graze] = _unit(d[graze] + rng.normal(size=(graze.sum(), 3)) * 1e-4)
        o[graze, 0] = np.where(rng.random(graze.sum()) < 0.5,
                               soup.vertices[..., 0].min(),
                               soup.vertices[..., 0].max())
    from clive2.scene import _build_scene_pytree

    cam = c2.create_scene(pixel_width=8, pixel_height=8).camera
    data, _, _ = _build_scene_pytree(
        c2.geometry.camera_geometry(cam) + soup, c2.default_materials(), cam)
    data = dict(data)
    data.pop("brute", None)
    data.pop("camtri", None)
    if "bvh" not in data or data["bvh"]["node_packed"].shape[0] < 3:
        raise AssertionError("scene must build a real tree")
    return data, o, d


SCENES = ("icosphere_320", "soup_1k", "room_mesh_camtri", "axis_grazing")


@functools.lru_cache(maxsize=None)
def _case(name, half_active):
    data, o, d = _scene(name)
    o = jnp.asarray(o, jnp.float32)
    d = jnp.asarray(d, jnp.float32)
    n = o.shape[0]
    rng = np.random.default_rng(7)
    if half_active:
        active = jnp.asarray(np.arange(n) % 2 == 0)
        t_max = jnp.asarray(rng.uniform(0.5, 6.0, n), jnp.float32)
    else:
        active = jnp.ones((n,), bool)
        t_max = jnp.full((n,), INF)
    oracle = intersect_bvh(o, d, unpack_gather_walk(data["bvh"]),
                           active=active, t_max=t_max)
    if "camtri" in data:
        oracle = _merge_camtri(o, d, data["camtri"], oracle, active, t_max)
    return data, o, d, active, t_max, [np.asarray(x) for x in oracle]


def _run(impl, data, o, d, active, t_max, any_hit):
    hit = IMPLS[impl](o, d, data["bvh"], active=active, t_max=t_max,
                      any_hit=any_hit)
    if "camtri" in data:
        hit = _merge_camtri(o, d, data["camtri"], hit, active, t_max)
    return [np.asarray(x) for x in hit]


@pytest.mark.parametrize("half_active", [False, True],
                         ids=["all_active", "half_active_tmax"])
@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("mode", ["closest", "any_hit"])
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_traversal_matches_oracle(impl, mode, scene, half_active):
    data, o, d, active, t_max, (oi, ot, ou, ov) = _case(scene, half_active)
    ti, tt, tu, tv = _run(impl, data, o, d, active, t_max,
                          any_hit=(mode == "any_hit"))
    act = np.asarray(active)
    # inactive lanes never report a hit
    assert (ti[~act] == -1).all() and np.isinf(tt[~act]).all()
    assert (oi[act] >= 0).mean() > 0.05, "scene must be hit"
    if mode == "closest":
        same = ti[act] == oi[act]
        assert 1.0 - same.mean() <= MAX_ID_MISMATCH
        hit = act & (ti == oi) & (oi >= 0)
        np.testing.assert_allclose(tt[hit], ot[hit], rtol=1e-5)
        np.testing.assert_allclose(tu[hit], ou[hit], atol=1e-5)
        np.testing.assert_allclose(tv[hit], ov[hit], atol=1e-5)
        assert np.isinf(tt[ti < 0]).all()
    else:
        # occlusion verdicts agree, and every reported hit is a real
        # intersection of that triangle under the lane's t_max
        agree = (ti[act] >= 0) == (oi[act] >= 0)
        assert 1.0 - agree.mean() <= MAX_ID_MISMATCH
        got = act & (ti >= 0)
        assert (tt[got] < np.asarray(t_max)[got]).all()
        both = got & (oi >= 0)
        assert (tt[both] >= ot[both] * (1 - 1e-5)).all()  # never nearer
        tris = _tri_table(data)
        bvh_hit = got & (ti < len(tris["tri"])) & (tris["tri"][
            np.minimum(ti, len(tris["tri"]) - 1)] == ti)
        k = ti[bvh_hit]
        h, t, _, _ = moller_trumbore(o[bvh_hit], d[bvh_hit], tris["v0"][k],
                                     tris["e1"][k], tris["e2"][k])
        assert np.asarray(h).all()
        np.testing.assert_allclose(np.asarray(t), tt[bvh_hit], rtol=1e-5)


def _tri_table(data):
    """Per-triangle-id v0/e1/e2 from the packed leaf rows."""
    u = unpack_gather_walk(data["bvh"])
    ids = np.asarray(u["leaf_tri"]).reshape(-1)
    keep = ids >= 0
    size = ids.max() + 1
    out = {"tri": np.full(size, -1, np.int64)}
    out["tri"][ids[keep]] = ids[keep]
    for name in ("v0", "e1", "e2"):
        col = np.zeros((size, 3), np.float32)
        col[ids[keep]] = np.asarray(u["leaf_" + name]).reshape(-1, 3)[keep]
        out[name] = jnp.asarray(col)
    return out


@pytest.mark.parametrize("n_rays", [1, BLOCK_RAYS + 1, 1000])
@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_ray_counts_pad_to_blocks(impl, n_rays):
    """Odd ray counts (one lane, one past a block, several blocks) give
    the same answers as the oracle lane for lane, and output shapes
    follow the input."""
    data, o, d, active, t_max, (oi, ot, _, _) = _case("soup_1k", False)
    sel = slice(0, n_rays)
    ti, tt, tu, tv = _run(impl, data, o[sel], d[sel], active[sel],
                          t_max[sel], any_hit=False)
    assert ti.shape == tt.shape == tu.shape == tv.shape == (n_rays,)
    assert ti.dtype == np.int32
    np.testing.assert_array_equal(ti, oi[sel])
    np.testing.assert_allclose(tt, ot[sel], rtol=1e-5)
