import jax.numpy as jnp
import numpy as np

from clive2.bvh import build_bvh
from clive2.bvh.build import leaf_tables
from clive2.geometry import TriangleSoup, box_geometry
from clive2.ops.intersect import (
    intersect_brute,
    intersect_bvh,
    moller_trumbore,
    ray_box_test,
    safe_inverse,
)


def bvh_arrays_for(soup):
    bvh = build_bvh(soup, use_native=False)
    t = leaf_tables(bvh, soup)
    return dict(
        node_mins=jnp.asarray(bvh.node_mins),
        node_maxes=jnp.asarray(bvh.node_maxes),
        miss=jnp.asarray(bvh.miss),
        leaf_id=jnp.asarray(bvh.leaf_id),
        leaf_v0=jnp.asarray(t["v0"]),
        leaf_e1=jnp.asarray(t["e1"]),
        leaf_e2=jnp.asarray(t["e2"]),
        leaf_tri=jnp.asarray(t["tri_index"]),
    )


def test_moller_trumbore_analytic():
    v0 = jnp.array([[0.0, 0.0, 0.0]])
    e1 = jnp.array([[1.0, 0.0, 0.0]])
    e2 = jnp.array([[0.0, 1.0, 0.0]])
    o = jnp.array([[0.25, 0.25, 1.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    hit, t, u, v = moller_trumbore(o, d, v0, e1, e2)
    assert bool(hit[0])
    np.testing.assert_allclose(float(t[0]), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(u[0]), 0.25, rtol=1e-5)
    np.testing.assert_allclose(float(v[0]), 0.25, rtol=1e-5)
    # miss outside barycentric range
    o2 = jnp.array([[2.0, 2.0, 1.0]])
    hit2, t2, _, _ = moller_trumbore(o2, d, v0, e1, e2)
    assert not bool(hit2[0])
    assert not bool(jnp.isfinite(t2[0]))


def test_moller_trumbore_parallel_ray():
    v0 = jnp.array([[0.0, 0.0, 0.0]])
    e1 = jnp.array([[1.0, 0.0, 0.0]])
    e2 = jnp.array([[0.0, 1.0, 0.0]])
    o = jnp.array([[0.0, 0.0, 1.0]])
    d = jnp.array([[1.0, 0.0, 0.0]])  # parallel to the plane
    hit, _, _, _ = moller_trumbore(o, d, v0, e1, e2)
    assert not bool(hit[0])


def test_ray_box_slab():
    o = jnp.array([[0.0, 0.0, -5.0]])
    d = jnp.array([[0.0, 0.0, 1.0]])
    inv = safe_inverse(d)
    bmin = jnp.array([[-1.0, -1.0, -1.0]])
    bmax = jnp.array([[1.0, 1.0, 1.0]])
    assert bool(ray_box_test(o, inv, bmin, bmax, jnp.array([jnp.inf]))[0])
    # early-out: best_t closer than the box
    assert not bool(ray_box_test(o, inv, bmin, bmax, jnp.array([1.0]))[0])
    # axis-parallel ray outside the slab (zero direction component)
    o2 = jnp.array([[5.0, 0.0, -5.0]])
    assert not bool(ray_box_test(o2, safe_inverse(d), bmin, bmax,
                                 jnp.array([jnp.inf]))[0])
    # ray starting inside
    o3 = jnp.array([[0.0, 0.0, 0.0]])
    assert bool(ray_box_test(o3, inv, bmin, bmax, jnp.array([jnp.inf]))[0])


def test_bvh_matches_brute_force(rng):
    base = rng.uniform(-8, 8, size=(300, 1, 3))
    verts = (base + rng.normal(size=(300, 3, 3))).astype(np.float32)
    soup = TriangleSoup.from_vertices(verts)
    arrays = bvh_arrays_for(soup)

    n = 512
    origins = rng.uniform(-9, 9, size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    bi, bt, bu, bv = intersect_brute(
        jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(soup.vertices)
    )
    hi, ht, hu, hv = intersect_bvh(jnp.asarray(origins), jnp.asarray(dirs), arrays)

    bi, bt = np.asarray(bi), np.asarray(bt)
    hi, ht = np.asarray(hi), np.asarray(ht)
    hit_mask = bi >= 0
    assert (hit_mask == (hi >= 0)).mean() > 0.999
    same = hit_mask & (hi >= 0)
    np.testing.assert_allclose(ht[same], bt[same], rtol=1e-4)
    # triangle ids may differ only at exact-tie t values
    diff = same & (bi != hi)
    assert (np.abs(bt[diff] - ht[diff]) < 1e-4).all()


def test_bvh_respects_active_mask(rng):
    soup = box_geometry()
    arrays = bvh_arrays_for(soup)
    origins = jnp.zeros((4, 3), dtype=jnp.float32)
    dirs = jnp.tile(jnp.array([[0.0, -1.0, 0.0]], dtype=jnp.float32), (4, 1))
    active = jnp.array([True, False, True, False])
    tri, t, _, _ = intersect_bvh(origins, dirs, arrays, active=active)
    tri = np.asarray(tri)
    assert tri[0] >= 0 and tri[2] >= 0
    assert tri[1] == -1 and tri[3] == -1


def test_cornell_box_hits_from_inside():
    soup = box_geometry()
    arrays = bvh_arrays_for(soup)
    origins = jnp.zeros((6, 3), dtype=jnp.float32)
    dirs = jnp.asarray(
        np.array(
            [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
            dtype=np.float32,
        )
    )
    tri, t, _, _ = intersect_bvh(origins, dirs, arrays)
    assert (np.asarray(tri) >= 0).all()
    # room is [-10,-2,-10]..[10,10,10]: +y first hits the light at 0.95*10
    np.testing.assert_allclose(np.asarray(t)[2], 9.5, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(t)[3], 2.0, rtol=1e-4)


def test_packed_walk_matches_oracle(rng):
    """The packed-row gather walk must match the unpacked oracle."""
    from clive2.bvh import build_bvh
    from clive2.bvh.build import leaf_tables
    from clive2.ops.intersect import intersect_bvh_packed, pack_gather_walk

    base = rng.uniform(-8, 8, size=(400, 1, 3))
    soup = TriangleSoup.from_vertices(
        (base + rng.normal(size=(400, 3, 3))).astype(np.float32)
    )
    bvh = build_bvh(soup, use_native=False)
    legacy = bvh_arrays_for(soup)
    packed = {k: jnp.asarray(v)
              for k, v in pack_gather_walk(bvh, leaf_tables(bvh, soup)).items()}

    n = 512
    origins = rng.uniform(-9, 9, size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    a = intersect_bvh(jnp.asarray(origins), jnp.asarray(dirs), legacy)
    b = intersect_bvh_packed(jnp.asarray(origins), jnp.asarray(dirs), packed)
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    at, bt = np.asarray(a[1]), np.asarray(b[1])
    m = np.asarray(a[0]) >= 0
    np.testing.assert_allclose(at[m], bt[m], rtol=1e-6)
