"""Ray-scene intersection: slab test, Möller–Trumbore, BVH traversal.

Wavefront replacement for the reference's per-thread stack traversal
(reference src/trace.metal:106-197).  Instead of a 64-deep stack per
GPU thread (trace.metal:145), the flat BVH is threaded with DFS-preorder
miss links (see bvh/build.py) so per-ray traversal state is a *single int
node pointer*.  On CUDA each ray walks on its own thread
(ops/walk_kernel.py); elsewhere the whole wavefront advances in lockstep
inside one ``lax.while_loop`` with finished rays masked (the XLA walk,
``intersect_bvh_packed``).  ``traverse_bvh`` picks between them.

Node pointers only move forward (preorder), so a walk terminates in at
most ``n_nodes`` iterations.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constants import DELTA

INF = jnp.float32(jnp.inf)


def safe_inverse(d):
    """1/direction with zero components nudged to keep the slab test NaN-free."""
    tiny = jnp.float32(1e-30)
    return 1.0 / jnp.where(jnp.abs(d) < tiny, jnp.where(d < 0, -tiny, tiny), d)


def ray_box_test(origin, inv_dir, bmin, bmax, t_max):
    """Vectorized slab test with early-out vs current best t
    (trace.metal:106-115).  origin/inv_dir [..., 3]; returns bool [...]."""
    t0 = (bmin - origin) * inv_dir
    t1 = (bmax - origin) * inv_dir
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    tmin_f = jnp.maximum(jnp.max(tmin, axis=-1), 0.0)
    tmax_f = jnp.minimum(jnp.min(tmax, axis=-1), t_max)
    return tmin_f <= tmax_f


def moller_trumbore(origin, direction, v0, e1, e2):
    """Batched Möller–Trumbore (trace.metal:117-142).

    origin/direction [..., 3] broadcast against v0/e1/e2 [..., 3].
    Returns (hit bool, t, u, v); misses get t = +inf.
    """
    h = jnp.cross(direction, e2)
    a = jnp.sum(e1 * h, axis=-1)
    f = 1.0 / a  # a == 0 -> inf -> comparisons below reject
    s = origin - v0
    u = f * jnp.sum(s * h, axis=-1)
    q = jnp.cross(s, e1)
    v = f * jnp.sum(direction * q, axis=-1)
    t = f * jnp.sum(e2 * q, axis=-1)
    hit = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > DELTA)
    t = jnp.where(hit, t, INF)
    return hit, t, u, v


def intersect_brute(origin, direction, tri_vertices):
    """Closest hit by testing every triangle; test oracle and tiny-scene path.

    origin/direction [N, 3]; tri_vertices [T, 3, 3].
    Returns (tri_idx [N] i32 (-1 miss), t, u, v).
    """
    v0 = tri_vertices[:, 0]
    e1 = tri_vertices[:, 1] - tri_vertices[:, 0]
    e2 = tri_vertices[:, 2] - tri_vertices[:, 0]
    hit, t, u, v = moller_trumbore(
        origin[:, None, :], direction[:, None, :], v0[None], e1[None], e2[None]
    )  # [N, T]
    best = jnp.argmin(t, axis=1)
    n = jnp.arange(origin.shape[0])
    best_t = t[n, best]
    found = jnp.isfinite(best_t)
    return (
        jnp.where(found, best, -1).astype(jnp.int32),
        best_t,
        jnp.where(found, u[n, best], 0.0),
        jnp.where(found, v[n, best], 0.0),
    )


def intersect_brute_chunked(origin, direction, brute, active=None,
                            t_max=None, chunk: int = 32):
    """Closest hit by dense Möller–Trumbore over all triangles, chunked.

    For small scenes this beats any BVH walk: zero gathers, pure
    broadcasted elementwise math that XLA fuses (the Cornell presets are
    16-20 triangles).  The scene build selects this path via the ``brute``
    scene entry (see scene.py) when the triangle count is small.

    brute: dict with v0/e1/e2 [Tpad, 3] (padded with degenerate tris) and
    ``count`` (python int, unused — padding is inert because degenerate
    triangles produce a==0 -> miss).
    """
    v0, e1, e2 = brute["v0"], brute["e1"], brute["e2"]
    t_pad = v0.shape[0]
    n = origin.shape[0]
    n_chunks = t_pad // chunk

    def body(c, state):
        best_t, best_i, best_u, best_v = state
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, c * chunk, chunk, axis=0)
        hit, t, u, v = moller_trumbore(
            origin[:, None, :], direction[:, None, :],
            sl(v0)[None], sl(e1)[None], sl(e2)[None],
        )  # [N, chunk]
        # sanitize: missed lanes carry inf/nan u,v — zero them so the
        # one-hot select below can't be poisoned by 0 * inf
        u = jnp.where(hit, u, 0.0)
        v = jnp.where(hit, v, 0.0)
        t_c = jnp.min(t, axis=1)
        k = jnp.argmin(t, axis=1)
        onehot = (jax.lax.broadcasted_iota(jnp.int32, t.shape, 1) == k[:, None])
        ohf = onehot.astype(jnp.float32)
        better = t_c < best_t
        best_t = jnp.where(better, t_c, best_t)
        best_i = jnp.where(better, (c * chunk + k).astype(jnp.int32), best_i)
        best_u = jnp.where(better, jnp.sum(u * ohf, axis=1), best_u)
        best_v = jnp.where(better, jnp.sum(v * ohf, axis=1), best_v)
        return best_t, best_i, best_u, best_v

    init = (
        jnp.full(n, INF) if t_max is None else t_max,
        jnp.full(n, -1, dtype=jnp.int32),
        jnp.zeros(n, dtype=jnp.float32),
        jnp.zeros(n, dtype=jnp.float32),
    )
    best_t, best_i, best_u, best_v = jax.lax.fori_loop(0, n_chunks, body, init)
    if active is not None:
        best_i = jnp.where(active, best_i, -1)
    best_t = jnp.where(best_i >= 0, best_t, INF)
    return best_i, best_t, best_u, best_v


def intersect_scene(origin, direction, scene, active=None, t_max=None,
                    any_hit=False, mesh=None):
    """Static dispatch over the scene's traversal representation.

    The scene pytree's *structure* selects the implementation (structure is
    static under jit): a ``brute`` entry -> dense MT; otherwise the
    threaded-BVH walk (``traverse_bvh``).  BVH-path scenes intersect the
    sensor-plane triangles separately (``camtri``) and merge the closest
    hit — the sensor stays out of the BVH so camera moves never rebuild it
    (scene.py:Scene.with_camera).

    ``any_hit`` licenses first-hit termination for visibility casts whose
    ``t_max`` already excludes the target (the hit reported is then SOME
    hit under the cap, not necessarily the closest); the brute path
    ignores it — its closest hit is a valid any-hit answer too.
    """
    if "brute" in scene:
        return intersect_brute_chunked(origin, direction, scene["brute"],
                                       active=active, t_max=t_max)
    hit = traverse_bvh(origin, direction, scene["bvh"], active=active,
                       t_max=t_max, any_hit=any_hit, mesh=mesh)
    if "camtri" in scene:
        hit = _merge_camtri(origin, direction, scene["camtri"], hit, active,
                            t_max)
    return hit


def _tile_sharded(mesh, kernel_fn, bvh_arrays, any_hit):
    """``kernel_fn`` under shard_map: rays split over ``tiles``, tables
    replicated; same call signature as the unsharded partial.  A wavefront
    whose length does not divide by the tile count is padded with inactive
    rays and cut back after the walk."""
    from jax.sharding import PartitionSpec as P

    tiles, rep = P("tiles"), P()
    n_tiles = mesh.shape["tiles"]

    def local(bvh, o, d, active, t_max):
        return kernel_fn(o, d, bvh, active=active, t_max=t_max,
                         any_hit=any_hit)

    sharded = jax.shard_map(
        local, mesh=mesh,
        in_specs=(jax.tree.map(lambda _: rep, bvh_arrays),
                  tiles, tiles, tiles, tiles),
        out_specs=(tiles,) * 4, check_vma=False)

    def call(o, d, active, t_max):
        n = o.shape[0]
        pad = -n % n_tiles
        if pad:
            o = jnp.pad(o, ((0, pad), (0, 0)))
            d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
            active = jnp.pad(active, (0, pad))
            t_max = jnp.pad(t_max, (0, pad), constant_values=jnp.inf)
        return tuple(x[:n] for x in sharded(bvh_arrays, o, d, active, t_max))

    return call


def traverse_bvh(origin, direction, bvh_arrays, active=None, t_max=None,
                 any_hit=False, mesh=None):
    """Threaded-BVH traversal, chosen once when the step is lowered: the
    per-ray Pallas kernel (ops/walk_kernel.py) on CUDA, the XLA gather walk
    everywhere else.

    ``mesh``: a mesh whose ``tiles`` axis shards the wavefront.  GSPMD does
    not partition a Pallas call, so the kernel then runs under
    ``shard_map``, each device walking its own rays against replicated
    tables (rays are independent)."""
    from .walk_kernel import intersect_bvh_kernel

    n = origin.shape[0]
    if active is None:
        active = jnp.ones((n,), bool)
    if t_max is None:
        t_max = jnp.full((n,), INF)
    walk = functools.partial(intersect_bvh_packed, bvh_arrays=bvh_arrays,
                             any_hit=any_hit)
    kernel = functools.partial(intersect_bvh_kernel, bvh_arrays=bvh_arrays,
                               any_hit=any_hit)
    if mesh is not None and mesh.shape["tiles"] > 1:
        kernel = _tile_sharded(mesh, intersect_bvh_kernel, bvh_arrays,
                               any_hit)
    return jax.lax.platform_dependent(
        origin, direction, active, t_max,
        cuda=lambda o, d, a, t: kernel(o, d, active=a, t_max=t),
        default=lambda o, d, a, t: walk(o, d, active=a, t_max=t),
    )


def _merge_camtri(origin, direction, camtri, hit, active, t_max=None):
    """Merge the closest of (BVH hit, sensor-plane hit); a sensor hit at
    or past ``t_max`` does not count, as for any other triangle."""
    best_i, best_t, best_u, best_v = hit
    c_hit, c_t, c_u, c_v = moller_trumbore(
        origin[:, None, :], direction[:, None, :],
        camtri["v0"][None], camtri["e1"][None], camtri["e2"][None],
    )  # [N, C]
    c_u = jnp.where(c_hit, c_u, 0.0)
    c_v = jnp.where(c_hit, c_v, 0.0)
    t_min = jnp.min(c_t, axis=1)
    k = jnp.argmin(c_t, axis=1)
    ohf = (
        jax.lax.broadcasted_iota(jnp.int32, c_t.shape, 1) == k[:, None]
    ).astype(jnp.float32)
    better = t_min < best_t
    if t_max is not None:
        better &= t_min < t_max
    if active is not None:
        better &= active
    ids_f = camtri["ids"].astype(jnp.float32)[None, :]
    sel_i = jnp.sum(ids_f * ohf, axis=1).astype(jnp.int32)
    return (
        jnp.where(better, sel_i, best_i),
        jnp.where(better, t_min, best_t),
        jnp.where(better, jnp.sum(c_u * ohf, axis=1), best_u),
        jnp.where(better, jnp.sum(c_v * ohf, axis=1), best_v),
    )


def intersect_bvh(origin, direction, bvh_arrays, active=None, t_max=None):
    """Closest-hit traversal of a miss-link threaded BVH.

    origin/direction: [N, 3] f32
    bvh_arrays: dict with
        node_mins/node_maxes [n, 3], miss [n] i32, leaf_id [n] i32,
        leaf_v0/leaf_e1/leaf_e2 [L, K, 3], leaf_tri [L, K] i32 (-1 padding)
    active: optional [N] bool; inactive rays skip traversal entirely.

    Returns (tri_idx [N] i32 (-1 = miss), t [N] (inf on miss), u, v).
    """
    node_mins = bvh_arrays["node_mins"]
    node_maxes = bvh_arrays["node_maxes"]
    miss = bvh_arrays["miss"]
    leaf_id = bvh_arrays["leaf_id"]
    leaf_v0 = bvh_arrays["leaf_v0"]
    leaf_e1 = bvh_arrays["leaf_e1"]
    leaf_e2 = bvh_arrays["leaf_e2"]
    leaf_tri = bvh_arrays["leaf_tri"]

    n_nodes = node_mins.shape[0]
    n_rays = origin.shape[0]
    inv_dir = safe_inverse(direction)

    start = jnp.zeros(n_rays, dtype=jnp.int32)
    if active is not None:
        start = jnp.where(active, start, n_nodes)

    def cond(state):
        node, _, _, _, _ = state
        return jnp.any(node < n_nodes)

    def body(state):
        node, best_t, best_i, best_u, best_v = state
        alive = node < n_nodes
        nd = jnp.minimum(node, n_nodes - 1)

        bmin = node_mins[nd]
        bmax = node_maxes[nd]
        box_hit = ray_box_test(origin, inv_dir, bmin, bmax, best_t) & alive

        lid = leaf_id[nd]
        is_leaf = lid >= 0
        do_leaf = box_hit & is_leaf
        lsafe = jnp.maximum(lid, 0)

        v0 = leaf_v0[lsafe]           # [N, K, 3]
        e1 = leaf_e1[lsafe]
        e2 = leaf_e2[lsafe]
        ti = leaf_tri[lsafe]          # [N, K]

        hit, t, u, v = moller_trumbore(
            origin[:, None, :], direction[:, None, :], v0, e1, e2
        )
        valid = hit & (ti >= 0) & do_leaf[:, None]
        t = jnp.where(valid, t, INF)
        u = jnp.where(valid, u, 0.0)
        v = jnp.where(valid, v, 0.0)
        t_leaf = jnp.min(t, axis=1)
        k = jnp.argmin(t, axis=1)
        ohf = (
            jax.lax.broadcasted_iota(jnp.int32, t.shape, 1) == k[:, None]
        ).astype(jnp.float32)
        better = t_leaf < best_t
        best_t = jnp.where(better, t_leaf, best_t)
        ti_k = jnp.sum(ti.astype(jnp.float32) * ohf, axis=1).astype(jnp.int32)
        best_i = jnp.where(better, ti_k, best_i)
        best_u = jnp.where(better, jnp.sum(u * ohf, axis=1), best_u)
        best_v = jnp.where(better, jnp.sum(v * ohf, axis=1), best_v)

        nxt = jnp.where(box_hit & ~is_leaf, nd + 1, miss[nd])
        node = jnp.where(alive, nxt, node)
        return node, best_t, best_i, best_u, best_v

    init = (
        start,
        jnp.full(n_rays, INF) if t_max is None else t_max,
        jnp.full(n_rays, -1, dtype=jnp.int32),
        jnp.zeros(n_rays, dtype=jnp.float32),
        jnp.zeros(n_rays, dtype=jnp.float32),
    )
    _, best_t, best_i, best_u, best_v = jax.lax.while_loop(cond, body, init)
    best_t = jnp.where(best_i >= 0, best_t, INF)
    return best_i, best_t, best_u, best_v


def pack_gather_walk(bvh, leafs):
    """Pack the gather walk's per-iteration lookups into single wide rows.

    One [N, 8] node gather + one [N, 80] leaf gather per iteration of the
    XLA walk replace the eight separate gathers of the naive layout; the
    walk kernel (ops/walk_kernel.py) reads the same rows.

    node rows: min(3) max(3) miss leaf_id            (floats; ids < 2^24)
    leaf rows: K slots of v0(3) e1(3) e2(3) tri(1)
    """
    import numpy as np

    n = bvh.n_nodes
    node_packed = np.zeros((n, 8), dtype=np.float32)
    node_packed[:, 0:3] = bvh.node_mins
    node_packed[:, 3:6] = bvh.node_maxes
    node_packed[:, 6] = bvh.miss
    node_packed[:, 7] = bvh.leaf_id

    k = leafs["v0"].shape[1]
    lcount = leafs["v0"].shape[0]
    leaf_packed = np.zeros((lcount, k, 10), dtype=np.float32)
    leaf_packed[:, :, 0:3] = leafs["v0"]
    leaf_packed[:, :, 3:6] = leafs["e1"]
    leaf_packed[:, :, 6:9] = leafs["e2"]
    leaf_packed[:, :, 9] = leafs["tri_index"]
    return dict(
        node_packed=node_packed,
        leaf_packed=leaf_packed.reshape(lcount, k * 10),
    )


def intersect_bvh_packed(origin, direction, bvh_arrays, active=None,
                         t_max=None, any_hit=False):
    """Gather walk over packed rows (see pack_gather_walk); same contract
    and traversal order as intersect_bvh (the unpacked oracle).  With
    ``any_hit`` a lane stops at its first hit under ``t_max``."""
    node_packed = bvh_arrays["node_packed"]
    leaf_packed = bvh_arrays["leaf_packed"]
    n_nodes = node_packed.shape[0]
    n_rays = origin.shape[0]
    k = leaf_packed.shape[1] // 10
    inv_dir = safe_inverse(direction)

    start = jnp.zeros(n_rays, dtype=jnp.int32)
    if active is not None:
        start = jnp.where(active, start, n_nodes)

    def cond(state):
        return jnp.any(state[0] < n_nodes)

    def body(state):
        node, best_t, best_i, best_u, best_v = state
        alive = node < n_nodes
        nd = jnp.minimum(node, n_nodes - 1)

        nrow = jnp.take(node_packed, nd, axis=0)          # [N, 8]
        bmin = nrow[:, 0:3]
        bmax = nrow[:, 3:6]
        miss = nrow[:, 6].astype(jnp.int32)
        lid = nrow[:, 7].astype(jnp.int32)
        box_hit = ray_box_test(origin, inv_dir, bmin, bmax, best_t) & alive
        is_leaf = lid >= 0
        do_leaf = box_hit & is_leaf
        lsafe = jnp.maximum(lid, 0)

        lrow = jnp.take(leaf_packed, lsafe, axis=0).reshape(n_rays, k, 10)
        v0 = lrow[:, :, 0:3]
        e1 = lrow[:, :, 3:6]
        e2 = lrow[:, :, 6:9]
        ti = lrow[:, :, 9].astype(jnp.int32)

        hit, t, u, v = moller_trumbore(
            origin[:, None, :], direction[:, None, :], v0, e1, e2
        )
        valid = hit & (ti >= 0) & do_leaf[:, None]
        t = jnp.where(valid, t, INF)
        u = jnp.where(valid, u, 0.0)
        v = jnp.where(valid, v, 0.0)
        t_leaf = jnp.min(t, axis=1)
        kk = jnp.argmin(t, axis=1)
        ohf = (
            jax.lax.broadcasted_iota(jnp.int32, t.shape, 1) == kk[:, None]
        ).astype(jnp.float32)
        better = t_leaf < best_t
        best_t = jnp.where(better, t_leaf, best_t)
        ti_k = jnp.sum(ti.astype(jnp.float32) * ohf, axis=1).astype(jnp.int32)
        best_i = jnp.where(better, ti_k, best_i)
        best_u = jnp.where(better, jnp.sum(u * ohf, axis=1), best_u)
        best_v = jnp.where(better, jnp.sum(v * ohf, axis=1), best_v)

        nxt = jnp.where(box_hit & ~is_leaf, nd + 1, miss)
        if any_hit:
            nxt = jnp.where(best_i >= 0, n_nodes, nxt)
        node = jnp.where(alive, nxt, node)
        return node, best_t, best_i, best_u, best_v

    init = (
        start,
        jnp.full(n_rays, INF) if t_max is None else t_max,
        jnp.full(n_rays, -1, dtype=jnp.int32),
        jnp.zeros(n_rays, dtype=jnp.float32),
        jnp.zeros(n_rays, dtype=jnp.float32),
    )
    _, best_t, best_i, best_u, best_v = jax.lax.while_loop(cond, body, init)
    best_t = jnp.where(best_i >= 0, best_t, INF)
    return best_i, best_t, best_u, best_v


def visibility_test(a_origin, a_triangle, b_origin, b_triangle, scene,
                    active=None):
    """Mutual-visibility check between path vertices (trace.metal:178-197).

    Casts from a toward b; visible iff the closest hit along the segment's
    ray is exactly b's triangle (a self-hit on a's triangle counts as
    blocked, as in the reference).
    Returns bool [N].
    """
    delta = b_origin - a_origin
    from .sampling import normalize

    direction = normalize(delta)
    # cap the search just past the target: hits beyond b cannot change the
    # verdict, and the capped traversal prunes everything farther
    dist = jnp.sqrt(jnp.maximum(jnp.sum(delta * delta, axis=-1), 0.0))
    t_max = dist * 1.001 + 1e-4
    tri, _, _, _ = intersect_scene(a_origin, direction, scene, active=active,
                                   t_max=t_max)
    visible = (tri >= 0) & (tri != a_triangle) & (tri == b_triangle)
    return visible


def unpack_gather_walk(bvh_arrays):
    """``pack_gather_walk``'s rows back to ``intersect_bvh``'s separate
    tables, so the unpacked oracle can check a packed scene."""
    node = bvh_arrays["node_packed"]
    leaf = bvh_arrays["leaf_packed"]
    lrow = leaf.reshape(leaf.shape[0], -1, 10)
    return dict(
        node_mins=node[:, 0:3],
        node_maxes=node[:, 3:6],
        miss=node[:, 6].astype(jnp.int32),
        leaf_id=node[:, 7].astype(jnp.int32),
        leaf_v0=lrow[:, :, 0:3],
        leaf_e1=lrow[:, :, 3:6],
        leaf_e2=lrow[:, :, 6:9],
        leaf_tri=lrow[:, :, 9].astype(jnp.int32),
    )
