"""Per-ray stackless BVH walk as one Pallas kernel (Triton route).

The same traversal as the XLA gather walk (``intersect.intersect_bvh_packed``)
and its unpacked oracle (``intersect.intersect_bvh``): DFS-preorder nodes
threaded with miss links, next = ``box_hit & ~leaf ? nd + 1 : miss[nd]``.
The difference is where the loop lives.  The XLA walk is one
``lax.while_loop`` over the whole wavefront, so every iteration costs the
full batch and the loop runs as long as the slowest ray; here each program
owns ``BLOCK_RAYS`` rays (one per thread), keeps its state in registers,
and runs only until its own slowest ray is done.  Node and leaf rows are
read by masked per-lane gathers from device memory; the hot top of the
tree stays in L2.

Rays come in as SoA columns so the per-block loads coalesce.  Tables are
``pack_gather_walk``'s ``node_packed`` [n, 8] and ``leaf_packed``
[L, K * 10], flattened.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..constants import DELTA

BLOCK_RAYS = 128
NUM_WARPS = 4
_NODE_W = 8          # node row: min(3) max(3) miss leaf_id
_TRI_W = 10          # leaf slot: v0(3) e1(3) e2(3) tri


def _walk_kernel(node_ref, leaf_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref,
                 dz_ref, tmax_ref, act_ref, oi_ref, ot_ref, ou_ref, ov_ref, *,
                 n_nodes: int, k: int, any_hit: bool):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    def inv(d):         # intersect.safe_inverse
        return 1.0 / jnp.where(jnp.abs(d) < 1e-30,
                               jnp.where(d < 0, -1e-30, 1e-30), d)

    ix, iy, iz = inv(dx), inv(dy), inv(dz)
    node0 = jnp.where(act_ref[...] != 0, 0, n_nodes).astype(jnp.int32)
    init = (node0, tmax_ref[...], jnp.full(node0.shape, -1, jnp.int32),
            jnp.zeros(node0.shape, jnp.float32),
            jnp.zeros(node0.shape, jnp.float32))

    def cond(state):
        # reduce_max: Triton's lowering has no reduce_or
        return jnp.max((state[0] < n_nodes).astype(jnp.int32)) > 0

    def body(state):
        node, best_t, best_i, best_u, best_v = state
        alive = node < n_nodes
        nd = jnp.minimum(node, n_nodes - 1)
        base = nd * _NODE_W

        def node_col(c):
            return plt.load(node_ref.at[base + c], mask=alive, other=0.0)

        # slab test (intersect.ray_box_test)
        t0x = (node_col(0) - ox) * ix
        t0y = (node_col(1) - oy) * iy
        t0z = (node_col(2) - oz) * iz
        t1x = (node_col(3) - ox) * ix
        t1y = (node_col(4) - oy) * iy
        t1z = (node_col(5) - oz) * iz
        tmin = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                       jnp.minimum(t0y, t1y)),
                           jnp.minimum(t0z, t1z))
        tmax = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                       jnp.maximum(t0y, t1y)),
                           jnp.maximum(t0z, t1z))
        box_hit = (jnp.maximum(tmin, 0.0)
                   <= jnp.minimum(tmax, best_t)) & alive
        miss = node_col(6).astype(jnp.int32)
        lid = node_col(7).astype(jnp.int32)
        is_leaf = lid >= 0
        do_leaf = box_hit & is_leaf
        lbase = jnp.maximum(lid, 0) * (k * _TRI_W)

        # leaf members in slot order; a strict "<" keeps the first of equal
        # minima, as the oracle's argmin does
        for m in range(k):
            def leaf_col(c, m=m):
                return plt.load(leaf_ref.at[lbase + (m * _TRI_W + c)],
                                mask=do_leaf, other=0.0)

            v0x, v0y, v0z = leaf_col(0), leaf_col(1), leaf_col(2)
            e1x, e1y, e1z = leaf_col(3), leaf_col(4), leaf_col(5)
            e2x, e2y, e2z = leaf_col(6), leaf_col(7), leaf_col(8)
            tri = leaf_col(9).astype(jnp.int32)
            # Möller–Trumbore (intersect.moller_trumbore)
            hx = dy * e2z - dz * e2y
            hy = dz * e2x - dx * e2z
            hz = dx * e2y - dy * e2x
            a = e1x * hx + e1y * hy + e1z * hz
            f = 1.0 / a
            sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
            u = f * (sx * hx + sy * hy + sz * hz)
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            v = f * (dx * qx + dy * qy + dz * qz)
            t = f * (e2x * qx + e2y * qy + e2z * qz)
            hit = ((u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
                   & (t > DELTA))
            better = hit & (tri >= 0) & do_leaf & (t < best_t)
            best_t = jnp.where(better, t, best_t)
            best_i = jnp.where(better, tri, best_i)
            best_u = jnp.where(better, u, best_u)
            best_v = jnp.where(better, v, best_v)

        nxt = jnp.where(box_hit & ~is_leaf, nd + 1, miss)
        if any_hit:
            nxt = jnp.where(best_i >= 0, n_nodes, nxt)
        node = jnp.where(alive, nxt, node)
        return node, best_t, best_i, best_u, best_v

    _, best_t, best_i, best_u, best_v = jax.lax.while_loop(cond, body, init)
    oi_ref[...] = best_i
    ot_ref[...] = jnp.where(best_i >= 0, best_t, jnp.float32(jnp.inf))
    ou_ref[...] = best_u
    ov_ref[...] = best_v


@functools.partial(jax.jit, static_argnames=("any_hit", "interpret"))
def intersect_bvh_kernel(origin, direction, bvh_arrays, active=None,
                         t_max=None, any_hit: bool = False,
                         interpret: bool = False):
    """Closest hit (or, with ``any_hit``, some hit under ``t_max``: the
    lane stops at its first) through the packed threaded BVH.

    Same contract as ``intersect.intersect_bvh_packed``: origin/direction
    [N, 3]; optional ``active`` [N] bool and ``t_max`` [N]; returns
    (tri_idx [N] i32, -1 = miss; t [N], inf on miss; u; v).
    """
    node_packed = bvh_arrays["node_packed"]
    leaf_packed = bvh_arrays["leaf_packed"]
    n_nodes = node_packed.shape[0]
    k = leaf_packed.shape[1] // _TRI_W
    n = origin.shape[0]
    n_pad = -(-max(n, 1) // BLOCK_RAYS) * BLOCK_RAYS

    def col(a, fill):
        return jnp.pad(a, (0, n_pad - n), constant_values=fill)

    act = (jnp.ones((n,), jnp.int32) if active is None
           else active.astype(jnp.int32))
    tm = (jnp.full((n,), jnp.inf, jnp.float32) if t_max is None
          else t_max.astype(jnp.float32))
    rays = [col(origin[:, c], 0.0) for c in range(3)]
    rays += [col(direction[:, c], 1.0) for c in range(3)]
    rays += [col(tm, jnp.inf), col(act, 0)]

    def whole(a):
        return pl.BlockSpec(a.shape, lambda i: (0,))

    lane = pl.BlockSpec((BLOCK_RAYS,), lambda i: (i,))
    node_flat = node_packed.reshape(-1)
    leaf_flat = leaf_packed.reshape(-1)
    out = pl.pallas_call(
        functools.partial(_walk_kernel, n_nodes=n_nodes, k=k,
                          any_hit=any_hit),
        grid=(n_pad // BLOCK_RAYS,),
        in_specs=[whole(node_flat), whole(leaf_flat)] + [lane] * 8,
        out_specs=[lane] * 4,
        out_shape=[jax.ShapeDtypeStruct((n_pad,), jnp.int32)]
        + [jax.ShapeDtypeStruct((n_pad,), jnp.float32)] * 3,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="bvh_walk",
    )(node_flat, leaf_flat, *rays)
    return tuple(o[:n] for o in out)
