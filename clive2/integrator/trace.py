"""Subpath generation: ray emission + depth-major wavefront tracing.

Wavefront replacement for the reference megakernel ``generate_paths``
(reference src/trace.metal:381-532) and the ray-emission kernels
(:1020-1067 camera, :1070-1124 light).  The megakernel's per-thread
6-bounce loop becomes a ``lax.scan`` over bounce depth: at each depth the
whole wavefront traverses the BVH, shades, and bounces in lockstep, with
dead rays masked.  Paths are SoA pytrees of [N, D, ...] arrays instead of
1,040-byte AoS ``Path`` structs (struct_types.py:24-31).

BDPT bookkeeping contract (matches trace.metal:499-507):
  vertex k's  c_importance = pdf of sampling the edge (k-1 -> k) at vertex
              k-1 when walking FROM the camera
  vertex k's  l_importance = pdf of sampling the edge (k+1 -> k) at vertex
              k+1 when walking FROM the light
  tot_importance = running product of the forward importance along the
              subpath's own travel direction
  color      = path throughput after the bounce at vertex k (BRDF * prior,
              material color only on external-reflection/egress events,
              trace.metal:489-494)

RNG: counter-based ``jax.random`` keys folded per (purpose, depth) replace
the reference's persistent per-pixel xorshift buffer (trace.metal:87-93,
renderer.py:54) — reproducible and shard-friendly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import DELTA, MAX_BOUNCES, REFERENCE_MIS
from ..ops import bsdf
from ..ops.intersect import intersect_scene
from ..ops.sampling import (
    PI,
    dot,
    ggx_sample,
    normalize,
    orthonormal,
    random_hemisphere_uniform,
    sample_triangle_uniform,
)

def light_gen_key(origin, direction):
    """Generation-time sort key for light-subpath wavefronts: coarse
    position Morton (3 bits/axis, normalized to the wavefront's own
    bounds) major, direction Morton (7 bits/axis) minor — 30 bits total.

    Light origins lie ON the emitters, so an entry-point Morton key would
    collapse them into one position cell; direction-major order groups
    rays that travel alike.  Coarse position bits keep multi-emitter
    scenes grouped per emitter; within one small emitter they are
    constant and direction decides."""
    lo = jnp.min(origin, axis=0, keepdims=True)
    hi = jnp.max(origin, axis=0, keepdims=True)

    def cell(p, plo, phi, bits):
        q = jnp.clip(
            ((p - plo) / jnp.maximum(phi - plo, 1e-30)
             * (1 << bits)).astype(jnp.uint32),
            0, (1 << bits) - 1,
        )
        out = jnp.zeros(p.shape[:-1], jnp.uint32)
        for b in range(bits):         # interleave x, y, z bit-by-bit
            for ax in range(3):
                out = out | (((q[..., ax] >> b) & 1) << (3 * b + (2 - ax)))
        return out

    pos = cell(origin, lo, hi, 3)                        # 9 bits
    dcell = cell(direction, jnp.float32(-1.0), jnp.float32(1.0), 7)
    return (pos << 21) | dcell


def _take(tree, idx):
    return jax.tree.map(lambda a: jnp.take(a, idx, axis=0), tree)


def generate_camera_rays(key, cam, width: int, height: int,
                         row0=0, rows: int = None, pixel_sel=None):
    """One jittered primary ray per pixel (trace.metal:1020-1067).

    Rays start on the physical sensor plane and aim at the focal point.
    ``row0``/``rows`` restrict generation to an image stripe (chunked
    rendering; row0 may be traced); ``pixel_sel`` ([M] i32 flat indices)
    instead generates rays for an arbitrary pixel subset (adaptive
    sampling).  Returns (ray pytree [N], pixel_idx [N]).
    """
    if pixel_sel is not None:
        n = pixel_sel.shape[0]
        pixel_idx = pixel_sel.astype(jnp.int32)
    else:
        rows = height if rows is None else rows
        n = width * rows
        pixel_idx = (jnp.asarray(row0, jnp.int32) * width
                     + jnp.arange(n, dtype=jnp.int32))
    off = jax.random.uniform(key, (n, 2), dtype=jnp.float32)

    px = (pixel_idx % width).astype(jnp.float32)
    py = (pixel_idx // width).astype(jnp.float32)
    xn = (px + off[:, 0] - 0.5 * width) / width
    yn = (py + off[:, 1] - 0.5 * height) / height

    origin = (
        cam["center"][None, :]
        + (xn * cam["phys_width"])[:, None] * cam["dx"][None, :]
        + (yn * cam["phys_height"])[:, None] * cam["dy"][None, :]
    )
    direction = normalize(cam["focal_point"][None, :] - origin)
    c_imp = 1.0 / (cam["phys_width"] * cam["phys_height"])

    rays = dict(
        origin=origin,
        direction=direction,
        normal=jnp.broadcast_to(cam["direction"], origin.shape),
        color=jnp.ones_like(origin),
        c_importance=jnp.full((n,), c_imp, dtype=jnp.float32),
        l_importance=jnp.ones((n,), dtype=jnp.float32),  # filled during trace
        tot_importance=jnp.full((n,), c_imp, dtype=jnp.float32),
        material=jnp.full((n,), 7, dtype=jnp.int32),
        triangle=jnp.full((n,), -1, dtype=jnp.int32),
        hit_light=jnp.full((n,), -1, dtype=jnp.int32),
        hit_camera=jnp.full((n,), -1, dtype=jnp.int32),
    )
    return rays, pixel_idx


def generate_light_rays(key, lights, materials, n: int):
    """Uniform light-surface emission rays (trace.metal:1070-1124).

    Picks a light triangle uniformly, a uniform barycentric point on it,
    and a uniform-hemisphere direction; l_importance = 1/(count * area).
    """
    k_pick, k_bary, k_dir = jax.random.split(key, 3)
    count = lights["v0"].shape[0]
    # matches (int)(rand * count) in the reference
    pick = jnp.minimum(
        (jax.random.uniform(k_pick, (n,)) * count).astype(jnp.int32), count - 1
    )
    lv = _take(lights, pick)

    bary = jax.random.uniform(k_bary, (n, 2), dtype=jnp.float32)
    normal = lv["normal"]
    origin = sample_triangle_uniform(lv["v0"], lv["v1"], lv["v2"], bary)
    origin = origin + DELTA * normal

    x, y = orthonormal(normal)
    rolls = jax.random.uniform(k_dir, (n, 2), dtype=jnp.float32)
    direction = random_hemisphere_uniform(x, y, normal, rolls)

    l_imp = 1.0 / (count * lv["area"])
    emission = jnp.take(materials["emission"], lv["material"], axis=0)

    rays = dict(
        origin=origin,
        direction=direction,
        normal=normal,
        color=emission,
        c_importance=jnp.ones((n,), dtype=jnp.float32),  # filled during trace
        l_importance=l_imp.astype(jnp.float32),
        tot_importance=l_imp.astype(jnp.float32),
        material=lv["material"].astype(jnp.int32),
        triangle=lv["tri_index"].astype(jnp.int32),
        hit_light=jnp.full((n,), -1, dtype=jnp.int32),
        hit_camera=jnp.full((n,), -1, dtype=jnp.int32),
    )
    return rays


def _select_bounce(mat_type, f_lottery, fres, diffuse, reflect, transmit):
    """Material dispatch (trace.metal:474-487) as masked selects.

    type 0: diffuse; type 1: Fresnel-weighted reflect|transmit;
    type 2: Fresnel-weighted reflect|diffuse; else: reflect.
    """
    take_reflect = f_lottery <= fres
    picks = []
    for branch in range(4):  # wo, f, c_p, l_p
        d, r, t = diffuse[branch], reflect[branch], transmit[branch]
        if branch == 0:
            expand = lambda c: c[:, None]
        else:
            expand = lambda c: c
        v = jnp.where(
            expand(mat_type == 0),
            d,
            jnp.where(
                expand(mat_type == 1),
                jnp.where(expand(take_reflect), r, t),
                jnp.where(
                    expand(mat_type == 2),
                    jnp.where(expand(take_reflect), r, d),
                    r,
                ),
            ),
        )
        picks.append(v)
    return tuple(picks)


def trace_subpaths(key, rays, pytree_scene, from_camera,
                   max_bounces: int = MAX_BOUNCES, mesh=None):
    """Trace a wavefront of subpaths to ``max_bounces`` stored vertices.

    ``from_camera`` may be a python bool or a per-ray [N] bool array —
    the latter lets camera and light wavefronts trace as ONE merged scan
    (render.py does this: one traversal kernel instance instead of two,
    double-size packets).

    ``mesh``: the pixel-tile mesh the wavefront is sharded over, if any
    (see ops/intersect.py:traverse_bvh).

    Returns a path pytree (depth-major layout — slicing one vertex level is
    a contiguous read, which matters on HBM):
      vertices: dict of [D, N, ...] arrays (fields as in generate_* rays)
      valid:    [D, N] bool — vertex d stored (reference path.length = count)
      length:   [N] i32

    A vertex is stored only when its full bounce iteration completed,
    mirroring the reference's break-before-store semantics
    (trace.metal:407-517).
    """
    tri = pytree_scene["tri"]
    mat = pytree_scene["mat"]

    n = rays["origin"].shape[0]
    fc = jnp.broadcast_to(jnp.asarray(from_camera, dtype=bool), (n,))
    fwd_pending0 = jnp.where(
        fc, rays["c_importance"],
        jnp.float32(1.0 / (2.0 * PI)),
    )

    def step(carry, depth):
        cur, fwd_pending, active = carry

        hit_i, hit_t, hit_u, hit_v = intersect_scene(
            cur["origin"], cur["direction"], pytree_scene, active=active,
            mesh=mesh,
        )
        hit_ok = hit_i >= 0
        safe_i = jnp.maximum(hit_i, 0)

        # one fused gather for every hit attribute (scene.py packs rows)
        attrs = jnp.take(tri["packed"], safe_i, axis=0)
        face_n = attrs[:, 0:3]
        n0 = attrs[:, 3:6]
        n1 = attrs[:, 6:9]
        n2 = attrs[:, 9:12]
        tri_mat = attrs[:, 12].astype(jnp.int32)
        is_light = attrs[:, 13].astype(jnp.int32)
        is_camera = attrs[:, 14].astype(jnp.int32)

        alpha = jnp.take(mat["alpha"], tri_mat, axis=0)
        ior = jnp.take(mat["ior"], tri_mat, axis=0)
        mat_type = jnp.take(mat["type"], tri_mat, axis=0)
        mat_color = jnp.take(mat["color"], tri_mat, axis=0)

        d = cur["direction"]
        cos_f = dot(-d, face_n)
        front = cos_f > 0.0
        degenerate = cos_f == 0.0

        sampled_n = bsdf.interpolate_normal(n0, n1, n2, hit_u, hit_v)
        nrm = jnp.where(front[:, None], sampled_n, -sampled_n)
        ni = jnp.where(front, 1.0, ior)
        no = jnp.where(front, ior, 1.0)

        new_origin = cur["origin"] + d * hit_t[:, None]
        new_hit_light = jnp.where(
            (is_light != 0) & (dot(d, face_n) < 0.0), hit_i, -1
        ).astype(jnp.int32)
        new_hit_camera = jnp.where(is_camera != 0, hit_i, -1).astype(jnp.int32)

        wi = -d
        k_depth = jax.random.fold_in(key, depth)
        ka, kb, kc = jax.random.split(k_depth, 3)
        roll_a = jax.random.uniform(ka, (n, 2), dtype=jnp.float32)
        roll_b = jax.random.uniform(kb, (n, 2), dtype=jnp.float32)
        # The reference reuses roll_b.x for the Fresnel lottery
        # (trace.metal:477-485), correlating it with the diffuse sample; we
        # draw an independent uniform (statistically equivalent estimator).
        roll_c = jax.random.uniform(kc, (n,), dtype=jnp.float32)

        m = ggx_sample(nrm, roll_a, alpha)
        ok_m = (dot(wi, m) >= 0.0) & (dot(m, nrm) >= 0.0)
        fres = bsdf.fresnel(wi, m, ni, no)

        # bounce fns return (fwd, rev) pdfs in camera convention; swap per
        # ray for light-subpath lanes
        diffuse = bsdf.diffuse_bounce(wi, nrm, True, roll_b)
        reflect = bsdf.reflect_bounce(wi, nrm, m, ni, no, alpha, True)
        transmit = bsdf.transmit_bounce(wi, nrm, m, ni, no, alpha, True)
        wo, f, fwd_p, rev_p = _select_bounce(
            mat_type, roll_c, fres, diffuse, reflect, transmit
        )
        c_p = jnp.where(fc, fwd_p, rev_p)
        l_p = jnp.where(fc, rev_p, fwd_p)

        # throughput color rules (trace.metal:489-494)
        wi_fn = dot(wi, face_n)
        wo_fn = dot(wo, face_n)
        apply_color = ((wi_fn > 0.0) & (wo_fn > 0.0)) | ((wi_fn < 0.0) & (wo_fn > 0.0))
        new_color = jnp.where(
            apply_color[:, None],
            f[:, None] * cur["color"] * mat_color,
            f[:, None] * cur["color"],
        )
        if not REFERENCE_MIS:
            # the Lambertian emitter's flux toward the first light-subpath
            # edge carries cos(n_light, dir); the reference's throughput
            # omits it (its light rays sample a uniform hemisphere with
            # pdf 1/2pi and start with color = emission only), biasing
            # every s>=2 strategy.  Fold it in at the first light bounce
            # so color(y_0) = emission stays untouched for s=1/t=1 use.
            emit_cos = jnp.abs(dot(cur["direction"], cur["normal"]))
            first_light = jnp.broadcast_to(depth == 0, fc.shape) & ~fc
            new_color = jnp.where(
                first_light[:, None],
                new_color * emit_cos[:, None],
                new_color,
            )

        new_fwd = fwd_pending
        new_tot = cur["tot_importance"] * new_fwd

        bounce_ok = ok_m & (f != 0.0)
        if REFERENCE_MIS:
            # reference break-before-store: a vertex is stored only when the
            # bounce at the NEXT hit also succeeded (trace.metal:407-517) —
            # needed there because the stored vertex's reverse pdf comes
            # from that bounce
            valid = active & hit_ok & ~degenerate & bounce_ok
            store = valid
        else:
            # corrected estimator: store on hit success alone.  The stale
            # reverse pdf this would expose is never read (the MIS chain
            # overrides every junction value), and requiring the next
            # bounce silently drops ~8% of connection paths (an extra
            # coin-flip the unidirectional estimator does not pay),
            # biasing every s>=1 strategy low.
            store = active & hit_ok & ~degenerate
            valid = store & bounce_ok

        # finalize and emit the CURRENT vertex (reference stores path.rays[i]
        # only after the bounce at the new hit succeeded)
        emit = dict(cur)
        emit["l_importance"] = jnp.where(fc, l_p, cur["l_importance"])
        emit["c_importance"] = jnp.where(fc, cur["c_importance"], c_p)
        next_pending = jnp.where(fc, c_p, l_p)

        new_cur = dict(
            origin=new_origin,
            direction=wo,
            normal=nrm,
            color=new_color,
            c_importance=jnp.where(fc, new_fwd, 1.0),
            l_importance=jnp.where(fc, 1.0, new_fwd),
            tot_importance=new_tot,
            material=tri_mat.astype(jnp.int32),
            triangle=hit_i.astype(jnp.int32),
            hit_light=new_hit_light,
            hit_camera=new_hit_camera,
        )
        # keep dead lanes frozen (values are masked by `valid` downstream)
        new_cur = jax.tree.map(
            lambda new, old: jnp.where(
                valid.reshape((n,) + (1,) * (new.ndim - 1)), new, old
            ),
            new_cur,
            cur,
        )
        new_pending = jnp.where(valid, next_pending, fwd_pending)

        return (new_cur, new_pending, valid), (emit, store)

    cur0 = dict(rays)
    carry0 = (cur0, fwd_pending0, jnp.ones(n, dtype=bool))
    _, (verts, valid) = jax.lax.scan(
        step, carry0, jnp.arange(max_bounces), length=max_bounces
    )
    # scan stacks along axis 0 -> [D, N, ...]; transpose to [N, D, ...]
    # scan stacks along axis 0 -> keep the natural [D, N, ...] layout
    length = jnp.sum(valid.astype(jnp.int32), axis=0)
    # extension rays actually cast: one per vertex stored, plus the final
    # breaking cast per path (capped at max_bounces)
    n_rays = jnp.sum(jnp.minimum(length + 1, max_bounces).astype(jnp.int32))
    return dict(vertices=verts, valid=valid, length=length, n_rays=n_rays)


def unidirectional_image(path, all_hits: bool = False):
    """s=0-style plain path-traced estimate from a camera path
    (trace.metal:523-528): first stored vertex that hit a light contributes
    prior color / tot_importance.

    all_hits=True accumulates EVERY light-hit vertex instead of breaking at
    the first (the reference breaks, trace.metal:523-528).  First-hit-only
    drops transport whose intermediate vertices lie on the emitter surface
    (the light both emits and reflects), which is ~13% of class-4+ energy
    on the Cornell preset — the BDPT strategies all cover those paths, so
    the convergence oracle (tests/test_convergence.py) must use
    all_hits=True to target the same integral.  The display image keeps
    the reference's first-hit semantics for pixel parity.
    """
    hit_light = path["vertices"]["hit_light"]   # [D, N]
    valid = path["valid"]
    mask = valid & (hit_light >= 0)
    color = path["vertices"]["color"]           # [D, N, 3]
    tot = path["vertices"]["tot_importance"]    # [D, N]
    if all_hits:
        d = color.shape[0]
        prior_color = jnp.concatenate(
            [jnp.ones_like(color[0:1]), color[: d - 1]], axis=0
        )  # prior vertex's throughput; vertex 0 can't be a light hit anyway
        est = prior_color / jnp.maximum(tot, 1e-30)[:, :, None]
        return jnp.sum(jnp.where(mask[:, :, None], est, 0.0), axis=0)
    has = jnp.any(mask, axis=0)
    first = jnp.argmax(mask, axis=0)            # [N]
    prior_color = jnp.take_along_axis(
        color, jnp.maximum(first - 1, 0)[None, :, None], axis=0
    )[0]
    tot_first = jnp.take_along_axis(tot, first[None, :], axis=0)[0]
    out = prior_color / jnp.maximum(tot_first, 1e-30)[:, None]
    return jnp.where(has[:, None], out, 0.0)
