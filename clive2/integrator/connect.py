"""BDPT vertex connection with balance-heuristic MIS.

Wavefront replacement for the reference ``connect_paths`` kernel
(reference src/trace.metal:620-869) plus the entire light-splat
machinery (``light_sort`` :872-934, host ``light_bins`` renderer.py:97-111,
``light_image_gather`` :937-964): splats become one deterministic
scatter-add, eliminating the 276 bitonic-sort launches and the mid-frame
device->host round trip.

Structure:
  * every (t, s) strategy that needs a ray cast (t=1 camera-plane
    projections, general-join visibility tests) is evaluated in ONE
    mega-batched traversal over the strategy-major [P * N] wavefront, so
    the BVH traversal is compiled once;
  * the per-strategy MIS chains (p_ratios / p_values sweep,
    trace.metal:708-776) are unrolled per static (t, s) as masked
    vectorized ops over the whole wavefront.

Deliberate deviations from reference quirks (SURVEY §"quirks"):
  * the out-of-range p_ratios read at trace.metal:746-749 writes only a
    dead slot; we simply don't compute it;
  * t=1 splat pixels that round outside the image are dropped instead of
    wrapping into neighbor rows (trace.metal:602-605 does not clamp).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from ..constants import DELTA, MAX_BOUNCES
from ..ops.intersect import intersect_scene
from ..ops.sampling import PI, dot, normalize

# CLIVE2_REFERENCE_MIS=1 restores the reference's estimator verbatim (for
# pixel-exact parity runs); the default is the corrected estimator
# (constants.py:REFERENCE_MIS documents the differences).
from ..constants import REFERENCE_MIS

import os

# CLIVE2_ANY_HIT=0 forces closest-hit connection casts (A/B knob).  The
# default lets the traversal stop an occluded visibility cast at its first
# occluder instead of refining to the closest hit.
ANY_HIT_CASTS = os.environ.get("CLIVE2_ANY_HIT", "1") != "0"

# Compacted connection cast: gather each pixel's first K active (t, s)
# strategies into a dense [K, N] dispatch instead of the strategy-major
# [P, N] mega-batch (P ~ 36-41 but only ~1 strategy/pixel is active on
# the eval scenes).  0 disables (full mega-batch), the default; on the
# GPU it is not measured yet.
CONNECT_K = int(os.environ.get("CLIVE2_CONNECT_K", "0"))


def _take_d(tree, d):
    """Index vertex d (possibly traced) out of [D, N, ...] path arrays."""
    return jax.tree.map(lambda a: jnp.take(a, d, axis=0), tree)


def _vstatic(tree, d: int):
    return jax.tree.map(lambda a: a[d], tree)


def _geom(a, b):
    """cosine_geometry_term (trace.metal:539-544): uses each vertex's
    *stored* direction, exactly as the reference does."""
    delta = b["origin"] - a["origin"]
    dist2 = jnp.maximum(dot(delta, delta), 1e-30)
    cos_a = jnp.abs(dot(a["direction"], a["normal"]))
    cos_b = jnp.abs(dot(b["direction"], b["normal"]))
    return cos_a * cos_b / dist2


def connection_pairs(max_bounces: int = MAX_BOUNCES):
    """(t, s) strategies that require a ray cast, in lax.map order."""
    pairs = []
    for t in range(1, max_bounces + 1):
        for s in range(1, max_bounces + 1):
            if t + s < 2:
                continue
            pairs.append((t, s))
    return pairs


def connect_paths(cam_path, light_path, scene, width: int, height: int,
                  max_bounces: int = MAX_BOUNCES,
                  debug_per_strategy: bool = False, mesh=None):
    """All-strategies BDPT connection for a wavefront of path pairs.

    cam_path / light_path: outputs of trace.trace_subpaths
    Returns dict:
      contribution [N, 3]        (t != 1 strategies, per camera pixel)
      contrib_weight_sum [N]
      light_image [H, W, 3]      (t == 1 splats, scatter-added)
      light_weight_image [H, W]

    debug_per_strategy: additionally return ``per_strategy``, a dict
    mapping (t, s) -> dict(weighted=[H, W, 3], unweighted=[H, W, 3],
    weight=[H, W]) full-frame images for that single strategy (t=1 splats
    scattered separately).  Diagnostic only — not for production renders.
    """
    CV, cam_valid, cam_len = cam_path["vertices"], cam_path["valid"], cam_path["length"]
    LV, light_len = light_path["vertices"], light_path["length"]
    mat = scene["mat"]
    tri = scene["tri"]
    cam = scene["camera"]

    n = cam_len.shape[0]
    pairs = connection_pairs(max_bounces)
    pair_arr = jnp.asarray(pairs, dtype=jnp.int32)

    # ---- stage A: ALL (t, s) ray casts as ONE mega-batched traversal -------
    # One [P*N]-ray traversal instead of P sequential ones: one compiled
    # walk, one launch per cast.
    pre = precompute_mis(CV, LV, mat, max_bounces)
    t_i = pair_arr[:, 0] - 1                      # [P]
    s_i = pair_arr[:, 1] - 1
    take = lambda X, idx: jnp.take(X, idx, axis=0)
    lv_o = take(LV["origin"], s_i)                # [P, N, 3]
    lv_n = take(LV["normal"], s_i)
    cv_o = take(CV["origin"], t_i)
    cv_n = take(CV["normal"], t_i)
    l_spec = take(pre["L"]["spec"], s_i)          # [P, N]
    c_spec = take(pre["C"]["spec"], t_i)

    t_col = pair_arr[:, 0][:, None]               # [P, 1]
    s_col = pair_arr[:, 1][:, None]
    lens_ok = (t_col <= cam_len[None, :]) & (s_col <= light_len[None, :])

    proj_dir = normalize(cam["focal_point"][None, None, :] - lv_o)
    cam_dir = cam["direction"][None, None, :]
    t1_ok = ~l_spec & (dot(proj_dir, cam_dir) <= 0.0)

    dir_l_to_c = normalize(cv_o - lv_o)
    gen_ok = (
        ~l_spec
        & ~c_spec
        & (dot(lv_n, dir_l_to_c) >= DELTA)
        & (dot(cv_n, -dir_l_to_c) >= DELTA)
    )

    is_t1 = (pair_arr[:, 0] == 1)[:, None]        # [P, 1]
    active = lens_ok & jnp.where(is_t1, t1_ok, gen_ok)
    direction = jnp.where(is_t1[..., None], proj_dir, dir_l_to_c)
    # per-ray search caps (shadow-ray pruning): a general join only needs
    # hits up to the camera-side vertex; a t=1 projection only up to the
    # sensor plane.  Capping best-t before the walk prunes every subtree
    # beyond the target (measured large on big scenes).
    delta_pc = cv_o - lv_o
    d_gen = jnp.sqrt(jnp.maximum(dot(delta_pc, delta_pc), 0.0))
    den = dot(proj_dir, cam_dir)
    num = dot(cam["center"][None, None, :] - lv_o, cam_dir)
    d_t1 = jnp.where(den < -1e-12, num / den, jnp.inf)
    if REFERENCE_MIS or not ANY_HIT_CASTS:
        # reference closest-hit visibility (hit must BE the target): cap
        # just beyond the target so it registers
        t_max = jnp.where(is_t1, d_t1, d_gen) * 1.001 + 1e-4
        any_hit = False
    else:
        # robust visibility only asks "is any hit strictly inside the
        # segment?" — cap strictly BELOW the target so every recordable
        # hit is a true occluder, and let the traversal stop at the first
        # one (any_hit) instead of refining to the closest
        t_max = jnp.where(is_t1, d_t1, d_gen) * (1.0 - 1e-3)
        any_hit = True

    p_cnt = len(pairs)
    flat = lambda a: a.reshape((p_cnt * n,) + a.shape[2:])
    if 0 < CONNECT_K < p_cnt:
        # ---- compacted cast: the [P, N] mega-batch averages only ~1
        # active strategy per pixel on the eval scenes.  Gather each
        # pixel's FIRST K active
        # pairs into a [K, N] cast (density ~= count/K), scatter results
        # back by pair id, and run the rare >K overflow through the full
        # mega-batch under a lax.cond that skips the walk entirely when
        # no pixel overflows.  Per-ray results are identical: the same
        # (origin, direction, t_max) rays are cast either way.
        K = CONNECT_K
        act_i = active.astype(jnp.int32)                   # [P, N]
        rank = jnp.cumsum(act_i, axis=0) - act_i           # [P, N]
        score = jnp.where(
            active, p_cnt - jnp.arange(p_cnt, dtype=jnp.int32)[:, None], 0)
        vals, idxs = jax.lax.top_k(score.T, K)             # [N, K]
        sel = idxs.T                                       # [K, N] pair ids
        act_k = (vals > 0).T                               # [K, N]
        o_k = jnp.take_along_axis(lv_o, sel[..., None], axis=0)
        d_k = jnp.take_along_axis(direction, sel[..., None], axis=0)
        tm_k = jnp.take_along_axis(t_max, sel, axis=0)
        flatk = lambda a: a.reshape((K * n,) + a.shape[2:])
        hi_k, ht_k, _, _ = intersect_scene(
            flatk(o_k), flatk(d_k), scene, active=flatk(act_k),
            t_max=flatk(tm_k), any_hit=any_hit, mesh=mesh,
        )
        pix = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :],
                               (K, n))
        row = jnp.where(act_k, sel, p_cnt)                 # dead -> dropped
        cast_tri = jnp.full((p_cnt, n), -1, jnp.int32).at[
            row, pix].set(hi_k.reshape(K, n), mode="drop")
        cast_t = jnp.full((p_cnt, n), jnp.inf, jnp.float32).at[
            row, pix].set(ht_k.reshape(K, n), mode="drop")

        rem = active & (rank >= K)

        def _run_rem(_):
            hi_r, ht_r, _, _ = intersect_scene(
                flat(lv_o), flat(direction), scene, active=flat(rem),
                t_max=flat(t_max), any_hit=any_hit, mesh=mesh,
            )
            return hi_r.reshape(p_cnt, n), ht_r.reshape(p_cnt, n)

        def _skip_rem(_):
            return (jnp.full((p_cnt, n), -1, jnp.int32),
                    jnp.full((p_cnt, n), jnp.inf, jnp.float32))

        hi_r, ht_r = jax.lax.cond(jnp.any(rem), _run_rem, _skip_rem, None)
        cast_tri = jnp.where(rem, hi_r, cast_tri)
        cast_t = jnp.where(rem, ht_r, cast_t)
    else:
        hit_i, hit_t, _, _ = intersect_scene(
            flat(lv_o), flat(direction), scene, active=flat(active),
            t_max=flat(t_max), any_hit=any_hit, mesh=mesh,
        )
        cast_tri = hit_i.reshape(p_cnt, n)
        cast_t = hit_t.reshape(p_cnt, n)
    cast_active = active
    pair_index = {ts: i for i, ts in enumerate(pairs)}

    # ---- stage B: per-strategy MIS + contributions (static unroll) ---------
    contribution = jnp.zeros((n, 3), dtype=jnp.float32)
    contrib_weight = jnp.zeros((n,), dtype=jnp.float32)
    splat_pix, splat_val, splat_wgt = [], [], []
    per_strategy = {}

    def _debug_record(t, s, valid, w, est, pix=None):
        """est: per-lane UNWEIGHTED estimate [N, 3] (already masked)."""
        if not debug_per_strategy:
            return
        wv = jnp.where(valid, w, 0.0)
        if pix is None:          # lane i == pixel i (full-frame wavefront)
            img_u = est.reshape(height, width, 3)
            img_w = (wv[:, None] * est).reshape(height, width, 3)
            img_ww = wv.reshape(height, width)
        else:
            flat = lambda v: (
                jnp.zeros((width * height,), jnp.float32)
                .at[pix].add(v, mode="drop")
            )
            img_u = jnp.stack(
                [flat(est[:, c]) for c in range(3)], -1
            ).reshape(height, width, 3)
            img_w = jnp.stack(
                [flat(wv * est[:, c]) for c in range(3)], -1
            ).reshape(height, width, 3)
            img_ww = flat(wv).reshape(height, width)
        per_strategy[(t, s)] = dict(
            weighted=img_w, unweighted=img_u, weight=img_ww
        )

    for t in range(1, max_bounces + 1):
        for s in range(0, max_bounces + 1):
            if t + s < 2:
                continue
            if t == 1:
                res = _strategy_t1(
                    t, s, CV, LV, cam_len, light_len, scene, width, height,
                    cast_tri[pair_index[(t, s)]],
                    cast_t[pair_index[(t, s)]],
                    cast_active[pair_index[(t, s)]],
                    pre,
                )
                pix, val, wgt, est_unw, t1_valid, t1_w = res
                splat_pix.append(pix)
                splat_val.append(val)
                splat_wgt.append(wgt)
                _debug_record(t, s, t1_valid, t1_w, est_unw, pix=pix)
            else:
                if s == 0:
                    valid = (t <= cam_len)
                    cv = _vstatic(CV, t - 1)
                    valid &= cv["hit_light"] >= 0
                    lv = None
                    g = jnp.ones((n,), dtype=jnp.float32)
                    emission = jnp.take(mat["emission"], cv["material"],
                                        axis=0)
                    color = _vstatic(CV, t - 2)["color"] * emission
                else:
                    idx = pair_index[(t, s)]
                    cv = _vstatic(CV, t - 1)
                    lv = _vstatic(LV, s - 1)
                    if REFERENCE_MIS:
                        visible = (
                            (cast_tri[idx] >= 0)
                            & (cast_tri[idx] != lv["triangle"])
                            & (cast_tri[idx] == cv["triangle"])
                        )
                    else:
                        # robust visibility: with the cast capped at the
                        # segment length, "no hit strictly inside the
                        # segment" means unoccluded.  Requiring the hit to
                        # BE the target triangle (the reference's rule,
                        # trace.metal:193-196) silently kills grazing
                        # connections where Möller-Trumbore is
                        # ill-conditioned (measured ~35% of direct light
                        # lost on the Cornell side walls).
                        seg = cv["origin"] - lv["origin"]
                        seg_len = jnp.sqrt(jnp.maximum(dot(seg, seg), 1e-30))
                        visible = (
                            (cast_tri[idx] == cv["triangle"])
                            | (cast_tri[idx] < 0)
                            | (cast_t[idx] >= seg_len * (1.0 - 1e-3))
                        )
                    valid = cast_active[idx] & visible
                    dir_l_to_c = normalize(cv["origin"] - lv["origin"])
                    if REFERENCE_MIS:
                        # reference formula: cos/pi junction "BRDFs" plus a
                        # geometry term built from stale stored directions
                        new_camera_f = (
                            jnp.abs(dot(-dir_l_to_c, cv["normal"])) / PI
                        )
                        g = _geom(cv, lv)
                    else:
                        # diffuse BRDF is 1/pi (no cosine); the junction
                        # cosines belong to the geometry term, evaluated
                        # with the ACTUAL connection direction
                        new_camera_f = jnp.full_like(cv["tot_importance"],
                                                     1.0 / PI)
                        delta_j = cv["origin"] - lv["origin"]
                        d2_j = jnp.maximum(dot(delta_j, delta_j), 1e-30)
                        g = (jnp.abs(dot(dir_l_to_c, lv["normal"]))
                             * jnp.abs(dot(dir_l_to_c, cv["normal"])) / d2_j)
                    camera_color = (
                        _vstatic(CV, t - 2)["color"]
                        * new_camera_f[:, None]
                        * jnp.take(mat["color"], cv["material"], axis=0)
                    )
                    if s == 1:
                        light_color = jnp.take(mat["emission"],
                                               lv["material"], axis=0)
                    else:
                        if REFERENCE_MIS:
                            new_light_f = (
                                jnp.abs(dot(dir_l_to_c, lv["normal"])) / PI
                            )
                        else:
                            new_light_f = jnp.full_like(
                                lv["tot_importance"], 1.0 / PI
                            )
                            if s == 2:
                                # the emission cosine lives in color(y_1)
                                # onward (trace.py folds it at the first
                                # light bounce); s == 2 uses color(y_0)
                                # and needs it explicitly
                                y0 = _vstatic(LV, 0)
                                new_light_f = new_light_f * jnp.abs(
                                    dot(y0["direction"], y0["normal"])
                                )
                        light_color = (
                            _vstatic(LV, s - 2)["color"]
                            * new_light_f[:, None]
                            * jnp.take(mat["color"], lv["material"], axis=0)
                        )
                    color = camera_color * light_color

                light_tot = (
                    jnp.ones_like(cv["tot_importance"]) if s == 0
                    else lv["tot_importance"]
                )
                p_s = cv["tot_importance"] * light_tot
                if s >= 1:
                    delta = cv["origin"] - lv["origin"]
                    d_x = jnp.maximum(dot(delta, delta), 1e-30)
                else:
                    d_x = None
                if REFERENCE_MIS:
                    w, p_s, ok = _mis_weight_fast(t, s, pre, p_s, Dx=d_x)
                elif s == 0:
                    w, p_s, ok = _mis_weight_correct(
                        t, s, pre, p_s, l0_override=pre["L"]["l"][0]
                    )
                else:
                    dj = normalize(cv["origin"] - lv["origin"])
                    w, p_s, ok = _mis_weight_correct(
                        t, s, pre, p_s, Dx=d_x,
                        jcos_l=jnp.abs(dot(dj, lv["normal"])),
                        jcos_c=jnp.abs(dot(dj, cv["normal"])),
                    )
                valid &= ok
                contrib = (w * g / jnp.maximum(p_s, 1e-38))[:, None] * color
                contribution += jnp.where(valid[:, None], contrib, 0.0)
                contrib_weight += jnp.where(valid, w, 0.0)
                _debug_record(t, s, valid, w, jnp.where(
                    valid[:, None],
                    (g / jnp.maximum(p_s, 1e-38))[:, None] * color, 0.0
                ))

    # One scatter pass per channel over the concatenated strategies.
    # (Scattering into an [H*W, 3] accumulator lets XLA pick a transposed
    # layout for it — measured 250 ms per scatter at 1080p vs 0.06 ms for a
    # flat layout; per-channel flat scatters avoid the trap entirely.)
    pix = jnp.concatenate(splat_pix)
    vals = jnp.concatenate(splat_val)
    wgts = jnp.concatenate(splat_wgt)
    # materialize flat per-channel operands before scattering: anything XLA
    # fuses into the scatter custom-call (even a strided column slice)
    # makes it run orders of magnitude slower than over plain flat operands
    pix, v0, v1, v2, wgts = jax.lax.optimization_barrier(
        (pix, vals[:, 0], vals[:, 1], vals[:, 2], wgts)
    )
    channels = [
        jnp.zeros((width * height,), jnp.float32).at[pix].add(vc, mode="drop")
        for vc in (v0, v1, v2)
    ]
    flat_light_w = jnp.zeros((width * height,), jnp.float32).at[pix].add(
        wgts, mode="drop"
    )
    light_image = jnp.stack(channels, axis=-1).reshape(height, width, 3)

    out = dict(
        contribution=contribution,
        contrib_weight_sum=contrib_weight,
        light_image=light_image,
        light_weight_image=flat_light_w.reshape(height, width),
        n_rays=jnp.sum(cast_active.astype(jnp.int32)),
    )
    if debug_per_strategy:
        out["per_strategy"] = per_strategy
    return out


def _strategy_t1(t, s, CV, LV, cam_len, light_len, scene, width, height,
                 hit_i, hit_t, active, pre):
    """t=1: project light vertex s-1 onto the physical camera plane
    (world_ray_to_camera_ray, trace.metal:569-617) and emit a splat."""
    mat = scene["mat"]
    tri = scene["tri"]
    cam = scene["camera"]
    n = cam_len.shape[0]

    lv = _vstatic(LV, s - 1)
    proj_dir = normalize(cam["focal_point"][None, :] - lv["origin"])

    safe_i = jnp.maximum(hit_i, 0)
    is_cam_tri = (hit_i >= 0) & (
        jnp.take(tri["packed"], safe_i, axis=0)[:, 14] != 0
    )
    if not REFERENCE_MIS:
        # robust sensor reach: intersect the sensor PLANE analytically
        # (exact where the MT hit is grazing-fragile) and accept when no
        # scene hit lies strictly inside the segment
        den = dot(proj_dir, cam["direction"][None, :])
        num = dot(cam["center"][None, :] - lv["origin"],
                  cam["direction"][None, :])
        t_plane = jnp.where(den < -1e-12, num / den, jnp.inf)
        reached = (
            is_cam_tri | (hit_i < 0) | (hit_t >= t_plane * (1.0 - 1e-3))
        ) & jnp.isfinite(t_plane) & (t_plane > 0)
        is_cam_tri = reached
        camera_point = lv["origin"] + t_plane[:, None] * proj_dir
    else:
        camera_point = lv["origin"] + hit_t[:, None] * proj_dir

    rel = camera_point - cam["center"][None, :]
    x = dot(rel, cam["dx"][None, :])
    y = dot(rel, cam["dy"][None, :])
    if REFERENCE_MIS:
        # the reference's round() shifts the splat grid by half a pixel
        # relative to generate_camera_rays' pixel footprints
        px = jnp.round((x / cam["phys_width"] + 0.5) * width).astype(jnp.int32)
        py = jnp.round((y / cam["phys_height"] + 0.5) * height).astype(jnp.int32)
    else:
        px = jnp.floor((x / cam["phys_width"] + 0.5) * width).astype(jnp.int32)
        py = jnp.floor((y / cam["phys_height"] + 0.5) * height).astype(jnp.int32)
    pix_ok = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    pixel = py * width + px

    # synthetic camera vertex: overrides on a copy of camera vertex 0
    # (the Metal kernel writes into camera_path.rays[0]; unassigned fields —
    # c/l_importance — keep the original vertex-0 values)
    base = _vstatic(CV, 0)
    cv = dict(base)
    cv["origin"] = camera_point
    cv["direction"] = normalize(cam["focal_point"][None, :] - camera_point)
    cv["normal"] = jnp.broadcast_to(cam["direction"], (n, 3))
    cv["material"] = jnp.full((n,), 7, dtype=jnp.int32)
    cv["color"] = jnp.ones((n, 3), dtype=jnp.float32)
    cv["triangle"] = safe_i.astype(jnp.int32)
    cv["tot_importance"] = jnp.ones((n,), dtype=jnp.float32)

    valid = active & is_cam_tri & pix_ok

    p_s = cv["tot_importance"] * lv["tot_importance"]  # synthetic tot = 1
    delta = camera_point - lv["origin"]
    d_x = jnp.maximum(dot(delta, delta), 1e-30)
    w_synth = jnp.abs(dot(cv["direction"], cv["normal"]))
    spec_synth = jnp.broadcast_to(mat["type"][7] > 0, w_synth.shape)
    if REFERENCE_MIS:
        w, p_s, ok = _mis_weight_fast(t, s, pre, p_s, Dx=d_x,
                                      w_synth=w_synth,
                                      spec_synth=spec_synth)
    else:
        dj = normalize(camera_point - lv["origin"])
        w, p_s, ok = _mis_weight_correct(
            t, s, pre, p_s, Dx=d_x,
            jcos_l=jnp.abs(dot(dj, lv["normal"])),
            jcos_c=jnp.abs(dot(dj, cam["direction"][None, :])),
            spec_synth=spec_synth,
            t1_cam_c=pre["C"]["c"][0],
        )
    valid &= ok

    dir_l_to_c = normalize(camera_point - lv["origin"])
    prior = _vstatic(LV, max(0, s - 2))
    if REFERENCE_MIS:
        if s > 1:
            new_light_f = jnp.abs(dot(dir_l_to_c, lv["normal"])) / PI
        else:
            new_light_f = jnp.ones((n,), dtype=jnp.float32)
        g = _geom(lv, cv)
        shade = new_light_f * g
        lcolor = prior["color"] * jnp.take(mat["color"], lv["material"],
                                           axis=0)
    else:
        # unbiased splat: radiance toward the sensor times the light->pixel
        # area Jacobian through the pinhole.  Each sample launches W*H
        # light subpaths, so for splats landing in pixel p the requirement
        # is W*H * E[S * pdf * A_preimage] = radiance/c_imp^2 (the
        # unidirectional pixel value).  With A_preimage = A_pixel *
        # (cosC/cosL)(r0/r1)^2 through the focal point and A_pixel =
        # phys_w*phys_h/(W*H), the shade reduces to
        # phys_w*phys_h * (cosL/cosC)(r1/r0)^2.  The reference's
        # cosL*cosC/D shade is ~20% high on light-view pixels (measured)
        # and spatially distorted.
        if s > 1:
            brdf = jnp.full((n,), 1.0 / PI)
            if s == 2:
                # emission cosine: see the s == 2 note in connect_paths
                y0 = _vstatic(LV, 0)
                brdf = brdf * jnp.abs(dot(y0["direction"], y0["normal"]))
        else:
            brdf = jnp.ones((n,), dtype=jnp.float32)
        cos_l = jnp.abs(dot(dir_l_to_c, lv["normal"]))
        cos_c = jnp.maximum(
            jnp.abs(dot(dir_l_to_c, cam["direction"][None, :])), 1e-6
        )
        r0 = jnp.sqrt(jnp.maximum(dot(
            cam["focal_point"][None, :] - lv["origin"],
            cam["focal_point"][None, :] - lv["origin"]), 1e-30))
        r1 = jnp.sqrt(jnp.maximum(dot(
            cam["focal_point"][None, :] - camera_point,
            cam["focal_point"][None, :] - camera_point), 1e-30))
        k_sensor = cam["phys_width"] * cam["phys_height"]
        shade = brdf * k_sensor * (cos_l / cos_c) * (r1 / r0) ** 2
        lcolor = prior["color"] * jnp.take(mat["color"], lv["material"],
                                           axis=0)

    value = (
        (w * shade / jnp.maximum(p_s, 1e-38))[:, None] * lcolor
    )
    est_unw = jnp.where(
        valid[:, None],
        (shade / jnp.maximum(p_s, 1e-38))[:, None] * lcolor, 0.0
    )
    pix_out = jnp.where(valid, pixel, width * height)  # OOB -> dropped
    return (pix_out, jnp.where(valid[:, None], value, 0.0),
            jnp.where(valid, w, 0.0), est_unw, valid, w)


def precompute_mis(CV, LV, mat, max_bounces: int):
    """Shared MIS-chain terms, computed once per sample.

    Every strategy's p_ratios decompose into per-vertex terms (cosine
    weight w = |dot(dir, normal)|, the stored dual importances, specular
    flags) and per-edge squared distances — identical across the 41
    strategies except at the connection junction.  Precomputing them turns
    each strategy chain from ~12 geometry evaluations into ~12 fused
    multiplies (also shrinking the compile graph ~10x).
    """
    def per_path(V):
        w = jnp.abs(jnp.sum(V["direction"] * V["normal"], axis=-1))  # [D, N]
        matv = V["material"]
        d, n = matv.shape
        spec = (
            jnp.take(mat["type"], matv.reshape(-1), axis=0).reshape(d, n) > 0
        )
        delta = V["origin"][1:] - V["origin"][:-1]
        dist2 = jnp.maximum(jnp.sum(delta * delta, axis=-1), 1e-30)
        # cosine of vertex d's normal against its INCOMING edge (the edge
        # from vertex d-1) — the corrected MIS chain pairs each geometry
        # term's cosines with that edge's actual direction (in_cos[0] is
        # never read; see _mis_weight_correct)
        in_cos = jnp.concatenate(
            [w[0:1],
             jnp.abs(jnp.sum(V["direction"][:-1] * V["normal"][1:], axis=-1))],
            axis=0,
        )
        return dict(
            w=w,
            in_cos=in_cos,
            l=V["l_importance"],
            c=V["c_importance"],
            spec=spec,
            D=dist2,
        )

    return dict(L=per_path(LV), C=per_path(CV))


def _mis_weight_correct(t, s, pre, p_s, Dx=None, jcos_l=None, jcos_c=None,
                        spec_synth=None, l0_override=None, t1_cam_c=None):
    """Balance-heuristic weight with CONSISTENT junction pdfs/cosines.

    The reference's chain (transcribed in _mis_weight/_mis_weight_fast)
    knowingly uses stale values at the connection junction — the
    commented-out fix at trace.metal:696-706 ("technically correct but has
    no visible effect") — and pairs every geometry cosine with the
    vertex's own STORED outgoing direction even for the incoming edge.
    The per-path strategy weights then do not sum to 1, which biases the
    count-normalized image spatially (measured 0.3x-3.2x by row on the
    Cornell box; the display's divide-by-weight-sum largely hides it,
    which is why the reference author saw "no visible effect").

    This chain recomputes, per strategy (t, s):
      * junction pdf overrides (the reference's own commented fix):
        camera-junction l_importance = |dot(dir_join, n_light)|/pi,
        light-junction c_importance = |dot(dir_join, n_cam)|/pi
        (t=1: the sensor importance instead; s=0: the light-area pdf);
      * per-edge cosine pairing: each edge's geometry term uses THAT
        edge's direction at both endpoints (subpath-internal edges reuse
        the stored direction of the earlier endpoint; the junction edge
        uses the actual connection direction via jcos_l/jcos_c).

    Args: jcos_l/jcos_c = |cos| of the junction edge at the light/camera
    junction vertices (None when s == 0); l0_override replaces vertex 0's
    l_importance for s == 0 (the light-area pdf); t1_cam_c = the sensor
    c_importance used for the t == 1 light-junction override.
    """
    k = s + t
    L, C = pre["L"], pre["C"]

    def vert_l(i):
        if i == 0 and s == 0:
            return l0_override
        if i == 1:
            # the hypothetical light subpath's FIRST direction is sampled
            # uniform-hemisphere at the light surface (generate_light_rays),
            # pdf 1/2pi — regardless of which side actually sampled x_1.
            # (For s >= 2 the stored value already is 1/2pi.)
            return jnp.full_like(p_s, 1.0 / (2.0 * PI))
        if i == s and s >= 1:          # camera junction (or t=1 synthetic)
            return jcos_l / PI
        if i < s:
            return L["l"][i]
        return C["l"][t + s - 1 - i]

    def vert_c(i):
        if i == s - 1 and s >= 1:      # light junction
            return t1_cam_c if t == 1 else jcos_c / PI
        if i < s:
            return L["c"][i]
        j = t + s - 1 - i
        return C["c"][j]

    def vert_spec(i):
        if i < s:
            return L["spec"][i]
        j = t + s - 1 - i
        if t == 1 and j == 0:
            return spec_synth
        return C["spec"][j]

    def cos_light_side(i):
        """|cos| at vertex x_i against its light-side edge e_{i-1}."""
        if i - 1 == s - 1 and s >= 1:  # junction edge -> x_i is cam junction
            return jcos_c
        if i - 1 <= s - 2:             # light-internal edge, x_i = light[i]
            return L["in_cos"][i]
        j = t + s - 1 - i              # camera-internal, x_i = cam[j]
        return C["w"][j]

    def cos_cam_side(i):
        """|cos| at vertex x_i against its camera-side edge e_i."""
        if i == s - 1 and s >= 1:      # junction edge -> x_i is light junction
            return jcos_l
        if i <= s - 2:                 # light-internal edge
            return L["w"][i]
        j = t + s - 1 - i              # camera-internal
        return C["in_cos"][j]

    def edge_D(e):
        if s >= 1 and e == s - 1:
            return Dx
        if e <= s - 2:
            return L["D"][e]
        j = t + s - 1 - e              # edge (cam[j], cam[j-1])
        return C["D"][j - 1]

    # true pdf ratio p_{i+1}/p_i: only vertex x_i changes sides, so only
    # ITS solid-angle->area conversions appear — the single cosine at x_i
    # against each edge (the reference's two-cosine geometry terms mix in
    # the neighbors' stale cosines)
    ratios = []
    for i in range(k):
        if i == 0:
            num = vert_l(0)            # area pdf (light surface)
            den = vert_c(0) * cos_cam_side(0) / edge_D(0)
        elif i == k - 1:
            num = vert_l(k - 1) * cos_light_side(k - 1) / edge_D(k - 2)
            den = vert_c(k - 1)        # area pdf (sensor importance)
        else:
            num = vert_l(i) * cos_light_side(i) / edge_D(i - 1)
            den = vert_c(i) * cos_cam_side(i) / edge_D(i)
        ratios.append(num / jnp.where(jnp.abs(den) > 1e-38, den, 1e-38))

    p_values = [None] * (k + 1)
    p_values[s] = p_s
    for i in range(s, k):
        p_values[i + 1] = p_values[i] * ratios[i]
    for i in range(s - 1, -1, -1):
        p_values[i] = p_values[i + 1] / jnp.where(
            jnp.abs(ratios[i]) > 1e-38, ratios[i], 1e-38
        )

    for i in range(k):
        sp = vert_spec(i)
        p_values[i] = jnp.where(sp, 0.0, p_values[i])
        p_values[i + 1] = jnp.where(sp, 0.0, p_values[i + 1])
    p_values[k] = jnp.zeros_like(p_s)

    total = p_values[0]
    for i in range(1, k + 1):
        total = total + p_values[i]

    ok = (p_values[s] > 0.0) & (total > 0.0)
    w = jnp.where(ok, p_values[s] / jnp.where(total > 0.0, total, 1.0), 0.0)
    return w, p_s, ok


def _mis_weight_fast(t, s, pre, p_s, Dx=None, w_synth=None, spec_synth=None):
    """Balance-heuristic weight from precomputed terms.

    Numerically mirrors :func:`_mis_weight` (the direct transcription of
    trace.metal:693-776, kept as the test oracle): each ratio is formed as
    num/den with the same factors and guards, only with the geometry terms
    looked up instead of recomputed.

    Dx: junction squared distance between light[s-1] and the camera-side
    vertex (required when s >= 1); w_synth/spec_synth: cosine weight and
    specular flag of the t=1 synthetic camera vertex (its material is
    overwritten to the sensor slot, so the flag comes from the material
    table, not the original camera vertex).
    """
    k = s + t
    L, C = pre["L"], pre["C"]

    def vert(i):
        if i < s:
            return L["w"][i], L["l"][i], L["c"][i], L["spec"][i]
        j = t + s - 1 - i
        if t == 1 and j == 0:
            return w_synth, C["l"][0], C["c"][0], spec_synth
        return C["w"][j], C["l"][j], C["c"][j], C["spec"][j]

    def edge(e):
        # squared distance between vx[e] and vx[e+1]
        if e <= s - 2:
            return L["D"][e]
        if e == s - 1 and s >= 1:
            return Dx
        j = t + s - 2 - e  # camera edge (cam[j], cam[j+1])
        return C["D"][j]

    v = [vert(i) for i in range(k)]

    ratios = []
    for i in range(k):
        if i == 0:
            w0, l0, c0, _ = v[0]
            w1 = v[1][0]
            num = l0
            den = c0 * (w0 * w1 / edge(0))
        elif i == k - 1:
            wk, lk, ck, _ = v[k - 1]
            wp = v[k - 2][0]
            num = lk * (wk * wp / edge(k - 2))
            den = ck
        else:
            wi, li, ci, _ = v[i]
            num = li * (v[i - 1][0] * wi / edge(i - 1))
            den = ci * (wi * v[i + 1][0] / edge(i))
        ratios.append(num / jnp.where(jnp.abs(den) > 1e-38, den, 1e-38))

    p_values = [None] * (k + 1)
    p_values[s] = p_s
    for i in range(s, k):
        p_values[i + 1] = p_values[i] * ratios[i]
    for i in range(s - 1, -1, -1):
        p_values[i] = p_values[i + 1] / jnp.where(
            jnp.abs(ratios[i]) > 1e-38, ratios[i], 1e-38
        )

    for i in range(k):
        p_values[i] = jnp.where(v[i][3], 0.0, p_values[i])
        p_values[i + 1] = jnp.where(v[i][3], 0.0, p_values[i + 1])
    p_values[k] = jnp.zeros_like(p_s)

    total = p_values[0]
    for i in range(1, k + 1):
        total = total + p_values[i]

    ok = (p_values[s] > 0.0) & (total > 0.0)
    w = jnp.where(ok, p_values[s] / jnp.where(total > 0.0, total, 1.0), 0.0)
    return w, p_s, ok


def _mis_weight(t, s, CV, LV, cv, lv, mat, cv_synthetic=None):
    """Balance-heuristic weight for strategy (t, s)
    (trace.metal:693-776).

    Path vertices are indexed from the light end: x_i = light[i] for i < s,
    x_i = camera[t+s-1-i] otherwise; for t == 1 the camera vertex is the
    synthetic projected vertex.  Uses each vertex's stored dual importances
    (including the reference's acknowledged stale values for the chain
    endpoints — trace.metal:696-706 keeps them for speed, and so do we, so
    images match).
    Returns (w, p_s, ok).
    """
    k = s + t

    def vertex(i):
        if i < s:
            return _vstatic(LV, i)
        j = t + s - 1 - i
        if t == 1 and j == 0:
            return cv_synthetic if cv_synthetic is not None else cv
        return _vstatic(CV, j)

    vx = [vertex(i) for i in range(k)]

    ratios = []
    for i in range(k):
        if i == 0:
            a, b = vx[0], vx[1]
            num = a["l_importance"]
            den = a["c_importance"] * _geom(a, b)
        elif i == k - 1:
            a, b = vx[k - 1], vx[k - 2]
            num = a["l_importance"] * _geom(a, b)
            den = a["c_importance"]
        else:
            a, b, c = vx[i - 1], vx[i], vx[i + 1]
            num = b["l_importance"] * _geom(a, b)
            den = b["c_importance"] * _geom(b, c)
        ratios.append(num / jnp.where(jnp.abs(den) > 1e-38, den, 1e-38))

    light_tot = jnp.ones_like(cv["tot_importance"]) if s == 0 else lv["tot_importance"]
    p_s = cv["tot_importance"] * light_tot

    p_values = [None] * (k + 1)
    p_values[s] = p_s
    for i in range(s, k):
        p_values[i + 1] = p_values[i] * ratios[i]
    for i in range(s - 1, -1, -1):
        p_values[i] = p_values[i + 1] / jnp.where(
            jnp.abs(ratios[i]) > 1e-38, ratios[i], 1e-38
        )

    # specular vertices cannot be connection endpoints: zero their
    # hypothetical strategies (trace.metal:759-764)
    spec = [jnp.take(mat["type"], v["material"], axis=0) > 0 for v in vx]
    for i in range(k):
        p_values[i] = jnp.where(spec[i], 0.0, p_values[i])
        p_values[i + 1] = jnp.where(spec[i], 0.0, p_values[i + 1])
    p_values[k] = jnp.zeros_like(p_s)  # trace.metal:766

    total = p_values[0]
    for i in range(1, k + 1):
        total = total + p_values[i]

    ok = (p_values[s] > 0.0) & (total > 0.0)
    w = jnp.where(ok, p_values[s] / jnp.where(total > 0.0, total, 1.0), 0.0)
    return w, p_s, ok
