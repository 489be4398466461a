"""Per-stage wall-clock breakdown of one BDPT sample on a real preset.

Times nested prefixes of the pipeline as separate jitted programs
(trace -> +casts -> +full connect -> full sample) and reports the deltas,
plus per-stage ray counts, so optimization effort lands where the time is.

Usage: python scripts/profile_stages.py [preset] [size] [reps]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import clive2 as c2
from clive2.constants import MAX_BOUNCES
from clive2.integrator import trace as T
from clive2.integrator.connect import (
    connection_pairs, connect_paths, precompute_mis,
)
from clive2.integrator.render import render_sample
from clive2.ops.intersect import intersect_scene
from clive2.ops.sampling import dot, normalize
from clive2.constants import DELTA


def subpaths(key, scene_data, width, height):
    cam = scene_data["camera"]
    k_cam, k_light, k_trace = jax.random.split(key, 3)
    cam_rays, _ = T.generate_camera_rays(k_cam, cam, width, height)
    light_rays = T.generate_light_rays(
        k_light, scene_data["lights"], scene_data["mat"], width * height
    )
    n = width * height
    merged = jax.tree.map(
        lambda a, b: jnp.concatenate([a, b], axis=0), cam_rays, light_rays
    )
    fc = jnp.concatenate([jnp.ones((n,), bool), jnp.zeros((n,), bool)])
    path = T.trace_subpaths(k_trace, merged, scene_data, from_camera=fc)
    half = lambda tree, sl: jax.tree.map(lambda a: a[:, sl], tree)
    cam_path = dict(
        vertices=half(path["vertices"], slice(0, n)),
        valid=path["valid"][:, :n], length=path["length"][:n],
        n_rays=path["n_rays"],
    )
    light_path = dict(
        vertices=half(path["vertices"], slice(n, 2 * n)),
        valid=path["valid"][:, n:], length=path["length"][n:],
        n_rays=jnp.int32(0),
    )
    return cam_path, light_path


def casts_only(cam_path, light_path, scene, width, height):
    """Stage A of connect_paths, verbatim."""
    CV, cam_len = cam_path["vertices"], cam_path["length"]
    LV, light_len = light_path["vertices"], light_path["length"]
    mat = scene["mat"]
    cam = scene["camera"]
    pairs = connection_pairs(MAX_BOUNCES)
    pair_arr = jnp.asarray(pairs, dtype=jnp.int32)
    take_d = lambda tree, d: jax.tree.map(
        lambda a: jnp.take(a, d, axis=0), tree)

    def cast(pair):
        t, s = pair[0], pair[1]
        lv = take_d(LV, s - 1)
        cv = take_d(CV, t - 1)
        lens_ok = (t <= cam_len) & (s <= light_len)
        l_spec = jnp.take(mat["type"], lv["material"], axis=0) > 0
        c_spec = jnp.take(mat["type"], cv["material"], axis=0) > 0
        proj_dir = normalize(cam["focal_point"][None, :] - lv["origin"])
        t1_ok = ~l_spec & (dot(proj_dir, cam["direction"][None, :]) <= 0.0)
        dir_l_to_c = normalize(cv["origin"] - lv["origin"])
        gen_ok = (~l_spec & ~c_spec
                  & (dot(lv["normal"], dir_l_to_c) >= DELTA)
                  & (dot(cv["normal"], -dir_l_to_c) >= DELTA))
        is_t1 = t == 1
        active = lens_ok & jnp.where(is_t1, t1_ok, gen_ok)
        direction = jnp.where(is_t1, proj_dir, dir_l_to_c)
        delta = cv["origin"] - lv["origin"]
        d_gen = jnp.sqrt(jnp.maximum(dot(delta, delta), 0.0))
        den = dot(proj_dir, cam["direction"][None, :])
        num = dot(cam["center"][None, :] - lv["origin"],
                  cam["direction"][None, :])
        d_t1 = jnp.where(den < -1e-12, num / den, jnp.inf)
        # mirror production stage A: any-hit casts capped below the
        # target (see integrator/connect.py)
        t_max = jnp.where(is_t1, d_t1, d_gen) * (1.0 - 1e-3)
        hit_i, hit_t, _, _ = intersect_scene(
            lv["origin"], direction, scene, active=active,
            t_max=t_max, any_hit=True)
        return hit_i, hit_t, active

    return jax.lax.map(cast, pair_arr)


def timeit(fn, args, reps, name, counts=None):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    extra = ""
    if counts is not None:
        extra = f"  ({counts / dt / 1e6:8.2f} Mrays/s for its rays)"
    print(f"{name:28s} {dt * 1e3:9.2f} ms{extra}")
    return dt, out


def main():
    preset = sys.argv[1] if len(sys.argv) > 1 else "teapots"
    size = int(sys.argv[2]) if len(sys.argv) > 2 else 512
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    width = height = size
    scene = c2.create_scene_from_preset(preset, pixel_width=width,
                                        pixel_height=height)
    key = jax.random.key(0)
    n = width * height

    f_trace = jax.jit(lambda k: subpaths(k, scene.data, width, height))
    f_casts = jax.jit(
        lambda k: casts_only(*subpaths(k, scene.data, width, height),
                             scene.data, width, height))
    f_connect = jax.jit(
        lambda k: connect_paths(*subpaths(k, scene.data, width, height),
                                scene.data, width, height))
    f_full = jax.jit(
        lambda k: render_sample(k, scene.data, width, height))

    print(f"preset={preset} {size}x{size}  n={n} rays/wavefront")
    d_tr, path = timeit(f_trace, (key,), reps, "trace_subpaths",
                        counts=int(path_rays := np.asarray(
                            jax.jit(lambda k: subpaths(
                                k, scene.data, width, height
                            )[0]["n_rays"])(key))))
    d_ca, casts = timeit(f_casts, (key,), reps, "trace + casts")
    cast_rays = int(np.asarray(jnp.sum(casts[2].astype(jnp.int32))))
    print(f"{'':28s} casts delta {1e3*(d_ca-d_tr):9.2f} ms  "
          f"({cast_rays/1e6:.2f}M active cast rays -> "
          f"{cast_rays/(d_ca-d_tr)/1e6:.2f} Mrays/s)")
    d_cn, _ = timeit(f_connect, (key,), reps, "trace + full connect")
    print(f"{'':28s} MIS+contrib delta {1e3*(d_cn-d_ca):9.2f} ms")
    d_f, out = timeit(f_full, (key,), reps, "full render_sample")
    print(f"{'':28s} filter+rest delta {1e3*(d_f-d_cn):9.2f} ms")
    total_rays = int(np.asarray(out["n_rays"]))
    print(f"total rays/sample {total_rays/1e6:.2f}M -> "
          f"{total_rays/d_f/1e6:.2f} Mrays/s end-to-end")


if __name__ == "__main__":
    main()
