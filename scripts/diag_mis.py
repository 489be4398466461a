"""Per-class / per-strategy MIS diagnostic (VERDICT r1 #8 follow-up).

For each transport class k (= number of path vertices t+s), every BDPT
strategy with t+s = k is an unbiased estimator of the SAME class-k
transport integral.  This script renders, at high spp on a small Cornell:

  * uni_k      — the unidirectional (BSDF-sampled) class-k image, from the
                 camera path's first light hit at vertex index k-1;
  * unw(t,s)   — each strategy's UNWEIGHTED estimate (w := 1);
  * w(t,s)     — each strategy's weighted estimate and its weight image.

Checks printed per class:
  1. unbiasedness: mean(unw(t,s)) vs mean(uni_k) for every strategy —
     a deviation here is an estimator bug in that strategy, not MIS;
  2. partition: sum_t,s mean(w(t,s)) vs mean(uni_k) — a deviation here
     with all strategies unbiased is a weight (partition-of-unity) bug.

Usage: python scripts/diag_mis.py [spp] [size] [classes...]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import clive2 as c2
from clive2.constants import MAX_BOUNCES
from clive2.integrator.connect import connect_paths
from clive2.integrator.render import render_sample  # noqa: F401
from clive2.integrator import trace as T


def per_class_uni(path, k, height, width):
    """Class-k unidirectional image: ANY light hit at vertex index k-1
    (not just the first — BDPT covers paths whose intermediate vertices
    also lie on the emitter)."""
    d = k - 1
    hit_light = path["vertices"]["hit_light"][d]
    valid = path["valid"][d]
    sel = valid & (hit_light >= 0)
    prior_color = (
        path["vertices"]["color"][d - 1] if d >= 1
        else jnp.ones_like(path["vertices"]["color"][0])
    )
    tot = path["vertices"]["tot_importance"][d]
    out = prior_color / jnp.maximum(tot, 1e-30)[:, None]
    return jnp.where(sel[:, None], out, 0.0).reshape(height, width, 3)


def one_sample(key, scene_data, width, height):
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
    )
    light_path = dict(
        vertices=half(path["vertices"], slice(n, 2 * n)),
        valid=path["valid"][:, n:], length=path["length"][n:],
    )
    conn = connect_paths(cam_path, light_path, scene_data, width, height,
                         debug_per_strategy=True)
    unis = {
        k: per_class_uni(cam_path, k, height, width)
        for k in range(2, MAX_BOUNCES + 1)  # class k needs vertex k-1 <= D-1
    }
    return conn["per_strategy"], unis


def main():
    spp = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    size = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    width = height = size
    scene = c2.create_scene_from_preset("empty", pixel_width=width,
                                        pixel_height=height)
    key = jax.random.key(7)

    step = jax.jit(lambda k: one_sample(k, scene.data, width, height))
    acc_ps, acc_uni = None, None
    for i in range(spp):
        ps, unis = step(jax.random.fold_in(key, i))
        if acc_ps is None:
            acc_ps = jax.tree.map(lambda a: a, ps)
            acc_uni = unis
        else:
            acc_ps = jax.tree.map(lambda a, b: a + b, acc_ps, ps)
            acc_uni = jax.tree.map(lambda a, b: a + b, acc_uni, unis)
    acc_ps = jax.tree.map(lambda a: np.asarray(a) / spp, acc_ps)
    acc_uni = jax.tree.map(lambda a: np.asarray(a) / spp, acc_uni)

    classes = sorted({t + s for (t, s) in acc_ps})
    print(f"spp={spp} size={size}x{size}")
    for k in classes:
        uni_mean = acc_uni.get(k, np.zeros(1)).mean()
        strategies = sorted([ts for ts in acc_ps if sum(ts) == k])
        print(f"\n== class k={k} (uni mean {uni_mean:.6g}) ==")
        tot_weighted = 0.0
        for (t, s) in strategies:
            d = acc_ps[(t, s)]
            mu, mw = d["unweighted"].mean(), d["weighted"].mean()
            tot_weighted += mw
            ratio = mu / uni_mean if uni_mean > 0 else float("nan")
            print(f"  (t={t},s={s}): unweighted {mu:.6g} ({ratio:6.3f}x uni)"
                  f"  weighted {mw:.6g}  wmean {d['weight'].mean():.4f}")
        if uni_mean > 0:
            print(f"  SUM weighted {tot_weighted:.6g} "
                  f"({tot_weighted / uni_mean:6.3f}x uni)")


if __name__ == "__main__":
    main()
