"""Smoke test of the whole render path on one NVIDIA GPU, at real sizes.

    python chip_smoke.py                # one card, every phase below
    python chip_smoke.py --four-cards   # only the 4-card pixel-tile phase

Everything runs in this one process (a second JAX process on the card
would fail for want of memory); the CLIs are called in-process.  Phases:

  1. device      GPU required; card name and power limit, JAX version,
                 compile-cache directory, native BVH builder status
  2. assets      procedural scene assets (scripts/make_assets.py)
  3. traversal   the kept BVH traversal against the unpacked oracle
                 ``intersect_bvh`` on real wavefronts of dragon and
                 big-dragon at 512x512 (primary, depth-2 extension and
                 connection shadow rays), plus kernel-vs-walk timings
  4. oracles     strict per-block convergence, white and glass furnaces,
                 glass convergence through the BVH path (the tests' own
                 helpers and tolerances)
  5. main path   render CLI at its defaults (teapots 1280x720, 15 spp),
                 sponza at 1920x1080 for 2 samples through Renderer, the
                 movie CLI (dragon 1280x720, 3 frames at 2 spp)
  6. checkpoint  save, load, one more sample on both, compare

Every number is printed on its own line with the card beside it; the last
line is one JSON object, {"ok": true, "device": {...}}, printed only when
every phase passed.  Exits nonzero when JAX finds no GPU, when run outside
the repository, or when any phase failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# acceptance limits for the traversal against the oracle: ids may differ
# on near-ties through shared edges (FMA contraction differs between the
# kernel and XLA), t must agree where the ids do
MAX_ID_MISMATCH = 1e-4
MAX_REL_DT = 1e-5
MIN_OCCLUSION_AGREEMENT = 0.9999
# 4-card vs 1-card frame (the phase also checks the sharded traversal on a
# wavefront that does not divide by 4, which must match exactly).  The two are different compiled programs: XLA
# fuses (and contracts multiply-adds) differently around the sharded
# wavefront, and the splat scatter-add and its all-reduce sum in another
# order.  Last-bit differences in a ray are amplified by the glass
# dragon's specular chains into a different path for a few rays, which
# moves whole pixels.  So: most pixel values agree to FOUR_CARD_RTOL, the
# frame means agree to FOUR_CARD_MEAN_RTOL, and the ray counts to
# FOUR_CARD_RAYS_RTOL.
FOUR_CARD_RTOL = 1e-4
FOUR_CARD_MAX_OFF = 0.01          # fraction of values outside FOUR_CARD_RTOL
FOUR_CARD_MEAN_RTOL = 1e-3
FOUR_CARD_RAYS_RTOL = 1e-5


def card_line() -> str:
    """nvidia-smi's name and power limit of the card(s)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return r.stdout.strip().replace("\n", "; ") or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def result_line(ok: bool, devices, extra=None) -> str:
    """The JSON object the script prints last."""
    rec = {"ok": ok, "device": {"platform": devices[0].platform,
                                "kind": devices[0].device_kind,
                                "count": len(devices)}}
    rec.update(extra or {})
    return json.dumps(rec)


def compare_hits(oracle, got, active, any_hit=False):
    """Agreement of a traversal with the oracle on the active lanes.

    Closest hit: the fraction of lanes whose triangle ids differ, and the
    largest relative |dt| where ids agree on a hit.  Any hit: the fraction
    of lanes whose occluded / clear verdict agrees."""
    import numpy as np

    oi, ot = (np.asarray(x) for x in oracle[:2])
    gi, gt = (np.asarray(x) for x in got[:2])
    act = np.asarray(active)
    n = max(int(act.sum()), 1)
    if any_hit:
        agree = ((gi >= 0) == (oi >= 0)) & act
        return {"occlusion_agreement": float(agree.sum()) / n}
    same = (gi == oi) & act
    hit = same & (oi >= 0)
    rel = (np.abs(gt[hit] - ot[hit]) / np.maximum(np.abs(ot[hit]), 1e-30))
    return {"id_mismatch": float(n - same.sum()) / n,
            "max_rel_dt": float(rel.max()) if rel.size else 0.0,
            "hit_fraction": float(hit.sum()) / n}


class Smoke:
    def __init__(self, card):
        self.card = card
        self.failed = []

    def say(self, what, **numbers):
        print(json.dumps({"phase": what, **numbers, "card": self.card}),
              flush=True)

    def phase(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            fn(*args)
        except Exception:
            traceback.print_exc()
            self.failed.append(name)
            self.say(name, status="FAILED",
                     seconds=time.perf_counter() - t0)
            return
        self.say(name, status="passed", seconds=time.perf_counter() - t0)


# ---- phases ----------------------------------------------------------------

def phase_device(s):
    import jax

    from clive2.bvh import native

    native.available()
    s.say("device", jax=jax.__version__,
          kind=jax.devices()[0].device_kind, count=len(jax.devices()),
          compile_cache=jax.config.jax_compilation_cache_dir,
          native_bvh=native.STATUS)
    if not native.STATUS.startswith(("built", "loaded")):
        raise RuntimeError(f"native BVH builder: {native.STATUS}")


def phase_assets(s):
    from clive2.scene import RESOURCE_DIR

    need = ["teapot.obj", "dragon_vrip_res3.ply", "dragon_vrip.ply",
            "sponza_scale.ply"]
    if all(os.path.exists(os.path.join(RESOURCE_DIR, n)) for n in need):
        s.say("assets", present=True)
        return
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import make_assets

    t0 = time.perf_counter()
    make_assets.main()
    s.say("assets", generated_s=time.perf_counter() - t0)


def _wavefronts(scene, w, h):
    """Primary, depth-2 extension and connection shadow rays of one real
    BDPT sample: (name, origin, direction, active, t_max) tuples."""
    import jax
    import jax.numpy as jnp

    from clive2.integrator import trace as T
    from clive2.ops.sampling import normalize

    data = scene.data
    k_cam, k_light, k_trace = jax.random.split(jax.random.key(3), 3)

    @jax.jit
    def paths(data):
        cam, _ = T.generate_camera_rays(k_cam, data["camera"], w, h)
        light = T.generate_light_rays(k_light, data["lights"], data["mat"],
                                      w * h)
        merged = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), cam,
                              light)
        fc = jnp.arange(2 * w * h) < w * h
        p = T.trace_subpaths(k_trace, merged, data, from_camera=fc)
        return cam, p

    cam, p = paths(data)
    n = w * h
    inf = jnp.full((n,), jnp.inf)
    v = p["vertices"]
    ext = (v["origin"][2], v["direction"][2], p["valid"][2],
           jnp.full((2 * n,), jnp.inf))
    lo, co = v["origin"][1, n:], v["origin"][1, :n]
    delta = co - lo
    dist = jnp.sqrt(jnp.sum(delta * delta, axis=-1))
    shadow = (lo, normalize(delta), p["valid"][1, n:] & p["valid"][1, :n],
              dist * (1.0 - 1e-3))
    return [("primary", cam["origin"], cam["direction"],
             jnp.ones((n,), bool), inf),
            ("extension_d2", *ext), ("shadow", *shadow)]


def _time(fn, args, reps=3):
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def phase_traversal(s):
    import jax

    import clive2 as c2
    from clive2.ops.intersect import (
        intersect_bvh, intersect_bvh_packed, traverse_bvh, unpack_gather_walk)
    from clive2.ops.walk_kernel import intersect_bvh_kernel

    bad = []
    for name in ("dragon", "big-dragon"):
        scene = c2.create_scene_from_preset(name, pixel_width=512,
                                            pixel_height=512)
        bvh = scene.data["bvh"]
        oracle_fn = jax.jit(intersect_bvh)
        oracle_bvh = unpack_gather_walk(bvh)
        kept = jax.jit(traverse_bvh, static_argnames="any_hit")
        impls = {"kernel": intersect_bvh_kernel,
                 "walk": jax.jit(intersect_bvh_packed)}
        for ray_set, o, d, act, tmax in _wavefronts(scene, 512, 512):
            ref = oracle_fn(o, d, oracle_bvh, active=act, t_max=tmax)
            got = compare_hits(ref, kept(o, d, bvh, act, tmax), act)
            got.update(compare_hits(ref, kept(o, d, bvh, act, tmax,
                                              any_hit=True), act,
                                    any_hit=True))
            times = {f"{impl}_mrays_s": int(act.sum()) / _time(
                fn, (o, d, bvh, act, tmax)) / 1e6
                for impl, fn in impls.items()}
            s.say("traversal", scene=name, rays=ray_set,
                  active=int(act.sum()), **got, **times)
            if (got["id_mismatch"] > MAX_ID_MISMATCH
                    or got["max_rel_dt"] > MAX_REL_DT
                    or got["occlusion_agreement"] < MIN_OCCLUSION_AGREEMENT):
                bad.append(f"{name}/{ray_set}")
    if bad:
        raise AssertionError(f"traversal outside limits on {bad}")


def phase_oracles(s):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_convergence
    import test_convergence_glass
    import test_furnace

    images = test_convergence.oracle_images()
    test_convergence.check_strict(images)
    s.say("oracle_convergence_strict", spp=test_convergence.SPP)

    means = test_furnace.furnace_class_means()
    assert means[0] == 0 and means[1] > 0
    test_furnace.check_class_ratios(means)
    test_furnace.check_glass_furnace(test_furnace.render_glass_furnace())
    s.say("oracle_furnace", class_means=[float(m) for m in means])

    scene = test_convergence_glass.glass_scene(subdivisions=3)
    assert "bvh" in scene.data and "brute" not in scene.data
    test_convergence_glass.check_glass(
        test_convergence_glass.oracle_images(scene))
    s.say("oracle_glass_bvh", tris=scene.n_triangles,
          spp=test_convergence_glass.SPP)


def _measure(s, label, scene, samples):
    """Compile + timed samples through Renderer; returns the renderer."""
    import jax
    import numpy as np

    import clive2 as c2

    r = c2.Renderer(scene, seed=0)
    t0 = time.perf_counter()
    r.run_sample()
    r.block()
    first = time.perf_counter() - t0
    rays0 = r.rays_traced
    t0 = time.perf_counter()
    for _ in range(samples - 1):
        r.run_sample()
    r.block()
    steady = (time.perf_counter() - t0) / max(samples - 1, 1)
    rays = (r.rays_traced - rays0) / max(samples - 1, 1)
    nan = sum(int(np.isnan(np.asarray(r.state[k])).sum()) for k in (
        "summed_image", "summed_weight", "summed_unidirectional"))
    stats = jax.devices()[0].memory_stats() or {}
    s.say(label, resolution=f"{scene.pixel_width}x{scene.pixel_height}",
          tris=scene.n_triangles, chunk_rows=r.chunk_rows,
          compile_and_first_sample_s=first, steady_s_per_sample=steady,
          mrays_s=rays / steady / 1e6, rays_per_sample=rays,
          peak_bytes_in_use=stats.get("peak_bytes_in_use"), nan=nan)
    if nan:
        raise AssertionError(f"{label}: {nan} NaNs")
    return r


def phase_main_path(s, state):
    import clive2 as c2
    from clive2.apps import movie, render

    teapots = c2.create_scene_from_preset("teapots", 1280, 720)
    state["teapots"] = _measure(s, "teapots_720p", teapots, 4)
    t0 = time.perf_counter()
    render.main(["--display", "off", "--output-dir",
                 os.path.join(OUT, "render_cli")])
    s.say("render_cli_defaults", seconds=time.perf_counter() - t0)

    sponza = c2.create_scene_from_preset("sponza", 1920, 1080)
    r = _measure(s, "sponza_1080p", sponza, 2)
    render.save_png(os.path.join(OUT, "sponza_1080p_2spp.png"), r.image)
    del r

    dragon = c2.create_scene_from_preset_with_params(
        "dragon", 1280, 720, frame_idx=0, total_frames=3)
    _measure(s, "dragon_720p", dragon, 2)
    t0 = time.perf_counter()
    movie.main(["--scene", "dragon", "--movie-frames", "3", "--samples",
                "2", "--display", "off", "--output-dir", OUT])
    s.say("movie_cli", frames=3, spp=2, seconds=time.perf_counter() - t0)
    pngs = sorted(os.listdir(os.path.join(OUT, "test-movie")))
    if len(pngs) != 3:
        raise AssertionError(f"movie wrote {pngs}")


def phase_checkpoint(s, state):
    import numpy as np

    import clive2 as c2

    a = state["teapots"]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        a.save_checkpoint(path)
        b = c2.Renderer(a.scene, seed=123)
        b.load_checkpoint(path)
    a.run_sample()
    b.run_sample()
    diffs = {k: float(np.max(np.abs(np.asarray(a.state[k])
                                    - np.asarray(b.state[k]))))
             for k in ("summed_image", "summed_weight",
                       "summed_unidirectional")}
    identical = all(v == 0.0 for v in diffs.values())
    s.say("checkpoint", samples=a.samples, bit_identical=identical,
          max_abs_diff=diffs)
    for k in diffs:
        np.testing.assert_allclose(np.asarray(b.state[k]),
                                   np.asarray(a.state[k]), rtol=1e-5,
                                   atol=1e-6)


def _uneven_sharded_walk(s, scene, mesh, w=1281, h=721):
    """The traversal over the 4-card mesh on a wavefront whose length does
    not divide by 4 (w*h primary rays) against the one-card kernel.  The
    sharded walk pads with inactive rays, and rays are independent, so the
    answers must be the same bit for bit."""
    import jax
    import numpy as np

    from clive2.integrator import trace as T
    from clive2.ops.intersect import traverse_bvh
    from clive2.ops.walk_kernel import intersect_bvh_kernel

    n = w * h
    cam, _ = jax.jit(lambda k, c: T.generate_camera_rays(k, c, w, h))(
        jax.random.key(5), scene.data["camera"])
    o, d = cam["origin"], cam["direction"]
    act = jax.random.uniform(jax.random.key(6), (n,)) < 0.9
    tmax = jax.random.uniform(jax.random.key(7), (n,), minval=0.5,
                              maxval=20.0)
    bvh = scene.data["bvh"]
    for any_hit in (False, True):
        sharded = jax.jit(lambda o, d, b, a, t: traverse_bvh(
            o, d, b, a, t, any_hit=any_hit, mesh=mesh))
        got = sharded(o, d, bvh, act, tmax)
        want = intersect_bvh_kernel(o, d, bvh, act, tmax, any_hit=any_hit)
        differ = sum(int(np.sum(np.asarray(g) != np.asarray(x)))
                     for g, x in zip(got, want))
        s.say("four_cards_uneven_walk", rays=n, rays_mod_4=n % 4,
              any_hit=any_hit, values_differ=differ)
        if differ:
            raise AssertionError(f"sharded walk on {n} rays differs from "
                                 f"the one-card kernel in {differ} values")


def phase_four_cards(s):
    import jax
    import numpy as np

    import clive2 as c2
    from clive2.parallel.mesh import make_tile_mesh

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found "
                           f"{len(jax.devices())}")
    scene = c2.create_scene_from_preset("dragon", 1920, 1080)
    runs, rays = {}, {}
    for label, mesh in (("four", make_tile_mesh(4)), ("one", None)):
        r = c2.Renderer(scene, seed=7, mesh=mesh)
        t0 = time.perf_counter()
        r.run_sample()
        r.block()
        first = time.perf_counter() - t0
        rays[label] = r.rays_traced
        runs[label] = {k: np.asarray(v) for k, v in r.state.items()}
        t0 = time.perf_counter()
        r.run_sample()
        r.block()
        second = time.perf_counter() - t0
        s.say("four_cards_run", cards=4 if mesh else 1,
              compile_and_first_sample_s=first, second_sample_s=second,
              mrays_s=(r.rays_traced - rays[label]) / second / 1e6,
              rays_first_sample=rays[label])
    off, means = {}, {}
    for k in ("summed_image", "summed_weight", "summed_unidirectional"):
        a, b = runs["four"][k], runs["one"][k]
        off[k] = float(np.mean(np.abs(a - b) > FOUR_CARD_RTOL * np.abs(b)
                               + 1e-6))
        means[k] = float(abs(a.mean() - b.mean()) / max(abs(b.mean()),
                                                       1e-30))
    ray_rel = abs(rays["four"] - rays["one"]) / rays["one"]
    s.say("four_cards_compare", values_off=off, mean_rel_diff=means,
          rays_rel_diff=ray_rel, rtol=FOUR_CARD_RTOL,
          max_off=FOUR_CARD_MAX_OFF, mean_rtol=FOUR_CARD_MEAN_RTOL,
          rays_rtol=FOUR_CARD_RAYS_RTOL)
    if (max(off.values()) > FOUR_CARD_MAX_OFF
            or max(means.values()) > FOUR_CARD_MEAN_RTOL
            or ray_rel > FOUR_CARD_RAYS_RTOL):
        raise AssertionError("4-card frame differs from the 1-card frame")
    _uneven_sharded_walk(s, scene, make_tile_mesh(4))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card pixel-tile phase")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "clive2")):
        print(f"chip_smoke: the clive2 package is not beside {__file__}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX platform is "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    os.makedirs(OUT, exist_ok=True)
    os.chdir(ROOT)
    card = card_line()
    print(f"card: {card}", flush=True)
    s = Smoke(card)
    s.phase("device", phase_device, s)
    s.phase("assets", phase_assets, s)
    if args.four_cards:
        s.phase("four_cards", phase_four_cards, s)
    else:
        state = {}
        s.phase("traversal", phase_traversal, s)
        s.phase("oracles", phase_oracles, s)
        s.phase("main_path", phase_main_path, s, state)
        if "teapots" in state:
            s.phase("checkpoint", phase_checkpoint, s, state)
        else:
            s.failed.append("checkpoint")
    s.say("total", seconds=time.perf_counter() - t_start, failed=s.failed)
    print(f"card: {card}", flush=True)
    if s.failed:
        print(result_line(False, devices, {"failed": s.failed}), flush=True)
        return 1
    print(result_line(True, devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
