"""Benchmark: sustained BDPT throughput on one GPU, per BASELINE config.

Prints one JSON line per config: {"metric", "value", "unit", "spp_per_s",
"resolution", "samples", "phases", "platform", "device_kind",
"device_count"}.  Config order:

  canary_64      64x64 mesh scene (teapots preset), 2 spp — runs FIRST;
                 if this can't finish inside its budget every later row
                 is stamped {"canary": "failed"} so a systemic hang is
                 diagnosed once instead of guessed at per row
  headline       1080p Cornell Mrays/s
  cornell_256    Cornell-box diffuse, 256x256, 16 spp (config #1)
  teapots_512    two exact Utah teapots, GGX glass, 512x512 (config #2)
  dragon_512     glass dragon (47.7k tris), 512x512 (config #3)
  medium_dragon  202k-tri glass dragon, 512x512
  big_dragon     871k-tri glass dragon, 512x512
  sponza_1080p   ~1.3M-triangle scene at 1080p (config #4)
  movie_720p     per-frame orbit animation steady-state s/frame (config #5)

Mrays/s counts every BVH traversal actually performed (subpath extension
casts + BDPT visibility/projection casts).  The reference publishes no
numbers (BASELINE.md).

The bench measures the GPU only: the probe refuses any other platform
(error rows, nonzero exit).  Self-diagnosis:
  * each config's child process emits {"phase": ...} JSON marks at every
    stage boundary (scene build / warmup / per-sample), so a timeout row
    says WHERE the time went;
  * a provisional row (marked "provisional": true) is emitted after the
    first measured sample and refreshed at most every 15 s — a later
    hang still leaves a number;
  * the parent captures child output and, on timeout, recovers the last
    provisional row as the config's result ("partial": true);
  * the run ends with ONE summary line re-emitting every row, so tail
    truncation cannot lose the early rows;
  * no per-sample scalar readbacks: n_rays is read back once after the
    timed loop.

Each config runs in its own subprocess (one at a time, so one process
holds the card) under a wall-clock budget; on timeout or fault the parent
emits a diagnostic row.  Configs that finish early donate unspent budget
to later configs ("surplus rolling").

Env overrides: BENCH_CONFIGS (comma list of names above),
BENCH_WIDTH/BENCH_HEIGHT/BENCH_SAMPLES/BENCH_SCENE for the headline,
BENCH_TIME_BUDGET (scale factor on the per-config budgets, default 1.0),
BENCH_BUDGET_OVERRIDE (absolute seconds for a single config, set by the
parent process when surplus rolling is in effect).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# per-config wall budgets (seconds), scaled by BENCH_TIME_BUDGET; each
# absorbs a cold compile
BUDGETS = {
    "canary_64": 280,
    "headline": 400,
    "cornell_256": 280,
    "teapots_512": 320,
    "dragon_512": 420,
    "medium_dragon": 450,
    "big_dragon": 540,
    "sponza_1080p": 480,
    "movie_720p": 300,
}
DEFAULT_CONFIGS = ",".join(BUDGETS)

PROVISIONAL_EVERY_S = 15.0


def _ensure_assets():
    res = os.environ.get(
        "CLIVE2_RESOURCES",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "resources"),
    )
    needed = ["teapot.obj", "dragon_vrip_res3.ply", "dragon_vrip_res2.ply",
              "dragon_vrip.ply", "sponza_scale.ply"]
    if not all(os.path.exists(os.path.join(res, n)) for n in needed):
        subprocess.run(
            [sys.executable,
             os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "scripts", "make_assets.py")],
            check=True,
        )


class _Phases:
    """Phase-boundary marks: JSON lines to stdout + accumulated durations
    folded into the final row (VERDICT r3 next-round #1b)."""

    def __init__(self, metric):
        self.metric = metric
        self.t0 = time.perf_counter()
        self.last = self.t0
        self.durations = {}

    def mark(self, name):
        now = time.perf_counter()
        self.durations[name] = round(now - self.last, 2)
        self.last = now
        print(json.dumps({"metric": self.metric, "phase": name,
                          "t": round(now - self.t0, 2)}), flush=True)


def device_info():
    """platform / device_kind / device_count of this process's JAX."""
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "device_kind": d[0].device_kind,
            "device_count": len(d)}


def bench_render(preset, width, height, samples, metric,
                 chunk_rows=None, max_stripes=None, deadline=None,
                 flight=2):
    """Render ``samples`` full frames (or, chunked, up to ``max_stripes``
    row stripes per sample) and report sustained Mrays/s.  ``deadline``
    (time.monotonic value) stops measurement early but still reports —
    a partial measurement beats a missing row."""
    import jax
    import jax.numpy as jnp

    import clive2 as c2
    from clive2.integrator.render import render_sample

    ph = _Phases(metric)
    scene = c2.create_scene_from_preset(preset, pixel_width=width,
                                        pixel_height=height)
    ph.mark("scene_build")
    key = jax.random.key(0)

    if chunk_rows:
        @jax.jit
        def stripe(key, i, row0, scene_data):
            k = jax.random.fold_in(jax.random.fold_in(key, i), row0)
            return render_sample(k, scene_data, width, height,
                                 row0=row0, rows=chunk_rows)

        row_starts = list(range(0, height, chunk_rows))
        if max_stripes:
            row_starts = row_starts[:max_stripes]


        def step(key, i, scene_data):
            outs = None
            for r in row_starts:
                o = stripe(key, jnp.uint32(i), jnp.int32(r), scene_data)
                outs = o if outs is None else jax.tree.map(
                    lambda a, b: a + b, outs, o)
            return outs
    else:
        @jax.jit
        def step(key, i, scene_data):
            return render_sample(
                jax.random.fold_in(key, jnp.uint32(i)), scene_data,
                width, height
            )


    out = step(key, 0, scene.data)               # compile + warmup
    jax.block_until_ready(out)
    # rays/sample for provisional estimates — the ONE pre-loop scalar
    # readback
    rays_per_sample = int(out["n_rays"])
    ph.mark("warmup")

    frac = (len(row_starts) * chunk_rows / height) if chunk_rows else 1.0

    def row(mrays, done, dt, provisional=False):
        rec = {
            "metric": metric,
            "value": round(mrays, 2),
            "unit": "Mrays/s",
            "spp_per_s": round(done * frac / dt, 3) if dt > 0 else None,
            "resolution": f"{width}x{height}",
            "samples": done,
            **device_info(),
        }
        if frac < 1.0:
            rec["frame_fraction"] = round(frac, 4)
        if provisional:
            rec["provisional"] = True
        else:
            rec["phases"] = ph.durations
        return rec

    # measured loop: flight-of-N pipeline (overlaps dispatch with
    # compute), no per-sample readbacks, deadline checked on each
    # completion, provisional row after the first sample then every 15 s.
    t0 = time.perf_counter()
    nrays_dev = []
    done = 0
    pending = []
    last_prov = 0.0

    def complete(o):
        nonlocal done, last_prov
        jax.block_until_ready(o)
        done += 1
        el = time.perf_counter() - t0
        if done == 1 or el - last_prov > PROVISIONAL_EVERY_S:
            last_prov = el
            print(json.dumps(row(rays_per_sample * done / el / 1e6, done,
                                 el, provisional=True)), flush=True)

    stop = False
    for i in range(1, samples + 1):
        o = step(key, i, scene.data)
        nrays_dev.append(o["n_rays"])
        pending.append(o)
        if len(pending) >= flight:
            complete(pending.pop(0))
            if deadline is not None and time.monotonic() > deadline:
                stop = True
                break
    for o in pending if not stop else pending[:0]:
        complete(o)
    dt = time.perf_counter() - t0
    ph.mark("measure")

    total_rays = sum(int(x) for x in
                     jax.device_get(nrays_dev[:done]))    # one transfer
    ph.mark("readback")
    print(json.dumps(row(total_rays / dt / 1e6, done, dt)), flush=True)


def bench_movie(preset="teapots", width=1280, height=720, frames=3, spp=2):
    """Steady-state seconds/frame for the orbit animation (config #5) on a
    real BVH scene: camera-only update (Scene.with_camera) + cached jit
    across frames — the reference instead rebuilds scene+BVH+kernels per
    frame (reference movie.py:31-38)."""
    import jax
    import jax.numpy as jnp

    import clive2 as c2
    from clive2.integrator.render import render_sample
    from clive2.scene import orbit_camera

    metric = f"movie_s_per_frame_{preset}_{width}x{height}_{spp}spp"
    ph = _Phases(metric)
    scene = c2.create_scene_from_preset_with_params(
        preset, pixel_width=width, pixel_height=height,
        frame_idx=0, total_frames=120,
    )
    ph.mark("scene_build")
    key = jax.random.key(0)

    @jax.jit
    def step(key, i, scene_data):
        return render_sample(jax.random.fold_in(key, i), scene_data,
                             width, height)


    def frame(f):
        sc = scene.with_camera(
            orbit_camera(f, 120, width, height)
        ) if f else scene
        out = None
        for i in range(spp):
            out = step(key, jnp.uint32(f * spp + i), sc.data)
        jax.block_until_ready(out)

    frame(0)                                     # compile + warmup
    ph.mark("warmup")
    t0 = time.perf_counter()
    for f in range(1, frames + 1):
        frame(f)
    dt = (time.perf_counter() - t0) / frames
    ph.mark("measure")

    rec = {
        "metric": metric,
        "value": round(dt, 3),
        "unit": "s/frame",
        "spp_per_s": round(spp / dt, 3),
        "resolution": f"{width}x{height}",
        "samples": spp,
        "phases": ph.durations,
        **device_info(),
    }
    print(json.dumps(rec), flush=True)


def run_config(cfg: str):
    from clive2 import constants

    constants.TIMED_ENABLED = False
    _ensure_assets()

    budget = float(os.environ.get("BENCH_BUDGET_OVERRIDE", "0")) or (
        BUDGETS.get(cfg, 180) * float(
            os.environ.get("BENCH_TIME_BUDGET", "1.0")))
    deadline = time.monotonic() + budget * 0.92   # leave margin to report

    if cfg == "canary_64":
        # smallest real-mesh render: if THIS can't do 2 spp inside a
        # minute, every later mesh row inherits the diagnosis
        bench_render("teapots", 64, 64, 2, "canary_teapots_64x64",
                     deadline=deadline, flight=4)
    elif cfg == "headline":
        width = int(os.environ.get("BENCH_WIDTH", 1920))
        height = int(os.environ.get("BENCH_HEIGHT", 1080))
        samples = int(os.environ.get("BENCH_SAMPLES", 8))
        preset = os.environ.get("BENCH_SCENE", "empty")
        bench_render(preset, width, height, samples,
                     f"bdpt_ray_throughput_{width}x{height}_{preset}",
                     deadline=deadline)
    elif cfg == "cornell_256":
        # short samples: a deeper flight keeps dispatch off the clock
        bench_render("empty", 256, 256, 64, "cornell_256x256",
                     deadline=deadline, flight=4)
    elif cfg == "teapots_512":
        bench_render("teapots", 512, 512, 4, "teapots_ggx_512x512",
                     deadline=deadline)
    elif cfg == "dragon_512":
        bench_render("dragon", 512, 512, 4, "glass_dragon_47k_512x512",
                     deadline=deadline)
    elif cfg == "medium_dragon":
        bench_render("medium-dragon", 512, 512, 4,
                     "glass_dragon_202k_512x512", deadline=deadline)
    elif cfg == "big_dragon":
        bench_render("big-dragon", 512, 512, 4,
                     "glass_dragon_871k_512x512", deadline=deadline)
    elif cfg == "sponza_1080p":
        # a bounded stripe count keeps the row inside the bench budget —
        # Mrays/s is per-ray, so a partial frame measures the same
        # sustained throughput
        bench_render("sponza", 1920, 1080, 2,
                     "sponza_1.3Mtris_1920x1080", chunk_rows=54,
                     max_stripes=int(os.environ.get("BENCH_SPONZA_STRIPES",
                                                    "4")),
                     deadline=deadline)
    elif cfg == "movie_720p":
        bench_movie()
    else:
        raise ValueError(f"unknown bench config {cfg!r}")


def probe_device(probe_timeout=150):
    """Bounded probe of JAX's default backend in a subprocess, so the
    parent never opens the card itself.  Returns device_info() of the
    child, or None when the backend did not come up."""
    code = ("import json, bench; "
            "print('DEVICE', json.dumps(bench.device_info()))")
    try:
        r = subprocess.run([sys.executable, "-c", code],
                           capture_output=True, text=True,
                           timeout=probe_timeout,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
    except subprocess.TimeoutExpired:
        return None
    for line in r.stdout.splitlines():
        if line.startswith("DEVICE "):
            return json.loads(line[len("DEVICE "):])
    return None


def _parse_child_rows(text, cfg):
    """Extract (last_full_row, last_provisional_row, last_phase) from a
    child's captured stdout and echo every line through."""
    last_full = last_prov = None
    last_phase = None
    for line in (text or "").splitlines():
        print(line, flush=True)
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if "phase" in rec:
            last_phase = {"phase": rec.get("phase"), "t": rec.get("t")}
        elif rec.get("provisional"):
            last_prov = rec
        elif "value" in rec:
            last_full = rec
    return last_full, last_prov, last_phase


def main():
    configs = os.environ.get("BENCH_CONFIGS", DEFAULT_CONFIGS).split(",")

    if len(configs) > 1 or not os.environ.get("BENCH_NO_FORK"):
        # each config in its own subprocess: a device fault or overrun in
        # one config must not take down the remaining rows
        dev = probe_device()
        if not dev or dev["platform"] != "gpu":
            found = dev["platform"] if dev else "none (backend init failed)"
            msg = f"bench needs a GPU; JAX platform is {found}"
            print(msg, file=sys.stderr, flush=True)
            for cfg in configs:
                print(json.dumps({
                    "metric": cfg.strip(), "value": None, "unit": "error",
                    "error": msg, **(dev or {}),
                }), flush=True)
            return 1
        _ensure_assets()
        # surplus rolling: configs that finish under budget donate their
        # unspent seconds to later (bigger) configs, so a cold compile on
        # sponza/big_dragon gets the time cornell didn't use — the
        # worst-case TOTAL stays sum(budgets)
        surplus = 0.0
        summary = []
        canary_failed = False
        for cfg in configs:
            cfg = cfg.strip()
            budget = BUDGETS.get(cfg, 180) * float(
                os.environ.get("BENCH_TIME_BUDGET", "1.0")) + surplus
            env = dict(os.environ, BENCH_CONFIGS=cfg, BENCH_NO_FORK="1",
                       BENCH_BUDGET_OVERRIDE=f"{budget:.1f}")
            t_start = time.monotonic()
            out_text, err = "", None
            try:
                r = subprocess.run(
                    [sys.executable, os.path.abspath(__file__)],
                    env=env, timeout=budget, capture_output=True, text=True,
                )
                out_text = r.stdout
                sys.stderr.write(r.stderr or "")
                rc = r.returncode
                err = f"bench subprocess exited {rc}" if rc else None
            except subprocess.TimeoutExpired as e:
                out_text = e.stdout
                if isinstance(out_text, bytes):
                    out_text = out_text.decode("utf-8", "replace")
                se = e.stderr
                if isinstance(se, bytes):
                    se = se.decode("utf-8", "replace")
                sys.stderr.write(se or "")
                err = f"timeout after {budget:.0f}s"
            surplus = max(0.0, budget - (time.monotonic() - t_start))
            full, prov, phase = _parse_child_rows(out_text, cfg)
            if err and full is None:
                # recover the last provisional row (partial measurement
                # beats a bare timeout) and attribute the stall
                rec = dict(prov) if prov else {
                    "metric": cfg, "value": None, **dev,
                }
                # key recovered rows by the CONFIG name like bare-timeout
                # rows (the child's internal metric name would make
                # partial rows invisible to config-keyed log parsers)
                if rec.get("metric") != cfg:
                    rec["child_metric"] = rec.get("metric")
                    rec["metric"] = cfg
                rec["unit"] = ("timeout" if "timeout" in err
                               else rec.get("unit", "error"))
                rec["partial"] = True
                rec["error"] = err
                if phase:
                    rec["last_phase"] = phase
                if canary_failed:
                    rec["canary"] = "failed"
                print(json.dumps(rec), flush=True)
                summary.append(rec)
                if cfg == "canary_64":
                    canary_failed = True
            else:
                rec = (full if full is not None else
                       {"metric": cfg, "value": None, "unit": "no-row"})
                if err:
                    # the child printed a completed row but then exited
                    # nonzero — keep the row, but carry the error so the
                    # summary can't report a crashed subprocess as clean
                    rec = dict(rec)
                    rec["error"] = err
                summary.append(rec)
        # one final line re-emitting every row: tail truncation of the
        # output can no longer lose the early rows
        print(json.dumps({"metric": "bench_summary", **dev, "rows": [
            {k: r.get(k) for k in ("metric", "value", "unit", "spp_per_s",
                                   "samples", "partial", "error")
             if r.get(k) is not None}
            for r in summary]}), flush=True)
        return 0

    cfg = configs[0].strip()
    try:
        run_config(cfg)
    except Exception as e:  # emit a row even on failure
        print(json.dumps({
            "metric": cfg, "value": None, "unit": "error",
            "error": str(e)[:200],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
