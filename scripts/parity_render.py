"""RMSE-proxy parity artifact (VERDICT r4 round-5 item #6).

The north star's correctness clause is "<1e-3 RMSE vs Metal reference
images at equal spp" (BASELINE.json).  No Apple GPU exists in this
environment, and the reference repo contains NO rendered image — its
README embeds an external imgur URL (reference README.md:16),
unfetchable with zero egress — so a direct RMSE against the published
render is physically impossible here.  This script produces the closest
obtainable artifact: the reference's exact default still workload
(teapots, 1280x720, 15 samples — reference render.py:14-18) rendered on
the GPU under BOTH estimators:

  * production (mega-batched casts, any-hit shadow semantics, corrected
    MIS chain), and
  * CLIVE2_REFERENCE_MIS=1 (the reference's estimator verbatim —
    pixel-parity path, golden-pinned by tests/test_golden_reference.py)

and reports tone-mapped per-channel stats + RMSE between them.  When a
Metal render of the same scene/spp becomes obtainable, RMSE vs BOTH
images closes the clause with scripts/compare_images.py.

Run on the GPU (REFERENCE_MIS is read at import):
    python scripts/parity_render.py            # production estimator
    CLIVE2_REFERENCE_MIS=1 python scripts/parity_render.py
Then: python scripts/parity_render.py --report
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "output", "parity")
W, H, SPP = 1280, 720, 15


def _write_png(raw, path):
    """camera.tone_map already returns uint8 BGR 0-255 — write it
    directly (flipped to RGB)."""
    from clive2.apps.render import save_png
    from clive2.camera import tone_map

    save_png(path, np.asarray(tone_map(raw)))       # uint8 BGR


def render():
    import jax

    import clive2 as c2
    from clive2.camera import tone_map

    refmis = os.environ.get("CLIVE2_REFERENCE_MIS", "0") == "1"
    tag = "refmis" if refmis else "production"
    scene = c2.create_scene_from_preset("teapots", pixel_width=W,
                                        pixel_height=H)
    r = c2.Renderer(scene, seed=0)
    t0 = time.perf_counter()
    for _ in range(SPP):
        r.run_sample()
    jax.block_until_ready(r.state)
    dt = time.perf_counter() - t0
    raw = np.asarray(r.raw_image)
    os.makedirs(OUT, exist_ok=True)
    np.save(os.path.join(OUT, f"parity_{tag}_raw.npy"), raw)
    _write_png(raw, os.path.join(OUT, f"parity_{tag}.png"))
    print(json.dumps({
        "row": f"parity_{tag}", "w": W, "h": H, "spp": SPP,
        "seconds": round(dt, 1),
        "raw_mean": float(raw.mean()), "raw_max": float(raw.max()),
        "nan": int(np.isnan(raw).sum()),
    }), flush=True)


def report():
    a = np.load(os.path.join(OUT, "parity_production_raw.npy"))
    b = np.load(os.path.join(OUT, "parity_refmis_raw.npy"))

    # float gamma map in [0, 1] (sqrt = the reference's 0.5 gamma),
    # avoiding basic_tone_map's uint8 quantization and 0/0 at black
    def tm(x):
        return np.sqrt(np.clip(x, 0.0, 1.0))

    ta, tb = tm(a), tm(b)
    rec = {"row": "parity_report", "spp": SPP,
           "rmse_tonemapped": float(np.sqrt(np.mean((ta - tb) ** 2))),
           "mae_tonemapped": float(np.abs(ta - tb).mean())}
    for ch, name in enumerate("bgr"):
        rec[f"rmse_{name}"] = float(np.sqrt(np.mean(
            (ta[..., ch] - tb[..., ch]) ** 2)))
    rec["raw_rel_mean_diff"] = float(
        abs(a.mean() - b.mean()) / max(a.mean(), 1e-12))
    print(json.dumps(rec, indent=1))


if __name__ == "__main__":
    if "--report" in sys.argv:
        report()
    else:
        render()
