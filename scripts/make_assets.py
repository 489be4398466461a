"""Generate assets for the scene presets.

The reference presets expect ../resources/teapot.obj and the Stanford
dragon PLYs (scene.py:159-200 in the reference); those files are not in
this image.  The teapot is generated EXACTLY (the 32-patch Newell data
is public domain, clive2/models/teapot.py — 6,320 triangles at the
classic tessellation, the same mesh the reference's teapot.obj holds);
the dragons are procedural stand-ins carrying the REAL Stanford triangle
counts per resolution so benchmarks measure the workloads they claim.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from clive2.load import write_obj, write_ply
from clive2.models import displaced_blob_exact, utah_teapot

RES = os.environ.get(
    "CLIVE2_RESOURCES",
    os.path.join(os.path.dirname(__file__), "..", "resources"),
)


def main():
    os.makedirs(RES, exist_ok=True)

    v, f = utah_teapot(n=10)
    write_obj(os.path.join(RES, "teapot.obj"), v, f)
    print(f"teapot.obj: {len(f)} tris (exact Utah teapot)")

    # dragon stand-ins at the real Stanford triangle counts, scaled to the
    # preset's expectations: presets apply scale=50 and offset (0,-4,0);
    # the real dragon spans ~0.15 units.
    for name, count in [
        ("dragon_vrip_res3.ply", 47_794),
        ("dragon_vrip_res2.ply", 202_520),
        ("dragon_vrip.ply", 871_414),
        ("sponza_scale.ply", 1_310_720),  # BASELINE config #4
                                          # "Sponza-scale ~1M tris" stand-in
    ]:
        v, f = displaced_blob_exact(count)
        v = v * 0.06 + np.array([0.0, 0.085, 0.0])  # dragon-ish footprint
        write_ply(os.path.join(RES, name), v, f, binary=True)
        print(f"{name}: {len(f)} tris")


if __name__ == "__main__":
    main()
