"""Golden-image regression for the PARITY estimator (CLIVE2_REFERENCE_MIS=1).

The reference-verbatim estimator (stale junction pdfs, reference store
semantics, round() splat mapping — constants.py:REFERENCE_MIS) is the
only mode in which the north star's "<1e-3 RMSE vs reference at equal
spp" is even conceptually satisfiable, and it is the mode most likely to
rot because production defaults to the corrected estimator.  This pins
it with the same 24x24 / 4 spp recipe as tests/test_golden.py.

REFERENCE_MIS is read at import time, so the render runs in a
subprocess with the env var set.  Regenerate deliberately with:

    python -m tests.test_golden_reference   (writes the golden npz)
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

GOLDEN = os.path.join(os.path.dirname(__file__),
                      "golden_cornell_refmis.npz")
SIZE = 24
SPP = 4

_RENDER_SNIPPET = """
import jax

# The golden image is a CPU render: pin the platform through the config
# as well as JAX_PLATFORMS, so the child never opens a GPU on a machine
# that has one.
jax.config.update("jax_platforms", "cpu")

import numpy as np
import clive2 as c2

scene = c2.create_scene_from_preset("empty", pixel_width={size},
                                    pixel_height={size})
r = c2.Renderer(scene, seed=1234)
for _ in range({spp}):
    r.run_sample()
np.savez({out!r},
         image=np.asarray(r.state["summed_image"]),
         weight=np.asarray(r.state["summed_weight"]),
         uni=np.asarray(r.state["summed_unidirectional"]))
"""


def render_reference_mode(out_path: str):
    env = dict(
        os.environ,
        CLIVE2_REFERENCE_MIS="1",
        JAX_PLATFORMS="cpu",
    )
    subprocess.run(
        [sys.executable, "-c",
         _RENDER_SNIPPET.format(size=SIZE, spp=SPP, out=out_path)],
        env=env, check=True,
        cwd=os.path.join(os.path.dirname(__file__), ".."),
    )
    return np.load(out_path)


def test_golden_cornell_reference_mis():
    with tempfile.TemporaryDirectory() as td:
        got = render_reference_mode(os.path.join(td, "refmis.npz"))
        if not os.path.exists(GOLDEN):
            np.savez(GOLDEN, image=got["image"], weight=got["weight"],
                     uni=got["uni"])
            return  # first run establishes the golden
        g = np.load(GOLDEN)
        np.testing.assert_allclose(got["image"], g["image"],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(got["weight"], g["weight"],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(got["uni"], g["uni"],
                                   rtol=2e-4, atol=1e-5)


if __name__ == "__main__":
    if os.path.exists(GOLDEN):
        os.remove(GOLDEN)
    with tempfile.TemporaryDirectory() as td:
        got = render_reference_mode(os.path.join(td, "refmis.npz"))
        np.savez(GOLDEN, image=got["image"], weight=got["weight"],
                 uni=got["uni"])
    print(f"wrote {GOLDEN}")
