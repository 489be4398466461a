"""Golden-image regression for the GGX glass paths.

test_golden.py pins the diffuse Cornell; this pins a Cornell + glass
icosphere render so the specular reflect/transmit code paths (GGX
sampling, Fresnel weighting, dual-pdf bookkeeping — reference
trace.metal:334-379, :466-507) cannot rot silently between the
slower integrator-level oracles (tests/test_convergence_glass.py runs
256 spp; this runs 4).  Regenerate deliberately with:

    python -m tests.test_golden_glass  (writes tests/golden_glass.npz)
"""

import os

import numpy as np

import clive2 as c2
from clive2.geometry import TriangleSoup
from clive2.models import icosphere
from clive2.scene import create_scene
import pytest

pytestmark = pytest.mark.slow  # minutes-scale; default gate skips (-m slow)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_glass.npz")
SIZE = 24
SPP = 4


def _glass_scene():
    v, f = icosphere(1)
    soup = TriangleSoup.from_vertices(
        (v[f] * 1.6 + np.array([0.0, 0.6, 1.0])).astype(np.float32),
        material=5,                          # glass (type 1)
    )
    return create_scene(
        pixel_width=SIZE, pixel_height=SIZE,
        cam_center=np.array([0, 1.5, 6]),
        cam_direction=np.array([0, 0, -1.0]),
        extra_geometry=soup,
    )


def render_golden():
    r = c2.Renderer(_glass_scene(), seed=4321)
    for _ in range(SPP):
        r.run_sample()
    return (
        np.asarray(r.state["summed_image"]),
        np.asarray(r.state["summed_weight"]),
        np.asarray(r.state["summed_unidirectional"]),
    )


def test_golden_glass():
    if not os.path.exists(GOLDEN):
        img, w, uni = render_golden()
        np.savez(GOLDEN, image=img, weight=w, uni=uni)
        return  # first run establishes the golden
    img, w, uni = render_golden()
    g = np.load(GOLDEN)
    np.testing.assert_allclose(img, g["image"], rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(w, g["weight"], rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(uni, g["uni"], rtol=2e-4, atol=1e-5)


if __name__ == "__main__":
    if os.path.exists(GOLDEN):
        os.remove(GOLDEN)
    img, w, uni = render_golden()
    np.savez(GOLDEN, image=img, weight=w, uni=uni)
    print(f"wrote {GOLDEN}")
