"""Golden-image regression: the Cornell render must stay put.

The reference validates transport by eye (SURVEY §4); this pins it
numerically.  The golden accumulator was produced by tests/conftest's CPU
configuration at a fixed seed; any change to sampling order, MIS math, or
the filter shows up here.  Regenerate deliberately with:

    python -m tests.test_golden  (writes tests/golden_cornell.npz)
"""

import os

import jax
import numpy as np

import clive2 as c2

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_cornell.npz")
SIZE = 24
SPP = 4


def render_golden():
    scene = c2.create_scene_from_preset("empty", pixel_width=SIZE,
                                        pixel_height=SIZE)
    r = c2.Renderer(scene, seed=1234)
    for _ in range(SPP):
        r.run_sample()
    return (
        np.asarray(r.state["summed_image"]),
        np.asarray(r.state["summed_weight"]),
        np.asarray(r.state["summed_unidirectional"]),
    )


def test_golden_cornell():
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
