"""Adaptive sampling (ROADMAP feature; the reference scaffolds per-pixel
sample bins but drives them as identity, renderer.py:92).

Checks:
  1. adaptive samples concentrate where variance is (per-pixel counts
     spread after adaptive passes, totals conserved);
  2. the estimator stays consistent: a uniform-warmup + adaptive render
     agrees with a uniform-only render of the same scene to within noise
     (weight-normalized display estimator, global energy).
"""

import jax
import numpy as np
import pytest

import clive2 as c2
from clive2.renderer import Renderer

pytestmark = pytest.mark.slow  # minutes-scale; default gate skips (-m slow)

W = H = 48


@pytest.fixture(scope="module")
def scene():
    return c2.create_scene_from_preset("empty", pixel_width=W,
                                       pixel_height=H)


def test_adaptive_counts_and_consistency(scene):
    uniform = Renderer(scene, seed=3)
    for _ in range(10):
        uniform.run_sample()

    adaptive = Renderer(scene, seed=3)
    for _ in range(4):
        adaptive.run_sample()
    for _ in range(24):                      # 24 * 0.25 = 6 uniform-equiv
        adaptive.run_adaptive_sample(fraction=0.25)

    counts = np.asarray(adaptive.state["pixel_count"])
    # warmup gave 4 everywhere; adaptive passes add 24 * W*H/4 samples
    assert counts.min() >= 4.0
    total = counts.sum()
    assert total == pytest.approx(4 * W * H + 24 * (W * H // 4), rel=1e-6)
    # selection must actually discriminate (not uniform): counts spread
    assert counts.max() >= counts.min() + 4

    img_u = uniform.raw_image
    img_a = adaptive.raw_image
    # same-budget global agreement (loose: both are ~10-spp-noisy)
    ratio = img_a.mean() / img_u.mean()
    assert 0.85 < ratio < 1.15, f"energy ratio {ratio:.3f}"


def test_adaptive_checkpoint_roundtrip(tmp_path, scene):
    r = Renderer(scene, seed=5)
    for _ in range(3):
        r.run_sample()
    r.run_adaptive_sample(0.25)
    p = str(tmp_path / "ckpt.npz")
    r.save_checkpoint(p)

    r2 = Renderer(scene, seed=5)
    r2.load_checkpoint(p)
    np.testing.assert_array_equal(
        np.asarray(r.state["pixel_count"]),
        np.asarray(r2.state["pixel_count"]),
    )
    r.run_adaptive_sample(0.25)
    r2.run_adaptive_sample(0.25)
    np.testing.assert_array_equal(r.raw_image, r2.raw_image)


def test_adaptive_composes_with_chunked(scene):
    """VERDICT r2 #10: adaptive x chunked composition.  A chunked
    renderer runs the adaptive subset in chunk-sized batches; counts and
    energy must behave like the unchunked adaptive path."""
    r = Renderer(scene, seed=7, chunk_rows=12)    # 4 stripes of 48x12
    assert r.chunk_rows == 12
    for _ in range(4):
        r.run_sample()
    # fraction 0.5 -> n_select = 1152 > batch = 12*48 = 576 -> 2 batches
    for _ in range(6):
        r.run_adaptive_sample(fraction=0.5)

    counts = np.asarray(r.state["pixel_count"])
    assert counts.min() >= 4.0
    assert counts.sum() == pytest.approx(4 * W * H + 6 * (W * H // 2),
                                         rel=1e-6)
    assert counts.max() >= counts.min() + 2   # selection discriminates

    # energy agreement with a uniform renderer of the same scene
    u = Renderer(scene, seed=7)
    for _ in range(7):
        u.run_sample()
    ratio = r.raw_image.mean() / u.raw_image.mean()
    assert 0.85 < ratio < 1.15, f"energy ratio {ratio:.3f}"
