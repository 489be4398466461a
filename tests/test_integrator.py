import jax
import numpy as np
import pytest

import clive2 as c2
from clive2.integrator.render import render_sample_jit


@pytest.fixture(scope="module")
def cornell_32():
    return c2.create_scene_from_preset("empty", pixel_width=32, pixel_height=32)


def test_sample_finite_positive(cornell_32):
    out = render_sample_jit(jax.random.key(0), cornell_32.data, 32, 32)
    img = np.asarray(out["image"])
    w = np.asarray(out["weight"])
    assert np.isfinite(img).all()
    assert np.isfinite(w).all()
    assert (img >= 0).all()
    assert (w >= 0).all()
    assert img.sum() > 0
    assert int(out["n_rays"]) > 32 * 32  # at least one cast per pixel


def test_deterministic_given_key(cornell_32):
    a = render_sample_jit(jax.random.key(7), cornell_32.data, 32, 32)
    b = render_sample_jit(jax.random.key(7), cornell_32.data, 32, 32)
    np.testing.assert_array_equal(np.asarray(a["image"]), np.asarray(b["image"]))
    c = render_sample_jit(jax.random.key(8), cornell_32.data, 32, 32)
    assert not np.array_equal(np.asarray(a["image"]), np.asarray(c["image"]))


def test_cornell_structure(cornell_32):
    """Light brightest; left wall green-dominant, right wall blue-dominant
    (BGR channel order internally)."""
    r = c2.Renderer(cornell_32, seed=1)
    for _ in range(4):
        r.run_sample()
    raw = r.raw_image  # [H, W, 3] BGR
    h, w, _ = raw.shape
    # ceiling light region (top rows, center cols) brightest
    lum = raw.sum(axis=2)
    top = lum[: h // 5, 2 * w // 5 : 3 * w // 5].mean()
    assert top > lum.mean()
    # left wall: G channel dominates B-and-R; right wall: B(GR index 0)
    left = raw[h // 2 - 4 : h // 2 + 4, :3].mean(axis=(0, 1))
    right = raw[h // 2 - 4 : h // 2 + 4, -3:].mean(axis=(0, 1))
    assert left[1] > left[0] and left[1] > left[2]   # green wall
    assert right[0] > right[1] and right[0] > right[2]  # blue wall (BGR)


def test_uni_and_bdpt_energy_agree(cornell_32):
    """The reference's implicit oracle (SURVEY §4): the unidirectional
    estimator converges to the same scene as the BDPT one.

    The displayable images use different normalizations (weights vs counts)
    and truncations (uni stops at the first light hit and at 6 bounces;
    BDPT sums MIS-weighted paths up to ~12 vertices), so we compare total
    image energy of the count-normalized BDPT sum against the unidirectional
    sum — measured agreement is ~2.5% at convergence."""
    r = c2.Renderer(cornell_32, seed=2)
    for _ in range(32):
        r.run_sample()
    bdpt = np.asarray(r.state["summed_image"]) / r.samples
    uni = r.raw_unidirectional
    ratio = bdpt.mean() / uni.mean()
    assert 0.85 < ratio < 1.15, f"BDPT/unidirectional energy ratio {ratio:.3f}"


def test_weight_accumulation_bounded(cornell_32):
    out = render_sample_jit(jax.random.key(3), cornell_32.data, 32, 32)
    w = np.asarray(out["weight"])
    assert (w >= 0).all()
    # mean per-pixel weight is bounded by the strategy count (<= 41 w's of
    # at most 1 land somewhere per pixel-sample); individual pixels can
    # exceed this when several light-subpath splats hit the same pixel
    assert w.mean() < 41


def test_checkpoint_roundtrip(tmp_path, cornell_32):
    r = c2.Renderer(cornell_32, seed=5)
    r.run_sample()
    p = str(tmp_path / "ck.npz")
    r.save_checkpoint(p)
    r2 = c2.Renderer(cornell_32, seed=123)
    r2.load_checkpoint(p)
    r.run_sample()
    r2.run_sample()
    np.testing.assert_array_equal(r.raw_image, r2.raw_image)
