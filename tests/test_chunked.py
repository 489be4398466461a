"""Chunked (striped) rendering: equivalence with full-frame rendering.

ROADMAP #4 / VERDICT r1 #10: frames beyond ~2M pixels must render in row
stripes to keep path arrays in HBM.  Stripes draw different RNG streams
than the full-frame program, so equivalence is statistical: converged
images must match, and the 3x3 filter's one-row spill across stripe
boundaries must leave no seams in the weight image.
"""

import jax
import jax.numpy as jnp
import numpy as np

import clive2 as c2

import pytest  # noqa: E402

pytestmark = pytest.mark.slow  # minutes-scale; default gate skips (-m slow)


def _render(chunk_rows, spp=48, size=24, seed=3):
    scene = c2.create_scene_from_preset("empty", pixel_width=size,
                                        pixel_height=size)
    r = c2.Renderer(scene, seed=seed, chunk_rows=chunk_rows)
    for _ in range(spp):
        r.run_sample()
    return r


def test_chunked_matches_full():
    full = _render(None)
    chunked = _render(8)
    assert chunked.samples == full.samples
    assert int(np.asarray(chunked.state["n_samples"])) == full.samples

    fi = np.asarray(full.state["summed_image"]) / full.samples
    ci = np.asarray(chunked.state["summed_image"]) / chunked.samples
    assert np.isfinite(ci).all()
    # same converged energy (different RNG streams -> statistical band)
    assert abs(ci.mean() / fi.mean() - 1.0) < 0.06

    # no seams: per-row weight sums must track the full render's rows (a
    # dropped filter spill would dip exactly at stripe boundaries 8/16)
    wc = np.asarray(chunked.state["summed_weight"]).mean(axis=1)
    wf = np.asarray(full.state["summed_weight"]).mean(axis=1)
    row_ratio = wc / np.maximum(wf, 1e-9)
    assert row_ratio.min() > 0.85 and row_ratio.max() < 1.15, (
        f"stripe seam detected in weight rows: {row_ratio.round(3)}"
    )

    # unidirectional stripes tile exactly (no filter spill there)
    cu = np.asarray(chunked.state["summed_unidirectional"]) / chunked.samples
    fu = np.asarray(full.state["summed_unidirectional"]) / full.samples
    assert abs(cu.mean() / fu.mean() - 1.0) < 0.08


def test_chunk_rows_must_divide():
    scene = c2.create_scene_from_preset("empty", pixel_width=16,
                                        pixel_height=16)
    import pytest

    with pytest.raises(ValueError):
        c2.Renderer(scene, chunk_rows=5)
