"""Native (C++) BVH builder equivalence tests.

The native builder (csrc/bvh_builder.cpp, built on first use) must produce
trees identical to the numpy reference implementation.  Skipped, at run
time, where no C++ compiler can build it.
"""

import numpy as np
import pytest

from clive2.bvh import build_bvh, native
from clive2.geometry import TriangleSoup


@pytest.fixture(autouse=True)
def _needs_native():
    if not native.available():
        pytest.skip(f"native BVH builder unavailable: {native.STATUS}")


def make_soup(rng, n):
    base = rng.uniform(-10, 10, size=(n, 1, 3))
    return TriangleSoup.from_vertices(
        (base + rng.normal(size=(n, 3, 3))).astype(np.float32)
    )


@pytest.mark.parametrize("n", [1, 7, 8, 9, 100, 1000])
def test_native_matches_python(rng, n):
    soup = make_soup(rng, n)
    a = build_bvh(soup, use_native=False)
    b = build_bvh(soup, use_native=True)
    assert a.n_nodes == b.n_nodes
    assert a.n_leaves == b.n_leaves
    np.testing.assert_array_equal(a.miss, b.miss)
    np.testing.assert_array_equal(a.right_child, b.right_child)
    np.testing.assert_array_equal(a.leaf_id, b.leaf_id)
    np.testing.assert_array_equal(a.tri_start, b.tri_start)
    np.testing.assert_array_equal(a.tri_count, b.tri_count)
    np.testing.assert_array_equal(a.permutation, b.permutation)
    np.testing.assert_allclose(a.node_mins, b.node_mins, rtol=1e-6)
    np.testing.assert_allclose(a.node_maxes, b.node_maxes, rtol=1e-6)


def test_native_permutation_is_permutation(rng):
    soup = make_soup(rng, 5000)
    b = build_bvh(soup, use_native=True)
    assert sorted(b.permutation.tolist()) == list(range(5000))


def test_build_failure_is_reported(monkeypatch, tmp_path):
    """A compiler that cannot build the library leaves a warning and a
    status line, never a silent numpy fallback."""
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "STATUS", native.STATUS)
    monkeypatch.setattr(native, "library_path",
                        lambda: str(tmp_path / "tag" / "libclive2.so"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.warns(RuntimeWarning, match="numpy builder"):
        assert native._load() is None
    assert native.STATUS.startswith("build failed")
