import numpy as np
import pytest

from clive2.bvh import build_bvh
from clive2.bvh.build import leaf_tables
from clive2.constants import MAX_MEMBERS
from clive2.geometry import TriangleSoup, box_geometry


def random_soup(rng, n=200, spread=10.0):
    base = rng.uniform(-spread, spread, size=(n, 1, 3))
    verts = base + rng.normal(size=(n, 3, 3))
    return TriangleSoup.from_vertices(verts.astype(np.float32))


def test_flatten_covers_all_triangles(rng):
    soup = random_soup(rng)
    bvh = build_bvh(soup, use_native=False)
    assert sorted(bvh.permutation.tolist()) == list(range(len(soup)))
    # leaf ranges tile [0, T) exactly once
    leaf_mask = bvh.leaf_id >= 0
    counts = bvh.tri_count[leaf_mask]
    assert counts.sum() == len(soup)
    assert (counts <= MAX_MEMBERS).all()
    assert (counts > 0).all()


def test_parent_boxes_contain_children(rng):
    soup = random_soup(rng)
    bvh = build_bvh(soup, use_native=False)
    n = bvh.n_nodes
    for i in range(n):
        if bvh.leaf_id[i] >= 0:
            continue
        left, right = i + 1, int(bvh.right_child[i])
        for c in (left, right):
            assert (bvh.node_mins[i] <= bvh.node_mins[c] + 1e-5).all()
            assert (bvh.node_maxes[i] >= bvh.node_maxes[c] - 1e-5).all()


def test_miss_links_forward_and_terminate(rng):
    soup = random_soup(rng, n=64)
    bvh = build_bvh(soup, use_native=False)
    n = bvh.n_nodes
    assert (bvh.miss > np.arange(n)).all()
    assert (bvh.miss <= n).all()
    # walking "always miss" terminates
    node, steps = 0, 0
    while node < n and steps < n + 2:
        node = int(bvh.miss[node])
        steps += 1
    assert node == n


def test_leaf_boxes_contain_their_triangles(rng):
    soup = random_soup(rng, n=100)
    bvh = build_bvh(soup, use_native=False)
    mins, maxes = soup.mins, soup.maxes
    for i in range(bvh.n_nodes):
        if bvh.leaf_id[i] < 0:
            continue
        s, c = int(bvh.tri_start[i]), int(bvh.tri_count[i])
        tids = bvh.permutation[s : s + c]
        assert (mins[tids] >= bvh.node_mins[i] - 1e-5).all()
        assert (maxes[tids] <= bvh.node_maxes[i] + 1e-5).all()


def test_leaf_tables_shapes(rng):
    soup = box_geometry()
    bvh = build_bvh(soup, use_native=False)
    tables = leaf_tables(bvh, soup)
    assert tables["v0"].shape == (bvh.n_leaves, MAX_MEMBERS, 3)
    valid = tables["tri_index"] >= 0
    assert valid.sum() == len(soup)
    # padded entries are inert
    assert (tables["tri_index"][~valid] == -1).all()


def test_single_leaf_scene():
    soup = box_geometry()  # 14 tris > MAX_MEMBERS -> splits at least once
    bvh = build_bvh(soup, use_native=False)
    assert bvh.n_nodes >= 3
    tiny = TriangleSoup.from_vertices(
        np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], dtype=np.float32)
    )
    bvh2 = build_bvh(tiny, use_native=False)
    assert bvh2.n_nodes == 1
    assert bvh2.leaf_id[0] == 0
