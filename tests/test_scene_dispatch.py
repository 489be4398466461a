"""Scene build picks one traversal representation, the same on every
platform: dense brute force up to BRUTE_FORCE_MAX_TRIS triangles, the
threaded BVH plus the separate sensor-plane table beyond."""

import numpy as np
import pytest

import clive2 as c2
from clive2.geometry import TriangleSoup, box_geometry, camera_geometry
from clive2.scene import BRUTE_FORCE_MAX_TRIS


def _scene_with(total_tris):
    cam = c2.create_scene(pixel_width=8, pixel_height=8).camera
    fixed = len(camera_geometry(cam)) + len(box_geometry())
    n = total_tris - fixed
    rng = np.random.default_rng(n)
    extra = None
    if n > 0:
        base = rng.uniform(-1, 1, (n, 1, 3)) + np.array([0, 1.5, 0])
        extra = TriangleSoup.from_vertices(base + rng.uniform(
            -0.1, 0.1, (n, 3, 3)))
    scene = c2.create_scene(pixel_width=8, pixel_height=8,
                            cam_center=np.array([0, 1.5, 6]),
                            cam_direction=np.array([0, 0, -1.0]),
                            extra_geometry=extra)
    assert scene.n_triangles == total_tris
    return scene


@pytest.mark.parametrize("n_tris", [20, 256, 257, 5000])
def test_representation_by_triangle_count(n_tris):
    data = _scene_with(n_tris).data
    assert BRUTE_FORCE_MAX_TRIS == 256
    brute = n_tris <= BRUTE_FORCE_MAX_TRIS
    keys = set(data) - {"tri", "bvh", "mat", "lights", "camera"}
    assert keys == ({"brute"} if brute else {"camtri"})
    assert set(data["bvh"]) == {"node_packed", "leaf_packed"}
    if brute:
        assert data["brute"]["v0"].shape[0] % 32 == 0
        assert data["brute"]["v0"].shape[0] >= n_tris
    else:
        assert data["camtri"]["ids"].shape == (2,)
        assert data["bvh"]["leaf_packed"].shape[1] == 80
