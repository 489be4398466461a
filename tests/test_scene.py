"""Scene assembly, traversal-path selection, camera fast path."""

import numpy as np
import pytest

import clive2 as c2
from clive2.integrator.render import render_sample_jit
from clive2.models import displaced_blob
from clive2.load import soup_from_mesh
from clive2.scene import orbit_camera



@pytest.fixture(scope="module")
def bvh_scene():
    """A scene above the brute threshold (exercises BVH + camtri paths)."""
    v, f = displaced_blob(subdivisions=3)  # 1280 tris
    blob = soup_from_mesh(v * 20.0, f, material=3,
                          offset=np.array([0, 2.0, 0]))
    return c2.create_scene(
        pixel_width=24, pixel_height=24,
        cam_center=np.array([0, 1.5, 6]), cam_direction=np.array([0, 0, -1]),
        extra_geometry=blob,
    )


def test_path_selection():
    small = c2.create_scene_from_preset("empty", 16, 16)
    assert "brute" in small.data
    assert "camtri" not in small.data


def test_bvh_scene_renders_with_camtri(bvh_scene):
    assert "brute" not in bvh_scene.data
    assert "camtri" in bvh_scene.data
    # camera triangles excluded from the BVH leaf tables (packed layout:
    # tri ids live at columns 9, 19, 29, ... of leaf_packed rows)
    leaf_tri = np.asarray(bvh_scene.data["bvh"]["leaf_packed"])[:, 9::10]
    for cid in np.asarray(bvh_scene.camera_tri_ids):
        assert cid not in leaf_tri.astype(np.int64)
    import jax

    out = render_sample_jit(jax.random.key(0), bvh_scene.data, 24, 24)
    img = np.asarray(out["image"])
    assert np.isfinite(img).all() and img.sum() > 0


def test_with_camera_matches_full_rebuild():
    """with_camera must produce the same render as building the scene from
    scratch at the new camera."""
    import jax

    w = h = 20
    cam2 = orbit_camera(3, 16, w, h)
    fast = c2.create_scene_from_preset("empty", w, h).with_camera(cam2)
    full = c2.create_scene(
        pixel_width=w, pixel_height=h,
        cam_center=cam2.center, cam_direction=cam2.direction,
    )
    a = render_sample_jit(jax.random.key(5), fast.data, w, h)
    b = render_sample_jit(jax.random.key(5), full.data, w, h)
    np.testing.assert_allclose(
        np.asarray(a["image"]), np.asarray(b["image"]), rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(a["weight"]), np.asarray(b["weight"]), rtol=1e-5, atol=1e-7
    )


def test_with_camera_bvh_scene(bvh_scene):
    """Camera fast path on a BVH-path scene (camtri swap)."""
    import jax

    cam2 = orbit_camera(1, 8, 24, 24)
    fast = bvh_scene.with_camera(cam2)
    out = render_sample_jit(jax.random.key(2), fast.data, 24, 24)
    assert np.isfinite(np.asarray(out["image"])).all()
    # sensor geometry actually moved
    assert not np.allclose(
        np.asarray(fast.data["camtri"]["v0"]),
        np.asarray(bvh_scene.data["camtri"]["v0"]),
    )

def test_material_def_override():
    """Per-file material_def appends a new slot beyond the reference's
    8-slot table and assigns it to that mesh (ROADMAP feature #7)."""
    import os

    from clive2.materials import default_materials
    from clive2.scene import RESOURCE_DIR, create_scene

    teapot = os.path.join(RESOURCE_DIR, "teapot.obj")
    if not os.path.exists(teapot):
        # fresh checkout: resources/ is generated, not tracked — the
        # exact 32-patch teapot is cheap to emit here (make_assets.py
        # also builds the 1.3M-tri sponza, which is not)
        from clive2.load import write_obj
        from clive2.models import utah_teapot

        os.makedirs(RESOURCE_DIR, exist_ok=True)
        v, f = utah_teapot(n=10)
        write_obj(teapot, v, f)
    spec = [{"file_path": teapot,
             "material_def": {"color": (0.1, 0.6, 0.9), "type": 2,
                              "alpha": 0.3, "ior": 1.8}}]
    scene = create_scene(pixel_width=16, pixel_height=16, file_specs=spec)
    mat = scene.data["mat"]
    assert mat["color"].shape[0] == 9
    np.testing.assert_allclose(np.asarray(mat["color"])[8],
                               (0.1, 0.6, 0.9), rtol=1e-6)
    assert int(np.asarray(mat["type"])[8]) == 2
    assert len(default_materials()) == 8      # defaults untouched
    tri_mat = np.asarray(scene.data["tri"]["material"])
    assert (tri_mat == 8).sum() > 0
    import jax

    out = render_sample_jit(jax.random.key(0), scene.data, 16, 16)
    assert np.isfinite(np.asarray(out["image"])).all()
