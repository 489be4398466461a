"""Scene construction: geometry assembly, BVH build, device upload, presets.

Rebuild of reference src/scene.py.  The same pipeline — camera plane +
Cornell room always injected, optional mesh files merged, BVH built on host —
but the output is a pytree of jnp arrays (no byte-matched struct buffers),
and movie-style camera updates rebuild ONLY the camera/sensor state, not the
BVH (the reference rebuilds everything per frame, movie.py:31-38).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

import jax.numpy as jnp
import numpy as np

from .bvh import build_bvh
from .bvh.build import leaf_tables
from .camera import Camera
from .constants import UNIT_Z, ZERO_VECTOR
from .geometry import TriangleSoup, box_geometry, camera_geometry
from .load import load_mesh_file
from .materials import MaterialTable, default_materials

RESOURCE_DIR = os.environ.get(
    "CLIVE2_RESOURCES",
    os.path.join(os.path.dirname(__file__), "..", "resources"),
)

# scenes at or below this triangle count trace via dense Möller–Trumbore
# (no BVH walk; see ops/intersect.py:intersect_brute_chunked)
BRUTE_FORCE_MAX_TRIS = int(os.environ.get("CLIVE2_BRUTE_MAX_TRIS", 256))


@dataclasses.dataclass
class Scene:
    """Host handle + device pytree for one renderable scene."""

    camera: Camera
    pixel_width: int
    pixel_height: int
    data: Dict[str, Any]          # the jit-consumable pytree
    n_triangles: int
    n_nodes: int
    camera_tri_ids: Any = None    # global ids of the sensor-plane triangles

    def with_camera(self, camera: Camera) -> "Scene":
        """Replace only the camera + sensor-plane geometry — O(1), no BVH
        rebuild, no recompile (shapes unchanged).

        The reference rebuilds the whole scene, BVH, and kernels every
        animation frame (reference movie.py:31-38) even though only the
        camera moves; here the sensor plane lives OUTSIDE the BVH (it is
        intersected separately, ops/intersect.py:intersect_scene), so a
        camera move just swaps a handful of rows.  The row swaps run as
        ONE jitted program (per scene structure) instead of one device
        dispatch per .at[].set.
        """
        from .geometry import camera_geometry

        cam_soup = camera_geometry(camera)
        ids = np.asarray(self.camera_tri_ids)
        assert len(cam_soup) == len(ids)

        updates = dict(
            v=jnp.asarray(cam_soup.vertices.astype(np.float32)),
            fn=jnp.asarray(cam_soup.face_normals.astype(np.float32)),
            vn=jnp.asarray(cam_soup.vertex_normals.astype(np.float32)),
            ids=jnp.asarray(ids.astype(np.int32)),
        )
        data = _apply_camera_update(self.data, camera.to_pytree(), updates)

        new = dataclasses.replace(
            self, camera=camera, data=data,
            pixel_width=camera.pixel_width, pixel_height=camera.pixel_height,
        )
        new.build_seconds = 0.0
        return new


def _camtri_arrays(cam_soup, ids):
    v = cam_soup.vertices
    return dict(
        v0=jnp.asarray(v[:, 0]),
        e1=jnp.asarray(v[:, 1] - v[:, 0]),
        e2=jnp.asarray(v[:, 2] - v[:, 0]),
        ids=jnp.asarray(ids.astype(np.int32)),
    )


import jax as _jax


@_jax.jit
def _apply_camera_update(data, cam_pytree, up):
    """All sensor-plane row swaps fused into one program (see with_camera)."""
    v, fn, vn, ids = up["v"], up["fn"], up["vn"], up["ids"]
    data = dict(data)
    data["camera"] = cam_pytree

    if "camtri" in data:
        data["camtri"] = dict(
            v0=v[:, 0], e1=v[:, 1] - v[:, 0], e2=v[:, 2] - v[:, 0], ids=ids,
        )
    if "brute" in data:
        brute = dict(data["brute"])
        brute["v0"] = brute["v0"].at[ids].set(v[:, 0])
        brute["e1"] = brute["e1"].at[ids].set(v[:, 1] - v[:, 0])
        brute["e2"] = brute["e2"].at[ids].set(v[:, 2] - v[:, 0])
        data["brute"] = brute
    tri = dict(data["tri"])
    tri["face_normal"] = tri["face_normal"].at[ids].set(fn)
    for k, col in (("n0", 0), ("n1", 1), ("n2", 2)):
        tri[k] = tri[k].at[ids].set(vn[:, col])
    packed = tri["packed"]
    rows = packed[ids]
    rows = rows.at[:, 0:3].set(fn)
    rows = rows.at[:, 3:6].set(vn[:, 0])
    rows = rows.at[:, 6:9].set(vn[:, 1])
    rows = rows.at[:, 9:12].set(vn[:, 2])
    tri["packed"] = packed.at[ids].set(rows)
    data["tri"] = tri
    return data


def _build_scene_pytree(soup: TriangleSoup, materials: MaterialTable,
                        camera: Camera) -> Dict[str, Any]:
    # The sensor plane stays OUT of the BVH: it would bloat the root AABB
    # (the camera can sit far from the scene) and it moves every animation
    # frame.  BVH-path scenes intersect it separately (data["camtri"]);
    # brute-path scenes keep it in the dense triangle list.
    cam_ids = np.nonzero(soup.is_camera)[0]
    world_sel = np.nonzero(~soup.is_camera)[0]
    world = soup.select(world_sel)

    bvh = build_bvh(world)
    leafs = leaf_tables(bvh, world)
    # leaf tri ids are world-local; remap to global soup ids
    leafs["tri_index"] = np.where(
        leafs["tri_index"] >= 0,
        world_sel[np.minimum(leafs["tri_index"], len(world) - 1)],
        -1,
    ).astype(np.int32)

    dev = lambda a: jnp.asarray(a)
    tri = dict(
        face_normal=dev(soup.face_normals),
        n0=dev(soup.vertex_normals[:, 0]),
        n1=dev(soup.vertex_normals[:, 1]),
        n2=dev(soup.vertex_normals[:, 2]),
        material=dev(soup.material.astype(np.int32)),
        is_light=dev(soup.is_light.astype(np.int32)),
        is_camera=dev(soup.is_camera.astype(np.int32)),
    )
    # all hit-shading attributes in one row so the per-bounce lookup is a
    # single gather
    packed_attrs = np.zeros((len(soup), 16), dtype=np.float32)
    packed_attrs[:, 0:3] = soup.face_normals
    packed_attrs[:, 3:6] = soup.vertex_normals[:, 0]
    packed_attrs[:, 6:9] = soup.vertex_normals[:, 1]
    packed_attrs[:, 9:12] = soup.vertex_normals[:, 2]
    packed_attrs[:, 12] = soup.material
    packed_attrs[:, 13] = soup.is_light
    packed_attrs[:, 14] = soup.is_camera
    tri["packed"] = dev(packed_attrs)
    from .ops.intersect import pack_gather_walk

    bvh_arrays = {k: dev(v) for k, v in pack_gather_walk(bvh, leafs).items()}
    # Small scenes skip the BVH at trace time entirely: dense chunked
    # Möller–Trumbore over all triangles, an elementwise loop XLA fuses
    # (the dispatcher keys on this entry's presence,
    # ops/intersect.py:intersect_scene).
    brute = None
    if len(soup) <= BRUTE_FORCE_MAX_TRIS:
        chunk = 32
        t_pad = max(chunk, ((len(soup) + chunk - 1) // chunk) * chunk)
        v0 = np.zeros((t_pad, 3), np.float32)
        e1 = np.zeros((t_pad, 3), np.float32)
        e2 = np.zeros((t_pad, 3), np.float32)
        v0[: len(soup)] = soup.vertices[:, 0]
        e1[: len(soup)] = soup.vertices[:, 1] - soup.vertices[:, 0]
        e2[: len(soup)] = soup.vertices[:, 2] - soup.vertices[:, 0]
        brute = dict(v0=dev(v0), e1=dev(e1), e2=dev(e2))

    light_sel = np.nonzero(soup.is_light)[0]
    areas = soup.surface_areas()[light_sel]
    lights = dict(
        v0=dev(soup.vertices[light_sel, 0]),
        v1=dev(soup.vertices[light_sel, 1]),
        v2=dev(soup.vertices[light_sel, 2]),
        normal=dev(soup.face_normals[light_sel]),
        area=dev(areas.astype(np.float32)),
        tri_index=dev(light_sel.astype(np.int32)),
        material=dev(soup.material[light_sel].astype(np.int32)),
    )
    data = dict(
        tri=tri,
        bvh=bvh_arrays,
        mat={k: dev(v) for k, v in materials.to_pytree().items()},
        lights=lights,
        camera=camera.to_pytree(),
    )
    if brute is not None:
        data["brute"] = brute
    else:
        # the sensor plane is intersected separately from the BVH
        data["camtri"] = _camtri_arrays(soup.select(cam_ids), cam_ids)
    return data, bvh, cam_ids


def create_scene(
    pixel_width: int = 1280,
    pixel_height: int = 720,
    cam_center=ZERO_VECTOR,
    cam_direction=UNIT_Z,
    file_specs=None,
    materials: Optional[MaterialTable] = None,
    extra_geometry: Optional[TriangleSoup] = None,
    box_kwargs: Optional[dict] = None,
    soup_transform=None,
) -> Scene:
    """Assemble a scene (reference scene.py:21-104).

    Always injects the camera-plane triangles and the Cornell-style room
    with its ceiling light, then merges any mesh files from ``file_specs``
    (schema: file_path / material / scale / offset, scene.py:50-64).

    ``soup_transform``: optional callable applied to the fully assembled
    TriangleSoup before the BVH build — lets callers re-flag or re-material
    geometry wholesale (e.g. the white-furnace test marks every wall
    emissive, tests/test_furnace.py).
    """
    camera = Camera(
        center=np.asarray(cam_center, dtype=np.float64),
        direction=np.asarray(cam_direction, dtype=np.float64),
        pixel_width=pixel_width,
        pixel_height=pixel_height,
        phys_width=pixel_width / pixel_height,
        phys_height=1.0,
    )
    materials = materials or default_materials()
    if any("material_def" in s for s in file_specs or []):
        # appending must not mutate a caller-owned table
        materials = dataclasses.replace(
            materials, **{k: v.copy() for k, v in
                          materials.to_pytree().items()}
        )
    soup = camera_geometry(camera) + box_geometry(**(box_kwargs or {}))
    if extra_geometry is not None:
        soup = soup + extra_geometry
    for spec in file_specs or []:
        # per-file material override: a "material_def" dict (schema as in
        # MaterialTable.build) appends a new slot and assigns it to this
        # mesh — scenes are no longer limited to the reference's 8
        # hard-coded materials (reference load.py:179-200)
        mat_idx = spec.get("material", 0)
        if "material_def" in spec:
            mat_idx = materials.append(spec["material_def"])
        soup = soup + load_mesh_file(
            spec["file_path"],
            material=mat_idx,
            scale=spec.get("scale", 1.0),
            offset=spec.get("offset", ZERO_VECTOR),
        )

    if soup_transform is not None:
        soup = soup_transform(soup)

    t0 = time.time()
    data, bvh, cam_ids = _build_scene_pytree(soup, materials, camera)
    build_s = time.time() - t0

    scene = Scene(
        camera=camera,
        pixel_width=pixel_width,
        pixel_height=pixel_height,
        data=data,
        n_triangles=len(soup),
        n_nodes=bvh.n_nodes,
        camera_tri_ids=cam_ids,
    )
    scene.build_seconds = build_s
    return scene


# --------------------------------------------------------------------------
# presets (names and parameters match reference scene.py:149-206)
# --------------------------------------------------------------------------

def _res(name: str) -> str:
    return os.path.join(RESOURCE_DIR, name)


scene_presets: Dict[str, dict] = {
    "empty": {
        "cam_center": np.array([0, 1.5, 6]),
        "cam_direction": np.array([0, 0, -1]),
    },
    "teapots": {
        "cam_center": np.array([7, 0, 8]),
        "cam_direction": np.array([-1, 0, -1]),
        "file_specs": [
            {"file_path": _res("teapot.obj"), "offset": np.array([0, 0, 2.5]),
             "material": 5},
            {"file_path": _res("teapot.obj"), "offset": np.array([0, 0, -2.5]),
             "material": 0},
        ],
    },
    "dragon": {
        "cam_center": np.array([0, 1.5, 7.5]),
        "cam_direction": np.array([0, 0, -1]),
        "file_specs": [
            {"file_path": _res("dragon_vrip_res3.ply"),
             "offset": np.array([0, -4, 0]), "material": 5, "scale": 50},
        ],
    },
    "medium-dragon": {
        "cam_center": np.array([0, 1.5, 7.5]),
        "cam_direction": np.array([0, 0, -1]),
        "file_specs": [
            {"file_path": _res("dragon_vrip_res2.ply"),
             "offset": np.array([0, -4, 0]), "material": 5, "scale": 50},
        ],
    },
    "big-dragon": {
        "cam_center": np.array([0, 1.5, 7.5]),
        "cam_direction": np.array([0, 0, -1]),
        "file_specs": [
            {"file_path": _res("dragon_vrip.ply"),
             "offset": np.array([0, -4, 0]), "material": 5, "scale": 50},
        ],
    },
    # BASELINE config #4 ("Sponza-scale ~1M tris, 1080p, 64+ spp"): a
    # ~1.3M-triangle stand-in mesh (scripts/make_assets.py), diffuse
    # material so the BVH depth — not glass bounces — is the stressor
    "sponza": {
        "cam_center": np.array([0, 1.5, 7.5]),
        "cam_direction": np.array([0, 0, -1]),
        "file_specs": [
            {"file_path": _res("sponza_scale.ply"),
             "offset": np.array([0, -4, 0]), "material": 4, "scale": 50},
        ],
    },
}


def create_scene_from_preset(preset_name: str, pixel_width=1280,
                             pixel_height=720) -> Scene:
    preset = scene_presets.get(preset_name)
    if not preset:
        raise ValueError(f"Preset '{preset_name}' not found.")
    return create_scene(
        pixel_width=pixel_width,
        pixel_height=pixel_height,
        cam_center=preset["cam_center"],
        cam_direction=preset["cam_direction"],
        file_specs=preset.get("file_specs"),
    )


def orbit_camera(frame_idx: int, total_frames: int, pixel_width: int,
                 pixel_height: int) -> Camera:
    """Turntable camera on the reference's r=7.5 circle
    (reference scene.py:234-237)."""
    theta = 2 * np.pi * frame_idx / total_frames
    return Camera(
        center=np.array([np.sin(theta) * 7.5, 1.5, np.cos(theta) * 7.5]),
        direction=np.array([-np.sin(theta), 0, -np.cos(theta)]),
        pixel_width=pixel_width,
        pixel_height=pixel_height,
        phys_width=pixel_width / pixel_height,
        phys_height=1.0,
    )


def create_scene_from_preset_with_params(
    preset_name: str, pixel_width=1280, pixel_height=720,
    frame_idx: int = 0, total_frames: int = 1,
) -> Scene:
    """Orbit camera for animation frames (reference scene.py:223-245)."""
    preset = scene_presets.get(preset_name)
    if not preset:
        raise ValueError(f"Preset '{preset_name}' not found.")
    theta = 2 * np.pi * frame_idx / total_frames
    cam_center = np.array([np.sin(theta) * 7.5, 1.5, np.cos(theta) * 7.5])
    cam_direction = np.array([-np.sin(theta), 0, -np.cos(theta)])
    return create_scene(
        pixel_width=pixel_width,
        pixel_height=pixel_height,
        cam_center=cam_center,
        cam_direction=cam_direction,
        file_specs=preset.get("file_specs"),
    )
