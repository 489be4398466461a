"""Strict per-block convergence oracle on a GLASS scene (round-2 review
item #3: the diffuse-only Cornell never exercised the transmit/reflect
dual-pdf bookkeeping at integrator level).

Scene: the Cornell room plus an 80-triangle glass icosphere (material 5 —
Fresnel-weighted reflect|transmit, the reference's type-1 dispatch,
reference src/trace.metal:475-479, :364-379).  The sphere is small
enough to keep the scene on the brute traversal path (CPU-cheap) while
every refracted/TIR/reflected branch drives the GGX_transmit dual pdfs
(ops/bsdf.py:142-177) and the specular-vertex MIS-chain zeroing
(integrator/connect.py).

Oracle: identical to tests/test_convergence.py — class-limited BDPT vs
the all-hits unidirectional image per 8x8 block at 256 spp.  Glass
caustics converge slower than diffuse transport, so the block tolerance
is wider (0.18 vs 0.12) but still strict enough that the reference
estimator's stale-junction approximations fail it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clive2.constants import MAX_BOUNCES
from clive2.geometry import TriangleSoup
from clive2.integrator import trace as T
from clive2.integrator.connect import connect_paths
from clive2.models import icosphere
from clive2.scene import create_scene

pytestmark = pytest.mark.slow  # 96-256 spp oracle (default gate skips; -m slow)

W = H = 48
SPP = 256
BLK = 8


def glass_scene(subdivisions=1):
    """Cornell room plus a glass icosphere: 80 triangles at the default
    subdivision (the dense brute-force path), 1,280 at 3 (the BVH path)."""
    v, f = icosphere(subdivisions)
    soup = TriangleSoup.from_vertices(
        (v[f] * 1.6 + np.array([0.0, 0.6, 1.0])).astype(np.float32),
        material=5,                          # glass (type 1)
    )
    scene = create_scene(
        pixel_width=W, pixel_height=H,
        cam_center=np.array([0, 1.5, 6]),
        cam_direction=np.array([0, 0, -1.0]),
        extra_geometry=soup,
    )
    return scene


def _one_sample(key, scene_data):
    cam = scene_data["camera"]
    k_cam, k_light, k_trace = jax.random.split(key, 3)
    cam_rays, _ = T.generate_camera_rays(k_cam, cam, W, H)
    light_rays = T.generate_light_rays(
        k_light, scene_data["lights"], scene_data["mat"], W * H
    )
    n = W * H
    merged = jax.tree.map(
        lambda a, b: jnp.concatenate([a, b], axis=0), cam_rays, light_rays
    )
    fc = jnp.concatenate([jnp.ones((n,), bool), jnp.zeros((n,), bool)])
    path = T.trace_subpaths(k_trace, merged, scene_data, from_camera=fc)
    half = lambda tree, sl: jax.tree.map(lambda a: a[:, sl], tree)
    cam_path = dict(
        vertices=half(path["vertices"], slice(0, n)),
        valid=path["valid"][:, :n], length=path["length"][:n],
    )
    light_path = dict(
        vertices=half(path["vertices"], slice(n, 2 * n)),
        valid=path["valid"][:, n:], length=path["length"][n:],
    )
    conn = connect_paths(cam_path, light_path, scene_data, W, H,
                         debug_per_strategy=True)
    uni_all = T.unidirectional_image(cam_path, all_hits=True).reshape(H, W, 3)

    limited = jnp.zeros((H, W, 3))
    for (t, s), d in conn["per_strategy"].items():
        if t + s <= MAX_BOUNCES:
            limited = limited + d["weighted"]
    return dict(limited=limited, uni=uni_all)


def oracle_images(scene, spp=SPP):
    """Per-pixel means of class-limited BDPT and all-hits unidirectional."""
    key = jax.random.key(321)

    @jax.jit
    def step(i, acc):
        out = _one_sample(jax.random.fold_in(key, i), scene.data)
        return jax.tree.map(lambda a, b: a + b, acc, out)

    acc = dict(limited=jnp.zeros((H, W, 3)), uni=jnp.zeros((H, W, 3)))
    acc = jax.lax.fori_loop(0, spp, step, acc)
    return jax.tree.map(lambda a: np.asarray(a) / spp, acc)


@pytest.fixture(scope="module")
def images():
    scene = glass_scene()
    assert "brute" in scene.data
    return oracle_images(scene)


def _blocks(im):
    return im.reshape(H // BLK, BLK, W // BLK, BLK, 3).mean(axis=(1, 3))


def test_glass_bdpt_class_limited_matches_unidirectional(images):
    check_glass(images)


def check_glass(images):
    """Every 8x8 block within 18% (caustics converge slower), means within
    4%."""
    b_b, b_u = _blocks(images["limited"]), _blocks(images["uni"])
    scale = b_u.mean()
    assert scale > 0
    rel = np.abs(b_b - b_u) / (0.5 * (b_b + b_u) + 0.05 * scale)
    assert rel.max() < 0.18, (
        f"max block deviation {rel.max():.3f} at "
        f"{np.unravel_index(rel.argmax(), rel.shape)}"
    )
    assert abs(b_b.mean() / b_u.mean() - 1.0) < 0.04
