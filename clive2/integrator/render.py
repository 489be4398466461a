"""Per-sample render pipeline: the jit-compiled heart of the framework.

Replaces the reference's 8-stage host-driven kernel sequence
(reference src/renderer.py:280-291) with ONE fused jitted program:
ray gen -> two wavefront subpath traces -> BDPT connect (incl. splat
scatter) -> 3x3 filter finalize.  There are no mid-sample host round trips
(the reference reads back splat indices every sample, renderer.py:97-111).

Multi-chip: `sharded_render_sample` annotates the pixel wavefront with a
NamedSharding over a device mesh and lets GSPMD partition the whole
pipeline; the BVH/material tables replicate, the splat scatter and filter
halos become XLA collectives.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..constants import MAX_BOUNCES
from ..ops.filters import (
    filter_weights,
    finalize_samples,
    finalize_samples_scatter,
)
from .connect import connect_paths
from .trace import (
    generate_camera_rays,
    generate_light_rays,
    light_gen_key,
    trace_subpaths,
    unidirectional_image,
)


@functools.lru_cache(maxsize=8)
def _morton_codes(rows: int, width: int):
    """2D Morton code per raster lane of a rows*width grid, flattened."""
    yy, xx = np.mgrid[0:rows, 0:width]

    def spread(v):                     # 16-bit -> even bits of 32
        v = v.astype(np.uint64)
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return ((spread(yy) << 1) | spread(xx)).reshape(-1)


@functools.lru_cache(maxsize=8)
def _morton_pixel_perm(rows: int, width: int):
    """Static permutation putting a rows*width raster grid in 2D Morton
    order.  Applied to the camera wavefront at GENERATION time it makes
    neighbouring lanes trace neighbouring pixels with no runtime sort."""
    return np.argsort(_morton_codes(rows, width),
                      kind="stable").astype(np.int32)


@functools.lru_cache(maxsize=8)
def _banded_morton_perm(rows: int, width: int, bands: int):
    """Band-LOCAL Morton permutation: [bands, N//bands] indices into each
    contiguous raster-lane chunk.  Under pixel-tile sharding each band is
    exactly one device's lane chunk, so applying it as a banded
    take_along_axis keeps the permutation gather shard-local — a global
    Morton permutation would make GSPMD all-gather the wavefront."""
    n = rows * width
    code = _morton_codes(rows, width).reshape(bands, n // bands)
    return np.argsort(code, axis=1, kind="stable").astype(np.int32)


def _banded_take(tree, idx, bands: int):
    """Gather ``idx`` ([bands, per] band-local indices) along the lane dim
    of every leaf, reshaped so the gather never crosses band boundaries."""
    def g(a):
        b = a.reshape((bands, idx.shape[1]) + a.shape[1:])
        ix = idx.reshape(idx.shape + (1,) * (a.ndim - 1))
        return jnp.take_along_axis(b, ix, axis=1).reshape(a.shape)

    return jax.tree.map(g, tree)


def _wave_order() -> str:
    """Wavefront-order policy: "raster" (lane i = pixel i, the reference
    layout) or "morton" (static Morton pixel order + generation-sorted
    light rays — see _morton_pixel_perm / trace.light_gen_key).

    CLIVE2_WAVE_ORDER in {auto, raster, morton}; auto is raster.  Sharded
    wavefronts use the BAND-local Morton variant (each device's lane
    chunk is ordered in place, light rays sort per band), so the order
    machinery stays collective-free."""
    v = os.environ.get("CLIVE2_WAVE_ORDER", "auto")
    return v if v in ("raster", "morton") else "raster"


def render_sample(key, scene, width: int, height: int,
                  max_bounces: int = MAX_BOUNCES, mesh=None,
                  row0=None, rows: int = None):
    """One full BDPT sample for every pixel.

    ``row0``/``rows`` render only an image stripe (chunked rendering for
    frames whose full path arrays would not fit HBM): the outputs are still
    full-size [H, W] images — zero outside the stripe except the light
    (splat) image, which stripes legitimately write anywhere.  Summing the
    outputs over a partition of stripes equals one full sample.

    Returns dict(image [H, W, 3], weight [H, W], unidirectional [H, W, 3]).
    ``image``/``weight`` follow the reference accumulation contract:
    display = sum(image) / sum(weight) over samples (renderer.py:294-300).
    """
    cam = scene["camera"]
    chunked = rows is not None and rows != height
    rows_eff = height if rows is None else rows
    k_cam, k_light, k_trace = jax.random.split(key, 3)

    cam_rays, pixel_idx = generate_camera_rays(
        k_cam, cam, width, height,
        row0=0 if row0 is None else row0, rows=rows_eff,
    )
    light_rays = generate_light_rays(
        k_light, scene["lights"], scene["mat"], width * rows_eff
    )

    order = _wave_order()
    bands = int(mesh.shape["tiles"]) if mesh is not None else 1
    if order == "morton" and (width * rows_eff) % max(bands, 1):
        order = "raster"        # banded layout needs equal lane chunks
    if order == "morton":
        # static-order pipeline: Morton-permute the camera wavefront once
        # at generation (a compile-time-constant gather) and sort the light
        # wavefront once by its generation key.  Sharded: both are
        # BAND-local (one band = one device's lane chunk), so they compile
        # to shard-local gathers — no collectives.
        lkey = light_gen_key(light_rays["origin"], light_rays["direction"])
        if bands == 1:
            perm = jnp.asarray(_morton_pixel_perm(rows_eff, width))
            cam_rays = jax.tree.map(lambda a: a[perm], cam_rays)
            pixel_idx = pixel_idx[perm]
            lorder = jnp.argsort(lkey)
            light_rays = jax.tree.map(lambda a: a[lorder], light_rays)
        else:
            idx = jnp.asarray(_banded_morton_perm(rows_eff, width, bands))
            cam_rays = _banded_take(cam_rays, idx, bands)
            pixel_idx = _banded_take(pixel_idx, idx, bands)
            lord = jnp.argsort(lkey.reshape(bands, -1), axis=1)
            light_rays = _banded_take(light_rays, lord, bands)
    if mesh is not None:
        constrain = lambda tree: jax.tree.map(
            lambda a: jax.lax.with_sharding_constraint(
                a, NamedSharding(mesh, P(*(("tiles",) + (None,) * (a.ndim - 1))))
            ),
            tree,
        )
        cam_rays = constrain(cam_rays)
        light_rays = constrain(light_rays)

    sensor_pos = cam_rays["origin"]
    n = width * rows_eff

    # camera + light wavefronts trace as ONE merged scan (per-ray
    # from_camera flag): one traversal per depth instead of two
    merged = jax.tree.map(
        lambda a, b: jnp.concatenate([a, b], axis=0), cam_rays, light_rays
    )
    fc = jnp.concatenate(
        [jnp.ones((n,), bool), jnp.zeros((n,), bool)], axis=0
    )
    path = trace_subpaths(k_trace, merged, scene, from_camera=fc,
                          max_bounces=max_bounces, mesh=mesh)
    half = lambda tree, sl: jax.tree.map(lambda a: a[:, sl], tree)
    cam_path = dict(
        vertices=half(path["vertices"], slice(0, n)),
        valid=path["valid"][:, :n],
        length=path["length"][:n],
        n_rays=path["n_rays"],
    )
    light_path = dict(
        vertices=half(path["vertices"], slice(n, 2 * n)),
        valid=path["valid"][:, n:],
        length=path["length"][n:],
        n_rays=jnp.int32(0),
    )

    uni = unidirectional_image(cam_path)

    conn = connect_paths(cam_path, light_path, scene, width, height,
                         max_bounces=max_bounces, mesh=mesh)

    weights = filter_weights(sensor_pos, pixel_idx, cam, width, height)
    if order == "morton":
        # lane order is arbitrary: assemble by pixel_idx scatter (the
        # subset-path machinery), full-size outputs either way
        image, wimage = finalize_samples_scatter(
            conn["contribution"], weights, conn["contrib_weight_sum"],
            pixel_idx, width, height,
        )
        uni = jnp.zeros((height * width, 3), jnp.float32).at[pixel_idx].add(
            uni, mode="drop"
        ).reshape(height, width, 3)
    else:
        image, wimage = finalize_samples(
            conn["contribution"], weights, conn["contrib_weight_sum"],
            width, height,
            row0=None if not chunked else row0,
            rows=None if not chunked else rows,
        )

        uni = uni.reshape(rows_eff, width, 3)
        if chunked:
            uni_full = jnp.zeros((height, width, 3), dtype=uni.dtype)
            uni = jax.lax.dynamic_update_slice(
                uni_full, uni, (jnp.asarray(row0, jnp.int32), jnp.int32(0),
                                jnp.int32(0))
            )

    total_image = image + conn["light_image"]
    total_weight = wimage + conn["light_weight_image"]
    return dict(
        image=jnp.nan_to_num(total_image, posinf=0.0, neginf=0.0),
        weight=total_weight,
        unidirectional=jnp.nan_to_num(uni, posinf=0.0, neginf=0.0),
        n_rays=cam_path["n_rays"] + light_path["n_rays"] + conn["n_rays"],
    )


@functools.partial(jax.jit, static_argnames=("width", "height", "max_bounces"))
def render_sample_jit(key, scene, width: int, height: int,
                      max_bounces: int = MAX_BOUNCES):
    return render_sample(key, scene, width, height, max_bounces)


def render_sample_subset(key, scene, pixel_sel, width: int, height: int,
                         max_bounces: int = MAX_BOUNCES):
    """One BDPT sample for an ARBITRARY pixel subset (adaptive sampling —
    the reference scaffolds per-pixel sample bins but drives them as
    identity, renderer.py:92; this is the real implementation).

    pixel_sel: [M] i32 flat pixel indices (may repeat).  Outputs are
    full-size [H, W] images, zero away from the touched pixels except the
    splat image (light subpaths land anywhere).  The wavefront width M is
    the compile-time shape, so a fixed selection size reuses one program.
    """
    cam = scene["camera"]
    k_cam, k_light, k_trace = jax.random.split(key, 3)

    cam_rays, pixel_idx = generate_camera_rays(
        k_cam, cam, width, height, pixel_sel=pixel_sel
    )
    m = pixel_idx.shape[0]
    light_rays = generate_light_rays(k_light, scene["lights"], scene["mat"],
                                     m)
    sensor_pos = cam_rays["origin"]

    merged = jax.tree.map(
        lambda a, b: jnp.concatenate([a, b], axis=0), cam_rays, light_rays
    )
    fc = jnp.concatenate([jnp.ones((m,), bool), jnp.zeros((m,), bool)])
    path = trace_subpaths(k_trace, merged, scene, from_camera=fc,
                          max_bounces=max_bounces)
    half = lambda tree, sl: jax.tree.map(lambda a: a[:, sl], tree)
    cam_path = dict(
        vertices=half(path["vertices"], slice(0, m)),
        valid=path["valid"][:, :m],
        length=path["length"][:m],
        n_rays=path["n_rays"],
    )
    light_path = dict(
        vertices=half(path["vertices"], slice(m, 2 * m)),
        valid=path["valid"][:, m:],
        length=path["length"][m:],
        n_rays=jnp.int32(0),
    )

    uni_vals = unidirectional_image(cam_path)          # [M, 3]
    uni = jnp.zeros((height * width, 3), jnp.float32).at[pixel_idx].add(
        uni_vals, mode="drop"
    ).reshape(height, width, 3)
    uni_count = jnp.zeros((height * width,), jnp.float32).at[pixel_idx].add(
        1.0, mode="drop"
    ).reshape(height, width)

    conn = connect_paths(cam_path, light_path, scene, width, height,
                         max_bounces=max_bounces)

    weights = filter_weights(sensor_pos, pixel_idx, cam, width, height)
    image, wimage = finalize_samples_scatter(
        conn["contribution"], weights, conn["contrib_weight_sum"],
        pixel_idx, width, height,
    )

    total_image = image + conn["light_image"]
    total_weight = wimage + conn["light_weight_image"]
    return dict(
        image=jnp.nan_to_num(total_image, posinf=0.0, neginf=0.0),
        weight=total_weight,
        unidirectional=jnp.nan_to_num(uni, posinf=0.0, neginf=0.0),
        uni_count=uni_count,
        n_rays=cam_path["n_rays"] + light_path["n_rays"] + conn["n_rays"],
    )


def make_sharded_render(mesh, width: int, height: int,
                        max_bounces: int = MAX_BOUNCES):
    """jit-compiled render step sharded over the mesh's "tiles" axis."""

    @jax.jit
    def step(key, scene):
        return render_sample(key, scene, width, height, max_bounces, mesh=mesh)

    return step


def accumulate(state, sample):
    """Device-side running accumulation (replaces the reference's per-sample
    host numpy accumulation, renderer.py:253-278)."""
    return dict(
        summed_image=state["summed_image"] + sample["image"],
        summed_weight=state["summed_weight"] + sample["weight"],
        summed_unidirectional=state["summed_unidirectional"]
        + sample["unidirectional"],
        n_samples=state["n_samples"] + 1,
    )


def init_accumulators(width: int, height: int):
    return dict(
        summed_image=jnp.zeros((height, width, 3), dtype=jnp.float32),
        summed_weight=jnp.zeros((height, width), dtype=jnp.float32),
        summed_unidirectional=jnp.zeros((height, width, 3), dtype=jnp.float32),
        n_samples=jnp.zeros((), dtype=jnp.int32),
        # adaptive-sampling statistics: per-pixel sample counts and the
        # running sum of squared per-sample luma estimates (variance guide)
        summed_sq=jnp.zeros((height, width), dtype=jnp.float32),
        pixel_count=jnp.zeros((height, width), dtype=jnp.float32),
    )


def sample_luma_sq(sample):
    """Squared luma of one sample's count-normalized pixel estimate (the
    per-pixel variance accumulator's increment)."""
    val = sample["image"] / jnp.maximum(sample["weight"], 1e-6)[..., None]
    luma = jnp.mean(val, axis=-1)
    return luma * luma
