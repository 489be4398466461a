"""Render orchestrator: progressive accumulation, images, checkpointing.

Rebuild of the reference ``Renderer`` (reference src/renderer.py:16-352)
minus what a jitted wavefront program doesn't need: there are no 25
manually released buffers, no bitonic-sort driver, no mid-frame readback.  One jitted program
per sample; accumulators live on device and are pulled to host only for
display/save.  Adds sample-level checkpoint/resume (the reference has none —
SURVEY §5).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .camera import tone_map
from .constants import MAX_BOUNCES, timed
from .integrator.render import (
    init_accumulators,
    render_sample,
    render_sample_subset,
    sample_luma_sq,
)
from .scene import Scene


def _replicated(state, mesh):
    """Accumulators live replicated over the mesh, in and out of every
    step, so the second step reuses the first one's executable."""
    if mesh is None:
        return state
    return jax.lax.with_sharding_constraint(state, NamedSharding(mesh, P()))


@functools.lru_cache(maxsize=16)
def _make_step(width: int, height: int, max_bounces: int, mesh):
    """Module-level jit cache: renderers with the same image geometry share
    one compiled program.  The reference recompiles its Metal kernels for
    every movie frame (movie.py:31-38); here frame N+1 reuses frame N's
    executable as long as shapes match."""

    @functools.partial(jax.jit, donate_argnums=(2,))
    def _step(key, sample_idx, state, scene_data):
        # fold_in traced INSIDE the step: an eager per-sample fold_in costs
        # a full host dispatch (~30 ms measured) — here it fuses to nothing
        sample = render_sample(
            jax.random.fold_in(key, sample_idx),
            scene_data, width, height, max_bounces, mesh=mesh,
        )
        return _replicated(dict(
            summed_image=state["summed_image"] + sample["image"],
            summed_weight=state["summed_weight"] + sample["weight"],
            summed_unidirectional=state["summed_unidirectional"]
            + sample["unidirectional"],
            n_samples=state["n_samples"] + 1,
            summed_sq=state["summed_sq"] + sample_luma_sq(sample),
            pixel_count=state["pixel_count"] + 1.0,
        ), mesh), sample["n_rays"]

    return _step


def _adaptive_scores(state):
    """Per-pixel selection score from the accumulated statistics:
    variance OF THE MEAN, relativized (dark pixels matter less)."""
    n = state["pixel_count"]
    # display estimate is weight-normalized; use it where weights exist
    disp = state["summed_image"].mean(axis=-1) / jnp.maximum(
        state["summed_weight"], 1e-6
    )
    ex2 = state["summed_sq"] / jnp.maximum(n, 1.0)
    var = jnp.maximum(ex2 - disp * disp, 0.0)
    return (var / jnp.maximum(n, 1.0) / (disp * disp + 1e-4)).reshape(-1)


@functools.lru_cache(maxsize=16)
def _make_step_adaptive(width: int, height: int, n_select: int,
                        max_bounces: int):
    """Adaptive sample step: renders only the ``n_select`` highest-variance
    pixels (reference scaffolds identity bins, renderer.py:92 — this is the
    real thing).  Selection happens on-device from the accumulated
    variance statistics; one compiled program per (shape, n_select)."""

    @functools.partial(jax.jit, donate_argnums=(2,))
    def _step(key, sample_idx, state, scene_data):
        _, sel = jax.lax.top_k(_adaptive_scores(state), n_select)
        sel = sel.astype(jnp.int32)

        sample = render_sample_subset(
            jax.random.fold_in(key, sample_idx), scene_data, sel,
            width, height, max_bounces,
        )
        return dict(
            summed_image=state["summed_image"] + sample["image"],
            summed_weight=state["summed_weight"] + sample["weight"],
            summed_unidirectional=state["summed_unidirectional"]
            + sample["unidirectional"],
            n_samples=state["n_samples"] + 1,
            summed_sq=state["summed_sq"] + sample_luma_sq(sample),
            pixel_count=state["pixel_count"] + sample["uni_count"],
        ), sample["n_rays"]

    return _step


@functools.lru_cache(maxsize=16)
def _make_adaptive_select(width: int, height: int, n_select: int):
    @jax.jit
    def _select(state):
        _, sel = jax.lax.top_k(_adaptive_scores(state), n_select)
        return sel.astype(jnp.int32)

    return _select


@functools.lru_cache(maxsize=32)
def _make_adaptive_batch(width: int, height: int, batch: int,
                         max_bounces: int):
    """One batch of an adaptive sample on a CHUNKED renderer (adaptive x
    chunked composition): the selected pixel set is rendered in slices
    sized like the row stripes, each its own device program.  The batch index folds
    into the key so batches draw independent streams."""

    @jax.jit
    def _run(key, sample_idx, batch_idx, sel_batch, scene_data):
        k = jax.random.fold_in(
            jax.random.fold_in(key, sample_idx), batch_idx
        )
        return render_sample_subset(k, scene_data, sel_batch,
                                    width, height, max_bounces)

    return _run


@functools.lru_cache(maxsize=16)
def _make_step_chunked(width: int, height: int, chunk_rows: int,
                       max_bounces: int, mesh):
    """Striped sample step: the frame renders in row stripes of
    ``chunk_rows`` so path arrays stay ~chunk-sized in device memory — a
    4K frame no longer materializes 8M-ray wavefronts.  row0 is a traced
    argument, so every stripe reuses ONE compiled program."""

    @functools.partial(jax.jit, donate_argnums=(3,))
    def _stripe(key, sample_idx, row0, state, scene_data):
        k = jax.random.fold_in(jax.random.fold_in(key, sample_idx), row0)
        sample = render_sample(
            k, scene_data, width, height, max_bounces, mesh=mesh,
            row0=row0, rows=chunk_rows,
        )
        last = row0 >= height - chunk_rows
        stripe_rows = (
            (jnp.arange(height) >= row0) & (jnp.arange(height)
                                            < row0 + chunk_rows)
        ).astype(jnp.float32)[:, None]
        return _replicated(dict(
            summed_image=state["summed_image"] + sample["image"],
            summed_weight=state["summed_weight"] + sample["weight"],
            summed_unidirectional=state["summed_unidirectional"]
            + sample["unidirectional"],
            n_samples=state["n_samples"] + last.astype(jnp.int32),
            summed_sq=state["summed_sq"] + sample_luma_sq(sample),
            pixel_count=state["pixel_count"]
            + jnp.broadcast_to(stripe_rows, state["pixel_count"].shape),
        ), mesh), sample["n_rays"]

    return _stripe


# device memory one pixel's sample program needs at its peak (path
# vertices, the [P, N] connection cast, the traversal's temporaries):
# compiled.memory_analysis() of the sponza 1920x1080 step on an H100 gives
# 7.39 GB of temporaries, 3.6 KB per pixel
SAMPLE_BYTES_PER_PIXEL = 4 * 1024

# ray counts the Renderer keeps as device scalars before it sums the older
# half on the host (a Python int: a long render passes 2**31 rays)
RAY_COUNTS_KEPT = 256


def _auto_chunk_rows(width: int, height: int, limit_bytes=None):
    """Row-stripe height for frames whose one-program sample would not fit
    the device: the largest divisor of ``height`` whose stripe stays under
    80% of the device's memory limit, or None when the whole frame fits
    (or the backend reports no limit, as the CPU does)."""
    if limit_bytes is None:
        limit_bytes = (jax.devices()[0].memory_stats() or {}).get(
            "bytes_limit")
    if not limit_bytes:
        return None
    max_rows = int(0.8 * limit_bytes // (SAMPLE_BYTES_PER_PIXEL * width))
    if max_rows >= height:
        return None
    for r in range(max(min(max_rows, height), 1), 0, -1):
        if height % r == 0:
            return r
    return 1


class Renderer:
    def __init__(self, scene: Scene, seed: int = 0,
                 max_bounces: int = MAX_BOUNCES, mesh=None,
                 chunk_rows: int = None):
        """``mesh``: shard the pixel wavefront over the mesh's ``tiles``
        axis (scene tables replicate).  ``chunk_rows``: render each
        sample in row stripes of this height; by default only frames too
        large for device memory are striped."""
        if mesh is not None:
            scene = dataclasses.replace(scene, data=jax.device_put(
                scene.data, NamedSharding(mesh, P())))
        self.scene = scene
        self.width = scene.pixel_width
        self.height = scene.pixel_height
        self.max_bounces = max_bounces
        self.mesh = mesh
        self.key = jax.random.key(seed)
        self.samples = 0
        self._ray_counts = []     # newest programs' ray counts, on device
        self._rays_folded = 0     # older programs' ray counts, summed
        self.state = self._place(init_accumulators(self.width, self.height))
        if chunk_rows is None:
            chunk_rows = _auto_chunk_rows(self.width, self.height)
        if chunk_rows is not None and chunk_rows >= self.height:
            chunk_rows = None
        self.chunk_rows = chunk_rows
        if chunk_rows is None:
            self._step = _make_step(self.width, self.height, max_bounces,
                                    mesh)
        else:
            if self.height % chunk_rows:
                raise ValueError(
                    f"chunk_rows ({chunk_rows}) must divide the image "
                    f"height ({self.height})"
                )
            self._step = _make_step_chunked(
                self.width, self.height, chunk_rows, max_bounces, mesh
            )

    def _place(self, state):
        """Accumulators replicated over the mesh, as the steps keep them."""
        if self.mesh is None:
            return state
        return jax.device_put(state, NamedSharding(self.mesh, P()))

    @timed
    def run_sample(self):
        """One progressive BDPT sample over every pixel
        (reference renderer.py:280-291); chunked renderers sweep the frame
        in row stripes with one compiled program."""
        idx = jnp.uint32(self.samples)
        if self.chunk_rows is None:
            self.state, n_rays = self._step(self.key, idx, self.state,
                                            self.scene.data)
            self._count_rays(n_rays)
        else:
            for row0 in range(0, self.height, self.chunk_rows):
                self.state, n_rays = self._step(
                    self.key, idx, jnp.int32(row0), self.state,
                    self.scene.data)
                self._count_rays(n_rays)
        self.samples += 1

    @timed
    def run_adaptive_sample(self, fraction: float = 0.25):
        """One BDPT sample for only the highest-variance ``fraction`` of
        pixels (selected on-device from the accumulated per-pixel variance
        statistics).  Run a few uniform warmup samples first so the
        variance estimates exist.  Unbiased: the display normalization is
        weight-based, and the unidirectional image divides by per-pixel
        counts.

        Composes with chunked rendering: on a chunked renderer the
        selected pixels render in batches of chunk_rows*width (the same
        program size as the stripes), accumulated exactly like stripes
        are."""
        n_select = max(1, int(self.width * self.height * fraction))
        if self.chunk_rows is None:
            step = _make_step_adaptive(self.width, self.height, n_select,
                                       self.max_bounces)
            self.state, n_rays = step(self.key, jnp.uint32(self.samples),
                                      self.state, self.scene.data)
            self._count_rays(n_rays)
            self.samples += 1
            return

        batch = self.chunk_rows * self.width
        sel = _make_adaptive_select(self.width, self.height, n_select)(
            self.state
        )
        outs = None
        for i, b0 in enumerate(range(0, n_select, batch)):
            m = min(batch, n_select - b0)
            run = _make_adaptive_batch(self.width, self.height, m,
                                       self.max_bounces)
            sample = run(self.key, jnp.uint32(self.samples),
                         jnp.uint32(i), sel[b0:b0 + m], self.scene.data)
            self._count_rays(sample["n_rays"])
            outs = sample if outs is None else jax.tree.map(
                lambda a, b: a + b, outs, sample)
        # top_k indices are distinct, so batches touch disjoint pixels and
        # the summed tree has the same per-pixel stats a single program
        # would produce
        self.state = dict(
            summed_image=self.state["summed_image"] + outs["image"],
            summed_weight=self.state["summed_weight"] + outs["weight"],
            summed_unidirectional=self.state["summed_unidirectional"]
            + outs["unidirectional"],
            n_samples=self.state["n_samples"] + 1,
            summed_sq=self.state["summed_sq"] + sample_luma_sq(outs),
            pixel_count=self.state["pixel_count"] + outs["uni_count"],
        )
        self.samples += 1

    def _count_rays(self, n_rays):
        """Keep a program's ray count without waiting for the program: the
        count stays a device scalar until RAY_COUNTS_KEPT have gathered,
        then the older half (long finished) is summed on the host."""
        self._ray_counts.append(n_rays)
        if len(self._ray_counts) >= RAY_COUNTS_KEPT:
            half = RAY_COUNTS_KEPT // 2
            old, self._ray_counts = (self._ray_counts[:half],
                                     self._ray_counts[half:])
            self._rays_folded += sum(int(n) for n in jax.device_get(old))

    def block(self):
        jax.block_until_ready(self.state)

    @property
    def rays_traced(self) -> int:
        """Rays cast by the samples this renderer has run (every
        traversal: subpath extensions plus connection casts)."""
        return self._rays_folded + sum(
            int(n) for n in jax.device_get(self._ray_counts))

    # ---- images (reference renderer.py:293-316) ---------------------------

    @property
    def raw_image(self) -> np.ndarray:
        img = np.asarray(self.state["summed_image"])
        w = np.asarray(self.state["summed_weight"])[..., None]
        with np.errstate(divide="ignore", invalid="ignore"):  # 0/0 -> 0
            return np.nan_to_num(img / w, nan=0, posinf=0, neginf=0)

    @property
    def image(self) -> np.ndarray:
        return tone_map(self.raw_image, exposure=4.0)

    @property
    def unweighted_image(self) -> np.ndarray:
        img = np.asarray(self.state["summed_image"])
        return tone_map(np.nan_to_num(img, posinf=0, neginf=0), exposure=4.0)

    @property
    def raw_unidirectional(self) -> np.ndarray:
        img = np.asarray(self.state["summed_unidirectional"])
        n = np.maximum(np.asarray(self.state["pixel_count"]), 1.0)[..., None]
        return np.nan_to_num(img / n, posinf=0, neginf=0)

    @property
    def unidirectional_image(self) -> np.ndarray:
        return tone_map(self.raw_unidirectional, exposure=4.0)

    # ---- checkpoint / resume (new subsystem, SURVEY §5) --------------------

    def save_checkpoint(self, path: str):
        """Accumulators + sample counter; resuming continues the exact RNG
        stream (keys are counter-based fold_ins of the seed key)."""
        import os

        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        np.savez(
            path,
            summed_image=np.asarray(self.state["summed_image"]),
            summed_weight=np.asarray(self.state["summed_weight"]),
            summed_unidirectional=np.asarray(self.state["summed_unidirectional"]),
            n_samples=np.asarray(self.state["n_samples"]),
            summed_sq=np.asarray(self.state["summed_sq"]),
            pixel_count=np.asarray(self.state["pixel_count"]),
            samples=self.samples,
            key_data=jax.random.key_data(self.key),
        )

    def load_checkpoint(self, path: str):
        ckpt = np.load(path)
        hw = (self.height, self.width)
        get = lambda k: (jnp.asarray(ckpt[k]) if k in ckpt
                         else jnp.zeros(hw, jnp.float32))
        self.state = self._place(dict(
            summed_image=jnp.asarray(ckpt["summed_image"]),
            summed_weight=jnp.asarray(ckpt["summed_weight"]),
            summed_unidirectional=jnp.asarray(ckpt["summed_unidirectional"]),
            n_samples=jnp.asarray(ckpt["n_samples"]),
            summed_sq=get("summed_sq"),
            # pre-adaptive checkpoints: every pixel had `samples` samples
            pixel_count=(jnp.asarray(ckpt["pixel_count"])
                         if "pixel_count" in ckpt
                         else jnp.full(hw, float(ckpt["samples"]),
                                       jnp.float32)),
        ))
        self.samples = int(ckpt["samples"])
        self.key = jax.random.wrap_key_data(ckpt["key_data"])
