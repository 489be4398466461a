"""Device-mesh utilities for multi-chip rendering.

The reference is single-process/single-GPU (SURVEY §2.3); this build's
scaling model is:

  * **Pixel-wavefront data parallelism** (the one axis rendering needs):
    the [N]-ray wavefront is sharded over a 1-D ``tiles`` mesh axis;
    scene tables (BVH, triangles, materials) replicate.  The whole render
    program is jitted with sharding constraints and GSPMD inserts the
    collectives: an all-reduce for the t=1 light-splat image (splats land
    on any chip's pixels) and halo exchanges for the 3x3 reconstruction
    filter at tile borders — the hand-written ppermute rings of a
    NCCL-style design fall out of the compiler here.
  * **Frame parallelism** across hosts for animation: frames are
    embarrassingly parallel (reference movie.py renders them strictly
    serially); apps/movie.py shards them with --frame-stride/offset.

``make_tile_mesh`` builds the mesh; pass it to ``Renderer(scene,
mesh=...)`` or ``integrator.render.make_sharded_render``.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_tile_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the pixel-tile axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("tiles",))


def tile_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Sharding for a wavefront array: leading dim over tiles, rest
    replicated."""
    return NamedSharding(mesh, P(*(("tiles",) + (None,) * (ndim - 1))))
