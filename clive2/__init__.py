"""clive2: a bidirectional path tracer in JAX.

Ground-up JAX/XLA rebuild of pmclaugh/Clive2 (a Metal BDPT renderer):
Veach-style bidirectional path tracing with balance-heuristic MIS, GGX
microfacet reflection + transmission, SAH BVH with threaded stackless
traversal, physical camera-plane model, 3x3 Gaussian reconstruction and
Reinhard tone mapping — expressed as batched SoA wavefront ops under one
jitted program per sample, sharded over device meshes for multi-device.
"""

import hashlib as _hashlib
import os as _os

import jax as _jax

DEFAULT_CACHE_DIR = _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..", ".jax_cache"))


def _cpu_flags_tag() -> str:
    """Short hash of this host's CPU feature flags: XLA:CPU cache entries
    are machine code for the host that compiled them."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return _hashlib.sha256(line.encode()).hexdigest()[:12]
    except OSError:
        pass
    return "unknown"


def compile_cache_dir(environ=None):
    """Where the persistent compilation cache goes, or None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then reads it itself and the
    package sets nothing).  Otherwise a fixed path in the checkout; CPU-only
    processes get a subdirectory per host CPU type under it."""
    environ = _os.environ if environ is None else environ
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu":
        return _os.path.join(DEFAULT_CACHE_DIR, "cpu-" + _cpu_flags_tag())
    return DEFAULT_CACHE_DIR


_cache = compile_cache_dir()
if _cache is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache)

from .camera import Camera, tone_map  # noqa: F401,E402
from .materials import MaterialTable, default_materials  # noqa: F401,E402
from .renderer import Renderer  # noqa: F401,E402
from .scene import (  # noqa: F401,E402
    Scene,
    create_scene,
    create_scene_from_preset,
    create_scene_from_preset_with_params,
    scene_presets,
)

__version__ = "0.1.0"
