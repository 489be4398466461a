"""Profiling and tracing utilities.

The reference's only observability is a wall-clock decorator on every
pipeline stage (reference constants.py:39-49, applied at renderer.py:89-280)
plus ad-hoc prints.  This build keeps a ``timed`` parity decorator
(clive2.constants.timed) and adds:

  * ``stage_timer`` — wall-clock context manager that blocks on device
    completion, so timings mean what they say under async dispatch;
  * ``trace_to`` — jax.profiler trace context (view in TensorBoard /
    xprof) for op-level breakdowns;
  * ``device_memory_stats`` — live device-memory use per device.
"""

from __future__ import annotations

import contextlib
import time

import jax

from ..constants import timed  # noqa: F401  (re-export, parity with reference)


@contextlib.contextmanager
def stage_timer(name: str, result_holder: dict | None = None, sync=None):
    """Time a pipeline stage; blocks until ``sync`` (or all devices) is
    ready before reading the clock."""
    t0 = time.perf_counter()
    yield
    if sync is not None:
        jax.block_until_ready(sync)
    else:
        for d in jax.devices():
            try:
                d.synchronize_all_activity()  # pragma: no cover
            except Exception:
                break
    dt = time.perf_counter() - t0
    if result_holder is not None:
        result_holder[name] = result_holder.get(name, 0.0) + dt
    else:
        print(f"[stage {name}] {dt:.4f}s")


@contextlib.contextmanager
def trace_to(logdir: str):
    """Capture a jax.profiler trace for the enclosed region."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory_stats():
    """Per-device memory stats dicts (empty on backends without support)."""
    stats = {}
    for d in jax.devices():
        try:
            stats[str(d)] = d.memory_stats()
        except Exception:
            stats[str(d)] = {}
    return stats
