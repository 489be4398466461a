"""ctypes binding to the native (C++) BVH builder in csrc/bvh_builder.cpp.

The reference keeps its builder host-side in numpy+numba (bvh.py); here the
hot SAH sweep runs in C++.  The library is built from the committed source
on first use, into ``csrc/build/<cpu tag>/`` (gitignored; ``-march=native``
code is only valid on the CPU type that built it).  A failed build is
reported with a warning and the numpy builder is used instead.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import warnings

import numpy as np

_LIB = None
_TRIED = False
STATUS = "not loaded"

_CSRC = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "csrc"))
_SRC = os.path.join(_CSRC, "bvh_builder.cpp")
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")


def library_path() -> str:
    from .. import _cpu_flags_tag

    return os.path.join(_CSRC, "build", _cpu_flags_tag(), "libclive2.so")


def _build(so: str) -> str | None:
    """Compile the library to ``so``; returns an error message or None."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return "no C++ compiler found (set CXX)"
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        r = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, _SRC], timeout=300,
                           capture_output=True, text=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"{cxx} failed: {e}"
    if r.returncode != 0:
        return f"{cxx} exited {r.returncode}: {r.stderr.strip()[-2000:]}"
    os.replace(tmp, so)      # atomic: concurrent builders never see a stub
    return None


def _load():
    global _LIB, _TRIED, STATUS
    if _TRIED:
        return _LIB
    _TRIED = True
    so = library_path()
    if (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(_SRC)):
        err = _build(so)
        if err is not None:
            STATUS = f"build failed, numpy fallback: {err}"
            warnings.warn(f"native BVH builder unavailable ({err}); "
                          "falling back to the numpy builder",
                          RuntimeWarning, stacklevel=3)
            return None
        STATUS = f"built from csrc/ and loaded ({so})"
    else:
        STATUS = f"loaded ({so})"
    lib = ctypes.CDLL(so)
    lib.clive2_build_bvh.restype = ctypes.c_int64
    lib.clive2_build_bvh.argtypes = [
        ctypes.c_int64,                  # n_tris
        np.ctypeslib.ndpointer(np.float32),  # mins [T,3]
        np.ctypeslib.ndpointer(np.float32),  # maxes [T,3]
        ctypes.c_int64,                  # max_members
        # outputs (preallocated worst-case 2T-1 nodes)
        np.ctypeslib.ndpointer(np.float32),  # node_mins
        np.ctypeslib.ndpointer(np.float32),  # node_maxes
        np.ctypeslib.ndpointer(np.int32),    # miss
        np.ctypeslib.ndpointer(np.int32),    # right_child
        np.ctypeslib.ndpointer(np.int32),    # tri_start
        np.ctypeslib.ndpointer(np.int32),    # tri_count
        np.ctypeslib.ndpointer(np.int32),    # leaf_id
        np.ctypeslib.ndpointer(np.int32),    # permutation [T]
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def build_bvh_native(soup, max_members: int):
    from .build import FlatBVH

    lib = _load()
    assert lib is not None
    n = len(soup)
    mins = np.ascontiguousarray(soup.mins, dtype=np.float32)
    maxes = np.ascontiguousarray(soup.maxes, dtype=np.float32)
    cap = max(2 * n, 8)
    node_mins = np.zeros((cap, 3), np.float32)
    node_maxes = np.zeros((cap, 3), np.float32)
    miss = np.zeros(cap, np.int32)
    right_child = np.zeros(cap, np.int32)
    tri_start = np.zeros(cap, np.int32)
    tri_count = np.zeros(cap, np.int32)
    leaf_id = np.zeros(cap, np.int32)
    permutation = np.zeros(max(n, 1), np.int32)

    n_nodes = lib.clive2_build_bvh(
        n, mins, maxes, max_members,
        node_mins, node_maxes, miss, right_child,
        tri_start, tri_count, leaf_id, permutation,
    )
    if n_nodes <= 0:
        raise RuntimeError("native BVH build failed")
    n_nodes = int(n_nodes)
    # native writes miss == n_nodes for terminate already
    return FlatBVH(
        node_mins=node_mins[:n_nodes].copy(),
        node_maxes=node_maxes[:n_nodes].copy(),
        miss=miss[:n_nodes].copy(),
        right_child=right_child[:n_nodes].copy(),
        tri_start=tri_start[:n_nodes].copy(),
        tri_count=tri_count[:n_nodes].copy(),
        leaf_id=leaf_id[:n_nodes].copy(),
        permutation=permutation.copy(),
        n_leaves=int((leaf_id[:n_nodes] >= 0).sum()),
        max_leaf_size=max_members,
    )
