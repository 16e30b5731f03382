"""ctypes bindings for the native free-space decomposition
(``native/decomp.cpp``), the counterpart of :mod:`.decomp`'s numpy
``EllipsoidDecomp2D``.

The library is built with ``g++ -O3 -fPIC -shared`` at first use into
``build/decomp/`` at the repository root, named by the hash of the source and
the flags, as ``guidance/cpp_backend.py`` builds ``native/prm.cpp``: an
edited source builds anew and an unchanged one is reused. :func:`available`
reports whether it builds and loads.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "decomp.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "decomp"
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode() + b"\0" + _SRC.read_bytes())
    return _BUILD_DIR / f"libdecomp_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, out)  # a fresh inode: a mapped older copy stays intact
    return True


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built if needed; None when it cannot be built."""
    out = library_path()
    if not out.is_file() and not _build(out):
        return None
    lib = ctypes.CDLL(str(out))
    c_d = ctypes.POINTER(ctypes.c_double)
    lib.decomp_dilate_path.restype = ctypes.c_int
    lib.decomp_dilate_path.argtypes = [
        c_d, ctypes.c_int,  # path, n_pts
        c_d, ctypes.c_int,  # obstacles, n_obs
        ctypes.c_double, ctypes.c_int,  # local_range, max_constraints
        c_d, c_d, ctypes.POINTER(ctypes.c_int),  # out_a, out_b, out_counts
    ]
    return lib


def available() -> bool:
    return _load() is not None


def dilate_path(path: np.ndarray, obstacles: np.ndarray, local_range: float,
                max_constraints: int) -> List[List[Tuple[np.ndarray, float]]]:
    """Native counterpart of ``EllipsoidDecomp2D.dilate_path``. Raises
    ``RuntimeError`` when the library is unavailable or the call fails."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native decomposition ({_SRC.name}) does not "
                           f"build")
    path = np.ascontiguousarray(path, dtype=np.float64)
    obstacles = np.ascontiguousarray(
        obstacles if len(obstacles) else np.zeros((0, 2)), dtype=np.float64)
    n_pts = path.shape[0]
    out_a = np.zeros((n_pts * max_constraints * 2,), dtype=np.float64)
    out_b = np.zeros((n_pts * max_constraints,), dtype=np.float64)
    out_counts = np.zeros((n_pts,), dtype=np.int32)
    c_d = ctypes.POINTER(ctypes.c_double)
    rc = lib.decomp_dilate_path(
        path.ctypes.data_as(c_d), n_pts,
        obstacles.ctypes.data_as(c_d), obstacles.shape[0],
        float(local_range), int(max_constraints),
        out_a.ctypes.data_as(c_d), out_b.ctypes.data_as(c_d),
        out_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if rc != 0:
        raise RuntimeError(f"decomp_dilate_path failed with {rc}")
    A = out_a.reshape(n_pts, max_constraints, 2)
    Bv = out_b.reshape(n_pts, max_constraints)
    return [[(A[k, j].copy(), float(Bv[k, j]))
             for j in range(int(out_counts[k]))] for k in range(n_pts)]
