"""ctypes bindings for the native guidance PRM (``native/prm.cpp``).

The library is built with ``g++ -O3 -fPIC -shared`` at first use into
``build/prm/`` at the repository root, named by the hash of the source and
the flags, so an edited source builds anew and an unchanged one is reused.
:func:`available` reports whether the native path can be used; the numpy
implementation in :mod:`.global_guidance` stays the portable backend, and
both produce trajectories in identical formats.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "native" / "prm.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "prm"
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode() + b"\0" + _SRC.read_bytes())
    return _BUILD_DIR / f"libprm_{h.hexdigest()[:16]}.so"


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
    lib.prm_search.restype = ctypes.c_int
    lib.prm_search.argtypes = [
        c_d, c_d, ctypes.c_int,  # start, goals, n_goals
        c_d, c_d, ctypes.c_int, ctypes.c_int,  # obs_trajs, radii, n_obs, n_steps
        ctypes.c_double, ctypes.c_int,  # dt, n_grid
        ctypes.c_int, ctypes.c_uint64, ctypes.c_double,  # n_samples, seed, vmax
        ctypes.c_double, ctypes.c_double,  # length_weight, pass_threshold
        ctypes.c_int, ctypes.c_int,  # max_paths_enum, n_out
        c_d, c_d, c_d,  # out_paths, out_sigs, out_costs
    ]
    lib.h_signature_batch.restype = None
    lib.h_signature_batch.argtypes = [
        c_d, ctypes.c_int, ctypes.c_int,  # paths, P, K
        c_d, ctypes.c_int, ctypes.c_int,  # obs, n_obs, T
        ctypes.c_double, c_d,  # dt, out
    ]
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def prm_search(start, goals, obstacle_trajs, obstacle_radii, dt: float,
               n_grid: int, n_samples: int, seed: int, max_velocity: float,
               length_weight: float, pass_threshold: float,
               max_paths_enum: int, n_out: int):
    """Run the native search. goals: (n_goals, 3) [x, y, cost]. Returns
    (paths (k, n_grid, 2), sigs (k, n_obs), costs (k,)) with k <= n_out."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native PRM library could not be built")

    start = np.ascontiguousarray(start, dtype=np.float64)
    goals = np.ascontiguousarray(goals, dtype=np.float64)
    obs = np.ascontiguousarray(obstacle_trajs, dtype=np.float64)
    radii = np.ascontiguousarray(obstacle_radii, dtype=np.float64)
    n_obs = obs.shape[0] if obs.size else 0
    n_steps = obs.shape[1] if obs.size else 1
    if n_obs == 0:
        obs = np.zeros((1, 1, 2))
        radii = np.zeros(1)

    out_paths = np.zeros((n_out, n_grid, 2), dtype=np.float64)
    out_sigs = np.zeros((n_out, max(n_obs, 1)), dtype=np.float64)
    out_costs = np.zeros(n_out, dtype=np.float64)
    k = lib.prm_search(
        _ptr(start), _ptr(goals), goals.shape[0],
        _ptr(obs), _ptr(radii), n_obs, n_steps,
        ctypes.c_double(dt), n_grid, n_samples, ctypes.c_uint64(seed),
        ctypes.c_double(max_velocity), ctypes.c_double(length_weight),
        ctypes.c_double(pass_threshold), max_paths_enum, n_out,
        _ptr(out_paths), _ptr(out_sigs), _ptr(out_costs))
    return out_paths[:k], out_sigs[:k, :n_obs], out_costs[:k]


def h_signature_batch(paths, obstacle_trajs, dt: float) -> np.ndarray:
    """Native batched H-signature (``native/prm.cpp::h_signature_batch``).

    paths: (P, K, 2); obstacle_trajs: (n_obs, T, 2). Returns (P, n_obs);
    raises when the native library cannot be built."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native PRM library could not be built")
    paths = np.ascontiguousarray(paths, dtype=np.float64)
    obs = np.ascontiguousarray(obstacle_trajs, dtype=np.float64)
    P, K = paths.shape[0], paths.shape[1]
    n_obs, T = obs.shape[0], obs.shape[1]
    out = np.zeros((P, n_obs), dtype=np.float64)
    if P == 0 or n_obs == 0:
        return out
    lib.h_signature_batch(_ptr(paths), P, K, _ptr(obs), n_obs, T,
                          ctypes.c_double(dt), _ptr(out))
    return out
