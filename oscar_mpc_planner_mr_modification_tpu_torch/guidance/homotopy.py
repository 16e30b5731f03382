"""Homotopy classification of space-time trajectories around dynamic obstacles.

Counterpart of the JAX package's ``guidance/homotopy.py`` (the external
``guidance_planner``'s homology machinery: ``FindTopologyClassForPath`` and
the Homology / Winding comparison functions). Two formulations:

- *winding*: for each dynamic obstacle, the total winding angle of the
  trajectory around the obstacle's space-time trajectory (both on the same
  time grid). Passing an obstacle on the other side moves it by about +-pi;
  trajectories of one homotopy class have nearly equal winding vectors;
- *H-signature* (homology) in (x, y, t), computed natively
  (:mod:`.cpp_backend`) or with numpy, as the caller names it.

The functions are host numpy, vectorized over paths, but for
:func:`torch_signature_vector`, the winding vector on tensors for
classification on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def winding_signature(path_xy: np.ndarray, obstacle_xy: np.ndarray) -> float:
    """Total signed winding angle of path around one obstacle trajectory.

    path_xy, obstacle_xy: (T, 2) sampled on the same time grid.
    """
    rel = path_xy - obstacle_xy
    ang = np.arctan2(rel[:, 1], rel[:, 0])
    d = np.diff(ang)
    d = np.mod(d + np.pi, 2.0 * np.pi) - np.pi  # wrap increments to (-pi, pi]
    return float(np.sum(d))


def signature_vector(path_xy: np.ndarray, obstacle_trajs: np.ndarray) -> np.ndarray:
    """(n_obstacles,) winding vector. obstacle_trajs: (n_obs, T, 2)."""
    if len(obstacle_trajs) == 0:
        return np.zeros(0)
    rel = path_xy[None, :, :] - obstacle_trajs  # (n_obs, T, 2)
    ang = np.arctan2(rel[..., 1], rel[..., 0])
    d = np.diff(ang, axis=1)
    d = np.mod(d + np.pi, 2.0 * np.pi) - np.pi
    return np.sum(d, axis=1)


def signature_batch(paths_xy: np.ndarray, obstacle_trajs: np.ndarray) -> np.ndarray:
    """Winding vectors for a BATCH of paths in one vectorized pass.

    paths_xy: (P, T, 2); obstacle_trajs: (n_obs, T, 2). Returns (P, n_obs).
    The guidance planner classifies every candidate + the previous cycle's
    representatives each control tick; batching keeps that off the tick's
    host critical path (p99 latency gate)."""
    paths_xy = np.asarray(paths_xy, dtype=float)
    P = paths_xy.shape[0]
    if len(obstacle_trajs) == 0:
        return np.zeros((P, 0))
    rel = paths_xy[:, None, :, :] - obstacle_trajs[None]  # (P, n_obs, T, 2)
    ang = np.arctan2(rel[..., 1], rel[..., 0])
    d = np.diff(ang, axis=2)
    d = np.mod(d + np.pi, 2.0 * np.pi) - np.pi
    return np.sum(d, axis=2)


def same_homotopy_class(sig_a: np.ndarray, sig_b: np.ndarray,
                        threshold: float = np.pi) -> bool:
    """Two trajectories are homotopy-equivalent iff their winding vectors agree to
    within ``threshold`` for every obstacle (passing side unchanged)."""
    if len(sig_a) == 0:
        return True
    return bool(np.all(np.abs(np.asarray(sig_a) - np.asarray(sig_b)) < threshold))


def h_signature_vector(path_xy: np.ndarray, obstacle_trajs: np.ndarray,
                       dt: float = 1.0, backend: str = "cpp") -> np.ndarray:
    """H-signature (Bhattacharya-style homology invariant) in (x, y, t).

    The guidance_planner's default comparison function ("Homology",
    config/guidance_planner.yaml:12). Each obstacle's space-time trajectory is
    a skeleton curve in 3D (extended to +-infinity in time at its endpoints so
    the curve is topologically a line); the signature is the line integral
    along the robot's space-time trajectory of the Biot-Savart field of that
    skeleton (unit current, closed form per straight segment). For two
    trajectories sharing endpoints the signature difference is the LINKING
    NUMBER of their closed loop with the skeleton: 0 for homotopic
    trajectories, +-1 when they pass the obstacle on different sides —
    threshold at 0.5 (:data:`H_CLASS_THRESHOLD`).

    path_xy: (K, 2); obstacle_trajs: (n_obs, T, 2); both on the same dt grid.
    ``backend`` as :func:`h_signature_batch` takes it.
    """
    return h_signature_batch(np.asarray(path_xy, dtype=float)[None],
                             obstacle_trajs, dt=dt, backend=backend)[0]


def h_signature_batch(paths_xy: np.ndarray, obstacle_trajs: np.ndarray,
                      dt: float = 1.0, backend: str = "cpp") -> np.ndarray:
    """H-signatures for a BATCH of paths in one vectorized pass.

    paths_xy: (P, K, 2); obstacle_trajs: (n_obs, T, 2). Returns (P, n_obs).
    Same Biot-Savart closed form as :func:`h_signature_vector` with the
    obstacle-skeleton geometry computed once and broadcast over paths — the
    per-tick classification work (candidates + previous-cycle representatives
    + the unguided winner) is a handful of milliseconds per call unbatched,
    which is real money against the 33 ms p99 tick gate.

    ``backend``: ``"cpp"`` runs ``native/prm.cpp::h_signature_batch``
    (ctypes; the numpy broadcast costs ~1.5 ms/call in op overhead on these
    tiny shapes) and raises when its library cannot be built; ``"python"``
    runs :func:`h_signature_batch_numpy`. The same math: parity pinned by
    tests/test_torch_tick_host.py."""
    paths_xy = np.asarray(paths_xy, dtype=float)
    if backend not in ("cpp", "python"):
        raise ValueError(f"backend {backend!r} is neither 'cpp' nor 'python'")
    if len(obstacle_trajs) == 0:
        return np.zeros((paths_xy.shape[0], 0))
    if backend == "python":
        return h_signature_batch_numpy(paths_xy, obstacle_trajs, dt)
    from . import cpp_backend

    return cpp_backend.h_signature_batch(paths_xy, obstacle_trajs, dt)


def h_signature_batch_numpy(paths_xy: np.ndarray, obstacle_trajs: np.ndarray,
                            dt: float = 1.0) -> np.ndarray:
    """Portable numpy implementation of :func:`h_signature_batch` (its
    ``"python"`` backend; also the parity oracle)."""
    paths_xy = np.asarray(paths_xy, dtype=float)
    P, K = paths_xy.shape[0], paths_xy.shape[1]
    n_obs = len(obstacle_trajs)
    if n_obs == 0:
        return np.zeros((P, 0))
    tp = np.arange(K) * dt
    pts = np.concatenate(
        [paths_xy, np.broadcast_to(tp[None, :, None], (P, K, 1))],
        axis=2)  # (P, K, 3)
    mids = 0.5 * (pts[:, 1:] + pts[:, :-1])  # (P, K-1, 3)
    dls = pts[:, 1:] - pts[:, :-1]
    T = obstacle_trajs.shape[1]
    to = np.arange(T) * dt
    t_extend = 1e3 * max(dt * max(K, T), 1.0)

    # Obstacle skeletons, extended to +-inf in time at the endpoints
    S = np.concatenate(
        [obstacle_trajs, np.broadcast_to(to[None, :, None], (n_obs, T, 1))],
        axis=2)  # (n_obs, T, 3)
    S = np.concatenate([S[:, :1] - [0.0, 0.0, t_extend], S,
                        S[:, -1:] + [0.0, 0.0, t_extend]], axis=1)
    a, b = S[:, :-1], S[:, 1:]  # (n_obs, M, 3) segment endpoints
    d = b - a
    L = np.linalg.norm(d, axis=-1, keepdims=True)
    dhat = d / np.maximum(L, 1e-12)  # (n_obs, M, 3)

    r_a = mids[:, :, None, None, :] - a[None, None]  # (P, K-1, n_obs, M, 3)
    r_b = mids[:, :, None, None, :] - b[None, None]
    dh = dhat[None, None]  # (1, 1, n_obs, M, 3)
    cross = np.cross(np.broadcast_to(dh, r_a.shape), r_a)
    rho2 = np.maximum(np.sum(cross**2, axis=-1), 1e-12)
    cos_a = (np.sum(dh * r_a, axis=-1)
             / np.maximum(np.linalg.norm(r_a, axis=-1), 1e-12))
    cos_b = (np.sum(dh * r_b, axis=-1)
             / np.maximum(np.linalg.norm(r_b, axis=-1), 1e-12))
    B = cross / rho2[..., None] * (cos_a - cos_b)[..., None]
    # Sum the field over skeleton segments, dot with dl, sum along the path
    return np.einsum("pkoc,pkc->po", B.sum(axis=3), dls) / (4.0 * np.pi)


#: Class threshold for H-signatures: homotopic trajectories differ by ~0,
#: side flips by ~±1 (integer linking numbers).
H_CLASS_THRESHOLD = 0.5


def make_comparator(comparison_function: str, dt: float,
                    pass_threshold: float, backend: str = "cpp"):
    """Comparator factory matching guidance_planner's ``comparison_function``
    option (Homology | Winding | UVD, config/guidance_planner.yaml:12-16).

    Returns ``(signature_fn(path, obstacle_trajs) -> vector, threshold)``.
    UVD is not signature-based (it compares trajectory PAIRS, see
    :func:`uvd_equivalent`) and is rejected here; the two signature
    comparators agree whenever passing sides are clear-cut and differ only on
    marginal geometry. ``backend`` names the H-signature's implementation
    (:func:`h_signature_batch`); the winding comparator is numpy."""
    sig, _batch, thr = make_comparators(comparison_function, dt,
                                        pass_threshold, backend)
    return sig, thr


def make_comparators(comparison_function: str, dt: float,
                     pass_threshold: float, backend: str = "cpp"):
    """:func:`make_comparator` plus the batched variant: returns
    ``(signature_fn, signature_batch_fn, threshold)`` where
    ``signature_batch_fn(paths (P, K, 2), obstacle_trajs) -> (P, n_obs)``
    classifies all paths in one vectorized pass (the per-tick host budget of
    the runtime planner)."""
    if comparison_function.lower() == "winding":
        return signature_vector, signature_batch, pass_threshold
    if comparison_function.lower() in ("homology", "h", "h_signature"):
        return (lambda path, trajs: h_signature_vector(path, trajs, dt=dt,
                                                       backend=backend),
                lambda paths, trajs: h_signature_batch(paths, trajs, dt=dt,
                                                       backend=backend),
                H_CLASS_THRESHOLD)
    raise ValueError(
        f"unsupported comparison_function {comparison_function!r}; use "
        "'Winding' or 'Homology' (UVD is pairwise: guidance.homotopy."
        "uvd_equivalent)")


def uvd_equivalent(path_a: np.ndarray, path_b: np.ndarray,
                   obstacle_trajs: np.ndarray, margins) -> bool:
    """Uniform Visibility Deformation equivalence (the third guidance_planner
    comparator): two same-grid trajectories are UVD-equivalent iff for every
    time k the straight segment between a_k and b_k stays outside every
    obstacle disc at time k (the linear homotopy between them is
    collision-free)."""
    n = min(len(path_a), len(path_b))
    if len(obstacle_trajs) == 0:
        return True
    margins = np.broadcast_to(np.asarray(margins, dtype=float),
                              (len(obstacle_trajs),))
    a = np.asarray(path_a[:n])
    b = np.asarray(path_b[:n])
    obs = np.asarray(obstacle_trajs)[:, :n]  # (n_obs, n, 2)
    seg = b - a  # (n, 2)
    rel = obs - a[None]  # (n_obs, n, 2)
    denom = np.maximum(np.sum(seg * seg, axis=-1), 1e-12)  # (n,)
    tproj = np.clip(np.sum(rel * seg[None], axis=-1) / denom, 0.0, 1.0)
    closest = a[None] + tproj[..., None] * seg[None]  # (n_obs, n, 2)
    dist = np.linalg.norm(obs - closest, axis=-1)  # (n_obs, n)
    return bool(np.all(dist >= margins[:, None]))


def torch_signature_vector(paths_xy: torch.Tensor,
                           obstacle_trajs: torch.Tensor) -> torch.Tensor:
    """Winding vectors on tensors, over any leading batch of paths:
    paths_xy (..., T, 2) against obstacle_trajs (n_obs, T, 2) -> (...,
    n_obs). The increments wrap with ``torch.remainder``, which takes the
    divisor's sign as numpy's and JAX's ``mod`` do."""
    rel = paths_xy[..., None, :, :] - obstacle_trajs  # (..., n_obs, T, 2)
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    d = torch.diff(ang, dim=-1)
    d = torch.remainder(d + math.pi, 2.0 * math.pi) - math.pi
    return torch.sum(d, dim=-1)
