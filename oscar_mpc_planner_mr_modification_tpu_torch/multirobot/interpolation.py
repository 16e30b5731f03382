"""Trajectory interpolation and comparison for multi-robot coordination,
counterpart of the JAX package's ``multirobot/interpolation.py`` (numpy,
the same operations in the same order):

- :func:`collision_mask_gk`: Gaussian-kernel space-time overlap of two
  trajectories;
- :func:`geometric_deviation`: the largest pointwise deviation, read by the
  GEOMETRIC communication trigger;
- :func:`interpolate_trajectory_by_elapsed_time`: shift a stale trajectory
  forward by the elapsed time: drop consumed steps, extrapolate the tail at
  clamped constant velocity and turn rate, blend the fractional remainder.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..utils.math import wrap_angle


def wrap_angle_difference(d):
    return np.mod(d + np.pi, 2.0 * np.pi) - np.pi


def interpolate_angle(a, b, alpha):
    return wrap_angle(a + alpha * wrap_angle_difference(b - a))


def collision_mask_gk(ego: np.ndarray, other: np.ndarray, sigma: float,
                      dt: float = 0.2) -> float:
    """Gaussian-kernel space-time overlap; low = little overlap."""
    n = min(len(ego), len(other))
    if n == 0:
        return 0.0
    d2 = np.sum((ego[:n] - other[:n]) ** 2, axis=1)
    return float(np.sum(np.exp(-d2 / sigma**2)) * dt)


def geometric_deviation(current: np.ndarray, broadcasted: np.ndarray) -> float:
    """Max pointwise deviation between two equally-sized trajectories."""
    if len(current) != len(broadcasted) or len(current) == 0:
        return 0.0
    return float(np.max(np.linalg.norm(current - broadcasted, axis=1)))


def interpolate_trajectory_by_elapsed_time(
        positions: np.ndarray, orientations: np.ndarray, dt: float,
        elapsed: float, control_frequency: float,
        robot_max_velocity: float, robot_max_angular_velocity: float
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Shift a received trajectory forward by ``elapsed`` seconds.

    Returns (positions, orientations) of the same length N, or None when no
    shift is needed / possible (fresh or too-stale data, size mismatch) -
    mirroring the early-outs of the reference implementation.
    """
    N = len(positions)
    if N == 0 or len(orientations) != N:
        return None
    if elapsed < 1.0 / control_frequency:
        return None  # fresh
    k = int(np.floor(elapsed / dt))
    tau = elapsed - k * dt
    alpha = tau / dt
    if k >= N:
        return None  # too stale
    if k == 0 and alpha < 0.01:
        return None
    if N < 2:
        return None

    pos = np.asarray(positions, dtype=float)
    ori = np.asarray(orientations, dtype=float)

    # Tail extrapolation at clamped constant velocity / turn rate
    v = (pos[-1] - pos[-2]) / dt
    v_mag = np.linalg.norm(v)
    if v_mag > robot_max_velocity:
        v = v / v_mag * robot_max_velocity
    psi_dot = wrap_angle_difference(ori[-1] - ori[-2]) / dt
    psi_dot = np.clip(psi_dot, -robot_max_angular_velocity,
                      robot_max_angular_velocity)
    n_extrap = k + 1
    t_ext = dt * np.arange(1, n_extrap + 1)
    ext_pos = pos[-1][None, :] + v[None, :] * t_ext[:, None]
    ext_ori = wrap_angle(ori[-1] + psi_dot * t_ext)

    pos = np.concatenate([pos[k:], ext_pos], axis=0)
    ori = np.concatenate([ori[k:], ext_ori], axis=0)

    if alpha > 0.001:
        pos = (1.0 - alpha) * pos[:-1] + alpha * pos[1:]
        ori = interpolate_angle(ori[:-1], ori[1:], alpha)
    else:
        pos = pos[:N]
        ori = ori[:N]

    # Enforce exactly N points
    while len(pos) < N:
        pos = np.concatenate([pos, pos[-1:]], axis=0)
        ori = np.concatenate([ori, ori[-1:]], axis=0)
    return pos[:N], ori[:N]
