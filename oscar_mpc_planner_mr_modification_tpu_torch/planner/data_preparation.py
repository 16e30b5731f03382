"""Obstacle and robot data preparation for one control cycle.

Counterpart of the JAX package's ``planner/data_preparation.py``: robot disc
decomposition, dummy obstacles at +100 m, constant-velocity predictions,
closest-N obstacle selection with linear time scaling, Gaussian uncertainty
propagation, and the merge of peer-robot trajectory obstacles. All numpy.
The closest-N selection (``prep.obstacles``) and each prediction
(``prep.prediction``) are spans of ``utils/profiling.py``: they run before
the tick's ``plan`` span.
"""

from __future__ import annotations

from typing import List, Set

import numpy as np

from ..types import (Disc, DynamicObstacle, Prediction, PredictionStep,
                     PredictionType)
from ..utils.profiling import span


def define_robot_area(length: float, width: float, n_discs: int) -> List[Disc]:
    """Disc decomposition of the robot footprint."""
    center_offset = length / 2.0
    radius = width / 2.0
    if n_discs <= 0:
        raise ValueError("a collision region needs at least one disc")
    if n_discs == 1:
        return [Disc(0.0, radius)]
    area = []
    for i in range(n_discs):
        if i == 0:
            area.append(Disc(-center_offset + radius, radius))
        elif i == n_discs - 1:
            area.append(Disc(-center_offset + length - radius, radius))
        else:
            area.append(Disc(
                -center_offset + radius + i * (length - 2.0 * radius) / (n_discs - 1),
                radius))
    return area


def get_dummy_obstacle(state) -> DynamicObstacle:
    """Far-away dummy obstacle."""
    return DynamicObstacle(
        index=-1,
        position=np.array([state.get("x") + 100.0, state.get("y") + 100.0]),
        angle=0.0, radius=0.0)


def get_constant_velocity_prediction(position, velocity, dt: float, steps: int,
                                     probabilistic: bool = False) -> Prediction:
    """Constant-velocity prediction over ``steps`` steps of ``dt``, with
    Gaussian uncertainty (0.3 per step, propagated) when ``probabilistic``."""
    with span("prep.prediction"):
        noise = 0.3 if probabilistic else 0.0
        pred = Prediction(
            PredictionType.GAUSSIAN if probabilistic
            else PredictionType.DETERMINISTIC,
            modes=[[]], probabilities=[1.0])
        position = np.asarray(position, dtype=float)
        velocity = np.asarray(velocity, dtype=float)
        positions = position[None, :] + np.outer(
            dt * np.arange(steps, dtype=float), velocity)
        pred.modes[0] = [PredictionStep(positions[i], 0.0, noise, noise)
                         for i in range(steps)]
        if probabilistic:
            propagate_prediction_uncertainty(pred, dt, steps)
        return pred


def get_gmm_prediction(position, velocities, probabilities, dt: float,
                       steps: int, noise: float = 0.0) -> Prediction:
    """Multi-mode (GMM) constant-velocity prediction: one mode per velocity
    hypothesis, weighted by ``probabilities``."""
    position = np.asarray(position, dtype=float)
    gaussian = noise > 0.0
    pred = Prediction(
        PredictionType.GAUSSIAN if gaussian else PredictionType.DETERMINISTIC,
        modes=[], probabilities=list(probabilities))
    for vel in velocities:
        vel = np.asarray(vel, dtype=float)
        pred.modes.append([
            PredictionStep(position + vel * dt * i, 0.0, noise, noise)
            for i in range(steps)])
    if gaussian:
        propagate_prediction_uncertainty(pred, dt, steps)
    return pred


def remove_distant_obstacles(obstacles: List[DynamicObstacle], state,
                             max_distance: float) -> List[DynamicObstacle]:
    pos = state.get_position()
    return [o for o in obstacles if np.linalg.norm(pos - o.position) < max_distance]


def ensure_obstacle_size(obstacles: List[DynamicObstacle], state, max_obstacles: int,
                         N: int, dt: float, probabilistic: bool = False
                         ) -> List[DynamicObstacle]:
    """Keep the closest ``max_obstacles`` (linearly time-scaled distance over the
    horizon) or pad with dummies."""
    with span("prep.obstacles"):
        if len(obstacles) > max_obstacles:
            pos = state.get_position()
            psi = state.get("psi")
            v = state.get("v")
            direction = np.array([np.cos(psi), np.sin(psi)])
            distances = []
            for obs in obstacles:
                K = min(N, len(obs.prediction.modes[0]))
                if K == 0:
                    distances.append(1e5)
                    continue
                mp = obs.prediction.mode_positions(0)[:K]  # (K, 2)
                ks = np.arange(K, dtype=float)
                ego = pos[None, :] + np.outer(v * ks, direction)
                d = (ks + 1.0) * 0.6 * np.linalg.norm(mp - ego, axis=1)
                distances.append(float(np.min(d)))
            order = np.argsort(distances)[:max_obstacles]
            obstacles = [obstacles[i] for i in order]
            for i, obs in enumerate(obstacles):
                obs.index = i
        elif len(obstacles) < max_obstacles:
            obstacles = list(obstacles)
            while len(obstacles) < max_obstacles:
                dummy = get_dummy_obstacle(state)
                dummy.prediction = get_constant_velocity_prediction(
                    dummy.position, np.zeros(2), dt, N, probabilistic)
                obstacles.append(dummy)
        return obstacles


def propagate_prediction_uncertainty(prediction: Prediction, dt: float, N: int
                                     ) -> None:
    """sigma_k = sqrt(sigma_{k-1}^2 + (sigma*dt)^2), on every GMM mode."""
    if prediction.type != PredictionType.GAUSSIAN:
        return
    for mode in prediction.modes:
        K = min(N, len(mode))
        if K == 0:
            continue
        major = np.sqrt(np.cumsum(
            np.asarray([s.major_radius for s in mode[:K]]) ** 2) * dt * dt)
        minor = np.sqrt(np.cumsum(
            np.asarray([s.minor_radius for s in mode[:K]]) ** 2) * dt * dt)
        for k in range(K):
            mode[k].major_radius = float(major[k])
            mode[k].minor_radius = float(minor[k])


def propagate_all_uncertainty(obstacles: List[DynamicObstacle], dt: float, N: int
                              ) -> None:
    for obs in obstacles:
        propagate_prediction_uncertainty(obs.prediction, dt, N)


def update_robot_obstacles_from_trajectories(
        data, validated_trajectory_robots: Set[str], ego_ns: str) -> None:
    """Merge the validated peer robots' trajectory obstacles
    (``data.trajectory_dynamic_obstacles``, by namespace) into
    ``dynamic_obstacles``, replacing an obstacle of the same index."""
    for ns, traj_obs in getattr(data, "trajectory_dynamic_obstacles", {}).items():
        if ns not in validated_trajectory_robots:
            continue
        for i, obs in enumerate(data.dynamic_obstacles):
            if obs.index == traj_obs.index:
                data.dynamic_obstacles[i] = traj_obs
                break
        else:
            data.dynamic_obstacles.append(traj_obs)
