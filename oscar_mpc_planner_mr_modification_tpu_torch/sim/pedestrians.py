"""Pedestrian simulator with social forces and prediction output.

Counterpart of the JAX package's ``sim/pedestrians.py``: pedestrians walk
toward personal goals under a social-force model (goal attraction,
pedestrian and robot repulsion, optional Gaussian process noise) and publish
constant-velocity predictions, optionally with Gaussian uncertainty: the
obstacle input the planner consumes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..planner.data_preparation import (get_constant_velocity_prediction,
                                        propagate_prediction_uncertainty)
from ..types import DynamicObstacle, ObstacleType


@dataclass
class Pedestrian:
    position: np.ndarray
    goal: np.ndarray
    velocity: np.ndarray = field(default_factory=lambda: np.zeros(2))
    desired_speed: float = 1.2
    radius: float = 0.3


class PedestrianSimulator:
    def __init__(self, pedestrians: List[Pedestrian], dt: float = 0.2,
                 process_noise: float = 0.0, seed: int = 0,
                 social_force_gain: float = 2.0, repulsion_gain: float = 1.5,
                 repulsion_range: float = 1.2):
        self.pedestrians = pedestrians
        self.dt = dt
        self.process_noise = process_noise
        self.rng = np.random.default_rng(seed)
        self.social_force_gain = social_force_gain
        self.repulsion_gain = repulsion_gain
        self.repulsion_range = repulsion_range

    def step(self, robot_positions: Optional[List[np.ndarray]] = None) -> None:
        robot_positions = robot_positions or []
        new_velocities = []
        for i, ped in enumerate(self.pedestrians):
            to_goal = ped.goal - ped.position
            dist = np.linalg.norm(to_goal)
            desired = (to_goal / dist * ped.desired_speed if dist > 0.1
                       else np.zeros(2))
            force = self.social_force_gain * (desired - ped.velocity)
            # Repulsion from other pedestrians and robots
            for j, other in enumerate(self.pedestrians):
                if i == j:
                    continue
                force += self._repulsion(ped.position, other.position)
            for rp in robot_positions:
                force += self._repulsion(ped.position, np.asarray(rp))
            if self.process_noise > 0:
                force += self.rng.normal(0, self.process_noise, 2)
            new_velocities.append(ped.velocity + force * self.dt)
        for ped, v in zip(self.pedestrians, new_velocities):
            speed = np.linalg.norm(v)
            if speed > 2.0 * ped.desired_speed:
                v = v / speed * 2.0 * ped.desired_speed
            ped.velocity = v
            ped.position = ped.position + v * self.dt

    def _repulsion(self, p, other):
        d = p - other
        dist = np.linalg.norm(d)
        if dist < 1e-6 or dist > self.repulsion_range:
            return np.zeros(2)
        return self.repulsion_gain * np.exp(-dist / 0.5) * d / dist

    def get_obstacles(self, N: int, probabilistic: bool = False
                      ) -> List[DynamicObstacle]:
        """Constant-velocity predictions over N steps (the planner's input)."""
        obstacles = []
        for i, ped in enumerate(self.pedestrians):
            obs = DynamicObstacle(index=i, position=ped.position.copy(),
                                  angle=float(np.arctan2(ped.velocity[1],
                                                         ped.velocity[0])),
                                  radius=ped.radius, type=ObstacleType.DYNAMIC)
            obs.current_speed = float(np.linalg.norm(ped.velocity))
            obs.prediction = get_constant_velocity_prediction(
                ped.position, ped.velocity, self.dt, N, probabilistic)
            obstacles.append(obs)
        return obstacles
