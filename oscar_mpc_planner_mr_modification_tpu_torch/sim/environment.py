"""Single-robot simulation environment, counterpart of the JAX package's
``sim/environment.py``: it integrates the robot model with the planner's
commands, steps the pedestrian simulator, feeds its predictions into
RealTimeData, brakes when a solve fails and ends an episode on completion
or after its timeout (60 s). The planner solves on its own device; the
robot's motion is integrated on the host
(:func:`..multirobot.driver.integrate_on_host`, f64).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..planner.data_preparation import define_robot_area, ensure_obstacle_size
from ..solver import State
from ..types import RealTimeData, ReferencePath
from .pedestrians import PedestrianSimulator


@dataclass
class EpisodeResult:
    completed: bool
    n_cycles: int
    duration: float
    min_obstacle_distance: float
    collisions: int
    trajectory: np.ndarray


class SimEnvironment:
    def __init__(self, planner, model, settings,
                 pedestrian_sim: Optional[PedestrianSimulator] = None,
                 reference_path: Optional[ReferencePath] = None,
                 goal: Optional[np.ndarray] = None,
                 episode_timeout: float = 60.0, clock=None):
        self.planner = planner
        self.model = model
        self.settings = settings
        self.pedestrian_sim = pedestrian_sim
        self.reference_path = reference_path
        self.goal = goal
        self.episode_timeout = episode_timeout
        self.clock = clock
        self.state = State(model)

    def reset(self, start_state: Optional[np.ndarray] = None) -> None:
        self.state = State(self.model)
        if start_state is not None:
            self.state.set_array(start_state)
        self.planner.reset()

    def make_data(self) -> RealTimeData:
        data = RealTimeData()
        data.robot_area = define_robot_area(
            self.settings["robot"]["length"], self.settings["robot"]["width"],
            self.settings["n_discs"])
        if self.goal is not None:
            data.goal = np.asarray(self.goal, dtype=float)
            data.goal_received = True
        if self.reference_path is not None:
            data.reference_path = self.reference_path
        N = self.planner.solver.N
        obstacles = (self.pedestrian_sim.get_obstacles(
            N, self.settings["probabilistic"]["enable"])
            if self.pedestrian_sim else [])
        data.dynamic_obstacles = ensure_obstacle_size(
            obstacles, self.state, self.settings["max_obstacles"], N,
            float(self.settings["integrator_step"]),
            probabilistic=self.settings["probabilistic"]["enable"])
        data.planning_start_time = (self.clock() if self.clock
                                    else time.monotonic())
        return data

    def run_episode(self, max_cycles: int = 300,
                    start_state: Optional[np.ndarray] = None) -> EpisodeResult:
        from ..multirobot.driver import integrate_on_host

        self.reset(start_state)
        dt = float(self.settings["integrator_step"])
        if self.reference_path is not None:
            self.planner.on_data_received(self.make_data(), "reference_path")

        min_dist = np.inf
        collisions = 0
        positions: List[np.ndarray] = []
        completed = False
        t0 = 0.0
        for cycle in range(max_cycles):
            data = self.make_data()
            output = self.planner.solve_mpc(self.state, data)
            if output.success:
                a = self.planner.get_solution(0, "a")
                w = self.planner.get_solution(0, "w")
            else:
                a = -abs(self.settings["deceleration_at_infeasible"])
                w = 0.0
            u = np.zeros(self.model.nu)
            u[0], u[1] = a, w
            arr = integrate_on_host(self.model, self.state.as_array(), u, dt)
            iv = self.model.state_index("v")
            arr[iv] = max(arr[iv], 0.0)
            self.state.set_array(arr)
            positions.append(self.state.get_position())

            if self.pedestrian_sim is not None:
                self.pedestrian_sim.step([self.state.get_position()])
                for ped in self.pedestrian_sim.pedestrians:
                    d = np.linalg.norm(self.state.get_position() - ped.position)
                    min_dist = min(min_dist, d)
                    if d < ped.radius + self.settings["robot_radius"]:
                        collisions += 1
            if self.clock is not None:
                self.clock.t += dt
            t0 += dt
            if self.planner.is_objective_reached(self.state, data):
                completed = True
                break
            if t0 > self.episode_timeout:
                break

        return EpisodeResult(
            completed=completed, n_cycles=cycle + 1, duration=t0,
            min_obstacle_distance=float(min_dist), collisions=collisions,
            trajectory=np.asarray(positions))
