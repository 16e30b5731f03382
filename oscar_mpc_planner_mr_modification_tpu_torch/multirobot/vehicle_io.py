"""Real-vehicle IO adapters, counterpart of the JAX package's
``multirobot/vehicle_io.py``: the ego pose comes from motion capture, a
tracked-object stream updates the obstacles that do not communicate, and
the command goes to the velocity controller (v from solution stage 1, w
from stage 0; a braking ramp when the solve fails).

- :class:`VehicleIO`: the hardware boundary (pose source, tracked-object
  source, velocity-command sink); :class:`MockViconIO` replays scripted
  frames for tests.
- :func:`update_noncommunicating_obstacles`: the tracked-object obstacle
  update (skip robot ids, align the orientation with the motion, rotate the
  body-frame twist to the global frame, refresh the constant-velocity
  prediction).
- :class:`RealVehicleAgent`: a :class:`.driver.RobotAgent` whose tick reads
  the pose from IO, merges tracked objects and pushes velocity commands.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..planner.data_preparation import get_constant_velocity_prediction
from ..types import DynamicObstacle, PlannerState
from .driver import RobotAgent


@dataclass
class _ObstacleHolder:
    """Minimal duck-typed container so update_noncommunicating_obstacles can
    operate on the agent's persistent tracked-obstacle store."""

    dynamic_obstacles: list


@dataclass
class PoseMeasurement:
    """One ego pose sample from the external localization source."""

    position: np.ndarray  # (2,)
    yaw: float
    velocity: float  # forward speed estimate
    stamp: float


@dataclass
class TrackedObject:
    """One motion-capture object (Vicon bundle entry).

    ``body_velocity`` is in the object's body frame, as published by the
    reference's object stream (jules_ros1_real_jackalplanner.cpp:581-584)."""

    id: int
    position: np.ndarray  # (2,)
    yaw: float
    body_velocity: np.ndarray  # (2,)
    stamp: float = 0.0


class VehicleIO:
    """Hardware boundary for a real vehicle. Implement per transport."""

    def read_pose(self) -> Optional[PoseMeasurement]:
        raise NotImplementedError

    def read_tracked_objects(self) -> List[TrackedObject]:
        return []

    def send_command(self, v: float, w: float) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        self.send_command(0.0, 0.0)


@dataclass
class MockViconIO(VehicleIO):
    """Scripted/replay IO for tests: queues of pose frames + object frames,
    and a log of every command sent."""

    poses: List[PoseMeasurement] = field(default_factory=list)
    object_frames: List[List[TrackedObject]] = field(default_factory=list)
    commands: List[tuple] = field(default_factory=list)
    _pose_i: int = 0
    _obj_i: int = 0

    def read_pose(self) -> Optional[PoseMeasurement]:
        if self._pose_i >= len(self.poses):
            return self.poses[-1] if self.poses else None
        p = self.poses[self._pose_i]
        self._pose_i += 1
        return p

    def read_tracked_objects(self) -> List[TrackedObject]:
        if not self.object_frames:
            return []
        i = min(self._obj_i, len(self.object_frames) - 1)
        self._obj_i += 1
        return self.object_frames[i]

    def send_command(self, v: float, w: float) -> None:
        self.commands.append((v, w))


def update_noncommunicating_obstacles(data, objects: List[TrackedObject],
                                      n_robot_ids: int, dt: float, N: int
                                      ) -> int:
    """Refresh non-communicating dynamic obstacles from the tracked-object
    stream (jules_ros1_real_jackalplanner.cpp:532-620). Objects with
    ``id < n_robot_ids`` are robots (handled by the trajectory exchange) and
    are skipped. Returns the number of obstacles updated."""
    updated = 0
    for obj in objects:
        if obj.id < n_robot_ids:
            continue
        speed = float(np.linalg.norm(obj.body_velocity))
        # Align orientation with the motion direction when moving (:566-576)
        if speed > 0.01:
            angle = obj.yaw + float(
                np.arctan2(obj.body_velocity[1], obj.body_velocity[0])
            ) + np.pi / 2.0
        else:
            angle = obj.yaw
        # Body-frame twist -> global frame (:581-584). The reference applies
        # RosTools::rotationMatrixFromHeading(-yaw), and that helper is the
        # GLOBAL->BODY matrix [[cos h, sin h], [-sin h, cos h]] (see its
        # global-to-local use at mpc_planner_dingo/src/ros1_planner.cpp:131),
        # so rotationMatrixFromHeading(-yaw) @ v_body rotates by +yaw.
        c, s = np.cos(obj.yaw), np.sin(obj.yaw)
        global_vel = np.array([
            c * obj.body_velocity[0] - s * obj.body_velocity[1],
            s * obj.body_velocity[0] + c * obj.body_velocity[1]])
        for obs in data.dynamic_obstacles:
            if obs.index == obj.id:
                obs.position = np.asarray(obj.position, dtype=float)
                obs.angle = float(angle)
                obs.prediction = get_constant_velocity_prediction(
                    obs.position, global_vel, dt, N)
                updated += 1
                break
    return updated


class RealVehicleAgent(RobotAgent):
    """RobotAgent driven by external IO instead of the simulator: the ego
    pose is read from the localization source each tick, tracked objects
    update non-communicating obstacles, and the command is pushed to the
    velocity controller as (v, w) — v from solution stage 1, w from stage 0
    (the reference's cmd extraction, ros1_jackalsimulator.cpp:181-201 /
    real planner equivalent)."""

    def __init__(self, *args, io: VehicleIO, n_robot_ids: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        self.io = io
        self.n_robot_ids = n_robot_ids
        self._pose_received = False
        # Persistent store of non-communicating (Vicon) obstacles, keyed by
        # tracked-object id. prepare_obstacle_data rebuilds
        # data.dynamic_obstacles from external_obstacles + peers every plan
        # cycle, so Vicon objects must live here and flow in as externals
        # (the reference keeps them alive in _data.dynamic_obstacles across
        # cycles, jules_ros1_real_jackalplanner.cpp:532-620).
        self._tracked_obstacles = {}

    def tick(self, external_obstacles=None):
        pose = self.io.read_pose()
        if pose is not None:
            self.state.set("x", float(pose.position[0]))
            self.state.set("y", float(pose.position[1]))
            self.state.set("psi", float(pose.yaw))
            self.state.set("v", float(pose.velocity))
            self._pose_received = True
        objects = self.io.read_tracked_objects()
        if objects:
            dt, N = self.planner.solver.dt, self.planner.solver.N
            radius = float(self.settings.get("obstacle_radius",
                                             self.settings["robot_radius"]))
            for obj in objects:
                if obj.id < self.n_robot_ids:
                    continue
                if obj.id not in self._tracked_obstacles:
                    obs = DynamicObstacle(index=obj.id,
                                          position=np.asarray(obj.position,
                                                              dtype=float),
                                          radius=radius)
                    obs.prediction = get_constant_velocity_prediction(
                        obs.position, np.zeros(2), dt, N)
                    self._tracked_obstacles[obj.id] = obs
            holder = _ObstacleHolder(list(self._tracked_obstacles.values()))
            update_noncommunicating_obstacles(
                holder, objects, self.n_robot_ids, dt, N)
        merged = list(external_obstacles or [])
        merged.extend(self._tracked_obstacles.values())
        m = super().tick(external_obstacles=merged or None)
        # Push the command to the physical controller
        if self.fsm in (PlannerState.PLANNING_ACTIVE,
                        PlannerState.WAITING_FOR_TRAJECTORY_DATA):
            out = self.planner.output
            if out is not None and out.success:
                v = float(self.planner.get_solution(1, "v"))
                w = float(self.planner.get_solution(0, "w"))
            else:  # braking ramp
                dt = float(self.settings["integrator_step"])
                dec = abs(self.settings["deceleration_at_infeasible"])
                v = max(float(self.state.get("v")) - dec * dt, 0.0)
                w = 0.0
            self.io.send_command(v, w)
        elif self.fsm in (PlannerState.JUST_REACHED_GOAL,
                          PlannerState.GOAL_REACHED):
            self.io.stop()
        return m
