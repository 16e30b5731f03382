"""Event-triggered inter-robot trajectory communication, counterpart of the
JAX package's ``multirobot/comms.py``: five triggers in priority order
(INFEASIBLE > NON_GUIDED_HOMOLOGY_FAIL > TOPOLOGY_CHANGE > GEOMETRIC
deviation > TIME heartbeat), silent in the FSM's non-planning states, and
the :class:`TrajectoryMessage` a robot publishes.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..types import PlannerOutput, PlannerState
from .interpolation import geometric_deviation


class CommunicationTriggerReason(enum.Enum):
    NO_COMMUNICATION = 0
    INFEASIBLE = 1
    INFEASIBLE_TO_FEASIBLE = 2
    TOPOLOGY_CHANGE = 3
    GEOMETRIC = 4
    TIME = 5
    NON_GUIDED_HOMOLOGY_FAIL = 6


class CommunicationTriggers:
    """The five trigger predicates (communication_triggers.cpp:22-84)."""

    @staticmethod
    def check_infeasible(output: PlannerOutput) -> bool:
        return not output.success

    @staticmethod
    def check_topology_change(output: PlannerOutput, n_paths: int) -> bool:
        if not output.success:
            return False
        non_guided_id = 2 * n_paths
        is_to_guided = output.selected_topology_id != non_guided_id
        return output.topology_changed and is_to_guided

    @staticmethod
    def check_geometric_deviation(current_traj: np.ndarray,
                                  last_communicated: Optional[np.ndarray],
                                  max_deviation: float) -> bool:
        if current_traj is None or last_communicated is None:
            return False
        if len(current_traj) == 0 or len(last_communicated) == 0:
            return False
        if len(current_traj) != len(last_communicated):
            return False
        return geometric_deviation(current_traj, last_communicated) > max_deviation

    @staticmethod
    def check_time(last_send_time: Optional[float], current_time: float,
                   heartbeat_period: float) -> bool:
        if last_send_time is None:
            return True
        return (current_time - last_send_time) >= heartbeat_period

    @staticmethod
    def check_non_guided_homology_fail(output: PlannerOutput, n_paths: int
                                       ) -> bool:
        if not output.success:
            return False
        return output.selected_topology_id == 2 * n_paths


_SILENT_STATES = {
    PlannerState.UNINITIALIZED, PlannerState.TIMER_STARTUP,
    PlannerState.WAITING_FOR_FIRST_EGO_POSE,
    PlannerState.INITIALIZING_OBSTACLES, PlannerState.GOAL_REACHED,
    PlannerState.RESETTING, PlannerState.ERROR_STATE,
}


@dataclass
class CommunicationState:
    last_send_time: Optional[float] = None
    last_communicated_trajectory: Optional[np.ndarray] = None
    trigger_reason: CommunicationTriggerReason = (
        CommunicationTriggerReason.NO_COMMUNICATION)
    n_sent: int = 0
    n_cycles: int = 0


def decide_communication(state: PlannerState, output: PlannerOutput,
                         comm: CommunicationState, settings, now: float,
                         current_trajectory: Optional[np.ndarray]) -> bool:
    """Prioritized trigger evaluation (jules_ros1_jackalplanner.cpp:1400-1482).

    Mutates ``comm.trigger_reason``; the caller records send time/trajectory on
    actual transmission.
    """
    comm.n_cycles += 1
    if not settings.get("enable_output", True):
        comm.trigger_reason = CommunicationTriggerReason.NO_COMMUNICATION
        return False
    if not settings["JULES"]["communicate_on_topology_switch_only"]:
        comm.trigger_reason = CommunicationTriggerReason.TIME
        return True
    if state in _SILENT_STATES:
        comm.trigger_reason = CommunicationTriggerReason.NO_COMMUNICATION
        return False

    n_paths = int(settings["JULES"]["n_paths"])
    max_deviation = float(settings["JULES"]["max_geometric_deviation"])
    heartbeat = float(settings["JULES"]["heartbeat_time"])

    if CommunicationTriggers.check_infeasible(output):
        comm.trigger_reason = CommunicationTriggerReason.INFEASIBLE
        return True
    if CommunicationTriggers.check_non_guided_homology_fail(output, n_paths):
        comm.trigger_reason = CommunicationTriggerReason.NON_GUIDED_HOMOLOGY_FAIL
        return True
    if CommunicationTriggers.check_topology_change(output, n_paths):
        comm.trigger_reason = CommunicationTriggerReason.TOPOLOGY_CHANGE
        return True
    if CommunicationTriggers.check_geometric_deviation(
            current_trajectory, comm.last_communicated_trajectory, max_deviation):
        comm.trigger_reason = CommunicationTriggerReason.GEOMETRIC
        return True
    if CommunicationTriggers.check_time(comm.last_send_time, now, heartbeat):
        comm.trigger_reason = CommunicationTriggerReason.TIME
        return True

    comm.trigger_reason = CommunicationTriggerReason.NO_COMMUNICATION
    return False


@dataclass
class TrajectoryMessage:
    """The ObstacleGMM-equivalent wire format: one robot's planned trajectory
    with per-pose timestamps (mpc_planner_msgs/ObstacleGMM.msg +
    publishDirectTrajectory, jules_ros1_jackalplanner.cpp:1265-1330)."""

    robot_ns: str
    robot_index: int
    positions: np.ndarray  # (N, 2)
    orientations: np.ndarray  # (N,)
    radius: float
    dt: float
    stamp: float
    trigger_reason: CommunicationTriggerReason = (
        CommunicationTriggerReason.NO_COMMUNICATION)
    is_braking: bool = False
