"""Planner telemetry record, counterpart of the JAX package's
``metrics.py``: :class:`MPCMetrics` is one robot's record of one control
cycle (solver, topology, FSM state, communication, timing, pose), and
:class:`MetricsLog` aggregates per-robot streams (communication rate,
success rate, summary).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class MPCMetrics:
    stamp: float = 0.0
    robot_ns: str = ""
    planner_state: str = ""
    solver_exit_code: int = 0
    solver_success: bool = False
    objective: float = 0.0
    selected_topology_id: int = -1
    selected_planner_index: int = -1
    used_guidance: bool = False
    num_guidance_found: int = 0
    topology_changed: bool = False
    communicated: bool = False
    communication_trigger: str = "NO_COMMUNICATION"
    planning_time_ms: float = 0.0
    velocity: float = 0.0
    position_x: float = 0.0
    position_y: float = 0.0


@dataclass
class MetricsLog:
    records: Dict[str, List[MPCMetrics]] = field(default_factory=dict)

    def add(self, metrics: MPCMetrics) -> None:
        self.records.setdefault(metrics.robot_ns, []).append(metrics)

    def communication_rate(self, robot_ns: str) -> float:
        recs = self.records.get(robot_ns, [])
        active = [r for r in recs if r.planner_state in
                  ("PLANNING_ACTIVE", "WAITING_FOR_TRAJECTORY_DATA")]
        if not active:
            return 0.0
        return sum(r.communicated for r in active) / len(active)

    def success_rate(self, robot_ns: str) -> float:
        recs = [r for r in self.records.get(robot_ns, [])
                if r.planner_state == "PLANNING_ACTIVE"]
        if not recs:
            return 0.0
        return sum(r.solver_success for r in recs) / len(recs)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            ns: {
                "cycles": len(recs),
                "success_rate": self.success_rate(ns),
                "communication_rate": self.communication_rate(ns),
                "mean_planning_ms": (
                    sum(r.planning_time_ms for r in recs) / max(len(recs), 1)),
            }
            for ns, recs in self.records.items()
        }
