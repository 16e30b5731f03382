"""High-level planning data types.

Counterpart of the JAX package's ``types.py``: host-side containers, plain
dataclasses over numpy arrays. The ported modules also read predictions of
another package's classes (duck-typed: ``type``, ``modes`` of steps with
``position``, ``angle``, ``major_radius``, ``minor_radius``, and
``probabilities``), so they stack positions through :func:`mode_positions`.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Geometry primitives
# ---------------------------------------------------------------------------
@dataclass
class Disc:
    """Robot collision disc."""

    offset: float
    radius: float

    def get_position(self, robot_position: np.ndarray, angle: float) -> np.ndarray:
        return robot_position + self.offset * np.array([np.cos(angle), np.sin(angle)])

    def to_robot_center(self, disc_position: np.ndarray, angle: float) -> np.ndarray:
        return disc_position - self.offset * np.array([np.cos(angle), np.sin(angle)])


@dataclass
class Halfspace:
    """Halfspace A.x <= b."""

    A: np.ndarray  # (2,)
    b: float


StaticObstacle = List[Halfspace]


# ---------------------------------------------------------------------------
# Obstacle predictions
# ---------------------------------------------------------------------------
class PredictionType(enum.Enum):
    DETERMINISTIC = 0
    GAUSSIAN = 1
    NONGAUSSIAN = 2
    NONE = 3


@dataclass
class PredictionStep:
    """Mean and uncertainty ellipse of one obstacle at one future step."""

    position: np.ndarray  # (2,)
    angle: float
    major_radius: float
    minor_radius: float


Mode = List[PredictionStep]


def mode_positions(mode) -> np.ndarray:
    """(L, 2) positions of one prediction mode; (0, 2) for an empty mode.

    A fresh array on every call, so it never aliases a step's ``position``."""
    return np.array([step.position for step in mode],
                    dtype=float).reshape(-1, 2)


@dataclass
class Prediction:
    """GMM-ready obstacle prediction; one mode is used in practice."""

    type: PredictionType = PredictionType.NONE
    modes: List[Mode] = field(default_factory=list)
    probabilities: List[float] = field(default_factory=list)

    def empty(self) -> bool:
        return len(self.modes) == 0 or len(self.modes[0]) == 0

    def mode_positions(self, mode_idx: int = 0) -> np.ndarray:
        """(L, 2) positions of one mode, (0, 2) when it is empty; a fresh
        array on every call (:func:`mode_positions`)."""
        return mode_positions(self.modes[mode_idx])


class ObstacleType(enum.Enum):
    STATIC = 0
    DYNAMIC = 1
    ROBOT = 2  # other robots treated as trajectory obstacles


@dataclass
class DynamicObstacle:
    """A dynamic obstacle with its prediction, and the bookkeeping of a peer
    robot's trajectory (when it was last updated, whether it is stale)."""

    index: int
    position: np.ndarray  # (2,)
    angle: float = 0.0
    radius: float = 0.325
    type: ObstacleType = ObstacleType.DYNAMIC
    current_speed: float = 0.0
    prediction: Prediction = field(default_factory=Prediction)
    last_trajectory_update_time: float = 0.0
    trajectory_needs_interpolation: bool = False

    def update_state(self, new_position: np.ndarray, new_angle: float,
                     new_prediction: Prediction) -> None:
        self.position = np.asarray(new_position, dtype=float)
        self.angle = float(new_angle)
        self.prediction = new_prediction


# ---------------------------------------------------------------------------
# Paths and trajectories
# ---------------------------------------------------------------------------
@dataclass
class ReferencePath:
    """Reference path waypoints, with optional velocity and arc length."""

    x: List[float] = field(default_factory=list)
    y: List[float] = field(default_factory=list)
    psi: List[float] = field(default_factory=list)
    v: List[float] = field(default_factory=list)
    s: List[float] = field(default_factory=list)

    def clear(self) -> None:
        self.x, self.y, self.psi, self.v, self.s = [], [], [], [], []

    def empty(self) -> bool:
        return len(self.x) == 0

    def has_velocity(self) -> bool:
        return len(self.v) > 0

    def has_distance(self) -> bool:
        return len(self.s) > 0


Boundary = ReferencePath


@dataclass
class Trajectory:
    """Timed 2D trajectory with orientations. The overlap mask and the
    deviation trigger wrap :mod:`.multirobot.interpolation`."""

    dt: float = 0.0
    positions: List[np.ndarray] = field(default_factory=list)
    orientations: List[float] = field(default_factory=list)
    last_trajectory_update_time: float = 0.0

    def add(self, x, y=None) -> None:
        if y is None:
            self.positions.append(np.asarray(x, dtype=float))
        else:
            self.positions.append(np.array([x, y], dtype=float))

    def add_orientation(self, psi: float) -> None:
        self.orientations.append(float(psi))

    def __len__(self) -> int:
        return len(self.positions)

    def as_array(self) -> np.ndarray:
        return np.asarray(self.positions, dtype=float).reshape(-1, 2)

    def calc_collision_mask_gk(self, other: "Trajectory", sigma: float) -> float:
        from .multirobot.interpolation import collision_mask_gk

        return collision_mask_gk(self.as_array(), other.as_array(), sigma)

    def geometric_deviation_trigger(self, broadcasted: "Trajectory",
                                    max_deviation: float) -> bool:
        from .multirobot.interpolation import geometric_deviation

        return geometric_deviation(self.as_array(),
                                   broadcasted.as_array()) > max_deviation


@dataclass
class FixedSizeTrajectory:
    """Sliding fixed-size position history."""

    size: int = 30
    positions: List[np.ndarray] = field(default_factory=list)

    def add(self, p: np.ndarray) -> None:
        self.positions.append(np.asarray(p, dtype=float))
        if len(self.positions) > self.size:
            self.positions.pop(0)


# ---------------------------------------------------------------------------
# Planner FSM and solver status
# ---------------------------------------------------------------------------
class PlannerState(enum.Enum):
    """The multi-robot planner's 12 states."""

    UNINITIALIZED = 0
    TIMER_STARTUP = 1
    WAITING_FOR_FIRST_EGO_POSE = 2
    INITIALIZING_OBSTACLES = 3
    WAITING_FOR_OTHER_ROBOTS_FIRST_POSES = 4
    WAITING_FOR_SYNC = 5
    WAITING_FOR_TRAJECTORY_DATA = 6
    PLANNING_ACTIVE = 7
    JUST_REACHED_GOAL = 8
    GOAL_REACHED = 9
    RESETTING = 10
    ERROR_STATE = 11


class SolverState(enum.Enum):
    SOLVED_WITH_HOMOLOGY_ID = 0
    SOLVED_NO_HOMOLOGY_ID = 1
    SOLVED_FAILED = 2


# ---------------------------------------------------------------------------
# Real-time data and module data
# ---------------------------------------------------------------------------
@dataclass
class RealTimeData:
    """All external inputs to one control cycle."""

    dynamic_obstacles: List[DynamicObstacle] = field(default_factory=list)
    static_obstacles: List[List[Halfspace]] = field(default_factory=list)  # per stage
    halfspaces: List[Halfspace] = field(default_factory=list)
    reference_path: ReferencePath = field(default_factory=ReferencePath)
    left_bound: Boundary = field(default_factory=ReferencePath)
    right_bound: Boundary = field(default_factory=ReferencePath)
    goal: Optional[np.ndarray] = None
    goal_received: bool = False
    robot_area: List[Disc] = field(default_factory=list)
    intrusion: float = 0.0
    past_trajectory: FixedSizeTrajectory = field(default_factory=FixedSizeTrajectory)
    planning_start_time: float = 0.0
    costmap: Optional[object] = None  # occupancy grid for decomp constraints

    def reset(self) -> None:
        self.__init__()


@dataclass
class ModuleData:
    """Data exchanged between modules within one cycle, with the T-MPC
    topology metadata."""

    path: Optional[object] = None  # fitted CubicSpline2D
    path_velocity: Optional[object] = None
    path_width_left: Optional[object] = None
    path_width_right: Optional[object] = None
    current_path_segment: int = 0
    static_obstacles: Optional[List[List[Halfspace]]] = None
    # Topology metadata (filled by the T-MPC guidance module)
    selected_topology_id: int = -1
    selected_planner_index: int = -1
    selected_was_non_guided: bool = False
    used_guidance: bool = False
    trajectory_cost: float = 0.0
    num_of_guidance_found: int = 0
    topology_changed: bool = False
    non_guided_homology_failed: bool = False
    solver_state: SolverState = SolverState.SOLVED_NO_HOMOLOGY_ID

    def reset(self) -> None:
        self.__init__()


@dataclass
class PlannerOutput:
    """Result of one ``solve_mpc`` call, with the topology metadata that
    drives communication triggers."""

    trajectory: Trajectory = field(default_factory=Trajectory)
    success: bool = False
    exit_code: int = 0
    objective: float = 0.0
    selected_topology_id: int = -1
    selected_planner_index: int = -1
    previous_topology_id: int = -1
    used_guidance: bool = False
    topology_changed: bool = False
    was_infeasible: bool = False
    trajectory_cost: float = 0.0
    num_of_guidance_found: int = 0
    non_guided_homology_failed: bool = False
