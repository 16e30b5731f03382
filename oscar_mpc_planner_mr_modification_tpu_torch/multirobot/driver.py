"""Multi-robot coordination driver, counterpart of the JAX package's
``multirobot/driver.py``: the fork's multi-robot node as a host-side agent
per robot and an in-process message bus standing in for the topics:

- the 12-state planner FSM with its guarded transitions;
- peer robots tracked as trajectory obstacles, far-away dummies until their
  first valid message;
- stale-trajectory interpolation and extrapolation before each plan;
- the braking command and a braking-trajectory broadcast on an infeasible
  solve, so that peers still receive a prediction;
- event-triggered communication with the five prioritized triggers;
- per-cycle :class:`..metrics.MPCMetrics` telemetry.

Each robot's planner is this package's :class:`..planner.Planner` (for the
T-MPC configurations one fused-kernel launch per tick on the card). The
robot's own state is integrated on the host (:meth:`RobotAgent.apply_command`:
the model's RK4 step on f64 CPU tensors), as simulation, not as part of the
solve.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..metrics import MetricsLog, MPCMetrics
from ..planner.data_preparation import (define_robot_area,
                                        ensure_obstacle_size,
                                        get_constant_velocity_prediction)
from ..solver import State
from ..types import (DynamicObstacle, ObstacleType, PlannerState,
                     Prediction, PredictionStep, PredictionType, RealTimeData)
from .comms import (CommunicationState, CommunicationTriggerReason,
                    TrajectoryMessage, decide_communication)
from .interpolation import interpolate_trajectory_by_elapsed_time


@dataclass
class MessageBus:
    """In-process pub/sub + request/reply standing in for the ROS topics and
    services between robots."""

    subscribers: Dict[str, List[Callable]] = field(default_factory=dict)
    # Trajectory service handlers: ns -> handler(requesting_ns, pose) ->
    # Optional[TrajectoryMessage]  (GetOtherTrajectories.srv equivalent)
    services: Dict[str, Callable] = field(default_factory=dict)
    # Startup-synchronization blackboard (the reference's first-pose topics +
    # sync barrier that WAITING_FOR_OTHER_ROBOTS_FIRST_POSES /
    # WAITING_FOR_SYNC wait on, data_types.h:180-181)
    first_poses: Dict[str, np.ndarray] = field(default_factory=dict)
    sync_ready: set = field(default_factory=set)

    def subscribe(self, ns: str, callback: Callable) -> None:
        self.subscribers.setdefault(ns, []).append(callback)

    def publish(self, sender_ns: str, msg: TrajectoryMessage) -> None:
        for ns, callbacks in self.subscribers.items():
            if ns == sender_ns:
                continue
            for cb in callbacks:
                cb(msg)

    def register_trajectory_service(self, ns: str, handler: Callable) -> None:
        """Register this robot as a trajectory provider
        (mpc_planner_msgs/srv/GetOtherTrajectories.srv: the reference exposes
        /get_other_robot_obstacles_srv so a late-joining robot can PULL peers'
        current plans instead of waiting for the next event-triggered push,
        jules_ros1_jackalplanner_working_one.cpp:155)."""
        self.services[ns] = handler

    def request_trajectories(self, requesting_ns: str,
                             requesting_pose: np.ndarray
                             ) -> List[TrajectoryMessage]:
        """Service call: collect every other robot's current trajectory."""
        out: List[TrajectoryMessage] = []
        for ns, handler in self.services.items():
            if ns == requesting_ns:
                continue
            msg = handler(requesting_ns, requesting_pose)
            if msg is not None:
                out.append(msg)
        return out


def integrate_on_host(model, x, u, dt: float) -> np.ndarray:
    """One step of the model's discrete dynamics (RK4, 3 sub-steps) from the
    numpy state x under the input u, on f64 CPU tensors: the simulated
    robot's own motion, not part of the planner's solve."""
    f64 = torch.float64
    x_next = model.discrete_dynamics(torch.as_tensor(x, dtype=f64),
                                     torch.as_tensor(u, dtype=f64), float(dt))
    return x_next.numpy().copy()


class RobotAgent:
    """One robot: FSM + planner + communication (JulesJackalPlanner equivalent)."""

    def __init__(self, ns: str, index: int, planner, model, settings,
                 goal: np.ndarray, bus: MessageBus, clock=time.monotonic,
                 start_pose=(0.0, 0.0, 0.0)):
        self.ns = ns
        self.index = index
        self.planner = planner
        self.model = model
        self.settings = settings
        self.bus = bus
        self.clock = clock
        self.goal = np.asarray(goal, dtype=float)

        self.state = State(model)
        self.start_pose = tuple(start_pose)
        self.state.set("x", start_pose[0])
        self.state.set("y", start_pose[1])
        self.state.set("psi", start_pose[2])
        self.last_output = None
        self.fsm = PlannerState.TIMER_STARTUP
        self.previous_fsm = PlannerState.UNINITIALIZED
        self.error_reason = ""
        self.data = RealTimeData()
        self.data.robot_area = define_robot_area(
            settings["robot"]["length"], settings["robot"]["width"],
            settings["n_discs"])
        self.data.goal = self.goal
        self.data.goal_received = True
        self.comm = CommunicationState()
        self.metrics = MetricsLog()
        # Peer trajectory store: ns -> TrajectoryMessage
        self._peer_trajectories: Dict[str, TrajectoryMessage] = {}
        self._validated_peers: set = set()
        self._peer_namespaces: List[str] = []
        self._pose_received = True  # sim provides poses synchronously
        self._fsm_lock = threading.Lock()  # async transports: rx thread vs tick
        self.last_command = (0.0, 0.0)
        self._last_trajectory_msg: Optional[TrajectoryMessage] = None
        bus.subscribe(ns, self._trajectory_callback)
        bus.register_trajectory_service(ns, self._trajectory_service)

    # -- message handling (jules :522-680) ---------------------------------
    def set_peers(self, namespaces: List[str]) -> None:
        self._peer_namespaces = [n for n in namespaces if n != self.ns]

    def _trajectory_callback(self, msg: TrajectoryMessage) -> None:
        if msg.robot_ns == self.ns:
            return
        if not np.all(np.isfinite(msg.positions)):
            return  # validation: reject garbage
        if len(msg.positions) == 0:
            return
        self._peer_trajectories[msg.robot_ns] = msg
        self._validated_peers.add(msg.robot_ns)
        # Receiving first valid trajectories unblocks planning (rx-driven FSM
        # transition, jules :634-637)
        if (self.fsm == PlannerState.WAITING_FOR_TRAJECTORY_DATA
                and self._have_all_peer_trajectories()):
            self.transition_to(PlannerState.PLANNING_ACTIVE)

    def _have_all_peer_trajectories(self) -> bool:
        return all(ns in self._validated_peers for ns in self._peer_namespaces)

    # -- FSM transitions (multi_robot_utility_functions.cpp:158-240) --------
    #: Valid transitions per state; a requested transition outside the table
    #: drives the FSM into ERROR_STATE (the reference's transitionTo guard).
    #: ERROR_STATE is reachable from EVERY state; its only exit is RESETTING.
    #: Divergence from the reference table: INITIALIZING_OBSTACLES may also
    #: go to WAITING_FOR_OTHER_ROBOTS_FIRST_POSES (the reference's own sync
    #: entry is commented out, jules_ros1_jackalplanner.cpp:433 — here the
    #: chain is live behind settings JULES.synchronized_start) and to
    #: PLANNING_ACTIVE directly for a robot with no peers.
    _VALID_TRANSITIONS = {
        PlannerState.UNINITIALIZED: {PlannerState.TIMER_STARTUP},
        PlannerState.TIMER_STARTUP: {PlannerState.WAITING_FOR_FIRST_EGO_POSE},
        PlannerState.WAITING_FOR_FIRST_EGO_POSE: {
            PlannerState.INITIALIZING_OBSTACLES},
        PlannerState.INITIALIZING_OBSTACLES: {
            PlannerState.WAITING_FOR_OTHER_ROBOTS_FIRST_POSES,
            PlannerState.WAITING_FOR_TRAJECTORY_DATA,
            PlannerState.PLANNING_ACTIVE},
        PlannerState.WAITING_FOR_OTHER_ROBOTS_FIRST_POSES: {
            PlannerState.WAITING_FOR_SYNC},
        PlannerState.WAITING_FOR_SYNC: {
            PlannerState.WAITING_FOR_TRAJECTORY_DATA},
        PlannerState.WAITING_FOR_TRAJECTORY_DATA: {
            PlannerState.PLANNING_ACTIVE, PlannerState.JUST_REACHED_GOAL,
            PlannerState.GOAL_REACHED},
        PlannerState.PLANNING_ACTIVE: {
            PlannerState.JUST_REACHED_GOAL, PlannerState.GOAL_REACHED},
        PlannerState.JUST_REACHED_GOAL: {PlannerState.GOAL_REACHED},
        PlannerState.GOAL_REACHED: {PlannerState.RESETTING},
        PlannerState.RESETTING: {PlannerState.TIMER_STARTUP},
        PlannerState.ERROR_STATE: {PlannerState.RESETTING},
    }

    def transition_to(self, new_state: PlannerState) -> bool:
        """Guarded FSM transition. Returns True when taken; an invalid
        request lands in ERROR_STATE instead (transitionTo semantics,
        multi_robot_utility_functions.cpp:158-172).

        Thread-safe and idempotent: over an ASYNC transport (socket bus,
        real ROS spinner threads) the rx-driven transition in
        :meth:`_trajectory_callback` can race the tick loop's own request —
        both legitimately deciding e.g. WAITING_FOR_TRAJECTORY_DATA →
        PLANNING_ACTIVE. The check-and-set is atomic under ``_fsm_lock`` and
        a request for the CURRENT state is a benign no-op, so the second
        arrival of the same decision cannot crash the FSM into ERROR_STATE."""
        with self._fsm_lock:
            if new_state == PlannerState.ERROR_STATE:
                self.previous_fsm = self.fsm
                self.fsm = PlannerState.ERROR_STATE
                return True
            if new_state == self.fsm:
                return True
            if new_state not in self._VALID_TRANSITIONS.get(self.fsm, set()):
                self.error_reason = (f"invalid transition "
                                     f"{self.fsm.name} -> {new_state.name}")
                self.previous_fsm = self.fsm
                self.fsm = PlannerState.ERROR_STATE
                return False
            self.previous_fsm = self.fsm
            self.fsm = new_state
            return True

    def enter_error_state(self, reason: str = "") -> None:
        """ERROR_STATE entry (e.g. jules_..._working_one.cpp:1502: missing
        reference path). Planning stops; recovery is via :meth:`recover`."""
        self.error_reason = reason
        self.transition_to(PlannerState.ERROR_STATE)
        self.last_command = (0.0, 0.0)

    def recover(self) -> None:
        """ERROR_STATE -> RESETTING (the only valid exit; the reset path then
        returns to TIMER_STARTUP on the next tick)."""
        self.transition_to(PlannerState.RESETTING)

    # -- trajectory service (GetOtherTrajectories.srv equivalent) ----------
    def _trajectory_service(self, requesting_ns: str,
                            requesting_pose: np.ndarray
                            ) -> Optional[TrajectoryMessage]:
        """Serve our current plan to a requesting (late-joining) peer. Falls
        back to a braking rollout from the current state when nothing has been
        broadcast yet, so the requester always gets a usable prediction."""
        if self._last_trajectory_msg is not None:
            return self._last_trajectory_msg
        pos, ori = self._braking_trajectory()
        return TrajectoryMessage(
            robot_ns=self.ns, robot_index=self.index, positions=pos,
            orientations=ori, radius=self.settings["robot_radius"],
            dt=self.planner.solver.dt, stamp=self.clock(),
            trigger_reason=CommunicationTriggerReason.NO_COMMUNICATION,
            is_braking=True)

    def request_peer_trajectories(self) -> int:
        """Pull peers' current plans through the bus service (the reference's
        /get_other_robot_obstacles_srv client call). Returns the number of
        trajectories received; each is ingested through the normal validated
        callback path."""
        replies = self.bus.request_trajectories(
            self.ns, self.state.get_position())
        for msg in replies:
            self._trajectory_callback(msg)
        return len(replies)

    # -- obstacle preparation (jules :800-1065) ----------------------------
    def prepare_obstacle_data(self, external_obstacles=None) -> None:
        N = self.planner.solver.N
        dt = self.planner.solver.dt
        now = self.clock()
        obstacles: List[DynamicObstacle] = list(external_obstacles or [])

        for peer_idx, ns in enumerate(self._peer_namespaces):
            msg = self._peer_trajectories.get(ns)
            robot_index = 1000 + peer_idx  # stable id per peer
            if msg is None:
                # Not yet received: far-away dummy (jules :100-140)
                pos = self.state.get_position() + np.array([100.0, 100.0])
                obs = DynamicObstacle(index=robot_index, position=pos,
                                      radius=self.settings["robot_radius"],
                                      type=ObstacleType.ROBOT)
                obs.prediction = get_constant_velocity_prediction(
                    pos, np.zeros(2), dt, N)
                obstacles.append(obs)
                continue
            positions, orientations = msg.positions, msg.orientations
            if self.settings["JULES"]["enable_trajectory_interpolation"]:
                out = interpolate_trajectory_by_elapsed_time(
                    positions, orientations, msg.dt, now - msg.stamp,
                    float(self.settings["control_frequency"]),
                    float(self.settings["JULES"]["robot_max_velocity"]),
                    float(self.settings["JULES"]["robot_max_angular_velocity"]))
                if out is not None:
                    positions, orientations = out
            obs = DynamicObstacle(
                index=robot_index, position=positions[0].copy(),
                angle=float(orientations[0]), radius=msg.radius,
                type=ObstacleType.ROBOT)
            steps = [PredictionStep(positions[min(k + 1, len(positions) - 1)].copy(),
                                    float(orientations[min(k + 1, len(positions) - 1)]),
                                    0.0, 0.0)
                     for k in range(N)]
            obs.prediction = Prediction(PredictionType.DETERMINISTIC,
                                        modes=[steps], probabilities=[1.0])
            obs.last_trajectory_update_time = msg.stamp
            obstacles.append(obs)

        self.data.dynamic_obstacles = ensure_obstacle_size(
            obstacles, self.state, self.settings["max_obstacles"], N, dt,
            probabilistic=self.settings["probabilistic"]["enable"])

    # -- FSM tick (jules :258-404) -----------------------------------------
    def tick(self, external_obstacles=None) -> MPCMetrics:
        t_start = self.clock()
        self.data.planning_start_time = t_start
        fsm = self.fsm
        output = None
        communicated = False

        if fsm == PlannerState.TIMER_STARTUP:
            self.transition_to(PlannerState.WAITING_FOR_FIRST_EGO_POSE)
        elif fsm == PlannerState.WAITING_FOR_FIRST_EGO_POSE:
            if self.state.valid_data() or self._pose_received:
                # Announce our first pose (the reference's first-pose topics
                # that WAITING_FOR_OTHER_ROBOTS_FIRST_POSES waits on)
                self.bus.first_poses[self.ns] = self.state.get_position()
                self.transition_to(PlannerState.INITIALIZING_OBSTACLES)
        elif fsm == PlannerState.INITIALIZING_OBSTACLES:
            # Pull peers' current plans through the trajectory service first
            # (late-joiner path, GetOtherTrajectories.srv) — peers that have
            # not registered/answered stay dummies until their next push.
            if self._peer_namespaces:
                self.request_peer_trajectories()
            self.prepare_obstacle_data(external_obstacles)
            if (self._peer_namespaces
                    and self.settings["JULES"].get("synchronized_start")):
                # Synchronized startup chain (enum states 4/5): wait for every
                # peer's first pose, then rendezvous at the sync barrier
                self.transition_to(
                    PlannerState.WAITING_FOR_OTHER_ROBOTS_FIRST_POSES)
            elif (not self._peer_namespaces
                    or self._have_all_peer_trajectories()):
                self.transition_to(PlannerState.PLANNING_ACTIVE)
            else:
                self.transition_to(PlannerState.WAITING_FOR_TRAJECTORY_DATA)
        elif fsm == PlannerState.WAITING_FOR_OTHER_ROBOTS_FIRST_POSES:
            if all(ns in self.bus.first_poses for ns in self._peer_namespaces):
                self.bus.sync_ready.add(self.ns)
                self.transition_to(PlannerState.WAITING_FOR_SYNC)
        elif fsm == PlannerState.WAITING_FOR_SYNC:
            ready = self.bus.sync_ready
            if all(ns in ready for ns in self._peer_namespaces):
                self.transition_to(PlannerState.WAITING_FOR_TRAJECTORY_DATA)
        elif fsm == PlannerState.WAITING_FOR_TRAJECTORY_DATA:
            # Plan conservatively while waiting; peers are dummies until valid
            output, communicated = self._guarded_plan_cycle(external_obstacles)
            if (self.fsm != PlannerState.ERROR_STATE
                    and self._have_all_peer_trajectories()):
                self.transition_to(PlannerState.PLANNING_ACTIVE)
        elif fsm == PlannerState.PLANNING_ACTIVE:
            output, communicated = self._guarded_plan_cycle(external_obstacles)
            if (self.fsm != PlannerState.ERROR_STATE
                    and self.planner.is_objective_reached(self.state,
                                                          self.data)):
                self.transition_to(PlannerState.JUST_REACHED_GOAL)
        elif fsm == PlannerState.JUST_REACHED_GOAL:
            self.last_command = (
                -abs(self.settings["deceleration_at_infeasible"]), 0.0)
            if abs(self.state.get("v")) < 0.05:
                self.transition_to(PlannerState.GOAL_REACHED)
        elif fsm == PlannerState.GOAL_REACHED:
            self.last_command = (0.0, 0.0)
        elif fsm == PlannerState.ERROR_STATE:
            # Unrecoverable error: stop planning, hold zero command
            # (jules :386-390). Exit only through recover() -> RESETTING.
            self.last_command = (0.0, 0.0)
        elif fsm == PlannerState.RESETTING:
            # Reset the PLANNER, not the robot: in this driver the State
            # object doubles as the simulated ground-truth pose (the
            # reference's reset zeroes only the estimator state and the sim
            # re-supplies the pose via the callback; zeroing here would
            # teleport every robot to the origin). The environment teleport
            # is reset_to_start(), driven by MultiRobotDriver.
            self.planner.reset(None, None)
            self.data.dynamic_obstacles = []
            self.data.goal = self.goal
            self.data.goal_received = True
            self.comm = CommunicationState()
            self._peer_trajectories.clear()
            self._validated_peers.clear()
            self._last_trajectory_msg = None  # don't serve stale plans
            self.bus.sync_ready.discard(self.ns)
            self.bus.first_poses.pop(self.ns, None)
            self.error_reason = ""
            self.transition_to(PlannerState.TIMER_STARTUP)

        self.last_output = output
        m = MPCMetrics(
            stamp=t_start, robot_ns=self.ns, planner_state=self.fsm.name,
            velocity=self.state.get("v"),
            position_x=self.state.get("x"), position_y=self.state.get("y"),
            planning_time_ms=(self.clock() - t_start) * 1e3,
            communicated=communicated,
            communication_trigger=self.comm.trigger_reason.name,
        )
        if output is not None:
            m.solver_success = output.success
            m.solver_exit_code = output.exit_code
            m.objective = output.objective
            m.selected_topology_id = output.selected_topology_id
            m.selected_planner_index = output.selected_planner_index
            m.used_guidance = output.used_guidance
            m.num_guidance_found = output.num_of_guidance_found
            m.topology_changed = output.topology_changed
        self.metrics.add(m)
        return m

    def _guarded_plan_cycle(self, external_obstacles):
        """_plan_cycle with the ERROR_STATE guard: an exception escaping the
        planner is unrecoverable-by-planning (the reference's error entry,
        e.g. jules_..._working_one.cpp:1502) — stop with a zero command and
        land in ERROR_STATE; a later recover() re-enters via RESETTING."""
        try:
            return self._plan_cycle(external_obstacles)
        except Exception as exc:  # noqa: BLE001 — any planner failure
            self.enter_error_state(f"{type(exc).__name__}: {exc}")
            return None, False

    def _plan_cycle(self, external_obstacles):
        """prepare -> solve -> command -> communicate (jules :800-1330)."""
        self.prepare_obstacle_data(external_obstacles)
        output = self.planner.solve_mpc(self.state, self.data)

        if output.success:
            a = self.planner.get_solution(0, "a")
            w = self.planner.get_solution(0, "w")
            self.last_command = (a, w)
            traj = np.asarray([p for p in output.trajectory.positions])
            oris = np.asarray(output.trajectory.orientations)
        else:
            # Braking fallback: command + braking trajectory for peers
            # (jules :1169-1218)
            self.last_command = (
                -abs(self.settings["deceleration_at_infeasible"]), 0.0)
            traj, oris = self._braking_trajectory()

        should_send = decide_communication(
            self.fsm, output, self.comm, self.settings, self.clock(), traj)
        if should_send:
            msg = TrajectoryMessage(
                robot_ns=self.ns, robot_index=self.index,
                positions=traj, orientations=oris,
                radius=self.settings["robot_radius"],
                dt=self.planner.solver.dt, stamp=self.clock(),
                trigger_reason=self.comm.trigger_reason,
                is_braking=not output.success)
            self.bus.publish(self.ns, msg)
            self._last_trajectory_msg = msg
            self.comm.last_send_time = self.clock()
            self.comm.last_communicated_trajectory = traj.copy()
            self.comm.n_sent += 1
        return output, should_send

    def _braking_trajectory(self):
        """Constant-heading braking rollout (jules :1169-1218)."""
        N = self.planner.solver.N
        dt = self.planner.solver.dt
        x, y = self.state.get("x"), self.state.get("y")
        psi, v = self.state.get("psi"), self.state.get("v")
        a = -abs(self.settings["deceleration_at_infeasible"])
        pos, ori = [], []
        for _ in range(N):
            pos.append([x, y])
            ori.append(psi)
            x += v * dt * np.cos(psi)
            y += v * dt * np.sin(psi)
            v = max(v + a * dt, 0.0)
        return np.asarray(pos), np.asarray(ori)

    def reset_to_start(self) -> None:
        """Environment (teleport) reset: back to the initial pose at rest
        (the simulator-side half of the episode reset,
        ros1_jackalsimulator.cpp:368-387)."""
        self.state.reset()
        self.state.set("x", self.start_pose[0])
        self.state.set("y", self.start_pose[1])
        self.state.set("psi", self.start_pose[2])
        self.last_command = (0.0, 0.0)
        self.last_output = None
        self._last_trajectory_msg = None

    def apply_command(self, dt: float) -> None:
        """Integrate own dynamics with the last command held zero-order over
        ``dt`` (sim actuation): the model's RK4 step on the host, f64."""
        a, w = self.last_command
        if a < 0.0:
            # The braking ramp stops AT standstill (ros1_jackalsimulator.cpp:
            # 190-201): clamp so v cannot cross zero mid-step — otherwise a
            # stopped robot integrates a net backward drift (RK4 averages
            # the negative-v portion of the step).
            a = max(a, -self.state.get("v") / max(float(dt), 1e-9))
        u = np.zeros(self.model.nu)
        u[0], u[1] = a, w
        arr = integrate_on_host(self.model, self.state.as_array(), u, dt)
        iv = self.model.state_index("v")
        arr[iv] = max(arr[iv], 0.0)  # no reverse from braking
        self.state.set_array(arr)


class MultiRobotDriver:
    """Multi-robot simulation loop (the Gazebo+launch-file role).

    ``run`` ticks all robots in lockstep (round 1/2 behavior); the reference's
    robots run on INDEPENDENT ROS timers, so ``run_desynchronized`` steps a
    fine simulation clock and fires each robot's tick on its own jittered
    period — peers' trajectory data is then genuinely stale between ticks,
    which is the regime the stale-trajectory interpolation and the five
    communication triggers were designed for (jules :836-1065, :1400-1482).
    ``run_experiments`` adds the reference's episode layer: record every
    iteration into an :class:`..utils.datasaver.ExperimentUtil`, reset the
    environment when all robots reach their objectives, and segment metrics
    per episode (ros1_jackalsimulator.cpp:368-387,
    experiment_util.cpp:125-157)."""

    def __init__(self, agents: List[RobotAgent], clock=None,
                 experiment_util=None):
        self.agents = agents
        namespaces = [a.ns for a in agents]
        for a in agents:
            a.set_peers(namespaces)
        self._clock = clock
        self.experiment = experiment_util
        self.episode_collisions = 0
        self._in_collision = False

    # -- collision monitoring (the sim env's collision check role) ---------
    def _check_collisions(self) -> None:
        agents = self.agents
        min_d, limit = np.inf, 0.0
        for i in range(len(agents)):
            for j in range(i + 1, len(agents)):
                d = float(np.linalg.norm(agents[i].state.get_position()
                                         - agents[j].state.get_position()))
                lim = (agents[i].settings["robot_radius"]
                       + agents[j].settings["robot_radius"])
                if d - lim < min_d - limit:
                    min_d, limit = d, lim
        colliding = min_d < limit
        if colliding and not self._in_collision:
            self.episode_collisions += 1  # edge-triggered event count
        self._in_collision = colliding

    def _record(self, agent, m) -> None:
        if self.experiment is not None:
            self.experiment.update(
                agent.state, agent.data, agent.last_output,
                runtime_s=m.planning_time_ms / 1e3,
                now=self._clock.t if self._clock is not None else None)

    def run(self, n_cycles: int, obstacle_provider=None) -> MetricsLog:
        log = MetricsLog()
        dt = float(self.agents[0].settings["integrator_step"])
        for cycle in range(n_cycles):
            external = obstacle_provider(cycle) if obstacle_provider else None
            for agent in self.agents:
                m = agent.tick(external_obstacles=external)
                log.add(m)
                self._record(agent, m)
            for agent in self.agents:
                agent.apply_command(dt)
            self._check_collisions()
            if self._clock is not None:
                self._clock.t += dt
            if all(a.fsm == PlannerState.GOAL_REACHED for a in self.agents):
                break
        return log

    def run_desynchronized(self, n_cycles: int, obstacle_provider=None,
                           jitter: float = 0.3, sim_substeps: int = 4,
                           seed: int = 0) -> MetricsLog:
        """Independent per-robot timers: robot i's ticks fire at its own
        random phase and a per-tick period jittered by ±``jitter``; the
        simulation advances in ``period / sim_substeps`` steps with commands
        held zero-order between ticks. Requires a driver clock (the agents'
        notion of elapsed time must be the simulated one for staleness to be
        real)."""
        assert self._clock is not None, "desynchronized run needs a sim clock"
        rng = np.random.default_rng(seed)
        log = MetricsLog()
        # Tick cadence matches the lockstep loop (one plan per integrator
        # step); phases/jitter desynchronize the robots within that cadence.
        period = float(self.agents[0].settings["integrator_step"])
        sim_dt = period / sim_substeps
        next_tick = {a.ns: self._clock.t + rng.uniform(0.0, period)
                     for a in self.agents}
        t_end = self._clock.t + n_cycles * period
        cycle = 0
        while self._clock.t < t_end:
            external = obstacle_provider(cycle) if obstacle_provider else None
            for agent in self.agents:
                if self._clock.t + 1e-9 >= next_tick[agent.ns]:
                    m = agent.tick(external_obstacles=external)
                    log.add(m)
                    self._record(agent, m)
                    next_tick[agent.ns] += period * (
                        1.0 + jitter * rng.uniform(-1.0, 1.0))
            for agent in self.agents:
                agent.apply_command(sim_dt)
            self._check_collisions()
            self._clock.t += sim_dt
            cycle += 1
            if all(a.fsm == PlannerState.GOAL_REACHED for a in self.agents):
                break
        return log

    def reset_environment(self) -> None:
        """All-robots-reached-objective reset (the aggregator +
        environment-reset role, ros1_jackalsimulator.cpp:368-387): robots at
        their goal take the GOAL_REACHED -> RESETTING edge; any stragglers
        are teleported by the environment (hard reset outside the planner
        FSM's own transition table)."""
        for a in self.agents:
            if a.fsm == PlannerState.GOAL_REACHED:
                a.transition_to(PlannerState.RESETTING)
            else:
                a.fsm = PlannerState.RESETTING  # env teleport (not a planner
                a.previous_fsm = PlannerState.UNINITIALIZED  # transition)
            a.reset_to_start()
        self.episode_collisions = 0
        self._in_collision = False

    def run_experiments(self, n_episodes: int, n_cycles: int,
                        obstacle_provider=None, desynchronized: bool = False,
                        **kwargs) -> MetricsLog:
        """Episode-segmented experiment loop. Each episode runs until all
        robots reach their goals (or the cycle budget expires), is closed in
        the :class:`ExperimentUtil` with duration/completed/collision
        metrics, and the environment resets for the next one."""
        log = MetricsLog()
        now = (lambda: self._clock.t) if self._clock is not None else None
        for ep in range(n_episodes):
            if self.experiment is not None:
                self.experiment.set_start_experiment(
                    now() if now else None)
            ep_log = (self.run_desynchronized(n_cycles, obstacle_provider,
                                              **kwargs)
                      if desynchronized
                      else self.run(n_cycles, obstacle_provider))
            for ns, records in ep_log.records.items():
                for m in records:
                    log.add(m)
            if self.experiment is not None:
                self.experiment.on_task_complete(
                    completed=self.all_reached_goal(),
                    collisions=self.episode_collisions,
                    now=now() if now else None)
            if ep + 1 < n_episodes:
                self.reset_environment()
        return log

    def all_reached_goal(self) -> bool:
        return all(a.fsm == PlannerState.GOAL_REACHED for a in self.agents)
