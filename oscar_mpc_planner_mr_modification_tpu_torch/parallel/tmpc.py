"""T-MPC++ parallel optimization: the planners of one robot as one batch.

Counterpart of the JAX package's ``parallel/tmpc.py``. The planner axis
(``n_paths`` guided planners plus one unguided) is the batch of one fleet
solve: per-planner parameters, warm starts and topology-constraint
linearizations are stacked into (P, ...) numpy arrays, solved on the device
in one upload, one solve and one readback
(:func:`..ops.sqp.make_buffered_packed_solve`), and the host then picks the
winner. Semantics kept from the JAX optimizer:

- the guidance goal grid and PRM update in :meth:`TMPCOptimizer.update`;
- guided planners warm-start from their guidance spline, the unguided one
  keeps the main solver's warm start;
- single-disc linearized topology halfspaces around each planner's warm
  start (radius robot + 1e-3);
- per-planner consistency parameters gated to stages 1..N-2, and fair-cost
  selection: the consistency cost is subtracted from each planner's
  objective, and the previously selected topology is weighted by
  ``selection_weight_consistency``;
- the best feasible planner by that cost; an unguided winner classified into
  a homotopy class; consistency tracking reset when every planner fails;
  the winner copied into the main solver.

The fleet backend is decided from the config alone, before any launch
(:func:`fleet_backend_for`): under ``"mirror"`` (the default
regularization), which the fused kernel does not run, ``"lanes"`` (per SQP
iteration one launch of the linearize entry that mirrors the Hessians in
the kernel and one of kernel B1 on its buffer), or ``"pallas"`` (B1 with
``torch.func`` linearization) where ``n_qp_iter_warm > 0`` asks for warm
duals, which only that backend has; else ``"fused"`` (kernel B2, the whole
SQP in one launch). It is never chosen on an exception: an OCP the fused
kernel's header does not cover raises ``NotImplementedError`` when the
optimizer is built.

A tick's phases here are spans of ``utils/profiling.py``: ``guidance``
(the PRM), ``tmpc.assemble`` (the planners' inputs), ``launch`` (staging
and the launches), ``select`` (readback and selection, with the wait on
the device as ``fetch_wait`` inside it) and ``build`` (a ladder entry's
solve built mid-run, counted in ``solve_builds``); ``optimize_finish``
counts ``tmpc.planners_solved``, ``tmpc.planners_enabled`` (a guidance
trajectory or the unguided planner) and ``tmpc.planners_useful`` (enabled
and solved).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..guidance.global_guidance import (GlobalGuidance, Goal,
                                        GuidanceConfig, TOPOLOGY_NO_MATCH)
from ..ops.sqp import (SQPResult, make_buffered_packed_solve,
                       make_fleet_sqp_solver, scale_iterations, unpack_results)
from ..types import SolverState
from ..utils.profiling import BENCHMARKERS, span


def fleet_backend_for(config) -> str:
    """The fleet backend of a planner's SQP config: ``"lanes"`` for the
    ``"mirror"`` regularization with cold QPs, ``"pallas"`` for ``"mirror"``
    with warm duals (``n_qp_iter_warm > 0``), else ``"fused"``."""
    if config.regularization != "mirror":
        return "fused"
    return "pallas" if config.n_qp_iter_warm > 0 else "lanes"


def packed_fleet_solve(solver, n_problems, backend, n_sqp):
    """The solver's OCP as a fleet of ``n_problems`` problems sharing one
    xinit, solved with ``n_sqp`` SQP iterations on ``backend``: one upload,
    one solve and one readback (:func:`..ops.sqp.make_buffered_packed_solve`)
    on the solver's device."""
    fleet = make_fleet_sqp_solver(
        solver.ocp, scale_iterations(solver.config, n_sqp),
        dtype=solver.dtype, device=solver.device, backend=backend)

    def batched(params, xinit, warm):
        return fleet(params, xinit.expand(n_problems, -1), warm)

    return make_buffered_packed_solve(
        batched, n_problems, solver.N, solver.ocp.npar, solver.nx,
        solver.nvar, solver.dtype, device=solver.device)


class TMPCOptimizer:
    def __init__(self, solver, settings, guidance_config: Optional[GuidanceConfig]
                 = None, clock=time.monotonic):
        self.solver = solver
        self.settings = settings
        self.clock = clock
        self.n_paths = int(settings["guidance"]["n_paths"])
        self.use_tmpcpp = bool(settings["t-mpc"]["use_t-mpc++"])
        self.enable_constraints = bool(settings["t-mpc"]["enable_constraints"])
        self.n_planners = self.n_paths + (1 if self.use_tmpcpp else 0)
        self.robot_radius = float(settings["robot_radius"])

        gcfg = guidance_config or GuidanceConfig(
            N=solver.N, dt=solver.dt,
            n_paths=self.n_paths,
            n_samples=int(settings["guidance"]["n_samples"]),
            seed=int(settings["guidance"]["seed"]),
            max_velocity=float(settings["guidance"]["max_velocity"]),
            max_acceleration=float(settings["guidance"]["max_acceleration"]),
            longitudinal_goals=int(settings["guidance"]["longitudinal_goals"]),
            vertical_goals=int(settings["guidance"]["vertical_goals"]),
            selection_weight_consistency=float(
                settings["guidance"]["selection_weight_consistency"]),
            comparison_function=str(
                settings["guidance"].get("comparison_function", "Winding")),
        )
        self.global_guidance = GlobalGuidance(gcfg)

        # One packed solve per ladder entry (n_sqp -> solve), built on first
        # selection; all of one backend, sharing one kernel library (the
        # schedule is runtime data). The full count is built here, so an OCP
        # the backend does not cover raises now.
        self.fleet_backend = fleet_backend_for(solver.config)
        self._fleet_n_full = solver._iter_ladder[0]
        self._packed_solve = {self._fleet_n_full: packed_fleet_solve(
            solver, self.n_planners, self.fleet_backend, self._fleet_n_full)}
        self._timed_variants = set()  # ladder entries past their first call
        self._pending_solve = None  # the in-flight solve and its timing
        self._pending_ctx = None  # host context for optimize_finish
        self.last_fetch_wait = 0.0  # blocking readback time of the last tick

        # Parameter column indices
        reg = solver.ocp.registry
        self._has_topology_params = reg.has_bundle("lin_constraint_a1")
        if self._has_topology_params:
            self._lin_a1 = np.asarray(reg.bundle_indices("lin_constraint_a1"))
            self._lin_a2 = np.asarray(reg.bundle_indices("lin_constraint_a2"))
            self._lin_b = np.asarray(reg.bundle_indices("lin_constraint_b"))
        self._consistency_available = (
            reg.has_parameter("consistency_weight")
            and bool(settings["JULES"]["consistency_enabled"]))
        self._consistency_on_non_guided = bool(
            settings["JULES"].get("consistency_on_non_guided_planner", False))
        self.consistency_weight = float(settings["weights"].get("consistency", 0.0))

        # Consistency tracking
        self._has_previous_trajectory = False
        self._prev_trajectory = np.zeros((solver.N, 2))
        self._interp_prev = np.zeros((solver.N, 2))
        self._prev_timestamp = 0.0
        self._prev_selected_topology_id = -1
        self._prev_was_original = False
        self.best_planner_index = -1

        # Last-cycle diagnostics (per planner)
        self.last_objectives = np.zeros(self.n_planners)
        self.last_exit_codes = np.zeros(self.n_planners, dtype=int)

    # ------------------------------------------------------------------
    def _dispatch_batch(self, params, xinit, warmstarts) -> None:
        """First half of the batched solve: upload, solve and readback
        queued on the device, nothing waited for (complete with
        :meth:`_fetch_batch`). The iteration count follows the solver's
        budget ladder (``Solver.select_iterations``); a ladder entry's first
        solve is not fed into the per-iteration time."""
        with span("launch"):
            n = self.solver.select_iterations()
            fn = self._packed_solve.get(n)
            if fn is None:
                with span("build"):
                    BENCHMARKERS.count("solve_builds")
                    fn = self._packed_solve[n] = packed_fleet_solve(
                        self.solver, self.n_planners, self.fleet_backend, n)
            first = n not in self._timed_variants
            self._timed_variants.add(n)
            t0 = time.perf_counter()
            handle = fn.dispatch(params, xinit, warmstarts)
            self._pending_solve = {"handle": handle, "fn": fn, "n": n,
                                   "t0": t0, "first": first}

    def _fetch_batch(self) -> SQPResult:
        """Blocking readback of the in-flight batched solve, as numpy.

        ``last_fetch_wait`` is what the tick waited on the device after its
        overlapped host work: a tick's wall time minus it is its host share.
        The time fed into the ladder runs from dispatch to the end of the
        readback, so in pipelined use it includes the overlapped host work:
        an overestimate, which only makes the ladder shed iterations
        earlier."""
        T, nz = self.solver.N + 1, self.solver.nvar
        pending = self._pending_solve
        self._pending_solve = None
        with span("fetch_wait") as waited:
            out = pending["fn"].fetch(pending["handle"])
        now = time.perf_counter()
        self.last_fetch_wait = waited.duration
        self.solver.note_solve_time(
            pending["n"], now - pending["t0"], compile_call=pending["first"])
        return unpack_results(out, T, nz)

    def _solve_batch(self, params, xinit, warmstarts) -> SQPResult:
        """The batched solve, synchronously: :meth:`_dispatch_batch`, then
        :meth:`_fetch_batch`."""
        self._dispatch_batch(params, xinit, warmstarts)
        return self._fetch_batch()

    # ------------------------------------------------------------------
    def update(self, state, data, module_data) -> None:
        """Load obstacles, start and goals into the guidance planner and run
        the PRM (the span ``guidance``)."""
        N = self.solver.N
        n_steps = N + 1
        trajs, radii = [], []
        for obs in data.dynamic_obstacles:
            if obs.prediction.empty():
                traj = np.broadcast_to(np.asarray(obs.position, dtype=float),
                                       (n_steps, 2))
            else:
                mp = obs.prediction.mode_positions(0)
                traj = np.concatenate(
                    [np.asarray(obs.position, dtype=float)[None],
                     mp])[:n_steps]
                if len(traj) < n_steps:
                    traj = np.concatenate([
                        traj, np.broadcast_to(traj[-1],
                                              (n_steps - len(traj), 2))])
            trajs.append(traj)
            radii.append(obs.radius + self.robot_radius)
        self.global_guidance.load_obstacles(
            np.asarray(trajs) if trajs else np.zeros((0, n_steps, 2)),
            np.asarray(radii))
        if data.static_obstacles:
            self.global_guidance.load_static_obstacles(data.static_obstacles[0])

        self.global_guidance.set_start(
            state.get_position(), state.get("psi"), state.get("v"))

        if module_data.path is not None:
            width_half = float(self.settings["road"]["width"]) / 2.0
            s_start = max(0.0, state.get("spline")) if state.has("spline") else 0.0
            self.global_guidance.load_reference_path(
                s_start, module_data.path,
                width_half - self.robot_radius - 0.1,
                width_half - self.robot_radius - 0.1,
                reference_velocity=float(
                    self.settings["weights"].get("reference_velocity", 2.0)))
        elif data.goal_received and data.goal is not None:
            # Goal-mode grid: a lateral fan around the straight line to the
            # goal, clamped to the PRM's reach over the horizon (goals beyond
            # v_max * T are unreachable and would void the search).
            direction = data.goal - state.get_position()
            dist = np.linalg.norm(direction)
            direction = direction / (dist + 1e-9)
            cfg = self.global_guidance.config
            reach = 0.8 * cfg.max_velocity * cfg.N * cfg.dt
            anchor = state.get_position() + direction * min(dist, reach)
            normal = np.array([-direction[1], direction[0]])
            goals = [Goal(anchor, 0.0)]
            for d in (-2.0, -1.0, 1.0, 2.0):
                goals.append(Goal(anchor + normal * d, abs(d)))
            self.global_guidance.set_goals(goals)

        with span("guidance"):
            self.global_guidance.update()
        module_data.num_of_guidance_found = (
            self.global_guidance.number_of_guidance_trajectories())

    # ------------------------------------------------------------------
    def optimize(self, state, data, module_data) -> int:
        """The parallel solve and the selection."""
        started = self.optimize_dispatch(state, data, module_data)
        if started is not True:
            return int(started)
        return self.optimize_finish(module_data)

    def optimize_dispatch(self, state, data, module_data):
        """Host half of :meth:`optimize` up to and including the dispatch.
        Returns ``True`` with the solve in flight (complete with
        :meth:`optimize_finish`), or an ``int`` exit code when the cycle
        resolved without a solve (guidance failed and T-MPC++ is off)."""
        gg = self.global_guidance
        if not self.use_tmpcpp and not gg.succeeded():
            return 0
        with span("tmpc.assemble"):
            self._interpolate_prev_trajectory()

            P, N = self.n_planners, self.solver.N
            n_guidance = gg.number_of_guidance_trajectories()

            params = np.repeat(self.solver.params.data[None], P, axis=0)
            warmstarts = np.repeat(self.solver._loaded_warmstart[None], P,
                                   axis=0)
            disabled = np.zeros(P, dtype=bool)
            is_original = np.zeros(P, dtype=bool)
            if self.use_tmpcpp:
                is_original[P - 1] = True
            consistency_enabled = np.zeros(P, dtype=bool)

            model = self.solver.ocp.model
            ix, iy = model.var_index("x"), model.var_index("y")
            ipsi, iv = model.var_index("psi"), model.var_index("v")

            topo_planners = []
            for p in range(P):
                if not is_original[p]:
                    if p >= n_guidance:
                        disabled[p] = True
                        continue
                    traj = gg.get_guidance_trajectory(p)
                    # Warm start from the guidance spline
                    if not self.settings["t-mpc"][
                            "warmstart_with_mpc_solution"]:
                        warmstarts[p, 1:N, ix] = traj.positions[1:N, 0]
                        warmstarts[p, 1:N, iy] = traj.positions[1:N, 1]
                        vel = np.asarray(traj.velocities[1:N])
                        warmstarts[p, 1:N, ipsi] = np.arctan2(vel[:, 1],
                                                              vel[:, 0])
                        warmstarts[p, 1:N, iv] = np.linalg.norm(vel, axis=1)
                    if self.enable_constraints and self._has_topology_params:
                        topo_planners.append(p)
                consistency_enabled[p] = self._should_enable_consistency(
                    p, is_original[p], n_guidance)
                if self._consistency_available:
                    self._fill_consistency_params(params[p],
                                                  consistency_enabled[p])
            self._fill_topology_constraints(params, warmstarts, data,
                                            topo_planners)

        # One dispatch; the readback is in optimize_finish. Snapshot what the
        # selection needs of the guidance: a pipelined driver may run the
        # next tick's PRM update (new trajectories and obstacles) while this
        # solve is in flight, and the finish must classify and weight against
        # the trajectories this solve was guided by.
        self._dispatch_batch(params, self.solver._xinit, warmstarts)
        trajs_snapshot = list(gg.trajectories)
        obs_snapshot = np.asarray(gg._obstacle_trajs)
        self._pending_ctx = (params, disabled, is_original,
                             consistency_enabled, n_guidance,
                             trajs_snapshot, obs_snapshot)
        return True

    def optimize_finish(self, module_data) -> int:
        """Readback and selection half of :meth:`optimize`."""
        with span("select"):
            gg = self.global_guidance
            P, N = self.n_planners, self.solver.N
            model = self.solver.ocp.model
            ix, iy = model.var_index("x"), model.var_index("y")
            (params, disabled, is_original, consistency_enabled,
             n_guidance, trajs_snapshot, obs_snapshot) = self._pending_ctx
            self._pending_ctx = None

            results = self._fetch_batch()
            Z = results.z
            costs = results.cost.copy()
            exit_codes = results.exit_code
            success = results.success & ~disabled
            BENCHMARKERS.count("tmpc.planners_solved", P)
            BENCHMARKERS.count("tmpc.planners_enabled",
                               P - int(disabled.sum()))
            BENCHMARKERS.count("tmpc.planners_useful", int(success.sum()))

            # Fair-cost comparison: subtract the realized consistency cost
            for p in range(P):
                if consistency_enabled[p] and self._has_previous_trajectory:
                    pos = Z[p, 1 : N - 1][:, [ix, iy]]
                    diff = pos - self._interp_prev[1 : N - 1]
                    costs[p] -= self.consistency_weight * float(
                        np.sum(diff**2))
                if (not is_original[p]) and p < n_guidance:
                    if trajs_snapshot[p].previously_selected:
                        costs[p] *= gg.config.selection_weight_consistency

            self.last_objectives = costs
            self.last_exit_codes = exit_codes

            # Selection: the feasible planner of least cost (the first on a
            # tie)
            feasible = np.where(success)[0]
            if len(feasible) == 0:
                self.best_planner_index = -1
                self._has_previous_trajectory = False
                self._prev_selected_topology_id = -1
                self._prev_was_original = False
                module_data.solver_state = SolverState.SOLVED_FAILED
                return int(exit_codes[0])

            best = int(feasible[np.argmin(costs[feasible])])
            self.best_planner_index = best
            best_path = Z[best, :, [ix, iy]].T  # (N+1, 2)

            # Topology bookkeeping
            if is_original[best]:
                guidance_id = 2 * gg.config.n_paths  # "no topology" id
                if (self.settings["JULES"][
                        "assign_meaningful_topology_id_to_non_guided"]
                        and n_guidance > 0):
                    match = gg.find_topology_class_for_path(
                        best_path, trajectories=trajs_snapshot,
                        obstacle_trajs=obs_snapshot)
                    if match != TOPOLOGY_NO_MATCH:
                        guidance_id = match
                non_guided_matched = guidance_id != 2 * gg.config.n_paths
                module_data.non_guided_homology_failed = not non_guided_matched
                if self.settings["JULES"][
                        "override_selected_traject_of_topology_non_guided"]:
                    clear = not non_guided_matched
                else:
                    clear = True
                gg.override_selected_trajectory(guidance_id, clear,
                                                selected_path=best_path)
                module_data.solver_state = (
                    SolverState.SOLVED_WITH_HOMOLOGY_ID if non_guided_matched
                    else SolverState.SOLVED_NO_HOMOLOGY_ID)
            else:
                guidance_id = trajs_snapshot[best].topology_class
                gg.override_selected_trajectory(guidance_id, clear=False,
                                                selected_path=best_path)
                module_data.solver_state = SolverState.SOLVED_WITH_HOMOLOGY_ID

            # The winner becomes the main solver's solution and parameters
            best_result = SQPResult(
                z=results.z[best], cost=results.cost[best],
                eq_res=results.eq_res[best], qp_comp=results.qp_comp[best],
                success=results.success[best],
                exit_code=results.exit_code[best])
            self.solver.load_result(best_result)
            self.solver.params.data[...] = params[best]

            module_data.selected_topology_id = int(guidance_id)
            module_data.selected_planner_index = best
            module_data.used_guidance = not bool(is_original[best])
            module_data.selected_was_non_guided = bool(is_original[best])
            module_data.trajectory_cost = float(costs[best])
            module_data.num_of_guidance_found = n_guidance

            # The trajectory that next cycle's consistency cost follows
            self._prev_trajectory = best_path[:N].copy()
            self._prev_timestamp = self.clock()
            self._has_previous_trajectory = True
            self._prev_selected_topology_id = int(guidance_id)
            self._prev_was_original = bool(is_original[best])

            return int(exit_codes[best])

    # ------------------------------------------------------------------
    def _fill_topology_constraints(self, params, warmstarts, data,
                                   planner_idx) -> None:
        """Single-disc linearized halfspaces around each planner's warm
        start, vectorized over (planners x stages). The projection sweeps
        stay sequential over obstacles: each projection sees the previous
        one's result."""
        if not planner_idx:
            return
        N = self.solver.N
        T = params.shape[1]
        model = self.solver.ocp.model
        ix, iy = model.var_index("x"), model.var_index("y")
        obstacles = data.dynamic_obstacles
        n_rows = len(self._lin_a1)
        radius = 1e-3 + self.robot_radius
        pidx = np.asarray(planner_idx)
        params[np.ix_(pidx, np.arange(T), self._lin_a1)] = 1.0
        params[np.ix_(pidx, np.arange(T), self._lin_a2)] = 0.0
        params[np.ix_(pidx, np.arange(T), self._lin_b)] = 1.0e4
        n_obs = len(obstacles)
        if n_obs == 0:
            return

        # Obstacle centers per stage k=1..N-1 (prediction step k-1, clamped)
        centers = np.empty((N - 1, n_obs, 2))
        for i, obs in enumerate(obstacles):
            pts = obs.prediction.mode_positions(0)  # (L, 2)
            centers[:, i] = pts[np.minimum(np.arange(N - 1), len(pts) - 1)]

        pos = warmstarts[pidx][:, 1:N][:, :, [ix, iy]].copy()  # (Pf, N-1, 2)
        # Project out of obstacle discs (3 sweeps, sequential over obstacles)
        for _ in range(3):
            for i in range(n_obs):
                c = centers[None, :, i]  # (1, N-1, 2)
                d = pos - c
                dist = np.linalg.norm(d, axis=-1, keepdims=True)
                degenerate = dist < 1e-9
                inside = dist < radius
                proj = c + d * (radius / np.maximum(dist, 1e-30))
                pos = np.where(inside & ~degenerate, proj, pos)
                pos = np.where(degenerate, c + np.array([radius, 0.0]), pos)

        # Halfspace rows: normal towards each obstacle center
        n_fill = min(n_obs, n_rows)
        cc = centers[None, :, :n_fill]  # (1, N-1, n_fill, 2)
        diff = cc - pos[:, :, None]  # (Pf, N-1, n_fill, 2)
        dist = np.linalg.norm(diff, axis=-1)  # (Pf, N-1, n_fill)
        ok = dist >= 1e-9
        a = diff / np.maximum(dist, 1e-30)[..., None]
        b = np.sum(a * cc, axis=-1) - radius
        stages = np.arange(1, N)
        params[np.ix_(pidx, stages, self._lin_a1[:n_fill])] = np.where(
            ok, a[..., 0], 1.0)
        params[np.ix_(pidx, stages, self._lin_a2[:n_fill])] = np.where(
            ok, a[..., 1], 0.0)
        params[np.ix_(pidx, stages, self._lin_b[:n_fill])] = np.where(
            ok, b, 1.0e4)

    def _should_enable_consistency(self, p, original, n_guidance) -> bool:
        if not self._consistency_available or not self._has_previous_trajectory:
            return False
        if self._prev_selected_topology_id == -1 and not self._prev_was_original:
            return False
        if original:
            return self._consistency_on_non_guided and self._prev_was_original
        if self._prev_was_original:
            return False
        if p < n_guidance:
            return (self.global_guidance.get_guidance_trajectory(p).topology_class
                    == self._prev_selected_topology_id)
        return False

    def _fill_consistency_params(self, params_p, enabled: bool) -> None:
        """Stage-gated consistency parameters: stages 1..N-2."""
        reg = self.solver.ocp.registry
        N = self.solver.N
        iw = reg.index("consistency_weight")
        ixp = reg.index("prev_traj_x")
        iyp = reg.index("prev_traj_y")
        params_p[:, iw] = 0.0
        params_p[:, ixp] = 0.0
        params_p[:, iyp] = 0.0
        if enabled and self._has_previous_trajectory:
            params_p[1 : N - 1, iw] = self.consistency_weight
            params_p[1 : N - 1, ixp] = self._interp_prev[1 : N - 1, 0]
            params_p[1 : N - 1, iyp] = self._interp_prev[1 : N - 1, 1]

    def _interpolate_prev_trajectory(self) -> None:
        """Shift the stored trajectory by the time elapsed on the clock."""
        if not self._has_previous_trajectory:
            return
        elapsed = max(0.0, self.clock() - self._prev_timestamp)
        dt = self.solver.dt
        N = len(self._prev_trajectory)
        k_shift = int(np.floor(elapsed / dt))
        alpha = (elapsed - k_shift * dt) / dt
        if k_shift >= N - 1:
            self._has_previous_trajectory = False
            return
        out = np.zeros_like(self._prev_trajectory)
        prev = self._prev_trajectory
        for k in range(N):
            src = k + k_shift
            if src < N - 1:
                out[k] = (1 - alpha) * prev[src] + alpha * prev[src + 1]
            elif src == N - 1:
                out[k] = prev[N - 1]
            else:
                vel = (prev[N - 1] - prev[N - 2]) / dt
                out[k] = prev[N - 1] + vel * ((src - (N - 1)) * dt + alpha * dt)
        self._interp_prev = out

    def reset(self) -> None:
        self.global_guidance.reset()
        if self._pending_solve is not None:
            # Drain the in-flight solve: its buffers are reused by the next.
            pending, self._pending_solve = self._pending_solve, None
            pending["fn"].fetch(pending["handle"])
        self._pending_ctx = None
        self._has_previous_trajectory = False
        self._prev_selected_topology_id = -1
        self._prev_was_original = False
        self.best_planner_index = -1
