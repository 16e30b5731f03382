"""Planner core: one control cycle.

Counterpart of the JAX package's ``planner/planner.py`` (``Planner::solveMPC``
of the reference): the data-ready gate, the warm-start policy (shift or hold
after a feasible cycle, the braking ramp after an infeasible one), module
updates and the vectorized parameter fill, the module-owned optimization
(the T-MPC guidance module) with the default solve as fallback, output
extraction and the topology metadata. ``prepare``, ``solve_mpc_start`` and
``solve_mpc_finish`` split the cycle so that the next tick's host work runs
while this tick's solve is on the device.
"""

from __future__ import annotations

import time
from typing import Optional

from ..modules.base import EXIT_CODE_NOT_OPTIMIZED_YET
from ..solver.solver import Solver
from ..types import ModuleData, PlannerOutput, Trajectory
from ..utils.profiling import BENCHMARKERS


class Planner:
    def __init__(self, solver: Solver, modules, settings=None):
        self.solver = solver
        self.modules = modules
        self.settings = settings if settings is not None else solver.settings
        self.module_data = ModuleData()
        self.output = PlannerOutput()
        self.was_reset = True
        self._prepared = None  # (data, ModuleData, staged params) by prepare()
        self._pending = None  # in-flight tick context (solve_mpc_start)
        self._staging_params = None  # prepare()'s fill target (lazy)
        self._startup_time = time.monotonic()
        # Wire the solver into the modules
        for m in self.modules:
            m.solver = solver

    def is_objective_reached(self, state, data) -> bool:
        return all(m.is_objective_reached(state, data) for m in self.modules)

    def on_data_received(self, data, data_name: str) -> None:
        self.modules.on_data_received(data, data_name)

    def solve_mpc(self, state, data) -> PlannerOutput:
        was_feasible = self.output.success
        prev_topology = self.output.selected_topology_id

        self.output = PlannerOutput()
        self.output.previous_topology_id = prev_topology
        self.module_data = ModuleData()

        # 1. Data-ready gate
        if not self.modules.is_data_ready(data):
            self.output.success = False
            self.output.was_infeasible = False
            return self.output

        bench = BENCHMARKERS.get("planning")
        bench.start()

        # 2. Warm start
        shift_forward = bool(
            self.settings.get("shift_previous_solution_forward", False)
            and self.settings.get("enable_output", True))
        if was_feasible:
            self.solver.initialize_warmstart(state, shift_forward)
        else:
            self.solver.initialize_with_braking(state)
        self.solver.set_xinit(state)

        # 3. Module updates
        self.modules.update_all(state, data, self.module_data)

        # 4. Parameter fill, vectorized over stages
        self.modules.set_all_parameters(self.solver.params, data, self.module_data)

        # 5. Latch the warm start
        self.solver.load_warmstart()

        # 6. Timeout budget: 1/f - used - 6 ms. The solver picks its SQP
        #    iteration count from its ladder to fit it
        #    (Solver.select_iterations). Budget tracking activates only when
        #    the caller stamped data.planning_start_time on the
        #    time.monotonic clock (real-vehicle/driver loops); sim-clock or
        #    unset stamps yield a non-positive budget, which the solver treats
        #    as "no budget information" and runs the full iteration count,
        #    keeping simulated runs deterministic.
        start = float(getattr(data, "planning_start_time", 0.0) or 0.0)
        used = (time.monotonic() - start) if start > 0.0 else float("inf")
        self.solver.solver_timeout = (
            1.0 / float(self.settings.get("control_frequency", 20))
            - used - 0.006)

        # 7. Optimize: a module that owns the optimization, else the solver
        opt_bench = BENCHMARKERS.get("optimization")
        opt_bench.start()
        exit_flag = EXIT_CODE_NOT_OPTIMIZED_YET
        for module in self.modules:
            exit_flag = module.optimize(state, data, self.module_data)
            if exit_flag != EXIT_CODE_NOT_OPTIMIZED_YET:
                break
        if exit_flag == EXIT_CODE_NOT_OPTIMIZED_YET:
            exit_flag = self.solver.solve()
        opt_bench.stop()
        bench.stop()

        return self._complete_output(exit_flag, prev_topology)

    def _complete_output(self, exit_flag: int, prev_topology) -> "PlannerOutput":
        """Steps 8-9 of solve_mpc: output extraction and the topology
        metadata."""
        if exit_flag != 1:
            self.output.success = False
            self.output.was_infeasible = True
            self.output.exit_code = exit_flag
            return self.output

        # 8. Output extraction
        self.output.success = True
        self.output.exit_code = exit_flag
        self.output.objective = self.solver.info["pobj"]
        traj = Trajectory(dt=self.solver.dt)
        for k in range(self.solver.N):
            traj.add(self.solver.get_output(k, "x"), self.solver.get_output(k, "y"))
            traj.add_orientation(self.solver.get_output(k, "psi"))
        self.output.trajectory = traj

        # 9. Topology metadata
        md = self.module_data
        self.output.selected_topology_id = md.selected_topology_id
        self.output.selected_planner_index = md.selected_planner_index
        self.output.used_guidance = md.used_guidance
        self.output.trajectory_cost = md.trajectory_cost
        self.output.num_of_guidance_found = md.num_of_guidance_found
        self.output.non_guided_homology_failed = md.non_guided_homology_failed
        self.output.topology_changed = (
            prev_topology != md.selected_topology_id)
        return self.output

    # ------------------------------------------------------------------
    # Pipelined (two-phase) tick: overlap next-tick host work with the
    # in-flight device solve. Exactly ONE solve stays in flight at a time.
    # Usage pattern per control period:
    #
    #   planner.solve_mpc_start(state_k, data_k)      # host prep + dispatch
    #   planner.prepare(pred_state, data_next)        # overlaps the flight
    #   out_k = planner.solve_mpc_finish()            # readback + selection
    #
    # ``prepare`` runs the EXPENSIVE host half (module updates - guidance
    # PRM, contouring segment search, road constraints - and the parameter
    # fill) with a PREDICTED state and the previous tick's warmstart buffer;
    # both are one control period stale, the same staleness class the
    # reference tolerates between sensing and actuation (its guidance also
    # runs on the state sampled at cycle start while the command lands at
    # cycle end). Solution-bound
    # quantities (warmstart shift, xinit, consistency parameters, topology
    # linearizations) are derived in solve_mpc_start from the ACTUAL state
    # and the just-returned solution.
    # ------------------------------------------------------------------
    def prepare(self, state, data) -> bool:
        """Run module updates + parameter fill for an upcoming solve (state
        may be a prediction). Returns False when the data gate fails.

        The fill lands in a STAGING buffer, not ``solver.params``: prepare
        runs while the previous tick's solve is still in flight, and that
        tick's finish copies the winning planner's parameters back into the
        live buffer — a direct fill here would be
        clobbered by that copy-back. solve_mpc_start latches the staged
        fill into the live buffer right before dispatch."""
        if not self.modules.is_data_ready(data):
            self._prepared = None
            return False
        md = ModuleData()
        self.modules.update_all(state, data, md)
        if self._staging_params is None:
            self._staging_params = self.solver.ocp.registry.new_buffer(
                self.solver.N)
        self.modules.set_all_parameters(self._staging_params, data, md)
        self._prepared = (data, md, self._staging_params)
        return True

    def predicted_next_state(self, state):
        """State predicted at the NEXT control period, from the last
        COMPLETED solution (the shift-forward warm start's own prediction).

        Called mid-flight (between solve_mpc_start and _finish — the
        intended overlap window), the freshest completed solution is the
        PREVIOUS tick's, so the next tick sits at its stage 2; called
        between ticks, stage 1. Falls back to the current state unchanged
        when the last solve was infeasible (the braking tick breaks the
        prediction chain anyway)."""
        nxt = type(state)(self.solver.ocp.model)
        steps = 2 if self._pending is not None else 1
        if self.solver._exit_code == 1:
            k = min(steps, self.solver.N - 1)
            for name in self.solver.ocp.model.states:
                nxt.set(name, self.solver.get_output(k, name))
        else:
            nxt.set_array(state.as_array())
        return nxt

    def solve_mpc_start(self, state, data) -> None:
        """First half of :meth:`solve_mpc`: consume prepared host work (or
        run it inline), initialize warmstart/xinit from the actual state,
        and dispatch the solve. Complete with :meth:`solve_mpc_finish`."""
        was_feasible = self.output.success
        prev_topology = self.output.selected_topology_id
        self.output = PlannerOutput()
        self.output.previous_topology_id = prev_topology

        prepared = self._prepared
        self._prepared = None
        if prepared is None or prepared[0] is not data:
            if not self.prepare(state, data):
                self.output.success = False
                self.output.was_infeasible = False
                self._pending = ("gated", 0, prev_topology, None)
                return
            prepared = self._prepared
            self._prepared = None
        self.module_data = prepared[1]
        # Latch the staged parameter fill into the live buffer (see prepare)
        self.solver.params.data[...] = prepared[2].data

        bench = BENCHMARKERS.get("planning")
        bench.start()

        shift_forward = bool(
            self.settings.get("shift_previous_solution_forward", False)
            and self.settings.get("enable_output", True))
        if was_feasible:
            self.solver.initialize_warmstart(state, shift_forward)
        else:
            self.solver.initialize_with_braking(state)
        self.solver.set_xinit(state)

        # State-bound refresh for the ACTUAL state (e.g. re-anchor the
        # contouring progress — prepare() anchored the PREDICTED state
        # object, not this one). AFTER set_xinit, matching the serial path
        # where update()'s anchor lands in the state after xinit is taken
        # and reaches the solver next tick via the model's progress
        # dynamics.
        for m in self.modules:
            m.refresh_state(state, self.module_data)

        # Re-run fills that read the (just-initialized) warmstart buffer
        for m in self.modules:
            if m.fill_depends_on_solution:
                m.set_parameters(self.solver.params, data, self.module_data)

        self.solver.load_warmstart()

        start = float(getattr(data, "planning_start_time", 0.0) or 0.0)
        used = (time.monotonic() - start) if start > 0.0 else float("inf")
        self.solver.solver_timeout = (
            1.0 / float(self.settings.get("control_frequency", 20))
            - used - 0.006)

        BENCHMARKERS.get("optimization").start()
        for module in self.modules:
            r = module.optimize_dispatch(state, data, self.module_data)
            if r is True:
                self._pending = ("module", module, prev_topology, (state, data))
                return
            if r is not None:
                self._pending = ("sync", int(r), prev_topology, None)
                return
        # No module claimed the optimization: the default synchronous
        # solve. No overlap benefit, still correct.
        self._pending = ("sync", self.solver.solve(), prev_topology, None)

    def solve_mpc_finish(self) -> "PlannerOutput":
        """Second half of :meth:`solve_mpc`: readback + selection + output."""
        kind, payload, prev_topology, ctx = self._pending
        self._pending = None
        if kind == "gated":
            return self.output
        if kind == "module":
            state, data = ctx
            exit_flag = payload.optimize_finish(state, data, self.module_data)
        else:
            exit_flag = payload
        BENCHMARKERS.get("optimization").stop()
        BENCHMARKERS.get("planning").stop()
        return self._complete_output(exit_flag, prev_topology)

    def get_solution(self, k: int, var_name: str) -> float:
        return self.solver.get_output(k, var_name)

    def get_ego_prediction(self, k: int, var_name: str) -> float:
        return self.solver.get_ego_prediction(k, var_name)

    def visualize(self, state, data) -> None:
        for m in self.modules:
            m.visualize(data, self.module_data)

    def reset(self, state=None, data=None, success: bool = True) -> None:
        """Reset the modules, the solver and the pipelined state."""
        self.modules.reset_all()
        self.solver.reset()
        self._prepared = None
        self._pending = None
        if state is not None:
            state.reset()
        if data is not None:
            data.reset()
        self.output = PlannerOutput()
        self.was_reset = True
