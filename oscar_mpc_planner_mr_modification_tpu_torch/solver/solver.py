"""Host-side Solver object: parameter, warm-start and output buffers, and
the single-instance solve.

Counterpart of the JAX package's ``solver/solver.py``: name-indexed
parameter, warm-start and output access, the shift-forward, hold and braking
warm-start policies, exit-flag semantics, cloning for parallel planners, and
the budget ladder of SQP iteration counts (``select_iterations``,
``note_solve_time``). Buffers are numpy.

:meth:`Solver.solve` runs the single-instance SQP
(:func:`..ops.sqp.make_sqp_solver`, plain PyTorch on the solver's device)
at the ladder entry that fits the tick's budget, with one device-to-host
copy of the result; it serves configurations whose modules do not claim the
optimization (``factory.configuration_basic``). The T-MPC optimizer
(:mod:`..parallel.tmpc`) instead stacks the buffers over its planners,
solves them as one fleet and hands the winner back through
:meth:`Solver.load_result`. The solve of each ladder entry is built on its
first selection and shared by every clone.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..ops.sqp import (SQPConfig, SQPResult, _phases_of, fetch_result_single,
                       make_sqp_solver, scale_iterations)
from .ocp import OCP


class Solver:
    def __init__(self, ocp: OCP, settings=None, dtype=torch.float64,
                 sqp_config: Optional[SQPConfig] = None, device="cuda"):
        settings = settings if settings is not None else ocp.settings
        self.ocp = ocp
        self.settings = settings
        self.N = ocp.N
        self.nu, self.nx, self.nvar = ocp.nu, ocp.nx, ocp.nvar
        self.dt = ocp.dt
        self.dtype = dtype
        self.device = torch.device(device)

        ss = settings.get("solver_settings", {})
        if sqp_config is None:
            # qp_iter_schedule: optional [[n_sqp, n_qp_iter], ...] phases of
            # the inexact-SQP schedule (SQPConfig.qp_iter_schedule).
            sched = tuple(
                (int(n), int(q)) for n, q in ss.get("qp_iter_schedule", ()))
            n_sqp = (sum(n for n, _ in sched) if sched
                     else int(ss.get("iterations", 10)))
            sqp_config = SQPConfig(
                n_sqp=n_sqp,
                n_qp_iter=int(ss.get("qp_iterations", 18)),
                qp_iter_schedule=sched,
            )
        self.config = sqp_config
        self._solve_fn = make_sqp_solver(ocp, sqp_config, dtype=dtype,
                                         device=self.device)

        # Budget-adaptive iteration control: a ladder of SQP iteration counts
        # (full, half, quarter); the largest one predicted to fit the
        # remaining budget runs. The per-iteration time is an EMA fed by
        # whoever solved last. The full count's solve is built above, the
        # others on their first selection.
        self.adaptive_iterations = bool(ss.get("adaptive_iterations", True))
        n_full = sum(n for n, _ in _phases_of(sqp_config))
        self._iter_ladder = sorted(
            {n_full, max(1, n_full // 2), max(1, n_full // 4)}, reverse=True)
        self._ladder_fns = {n_full: self._solve_fn}
        self._timed_variants = set()  # ladder entries past their first solve
        self._iter_time_ema = 0.0  # seconds per SQP iteration (0 = unknown)
        self.last_iterations_run = 0

        # Parameter buffer (N, npar)
        self.params = ocp.registry.new_buffer(self.N)
        # Warm-start buffer x0: (N+1, nvar) = (u, x) per stage
        self._x0 = np.zeros((self.N + 1, self.nvar))
        self._loaded_warmstart = np.zeros((self.N + 1, self.nvar))
        # Output
        self._output_z = np.zeros((self.N + 1, self.nvar))
        self._xinit = np.zeros(self.nx)
        self.info = {"pobj": float("inf"), "eq_res": float("inf"), "qp_comp": 0.0}
        self.solver_timeout = 0.0  # the tick's remaining budget, seconds
        self._exit_code = 0

    # -- cloning -----------------------------------------------------------
    def clone(self) -> "Solver":
        out = Solver.__new__(Solver)
        out.__dict__.update(self.__dict__)
        out.params = self.params.copy()
        out._x0 = self._x0.copy()
        out._loaded_warmstart = self._loaded_warmstart.copy()
        out._output_z = self._output_z.copy()
        out._xinit = self._xinit.copy()
        out.info = dict(self.info)
        return out

    def copy_params_from(self, other: "Solver") -> None:
        """The reference's ``operator=``: copy the parameters and the
        warm-start buffer only."""
        self.params = other.params.copy()
        self._x0 = other._x0.copy()

    def reset(self) -> None:
        self.params = self.ocp.registry.new_buffer(self.N)
        self._x0[...] = 0.0
        self._output_z[...] = 0.0
        self.info = {"pobj": float("inf"), "eq_res": float("inf"), "qp_comp": 0.0}

    # -- parameters --------------------------------------------------------
    def set_parameter(self, k: int, name: str, value: float) -> None:
        self.params.set_stage(k, name, value)

    def get_parameter(self, k: int, name: str) -> float:
        return float(self.params.data[k, self.params.reg.index(name)])

    def has_parameter(self, name: str) -> bool:
        return self.params.reg.has_parameter(name)

    # -- initial state -----------------------------------------------------
    def set_xinit(self, state) -> None:
        self._xinit = state.as_array()

    # -- ego prediction (warm-start buffer) access -------------------------
    def set_ego_prediction(self, k: int, name: str, value: float) -> None:
        self._x0[k, self.ocp.model.var_index(name)] = value

    def get_ego_prediction(self, k: int, name: str) -> float:
        return float(self._x0[k, self.ocp.model.var_index(name)])

    def set_ego_prediction_position(self, k: int, pos) -> None:
        self.set_ego_prediction(k, "x", pos[0])
        self.set_ego_prediction(k, "y", pos[1])

    def get_ego_prediction_trajectory(self) -> np.ndarray:
        """(N+1, 2) positions of the current warm start."""
        ix = self.ocp.model.var_index("x")
        iy = self.ocp.model.var_index("y")
        return self._x0[:, [ix, iy]].copy()

    # -- warm-start policies -----------------------------------------------
    def initialize_with_state(self, state) -> None:
        x = state.as_array()
        self._x0[:, : self.nu] = 0.0
        self._x0[:, self.nu :] = x[None, :]

    def initialize_with_braking(self, state) -> None:
        """Braking ramp: decelerate at ``deceleration_at_infeasible`` along
        the current heading until stopped."""
        self.initialize_with_state(state)
        decel = abs(float(self.settings["deceleration_at_infeasible"]))
        model = self.ocp.model
        x = state.get("x")
        y = state.get("y")
        psi = state.get("psi")
        v = state.get("v")
        spline = state.get("spline") if "spline" in model.states else None
        a = -decel
        dt = self.dt

        def put(k, vx, vy, vpsi, vv, vspline):
            self.set_ego_prediction(k, "x", vx)
            self.set_ego_prediction(k, "y", vy)
            self.set_ego_prediction(k, "psi", vpsi)
            self.set_ego_prediction(k, "v", vv)
            if vspline is not None:
                self.set_ego_prediction(k, "spline", vspline)
            if "a" in model.inputs:
                self.set_ego_prediction(k, "a", a)
            if "w" in model.inputs:
                self.set_ego_prediction(k, "w", 0.0)

        put(0, x, y, psi, v, spline)
        for k in range(1, self.N + 1):
            x += v * dt * np.cos(psi)
            y += v * dt * np.sin(psi)
            if spline is not None:
                spline += v * dt
            v = max(v + a * dt, 0.0)
            put(k, x, y, psi, v, spline)

    def initialize_warmstart(self, state, shift_forward: bool) -> None:
        """Shift-forward or hold warm start from the previous output."""
        names = list(self.ocp.model.inputs) + list(self.ocp.model.states)
        if shift_forward:
            for k in range(self.N + 1):
                for name in names:
                    if k == 0:
                        val = (state.get(name) if name in self.ocp.model.states
                               else self.get_output(0, name))
                    elif k >= self.N - 1:
                        val = self.get_output(self.N - 1, name)
                    else:
                        val = self.get_output(k + 1, name)
                    self.set_ego_prediction(k, name, val)
        else:
            for k in range(self.N):
                for name in names:
                    self.set_ego_prediction(k, name, self.get_output(k, name))
            for name in names:
                self.set_ego_prediction(self.N, name, self.get_output(self.N, name))

    def load_warmstart(self) -> None:
        """Latch the warm-start buffer as the solve's initial guess."""
        self._loaded_warmstart = self._x0.copy()

    # -- the iteration ladder ----------------------------------------------
    def select_iterations(self) -> int:
        """Largest ladder iteration count predicted to fit solver_timeout.

        Without a budget (``solver_timeout <= 0``, as with a simulated
        clock), without a timing yet, or with ``adaptive_iterations`` off,
        the full count. Never less than the smallest ladder entry."""
        full = self._iter_ladder[0]
        if (not self.adaptive_iterations or self._iter_time_ema <= 0.0
                or self.solver_timeout <= 0.0):
            return full
        for n in self._iter_ladder:
            if n * self._iter_time_ema <= self.solver_timeout:
                return n
        return self._iter_ladder[-1]

    def _ladder_fn(self, n: int):
        """The solve of ladder entry ``n`` (``n`` SQP iterations), built on
        first use."""
        if n not in self._ladder_fns:
            self._ladder_fns[n] = make_sqp_solver(
                self.ocp, scale_iterations(self.config, n), dtype=self.dtype,
                device=self.device)
        return self._ladder_fns[n]

    def note_solve_time(self, n: int, elapsed: float,
                        compile_call: bool) -> None:
        """Feed a measured solve of ``n`` SQP iterations into the
        per-iteration EMA; a first call (``compile_call``) is not fed."""
        self.last_iterations_run = n
        if compile_call:
            return
        per_iter = elapsed / n
        self._iter_time_ema = (per_iter if self._iter_time_ema <= 0.0
                               else 0.8 * self._iter_time_ema
                               + 0.2 * per_iter)

    # -- solve -------------------------------------------------------------
    def solve(self) -> int:
        """Solve the loaded problem at the ladder entry that fits the
        budget, store the result (one device-to-host copy) and return the
        exit code. A ladder entry's first solve is not fed into the
        per-iteration time."""
        n = self.select_iterations()
        fn = self._ladder_fn(n)
        first_call = n not in self._timed_variants
        t0 = time.perf_counter()
        result = fn(self.params.data, self._xinit, self._loaded_warmstart)
        self.load_result(fetch_result_single(result))
        elapsed = time.perf_counter() - t0
        if first_call:
            self._timed_variants.add(n)
        self.note_solve_time(n, elapsed, compile_call=first_call)
        return self._exit_code

    def load_result(self, result: SQPResult) -> int:
        """Store one problem's result (numpy fields or 0-d values), e.g. the
        winner of a batched solve."""
        self._output_z = np.asarray(result.z, dtype=float)
        self.info = {
            "pobj": float(result.cost),
            "eq_res": float(result.eq_res),
            "qp_comp": float(result.qp_comp),
        }
        self._exit_code = int(result.exit_code)
        return self._exit_code

    # -- output ------------------------------------------------------------
    def get_output(self, k: int, name: str) -> float:
        return float(self._output_z[k, self.ocp.model.var_index(name)])

    def get_output_trajectory(self) -> np.ndarray:
        """(N+1, nvar) full primal solution."""
        return self._output_z.copy()

    def explain_exit_flag(self, code: Optional[int] = None) -> str:
        code = self._exit_code if code is None else code
        return {
            1: "Success",
            0: "Failure (no more information)",
            2: "Failure (maximum number of iterations reached)",
            3: "Failure (minimum step size reached)",
        }.get(code, f"Unknown exit code; code: {code}")

    def print_if_bound_limited(self) -> list:
        """(stage, name, "lower" | "upper") for every output within 1e-2 of
        a bound (states at stage 0 excluded)."""
        hits = []
        lb, ub = self.ocp.model.bounds_arrays()
        names = list(self.ocp.model.inputs) + list(self.ocp.model.states)
        for k in range(self.N):
            for name in names:
                i = self.ocp.model.var_index(name)
                if k == 0 and name in self.ocp.model.states:
                    continue
                v = self._output_z[k, i]
                if abs(v - lb[i]) < 1e-2:
                    hits.append((k, name, "lower"))
                if abs(v - ub[i]) < 1e-2:
                    hits.append((k, name, "upper"))
        return hits
