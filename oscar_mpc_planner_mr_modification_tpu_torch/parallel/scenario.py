"""SH-MPC scenario optimization: the parallel scenario solvers as one batch.

Counterpart of the JAX package's ``parallel/scenario.py``. ``P`` parallel
solvers each draw their own scenario trajectories from the obstacles'
Gaussian predictions, build 24 support halfspaces per stage and disc from
them, and solve; the lowest-cost feasible plan wins. The host side is numpy,
as in the JAX package, and draws its samples with the same
``numpy.random.default_rng(seed)`` calls in the same order, so that both
packages fill the same parameters:

- :func:`posterior_epsilon` and :func:`scenario_sample_size`: the risk
  bound of the nonconvex scenario approach (Campi, Garatti and Ramponi
  2018) and the sample count that meets a risk level ``epsilon`` with
  confidence ``1 - beta`` at ``max_support`` support scenarios;
- integrated sampling: per-step noise increments whose variances are the
  differences of the marginal variances, summed along the horizon, so that
  each sample is a temporally consistent trajectory;
- :func:`select_support_halfspaces` and its batched form: the greedy
  free-space polytope, nearest scenario disc first, with domination pruning
  and a count of the discs left uncovered when the rows run out;
- the support count of the winner and its a-posteriori risk certificate.

The solve is one fleet solve of the ``P`` problems through
:func:`..ops.sqp.make_buffered_packed_solve` (one upload, one solve, one
readback), at the solver's iteration ladder as the T-MPC optimizer runs it.
Its fleet backend follows the port's rule (:func:`.tmpc.fleet_backend_for`):
``"pallas"`` (kernel B1 once per SQP iteration) for the ``"mirror"``
regularization, else ``"fused"`` (kernel B2, the whole SQP in one launch),
decided from the config when the optimizer is built and recorded as
``fleet_backend``; an OCP the backend does not cover raises then. Nothing
falls back to another backend.
"""

from __future__ import annotations

import time

import numpy as np
from scipy.special import gammaln

from ..modules.scenario_constraints import N_SCENARIO_CONSTRAINTS
from ..ops.sqp import SQPResult, unpack_results
from ..types import PredictionType
from .tmpc import fleet_backend_for, packed_fleet_solve


# ---------------------------------------------------------------------------
# Scenario-optimization theory
# ---------------------------------------------------------------------------
def _log_binom(n: int, k) -> np.ndarray:
    k = np.asarray(k)
    return gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)


def posterior_epsilon(S: int, k: int, beta: float) -> float:
    """With confidence >= 1 - beta, the violation probability of a scenario
    solution with k support scenarios out of S samples is at most
    ``1 - (beta / (S * C(S, k)))^(1 / (S - k))``; 1.0 when k >= S."""
    if k >= S:
        return 1.0
    log_t = (np.log(beta) - np.log(S) - _log_binom(S, k)) / (S - k)
    return float(1.0 - np.exp(log_t))


def scenario_sample_size(epsilon: float, beta: float, max_support: int,
                         s_max: int = 200_000) -> int:
    """The smallest sample count S with
    ``posterior_epsilon(S, max_support, beta) <= epsilon``."""
    assert 0.0 < epsilon < 1.0 and 0.0 < beta < 1.0 and max_support >= 1
    lo, hi = max_support + 1, max_support + 2
    while posterior_epsilon(hi, max_support, beta) > epsilon:
        hi *= 2
        if hi > s_max:
            raise ValueError(
                f"sample size exceeds {s_max} for eps={epsilon}, beta={beta}, "
                f"support={max_support}")
    while lo < hi:
        mid = (lo + hi) // 2
        if posterior_epsilon(mid, max_support, beta) <= epsilon:
            hi = mid
        else:
            lo = mid + 1
    return int(hi)


def select_support_halfspaces(pos, centers, margins, n_rows):
    """Greedy free-space polytope around ``pos`` (2,) from the scenario discs
    ``centers`` (M, 2) of radii ``margins`` (M,): returns ``(a (n_sel, 2),
    b (n_sel,), sel_idx (n_sel,), n_uncovered)``, at most ``n_rows`` rows.

    Discs are visited nearest boundary first. A disc that lies entirely in
    the excluded side of a selected halfspace (``a_i . c_j - margin_j >=
    b_i``) is dominated and takes no row; ``n_uncovered`` counts the
    non-dominated discs left when the rows run out."""
    M = centers.shape[0]
    if M == 0:
        return (np.zeros((0, 2)), np.zeros(0), np.zeros(0, dtype=int), 0)
    diff = centers - pos[None]
    dist = np.linalg.norm(diff, axis=1)
    deg = dist < 1e-9  # the point at a disc centre
    diff[deg] = np.array([1.0, 0.0])
    dist[deg] = 1e-9
    a_all = diff / dist[:, None]  # unit normals toward each disc
    b_all = np.sum(a_all * centers, axis=1) - margins
    order = np.argsort(dist - margins)

    sel = []
    covered = np.zeros(M, dtype=bool)
    for j in order:
        if covered[j]:
            continue
        if len(sel) == n_rows:
            break
        sel.append(j)
        covered |= (centers @ a_all[j]) - margins >= b_all[j] - 1e-12
    n_uncovered = int(np.count_nonzero(~covered))
    sel = np.asarray(sel, dtype=int)
    return a_all[sel], b_all[sel], sel, n_uncovered


def select_support_halfspaces_batch(pos, centers, margins, n_rows):
    """:func:`select_support_halfspaces` over any batch axes: ``pos`` (..., 2),
    ``centers`` (..., M, 2) (broadcast against pos's batch axes), ``margins``
    (M,) or (..., M). Returns ``(a (..., n_rows, 2), b (..., n_rows), valid
    (..., n_rows), n_uncovered (...))``; unfilled rows carry the far-away
    dummy a = (1, 0), b = 1e4. Per round every cell selects its nearest
    non-dominated disc and prunes what the new halfspace excludes; the loop
    runs over the rounds, numpy over everything else."""
    pos = np.asarray(pos, dtype=float)
    centers = np.asarray(centers, dtype=float)
    batch = np.broadcast_shapes(pos.shape[:-1], centers.shape[:-2])
    M = centers.shape[-2]
    a_sel = np.zeros(batch + (n_rows, 2))
    a_sel[..., 0] = 1.0
    b_sel = np.full(batch + (n_rows,), 1.0e4)
    valid = np.zeros(batch + (n_rows,), dtype=bool)
    if M == 0:
        return a_sel, b_sel, valid, np.zeros(batch, dtype=int)
    centers = np.broadcast_to(centers, batch + (M, 2))
    margins = np.broadcast_to(np.asarray(margins, dtype=float), batch + (M,))
    diff = centers - pos[..., None, :]
    dist = np.linalg.norm(diff, axis=-1)
    deg = dist < 1e-9
    diff = np.where(deg[..., None], np.array([1.0, 0.0]), diff)
    dist = np.maximum(dist, 1e-9)
    a_all = diff / dist[..., None]
    b_all = np.sum(a_all * centers, axis=-1) - margins
    key = dist - margins

    covered = np.zeros(batch + (M,), dtype=bool)
    for r in range(n_rows):
        left = ~np.all(covered, axis=-1)  # cells with non-dominated discs
        if not left.any():
            break
        masked = np.where(covered, np.inf, key)
        j = np.argmin(masked, axis=-1)
        aj = np.take_along_axis(a_all, j[..., None, None], axis=-2)[..., 0, :]
        bj = np.take_along_axis(b_all, j[..., None], axis=-1)[..., 0]
        a_sel[..., r, :] = np.where(left[..., None], aj, a_sel[..., r, :])
        b_sel[..., r] = np.where(left, bj, b_sel[..., r])
        valid[..., r] = left
        dom = (np.einsum("...mk,...k->...m", centers, aj) - margins
               >= bj[..., None] - 1e-12)
        covered |= dom & left[..., None]
    n_uncovered = np.count_nonzero(~covered, axis=-1)
    return a_sel, b_sel, valid, n_uncovered


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------
class ScenarioOptimizer:
    def __init__(self, solver, settings, seed: int = 0):
        self.solver = solver
        self.settings = settings
        scfg = settings["scenario_constraints"]
        self.n_solvers = int(scfg["parallel_solvers"])
        self.robot_radius = float(settings["robot_radius"])
        # (epsilon, beta) -> sample size; an explicit n_samples overrides
        self.epsilon = float(settings["probabilistic"]["risk"])
        self.beta = float(scfg.get("confidence", 1e-2))
        self.max_support = int(scfg.get("max_support", 10))
        if scfg.get("n_samples"):
            self.n_samples = int(scfg["n_samples"])
        else:
            self.n_samples = scenario_sample_size(
                self.epsilon, self.beta, self.max_support)
        self.rng = np.random.default_rng(seed)

        # One packed solve per ladder entry (n_sqp -> solve), the full count
        # built here, so an OCP the backend does not cover raises now.
        self.fleet_backend = fleet_backend_for(solver.config)
        n_full = solver._iter_ladder[0]
        self._packed_solve = {n_full: packed_fleet_solve(
            solver, self.n_solvers, self.fleet_backend, n_full)}
        self._timed_variants = set()  # ladder entries past their first call

        reg = solver.ocp.registry
        self.n_discs = int(settings["n_discs"])
        self._a1_idx, self._a2_idx, self._b_idx = (np.array([[
            reg.index(f"disc_{d}_scenario_constraint_{i}_{name}")
            for i in range(N_SCENARIO_CONSTRAINTS)]
            for d in range(self.n_discs)]) for name in ("a1", "a2", "b"))
        self._off_idx = np.array([
            reg.index(f"ego_disc_{d}_offset") for d in range(self.n_discs)])
        model = solver.ocp.model
        self._ipsi = (model.var_index("psi")
                      if "psi" in model.states else None)
        self._samples = None  # (n_solvers, n_samples, n_obs, N, 2)
        self._sample_radii = None
        self.best_solver_index = -1
        # Diagnostics of the last optimize()
        self.last_uncovered = 0  # most non-dominated discs dropped at a stage
        self.last_support = 0  # active rows of the returned solution
        self.last_certificate = 1.0  # posterior_epsilon(S, last_support, beta)

    # -- sampling ------------------------------------------------------------
    def sample_scenarios(self, data) -> None:
        """Draw per-solver scenario trajectories from the Gaussian predictions
        (mode 0): increments of variance sigma_k^2 - sigma_{k-1}^2, summed
        along the horizon and added to the mean."""
        N = self.solver.N
        obstacles = [o for o in data.dynamic_obstacles
                     if not o.prediction.empty()]
        n_obs = len(obstacles)
        if n_obs == 0:
            self._samples = None
            return
        means = np.zeros((n_obs, N, 2))
        stds = np.zeros((n_obs, N, 2))
        radii = np.zeros(n_obs)
        for i, obs in enumerate(obstacles):
            mode = obs.prediction.modes[0]
            gaussian = obs.prediction.type.name == PredictionType.GAUSSIAN.name
            for k in range(N):
                step = mode[min(k, len(mode) - 1)]
                means[i, k] = step.position
                if gaussian:
                    stds[i, k] = (step.major_radius, step.minor_radius)
            radii[i] = obs.radius
        var = stds**2
        var_inc = np.diff(var, axis=1, prepend=np.zeros((n_obs, 1, 2)))
        std_inc = np.sqrt(np.maximum(var_inc, 0.0))
        noise = self.rng.standard_normal(
            (self.n_solvers, self.n_samples, n_obs, N, 2))
        walk = np.cumsum(noise * std_inc[None, None], axis=3)
        self._samples = means[None, None] + walk
        self._sample_radii = radii

    # -- the batched solve ---------------------------------------------------
    def _solve_batch(self, params, xinit, warmstarts) -> SQPResult:
        """One upload, one solve, one readback, at the ladder entry that fits
        the solver's budget (``Solver.select_iterations``); a ladder entry's
        first solve is not fed into the per-iteration time."""
        n = self.solver.select_iterations()
        fn = self._packed_solve.get(n)
        if fn is None:
            fn = self._packed_solve[n] = packed_fleet_solve(
                self.solver, self.n_solvers, self.fleet_backend, n)
        first = n not in self._timed_variants
        self._timed_variants.add(n)
        t0 = time.perf_counter()
        out = fn(params, xinit, warmstarts)
        self.solver.note_solve_time(n, time.perf_counter() - t0,
                                    compile_call=first)
        return unpack_results(out, self.solver.N + 1, self.solver.nvar)

    # -- optimize ------------------------------------------------------------
    def optimize(self, state, data, module_data) -> int:
        if self._samples is None:
            self.sample_scenarios(data)
        if self._samples is None:
            return -999  # no obstacle data: the default solve

        P = self.n_solvers
        params = np.repeat(self.solver.params.data[None], P, axis=0)
        warmstarts = np.repeat(self.solver._loaded_warmstart[None], P, axis=0)
        model = self.solver.ocp.model
        ix, iy = model.var_index("x"), model.var_index("y")

        self.last_uncovered = self._fill_scenario_constraints(
            params, warmstarts, ix, iy)

        results = self._solve_batch(params, self.solver._xinit, warmstarts)
        feasible = np.where(results.success)[0]
        if len(feasible) == 0:
            self.best_solver_index = -1
            return int(results.exit_code[0])
        best = int(feasible[np.argmin(results.cost[feasible])])
        self.best_solver_index = best
        self.solver.load_result(SQPResult(*(x[best] for x in results)))
        self.solver.params.data[...] = params[best]
        module_data.trajectory_cost = float(results.cost[best])

        # Support count and posterior risk certificate of the winner
        self.last_support = self._count_support(params[best], results.z[best],
                                                ix, iy)
        self.last_certificate = posterior_epsilon(
            self.n_samples, self.last_support, self.beta)
        self._samples = None  # consumed; resampled on new data
        return int(results.exit_code[best])

    def _disc_positions(self, traj, ix, iy):
        """(..., n_discs, 2) collision-disc centres along ``traj`` (...,
        nvar): pose + offset_d (cos psi, sin psi), as
        ``modules.base.ego_disc_position``."""
        base = traj[..., [ix, iy]]
        psi = (traj[..., self._ipsi] if self._ipsi is not None
               else np.zeros(traj.shape[:-1]))
        heading = np.stack([np.cos(psi), np.sin(psi)], axis=-1)
        offs = self.solver.params.data[0, self._off_idx]
        return (base[..., None, :]
                + offs[..., :, None] * heading[..., None, :])

    def _fill_scenario_constraints(self, params, warmstarts, ix, iy) -> int:
        """The 24 halfspace rows per (stage, disc) of every solver from its
        own samples, over (solvers x stages x discs) at once; stage 0 and
        unfilled rows keep the far-away dummy. Returns the largest
        under-coverage of any cell."""
        n_rows = N_SCENARIO_CONSTRAINTS
        P, N = params.shape[0], self.solver.N
        samples = self._samples
        S, n_obs = samples.shape[1], samples.shape[2]
        # (S, n_obs) flattened sample-major: the radii repeat per sample
        margins = np.tile(self._sample_radii, S) + self.robot_radius
        # prediction step k-1 serves stage k
        steps = np.minimum(np.arange(N - 1), samples.shape[3] - 1)
        pts = samples[:, :, :, steps]
        pts = np.moveaxis(pts, 3, 1).reshape(P, N - 1, S * n_obs, 2)

        pos = self._disc_positions(warmstarts[:, 1:N], ix, iy)
        a, b, _, n_unc = select_support_halfspaces_batch(
            pos, pts[:, :, None], margins, n_rows)

        params[:, :, self._a1_idx] = 1.0
        params[:, :, self._a2_idx] = 0.0
        params[:, :, self._b_idx] = 1.0e4
        params[:, 1:N, self._a1_idx] = a[..., 0]
        params[:, 1:N, self._a2_idx] = a[..., 1]
        params[:, 1:N, self._b_idx] = b
        return int(np.max(n_unc)) if n_unc.size else 0

    def _count_support(self, params_p, Z, ix, iy, tol: float = 1e-4) -> int:
        """Scenario rows active at the solution (|g| < tol on a real row):
        the observed support count s* of the posterior certificate."""
        N = self.solver.N
        pos = self._disc_positions(Z[1:N], ix, iy)
        a1 = params_p[1:N][:, self._a1_idx]
        a2 = params_p[1:N][:, self._a2_idx]
        b = params_p[1:N][:, self._b_idx]
        real = b < 0.9e4
        g = a1 * pos[..., 0][..., None] + a2 * pos[..., 1][..., None] - b
        return int(np.count_nonzero(real & (np.abs(g) < tol)))
