"""Batched T-MPC step (torch): a (B instances x P planners) fleet of SQP
solves plus per-plan best-planner selection, counterpart of the JAX package's
``parallel/batch.py``."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.sqp import SQPConfig, make_fleet_sqp_solver


class TMPCStepResult(NamedTuple):
    best_z: torch.Tensor  # (B, N+1, nvar)
    best_cost: torch.Tensor  # (B,)
    best_index: torch.Tensor  # (B,) selected planner
    any_success: torch.Tensor  # (B,) bool
    all_costs: torch.Tensor  # (B, P), inf where a planner failed or is disabled
    all_success: torch.Tensor  # (B, P)


def make_batched_tmpc_step(ocp, config: SQPConfig, *, dtype, device="cuda",
                           backend: str = "pallas"):
    """(B, P)-batched T-MPC step on the fleet solver of ``backend``
    (:func:`..ops.sqp.make_fleet_sqp_solver`).

    plan_step(params (B,P,N,npar), xinit (B,nx), z_init (B,P,N+1,nvar),
    disabled (B,P) bool) -> TMPCStepResult with leading B axis. The B*P solves
    run as one fleet; each plan picks its cheapest successful, enabled planner
    (the first on ties, planner 0 when none succeeded)."""
    device = torch.device(device)
    fleet_solve = make_fleet_sqp_solver(ocp, config, dtype=dtype, device=device,
                                        backend=backend)

    def plan_step(params, xinit, z_init, disabled) -> TMPCStepResult:
        params = torch.as_tensor(params, dtype=dtype, device=device)
        xinit = torch.as_tensor(xinit, dtype=dtype, device=device)
        z_init = torch.as_tensor(z_init, dtype=dtype, device=device)
        disabled = torch.as_tensor(disabled, dtype=torch.bool, device=device)
        B, P = params.shape[:2]
        res = fleet_solve(params.reshape(B * P, *params.shape[2:]),
                          xinit.repeat_interleave(P, dim=0),
                          z_init.reshape(B * P, *z_init.shape[2:]))
        costs = torch.where(res.success.reshape(B, P) & ~disabled,
                            res.cost.reshape(B, P),
                            torch.full((B, P), float("inf"), dtype=dtype,
                                       device=device))
        best = torch.argmin(costs, dim=1)
        b_idx = torch.arange(B, device=device)
        z_bp = res.z.reshape(B, P, *res.z.shape[1:])
        best_cost = costs[b_idx, best]
        return TMPCStepResult(
            best_z=z_bp[b_idx, best], best_cost=best_cost, best_index=best,
            any_success=torch.isfinite(best_cost), all_costs=costs,
            all_success=torch.isfinite(costs))

    plan_step.fleet_solve = fleet_solve
    return plan_step


def to_torch_fleet(params, xinit, z_init, disabled, *, device="cuda", dtype):
    """Fleet inputs as numpy arrays (from ``build_tmpc_fleet`` of either
    package) -> tensors on ``device``: floats in ``dtype``, ``disabled`` bool."""
    def f(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return (f(params), f(xinit), f(z_init),
            torch.as_tensor(np.asarray(disabled, dtype=bool), device=device))
