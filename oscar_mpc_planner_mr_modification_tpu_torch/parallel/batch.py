"""Batched T-MPC step (torch): a (B instances x P planners) fleet of SQP
solves plus per-plan best-planner selection, counterpart of the JAX package's
``parallel/batch.py``.

The backend ``"auto"`` is resolved from the device when the step is built,
never on an exception: ``"pallas"`` (the QP kernel) on a CUDA device,
``"xla"`` (the single-instance solve, its plain version there) on the
CPU. The built step records it as ``plan_step.backend``."""

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


def resolve_backend(backend: str, device) -> str:
    """``"auto"`` -> ``"pallas"`` on a CUDA device, ``"xla"`` elsewhere;
    any other name is returned as it is. This is the JAX package's choice
    for a fleet step; under ``"mirror"`` ``"pallas"`` linearizes with
    ``torch.func`` and ``eigh``. Planners do not come here: they take
    :func:`.tmpc.fleet_backend_for`'s ``"lanes"`` for ``"mirror"``."""
    if backend != "auto":
        return backend
    return "pallas" if torch.device(device).type == "cuda" else "xla"


def make_plan_fn(ocp, config: SQPConfig, *, dtype, device="cuda"):
    """One T-MPC plan: P solves of the single-instance SQP
    (:func:`..ops.sqp.make_sqp_solver`, all P in one batch) and the argmin,
    i.e. the ``"xla"`` step of :func:`make_batched_tmpc_step` on a batch of
    one plan.

    plan(params (P, N, npar), xinit (nx,), z_init (P, N+1, nvar),
    disabled (P,) bool) -> TMPCStepResult without the B axis: a successful,
    enabled planner's cost, inf otherwise; ``all_success`` is that mask."""
    step = make_batched_tmpc_step(ocp, config, dtype=dtype, device=device,
                                  backend="xla")

    def plan(params, xinit, z_init, disabled) -> TMPCStepResult:
        out = step(*(torch.as_tensor(x)[None]
                     for x in (params, xinit, z_init, disabled)))
        return TMPCStepResult(*(x[0] for x in out))

    return plan


def make_batched_tmpc_step(ocp, config: SQPConfig, *, dtype, device="cuda",
                           backend: str = "pallas"):
    """(B, P)-batched T-MPC step on the fleet solver of ``backend``
    (:func:`..ops.sqp.make_fleet_sqp_solver`).

    plan_step(params (B,P,N,npar), xinit (B,nx), z_init (B,P,N+1,nvar),
    disabled (B,P) bool) -> TMPCStepResult with leading B axis. The B*P solves
    run as one fleet; each plan picks its cheapest successful, enabled planner
    (the first on ties, planner 0 when none succeeded). ``"xla"`` solves
    every problem as :func:`..ops.sqp.make_sqp_solver` does, as the JAX
    package's vmap of :func:`make_plan_fn`; ``"auto"`` resolves by
    :func:`resolve_backend`."""
    device = torch.device(device)
    backend = resolve_backend(backend, device)
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

    plan_step.fleet_solve, plan_step.backend = fleet_solve, backend
    return plan_step


def to_torch_fleet(params, xinit, z_init, disabled, *, device="cuda", dtype):
    """Fleet inputs as numpy arrays (from ``build_tmpc_fleet`` of either
    package) -> tensors on ``device``: floats in ``dtype``, ``disabled`` bool."""
    def f(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return (f(params), f(xinit), f(z_init),
            torch.as_tensor(np.asarray(disabled, dtype=bool), device=device))
