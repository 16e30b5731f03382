"""OCP assembly: modules + model -> torch stage functions.

Counterpart of the JAX package's ``solver/ocp.py``:
- the intermediate stage cost is the module objective with ``stage_idx=1`` and
  the terminal cost is the objective at ``stage_idx=N-1``, evaluated at ``u=0``;
- constraints ``lh <= h(z, p) <= uh`` apply at stages 0..N-1; state bounds at
  stages 1..N-1, input bounds at 0..N-1, stage N unconstrained;
- dynamics are RK4 with 3 sub-steps;
- infinite bounds are replaced by +-1e15 and dropped from the inequality rows.

The stage functions take one stage, ``z (nvar,)`` and ``p (npar,)``, and are
batched with ``torch.func.vmap`` by the SQP engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import numpy as np
import torch

INF_BOUND = 1e15  # stand-in for an infinite bound


@dataclass
class OCP:
    model: object
    modules: object
    settings: dict
    registry: object  # ParameterRegistry
    N: int
    dt: float
    nh: int

    cost_stage: Callable = None  # (z (nvar,), p (npar,)) -> scalar
    cost_terminal: Callable = None  # (x (nx,), p (npar,)) -> scalar
    ineq: Callable = None  # (z, p) -> (nh,)
    dynamics: Callable = None  # (x, u, p) -> x_next
    lh: np.ndarray = None
    uh: np.ndarray = None
    lbz: np.ndarray = None
    ubz: np.ndarray = None

    @property
    def nx(self) -> int:
        return self.model.nx

    @property
    def nu(self) -> int:
        return self.model.nu

    @property
    def nvar(self) -> int:
        return self.model.nvar

    @property
    def npar(self) -> int:
        return self.registry.npar

    # One-sided inequality rows per stage (finite bounds only), in the order
    #   [h lower rows | h upper rows | z lower box rows | z upper box rows]
    def ineq_row_spec(self):
        rows: List[tuple] = []
        for i in range(self.nh):
            if self.lh[i] > -INF_BOUND:
                rows.append(("hl", i))
        for i in range(self.nh):
            if self.uh[i] < INF_BOUND:
                rows.append(("hu", i))
        for j in range(self.nvar):
            if self.lbz[j] > -INF_BOUND:
                rows.append(("zl", j))
        for j in range(self.nvar):
            if self.ubz[j] < INF_BOUND:
                rows.append(("zu", j))
        return rows

    def stage_mask(self) -> np.ndarray:
        """(N+1, m) row activity per stage: the terminal stage is
        unconstrained and state bounds do not apply at stage 0 (x0 is fixed)."""
        row_spec = self.ineq_row_spec()
        is_xbox = np.array([k in ("zl", "zu") and i >= self.nu
                            for (k, i) in row_spec], dtype=bool)
        mask = np.ones((self.N + 1, len(row_spec)))
        mask[self.N, :] = 0.0
        mask[0, is_xbox] = 0.0
        return mask


def build_ocp(model, modules, settings) -> OCP:
    """Assemble the OCP from a model and its modules."""
    from ..utils.params import ParameterRegistry

    registry = ParameterRegistry()
    modules.define_parameters(registry)
    registry.freeze()

    N = int(settings["N"])
    dt = float(settings["integrator_step"])
    nu = model.nu

    lh = np.asarray(
        [b if np.isfinite(b) else -INF_BOUND
         for b in modules.constraint_lower_bounds()], dtype=float)
    uh = np.asarray(
        [b if np.isfinite(b) else INF_BOUND
         for b in modules.constraint_upper_bounds()], dtype=float)
    nh = modules.constraint_number()
    if len(lh) != nh or len(uh) != nh:
        raise ValueError(f"constraint bounds ({len(lh)}, {len(uh)}) do not "
                         f"match the constraint count {nh}")

    lbz, ubz = model.bounds_arrays()
    lbz = np.where(np.isfinite(lbz), lbz, -INF_BOUND)
    ubz = np.where(np.isfinite(ubz), ubz, INF_BOUND)

    def cost_stage(z, p):
        return modules.objective(model, z, registry.view(p), settings, 1)

    def cost_terminal(x, p):
        z = torch.cat([torch.zeros(nu, dtype=x.dtype, device=x.device), x])
        return modules.objective(model, z, registry.view(p), settings, N - 1)

    def ineq(z, p):
        cons = modules.constraints(model, z, registry.view(p), settings, 1)
        if len(cons) == 0:
            return torch.zeros(0, dtype=z.dtype, device=z.device)
        return torch.stack(cons)

    def dynamics(x, u, p):
        ctx = {
            "params": registry.view(p),
            "num_segments": settings.get("contouring", {}).get("num_segments", 0),
        }
        return model.discrete_dynamics(x, u, dt, ctx=ctx)

    return OCP(
        model=model, modules=modules, settings=settings, registry=registry,
        N=N, dt=dt, nh=nh,
        cost_stage=cost_stage, cost_terminal=cost_terminal, ineq=ineq,
        dynamics=dynamics, lh=lh, uh=uh, lbz=lbz, ubz=ubz,
    )


def save_maps(ocp: OCP, directory: str) -> dict:
    """Write {parameter_map, model_map, solver_settings} as YAML: the
    name -> index parameter map, name -> [x|u, index, lb, ub], and the sizes."""
    import os

    import yaml

    os.makedirs(directory, exist_ok=True)
    parameter_map = ocp.registry.save_map()

    model = ocp.model
    model_map = {}
    for i, name in enumerate(model.states):
        lb, ub, _ = model.get_bounds(name)
        model_map[name] = ["x", model.nu + i, float(lb), float(ub)]
    for i, name in enumerate(model.inputs):
        lb, ub, _ = model.get_bounds(name)
        model_map[name] = ["u", i, float(lb), float(ub)]

    solver_settings = {
        "N": ocp.N, "nx": ocp.nx, "nu": ocp.nu, "nvar": ocp.nvar,
        "npar": ocp.npar, "nh": ocp.nh,
        "integrator_step": ocp.dt,
        "solver": "tpu_sqp_ip",
    }

    paths = {}
    for name, payload in (("parameter_map", parameter_map),
                          ("model_map", model_map),
                          ("solver_settings", solver_settings)):
        path = os.path.join(directory, f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(payload, f, sort_keys=False)
        paths[name] = path
    return paths
