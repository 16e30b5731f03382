"""Control-module framework (torch).

Counterpart of the JAX package's ``modules/base.py``. A module has a
*symbolic side*, run at OCP assembly and under ``torch.func`` transforms on
:class:`..models.dynamics.ModelView` / :class:`..utils.params.ParameterView`
(``define_parameters``, ``get_value`` for objectives, ``get_constraints`` and
bounds for constraints), and a numpy *runtime side* that fills the dense
(N, npar) :class:`..utils.params.ParameterBuffer` once per control cycle.
Symbolic code is out of place and has no Python branch on a tensor value.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

EXIT_CODE_NOT_OPTIMIZED_YET = -999


class Module:
    module_name: str = "Module"
    module_type: str = "objective"  # or "constraint"
    description: str = ""

    # -- symbolic side -----------------------------------------------------
    def define_parameters(self, params) -> None:
        pass

    # -- runtime side ------------------------------------------------------
    def update(self, state, data, module_data) -> None:
        pass

    def set_parameters(self, buf, data, module_data) -> None:
        """Fill the (N, npar) parameter buffer for this cycle."""

    def is_data_ready(self, data) -> bool:
        return True

    def missing_data(self, data) -> str:
        return ""

    def is_objective_reached(self, state, data) -> bool:
        return True

    def on_data_received(self, data, data_name: str) -> None:
        pass

    def optimize(self, state, data, module_data) -> int:
        """Custom optimization hook; EXIT_CODE_NOT_OPTIMIZED_YET = use default solve."""
        return EXIT_CODE_NOT_OPTIMIZED_YET

    # -- pipelined (two-phase) optimize ------------------------------------
    # A module that owns its optimization may split it so that a driver can
    # run the next tick's host work while the solve is on the device
    # (Planner.solve_mpc_start / solve_mpc_finish). optimize_dispatch
    # returns None (the module does not optimize), an int (resolved without
    # a solve: the exit code) or True (a solve is in flight: call
    # optimize_finish).
    def optimize_dispatch(self, state, data, module_data):
        return None

    def optimize_finish(self, state, data, module_data) -> int:
        raise RuntimeError("optimize_finish without a pending dispatch")

    def refresh_state(self, state, module_data) -> None:
        """Re-derive state-bound quantities for the actual state after a
        pipelined ``prepare`` ran with a predicted one. Default: nothing."""

    #: True when set_parameters reads the solver's warm start or solution;
    #: pipelined drivers re-run those fills once the warm start is set.
    fill_depends_on_solution: bool = False

    def reset(self) -> None:
        pass

    def save_data(self, data_saver) -> None:
        pass

    def visualize(self, data, module_data) -> None:
        pass


class ObjectiveModule(Module):
    module_type = "objective"

    def get_value(self, model, params, settings, stage_idx):
        """Stage cost contribution. ``stage_idx`` is static (1 = intermediate,
        N-1 = terminal)."""
        raise NotImplementedError


class ConstraintModule(Module):
    module_type = "constraint"
    nh: int = 0

    def get_constraints(self, model, params, settings, stage_idx) -> List:
        raise NotImplementedError

    def get_lower_bound(self) -> List[float]:
        raise NotImplementedError

    def get_upper_bound(self) -> List[float]:
        raise NotImplementedError


class ModuleManager:
    """Ordered module container + NLP assembly helpers."""

    def __init__(self):
        self.modules: List[Module] = []

    def add_module(self, module: Module) -> Module:
        self.modules.append(module)
        return module

    def __iter__(self):
        return iter(self.modules)

    # Objectives first, then constraints: the order fixes parameter indices.
    def define_parameters(self, params) -> None:
        for module in self.modules:
            if module.module_type == "objective":
                module.define_parameters(params)
        for module in self.modules:
            if module.module_type == "constraint":
                module.define_parameters(params)

    # -- symbolic assembly -------------------------------------------------
    def objective(self, model, z, p_view, settings, stage_idx):
        cost = 0.0
        view = model.view(z)
        for module in self.modules:
            if module.module_type == "objective":
                cost = cost + module.get_value(view, p_view, settings, stage_idx)
        return cost

    def constraints(self, model, z, p_view, settings, stage_idx) -> List:
        out: List = []
        view = model.view(z)
        for module in self.modules:
            if module.module_type == "constraint":
                out.extend(module.get_constraints(view, p_view, settings, stage_idx))
        return out

    def constraint_lower_bounds(self) -> List[float]:
        lb: List[float] = []
        for module in self.modules:
            if module.module_type == "constraint":
                lb.extend(module.get_lower_bound())
        return lb

    def constraint_upper_bounds(self) -> List[float]:
        ub: List[float] = []
        for module in self.modules:
            if module.module_type == "constraint":
                ub.extend(module.get_upper_bound())
        return ub

    def constraint_number(self) -> int:
        return sum(m.nh for m in self.modules if m.module_type == "constraint")

    # -- runtime orchestration helpers ------------------------------------
    def is_data_ready(self, data) -> bool:
        return all(m.is_data_ready(data) for m in self.modules)

    def missing_data(self, data) -> str:
        return " ".join(
            m.missing_data(data) for m in self.modules if not m.is_data_ready(data)
        )

    def update_all(self, state, data, module_data) -> None:
        for m in self.modules:
            m.update(state, data, module_data)

    def set_all_parameters(self, buf, data, module_data) -> None:
        for m in self.modules:
            m.set_parameters(buf, data, module_data)

    def on_data_received(self, data, data_name: str) -> None:
        for m in self.modules:
            m.on_data_received(data, data_name)

    def reset_all(self) -> None:
        for m in self.modules:
            m.reset()


def mode_risk_allocation(prediction, risk: float, max_modes: int):
    """Per-mode risk split for GMM predictions: ``risk_j = risk / (M p_j)``
    clipped to [1e-6, 0.49], so ``sum_j p_j risk_j <= risk``. One mode gets the
    full risk; missing or zero probabilities fall back to a uniform split."""
    m_active = max(1, min(len(prediction.modes), max_modes))
    if m_active == 1:
        return [float(risk)]
    probs = list(prediction.probabilities[:m_active])
    if len(probs) < m_active or any(p <= 0.0 for p in probs):
        probs = [1.0 / m_active] * m_active
    total = sum(probs)
    probs = [p / total for p in probs]
    return [float(np.clip(risk / (m_active * p), 1e-6, 0.49)) for p in probs]


def ego_disc_position(model_view, params, disc_id: int):
    """Position of ego collision disc ``disc_id`` given the current pose (a
    model without a heading offsets the disc along x)."""
    pos_x = model_view.get("x")
    pos_y = model_view.get("y")
    offset = params.get(f"ego_disc_{disc_id}_offset")
    if not model_view.has("psi"):
        return (pos_x + offset, pos_y + 0.0 * offset)
    psi = model_view.get("psi")
    return (pos_x + torch.cos(psi) * offset, pos_y + torch.sin(psi) * offset)
