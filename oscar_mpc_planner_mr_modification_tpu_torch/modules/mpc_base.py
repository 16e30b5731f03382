"""Weighted penalties on states/inputs (MPCBase), torch counterpart of the JAX
package's ``modules/mpc_base.py``."""

from __future__ import annotations

from typing import Callable, List

from .base import ObjectiveModule


def _default_cost(x, w):
    return w[0] * x**2


class MPCBaseModule(ObjectiveModule):
    module_name = "MPCBaseModule"
    description = "Contains input and state penalties with tunable weights"

    def __init__(self, settings):
        self.settings = settings
        self._weights: List[str] = []
        self._weights_per_function: List[List[str]] = []
        self._variables_per_function: List[str] = []
        self._cost_functions: List[Callable] = []

    def weigh_variable(self, var_name: str, weight_names,
                       cost_function: Callable = _default_cost, **_kw) -> None:
        """Add a weighted penalty, e.g. ``w_a * a^2`` or
        ``w_v * (v - v_ref)^2`` via a custom lambda."""
        if not isinstance(weight_names, list):
            weight_names = [weight_names]
        for name in weight_names:
            self._weights.append(name)
        self._weights_per_function.append(weight_names)
        self._variables_per_function.append(var_name)
        self._cost_functions.append(cost_function)

    @property
    def weight_params(self) -> List[str]:
        return list(self._weights)

    # -- symbolic ----------------------------------------------------------
    def define_parameters(self, params) -> None:
        for name in self._weights:
            params.add(name, add_to_rqt_reconfigure=True)

    def get_value(self, model, params, settings, stage_idx):
        cost = 0.0
        for idx, cost_function in enumerate(self._cost_functions):
            weights = [params.get(w) for w in self._weights_per_function[idx]]
            variable = model.get(self._variables_per_function[idx])
            cost = cost + cost_function(variable, weights)
        return cost

    # -- runtime -------------------------------------------------------------
    def set_parameters(self, buf, data, module_data) -> None:
        weights_cfg = self.settings["weights"]
        for name in self._weights:
            buf.set(name, float(weights_cfg[name]))
