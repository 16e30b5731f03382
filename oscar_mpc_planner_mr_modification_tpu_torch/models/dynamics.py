"""Robot dynamics models as torch functions.

Counterpart of the JAX package's ``models/dynamics.py``: stateless dataclasses
whose ``continuous(x, u)`` returns dx/dt, discretized as explicit RK4 with 3
sub-steps over one ``integrator_step``. The variable layout is ``z = (u, x)``
with ``nvar = nu + nx``. All arithmetic is out of place, so the functions run
under ``torch.func`` transforms.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


class ModelView:
    """Name-based accessor over a ``z = (u, x)`` tensor."""

    __slots__ = ("_model", "_z")

    def __init__(self, model: "DynamicsModel", z):
        self._model = model
        self._z = z

    def get(self, name: str):
        m = self._model
        if name in m.states:
            return self._z[m.nu + m.states.index(name)]
        if name in m.inputs:
            return self._z[m.inputs.index(name)]
        raise KeyError(
            f"`{name}' is neither a state nor an input of model {m.name}"
        )

    def has(self, name: str) -> bool:
        return name in self._model.states or name in self._model.inputs


@dataclass(frozen=True)
class DynamicsModel:
    """Base dynamics model; subclasses define ``continuous``.

    ``lower_bound``/``upper_bound`` are over ``z = (u, x)``, length nvar.
    ``nx_integrate`` < nx means the trailing states are updated by
    ``discrete_update`` instead of RK4.
    """

    name: str = "base"
    nu: int = 0
    nx: int = 0
    states: Tuple[str, ...] = ()
    inputs: Tuple[str, ...] = ()
    lower_bound: Tuple[float, ...] = ()
    upper_bound: Tuple[float, ...] = ()
    nx_integrate: Optional[int] = None
    width: float = 0.65

    # -- layout ------------------------------------------------------------
    @property
    def nvar(self) -> int:
        return self.nu + self.nx

    def view(self, z) -> ModelView:
        return ModelView(self, z)

    def state_index(self, name: str) -> int:
        return self.states.index(name)

    def input_index(self, name: str) -> int:
        return self.inputs.index(name)

    def var_index(self, name: str) -> int:
        """Index into z=(u,x)."""
        if name in self.inputs:
            return self.inputs.index(name)
        return self.nu + self.states.index(name)

    def bounds_arrays(self):
        return (np.asarray(self.lower_bound, dtype=float),
                np.asarray(self.upper_bound, dtype=float))

    def get_bounds(self, name: str):
        i = self.var_index(name)
        return self.lower_bound[i], self.upper_bound[i], (
            self.upper_bound[i] - self.lower_bound[i])

    # -- dynamics ----------------------------------------------------------
    def continuous(self, x, u):
        raise NotImplementedError

    def discrete_update(self, x, u, x_integrated, ctx):
        """Post-integration discrete update hook. Default: passthrough."""
        return x_integrated

    def discrete_dynamics(self, x, u, dt: float, ctx=None, num_steps: int = 3):
        """x_{k+1} = F(x_k, u_k): RK4 x ``num_steps`` sub-steps of dt/num_steps."""
        n_int = self.nx if self.nx_integrate is None else self.nx_integrate
        xi = x[:n_int]

        def f(xi_part):
            x_full = (torch.cat([xi_part, x[n_int:]]) if n_int < self.nx
                      else xi_part)
            return torch.stack(self.continuous(x_full, u))[:n_int]

        h = dt / num_steps
        for _ in range(num_steps):
            k1 = f(xi)
            k2 = f(xi + 0.5 * h * k1)
            k3 = f(xi + 0.5 * h * k2)
            k4 = f(xi + h * k3)
            xi = xi + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

        return self.discrete_update(x, u, xi, ctx)


@dataclass(frozen=True)
class ContouringSecondOrderUnicycleModel(DynamicsModel):
    """Unicycle + spline progress state s with ds/dt = v."""

    name: str = "contouring_second_order_unicycle"
    nu: int = 2
    nx: int = 5
    states: Tuple[str, ...] = ("x", "y", "psi", "v", "spline")
    inputs: Tuple[str, ...] = ("a", "w")
    lower_bound: Tuple[float, ...] = (-2.0, -0.8, -2000.0, -2000.0, -np.pi * 4, -0.01, -1.0)
    upper_bound: Tuple[float, ...] = (2.0, 0.8, 2000.0, 2000.0, np.pi * 4, 3.0, 10000.0)

    def continuous(self, x, u):
        a, w = u[0], u[1]
        psi, v = x[2], x[3]
        return (v * torch.cos(psi), v * torch.sin(psi), w, a, v)
