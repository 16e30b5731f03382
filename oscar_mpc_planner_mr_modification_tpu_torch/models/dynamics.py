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
class SecondOrderUnicycleModel(DynamicsModel):
    """Unicycle with acceleration and turn rate as inputs."""

    name: str = "second_order_unicycle"
    nu: int = 2
    nx: int = 4
    states: Tuple[str, ...] = ("x", "y", "psi", "v")
    inputs: Tuple[str, ...] = ("a", "w")
    lower_bound: Tuple[float, ...] = (-2.0, -2.0, -200.0, -200.0, -np.pi * 4, -2.0)
    upper_bound: Tuple[float, ...] = (2.0, 2.0, 200.0, 200.0, np.pi * 4, 3.0)

    def continuous(self, x, u):
        a, w = u[0], u[1]
        psi, v = x[2], x[3]
        return (v * torch.cos(psi), v * torch.sin(psi), w, a)


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


@dataclass(frozen=True)
class ContouringSecondOrderUnicycleModelWithSlack(DynamicsModel):
    """The contouring unicycle with a slack state (SH-MPC's soft scenario
    constraints): ``slack`` has zero derivative and bounds (0, 5000)."""

    name: str = "contouring_second_order_unicycle_with_slack"
    nu: int = 2
    nx: int = 6
    states: Tuple[str, ...] = ("x", "y", "psi", "v", "spline", "slack")
    inputs: Tuple[str, ...] = ("a", "w")
    lower_bound: Tuple[float, ...] = (-2.0, -0.8, -2000.0, -2000.0, -np.pi * 4,
                                      -0.01, -1.0, 0.0)
    upper_bound: Tuple[float, ...] = (2.0, 0.8, 2000.0, 2000.0, np.pi * 4, 3.0,
                                      10000.0, 5000.0)

    def continuous(self, x, u):
        a, w = u[0], u[1]
        psi, v = x[2], x[3]
        return (v * torch.cos(psi), v * torch.sin(psi), w, a, v,
                torch.zeros_like(v))


#: The curvature floor of the curvature-aware progress update, on the
#: squared curvature: R = 1 / sqrt(max(ddx^2 + ddy^2, CURVATURE2_FLOOR))
#: caps the radius at 1e5, as 1 / max(|curvature|, 1e-5) does, with a finite
#: derivative on an exactly straight path (0 on the floored branch).
CURVATURE2_FLOOR = 1e-10


def _ca_spline_update(x, x_integrated, ctx):
    """Curvature-aware discrete progress update: the spline state advances
    by the arc of the path's osculating circle that the integrated step
    projects onto, ``s + R atan2(vt, R - contour_error - vn)``, with the
    path's point, unit tangent and radius R taken at the current s.

    ctx provides ``params`` (a ParameterView with the path's spline
    parameters) and ``num_segments``."""
    from ..ops.spline import Spline2D

    pos_x, pos_y = x[0], x[1]
    s = x[-1]

    path = Spline2D(ctx["params"], ctx["num_segments"], s)
    path_x, path_y = path.at(s)
    tx, ty = path.deriv_normalized(s)

    contour_error = ty * (pos_x - path_x) - tx * (pos_y - path_y)

    dpx = x_integrated[0] - pos_x
    dpy = x_integrated[1] - pos_y
    vt_t = dpx * tx + dpy * ty
    vn_t = dpx * ty - dpy * tx

    ddx, ddy = path.deriv2(s)
    curvature2 = ddx * ddx + ddy * ddy
    floor = torch.full((), CURVATURE2_FLOOR, dtype=s.dtype, device=s.device)
    R = torch.rsqrt(torch.maximum(curvature2, floor))

    theta = torch.atan2(vt_t, R - contour_error - vn_t)
    return torch.cat([x_integrated, (s + R * theta).unsqueeze(0)])


@dataclass(frozen=True)
class ContouringSecondOrderUnicycleModelCurvatureAware(DynamicsModel):
    """CA-MPC unicycle: RK4 on (x, y, psi, v), then the spline state by
    :func:`_ca_spline_update`."""

    name: str = "contouring_second_order_unicycle_curvature_aware"
    nu: int = 2
    nx: int = 5
    states: Tuple[str, ...] = ("x", "y", "psi", "v", "spline")
    inputs: Tuple[str, ...] = ("a", "w")
    lower_bound: Tuple[float, ...] = (-4.0, -0.8, -2000.0, -2000.0, -np.pi * 4, -0.01, -1.0)
    upper_bound: Tuple[float, ...] = (4.0, 0.8, 2000.0, 2000.0, np.pi * 4, 3.0, 10000.0)
    nx_integrate: Optional[int] = 4

    def continuous(self, x, u):
        a, w = u[0], u[1]
        psi, v = x[2], x[3]
        return (v * torch.cos(psi), v * torch.sin(psi), w, a)

    def discrete_update(self, x, u, x_integrated, ctx):
        return _ca_spline_update(x, x_integrated, ctx)


_WHEEL_BASE = 2.79  # Prius wheel base [m]


def _bicycle_field(x, u, lr, ratio):
    """The kinematic bicycle's (x, y, psi, v, delta) derivatives: slip
    angle beta = atan(ratio tan(delta)), psi' = (v / lr) sin(beta). The
    constants are tensors of the state's dtype: under torch.func a Python
    float beside a 0-d f32 tensor promotes the derivatives to f64."""
    a, w = u[0], u[1]
    psi, v, delta = x[2], x[3], x[4]
    lr_t, ratio_t = (torch.full((), c, dtype=v.dtype, device=v.device)
                     for c in (lr, ratio))
    beta = torch.atan(ratio_t * torch.tan(delta))
    return (v * torch.cos(psi + beta), v * torch.sin(psi + beta),
            (v / lr_t) * torch.sin(beta), a, w)


@dataclass(frozen=True)
class BicycleModel2ndOrder(DynamicsModel):
    """Kinematic bicycle with dynamic steering: inputs (a, steering rate w,
    slack), states (x, y, psi, v, steering angle delta, spline)."""

    name: str = "bicycle_2nd_order"
    nu: int = 3
    nx: int = 6
    states: Tuple[str, ...] = ("x", "y", "psi", "v", "delta", "spline")
    inputs: Tuple[str, ...] = ("a", "w", "slack")
    lower_bound: Tuple[float, ...] = (-3.0, -1.5, 0.0, -1.0e6, -1.0e6, -np.pi * 4,
                                      -0.01, -0.55, -1.0)
    upper_bound: Tuple[float, ...] = (3.0, 1.5, 1.0e2, 1.0e6, 1.0e6, np.pi * 4, 5.0,
                                      0.55, 5000.0)
    width: float = 2.25

    def continuous(self, x, u):
        lr = _WHEEL_BASE / 2.0
        lf = _WHEEL_BASE / 2.0
        return _bicycle_field(x, u, lr, lr / (lr + lf)) + (x[3],)


@dataclass(frozen=True)
class BicycleModel2ndOrderCurvatureAware(DynamicsModel):
    """CA-MPC bicycle: RK4 on (x, y, psi, v, delta), then the spline state by
    :func:`_ca_spline_update`."""

    name: str = "bicycle_2nd_order_curvature_aware"
    nu: int = 3
    nx: int = 6
    states: Tuple[str, ...] = ("x", "y", "psi", "v", "delta", "spline")
    inputs: Tuple[str, ...] = ("a", "w", "slack")
    lower_bound: Tuple[float, ...] = (-3.0, -1.5, 0.0, -1.0e6, -1.0e6, -np.pi * 4,
                                      -0.01, -0.55, -1.0)
    upper_bound: Tuple[float, ...] = (3.0, 1.5, 1.0e2, 1.0e6, 1.0e6, np.pi * 4, 8.0,
                                      0.55, 5000.0)
    nx_integrate: Optional[int] = 5
    width: float = 2.25
    lr: float = _WHEEL_BASE / 2.0

    def continuous(self, x, u):
        return _bicycle_field(x, u, self.lr, self.lr / (self.lr + self.lr))

    def discrete_update(self, x, u, x_integrated, ctx):
        return _ca_spline_update(x, x_integrated, ctx)
