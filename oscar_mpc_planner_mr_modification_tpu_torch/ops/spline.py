"""Sigmoid-spliced cubic splines, evaluated in torch.

Counterpart of the JAX package's ``ops/spline.py``: the reference path over the
horizon is ``num_segments`` cubic segments ``a s^3 + b s^2 + c s + d`` in local
coordinates ``s - s_start``, blended into one smooth function of progress ``s``
by chaining sigmoids ``lambda_i = sigmoid(-(s - s_start_i + 0.02) / 0.1)`` from
the last segment backwards. The segment axis is LEADING, shape ``(M, ...)``.
"""

from __future__ import annotations

import torch


def _as_segments(x):
    """Leading-segment-axis tensor from a per-segment list, or from a
    trailing-axis (..., M) tensor."""
    if isinstance(x, (list, tuple)):
        return torch.stack(list(x), dim=0)
    if x.ndim == 1:
        return x
    return torch.movedim(x, -1, 0)


def _chain_blend(values, lambdas):
    """Glue segment values back-to-front. values: (M, ...); lambdas: (M-1, ...)."""
    M = values.shape[0]
    out = values[M - 1]
    for k in range(M - 1, 0, -1):
        lam = lambdas[k - 1]
        out = lam * values[k - 1] + (1.0 - lam) * out
    return out


def _lambdas(starts, s):
    return torch.sigmoid(-(s[None] - starts[1:] + 0.02) / 0.1)


def eval_spline(a, b, c, d, starts, s):
    """Blended spline value at s."""
    a, b, c, d, starts = map(_as_segments, (a, b, c, d, starts))
    ds = s[None] - starts
    vals = ((a * ds + b) * ds + c) * ds + d
    return _chain_blend(vals, _lambdas(starts, s))


def eval_spline_deriv(a, b, c, starts, s):
    a, b, c, starts = map(_as_segments, (a, b, c, starts))
    ds = s[None] - starts
    vals = (3.0 * a * ds + 2.0 * b) * ds + c
    return _chain_blend(vals, _lambdas(starts, s))


def eval_spline_deriv2(a, b, starts, s):
    a, b, starts = map(_as_segments, (a, b, starts))
    vals = 6.0 * a * (s[None] - starts) + 2.0 * b
    return _chain_blend(vals, _lambdas(starts, s))


class Spline:
    """Named-parameter spline over a ParameterView: coefficients
    ``{name}{i}_a..d`` and knots ``spline{i}_start``."""

    def __init__(self, params, name: str, num_segments: int, s):
        self.a = [params.get(f"{name}{i}_a") for i in range(num_segments)]
        self.b = [params.get(f"{name}{i}_b") for i in range(num_segments)]
        self.c = [params.get(f"{name}{i}_c") for i in range(num_segments)]
        self.d = [params.get(f"{name}{i}_d") for i in range(num_segments)]
        self.starts = [params.get(f"spline{i}_start")
                       for i in range(num_segments)]
        self._s = s

    def at(self, s):
        return eval_spline(self.a, self.b, self.c, self.d, self.starts, s)

    def deriv(self, s):
        return eval_spline_deriv(self.a, self.b, self.c, self.starts, s)

    def deriv2(self, s):
        return eval_spline_deriv2(self.a, self.b, self.starts, s)


class Spline2D:
    """2D spline path (x(s), y(s))."""

    def __init__(self, params, num_segments: int, s):
        self.spline_x = Spline(params, "spline_x", num_segments, s)
        self.spline_y = Spline(params, "spline_y", num_segments, s)

    def at(self, s):
        return self.spline_x.at(s), self.spline_y.at(s)

    def deriv(self, s):
        return self.spline_x.deriv(s), self.spline_y.deriv(s)

    def deriv_normalized(self, s):
        dx = self.spline_x.deriv(s)
        dy = self.spline_y.deriv(s)
        norm = torch.sqrt(dx * dx + dy * dy)
        return dx / norm, dy / norm

    def deriv2(self, s):
        return self.spline_x.deriv2(s), self.spline_y.deriv2(s)

    def get_curvature(self, s):
        ddx = self.spline_x.deriv2(s)
        ddy = self.spline_y.deriv2(s)
        return torch.sqrt(ddx * ddx + ddy * ddy)
