"""Reference-path server.

Counterpart of the JAX package's ``sim/roadmap.py``: the standard path
shapes (straight, arc, S-bend, road boundaries) as
:class:`..types.ReferencePath`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..types import ReferencePath


def _path_from_xy(x, y, velocity: Optional[float] = None) -> ReferencePath:
    path = ReferencePath()
    path.x = list(np.asarray(x, dtype=float))
    path.y = list(np.asarray(y, dtype=float))
    s = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(x), np.diff(y)))])
    path.s = list(s)
    psi = np.arctan2(np.gradient(y), np.gradient(x))
    path.psi = list(psi)
    if velocity is not None:
        path.v = [float(velocity)] * len(path.x)
    return path


def straight_path(length: float = 30.0, n_points: int = 40, y: float = 0.0,
                  velocity: Optional[float] = None) -> ReferencePath:
    x = np.linspace(0.0, length, n_points)
    return _path_from_xy(x, np.full_like(x, y), velocity)


def curve_path(radius: float = 10.0, angle: float = np.pi / 2,
               n_points: int = 40, velocity: Optional[float] = None
               ) -> ReferencePath:
    """Quarter-turn (or ``angle``) arc starting along +x."""
    theta = np.linspace(-np.pi / 2, -np.pi / 2 + angle, n_points)
    x = radius * np.cos(theta)
    y = radius * np.sin(theta) + radius
    return _path_from_xy(x, y, velocity)


def s_bend_path(length: float = 30.0, amplitude: float = 2.0,
                n_points: int = 60, velocity: Optional[float] = None
                ) -> ReferencePath:
    x = np.linspace(0.0, length, n_points)
    y = amplitude * np.sin(2.0 * np.pi * x / length)
    return _path_from_xy(x, y, velocity)


def path_with_bounds(path: ReferencePath, width: float = 6.0):
    """Left/right road boundaries offset orthogonally from a center path."""
    x = np.asarray(path.x)
    y = np.asarray(path.y)
    psi = np.asarray(path.psi)
    nx, ny = -np.sin(psi), np.cos(psi)
    left = _path_from_xy(x + nx * width / 2.0, y + ny * width / 2.0)
    right = _path_from_xy(x - nx * width / 2.0, y - ny * width / 2.0)
    return left, right
