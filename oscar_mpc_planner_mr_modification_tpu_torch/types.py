"""Planning data types used by the ported modules.

Counterpart of the JAX package's ``types.py``, holding only the classes the
ported modules read. Obstacle predictions arrive as duck-typed objects with
``type``, ``modes`` (lists of steps with ``position``, ``angle``,
``major_radius``, ``minor_radius``) and ``probabilities``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


@dataclass
class Halfspace:
    """Halfspace A.x <= b."""

    A: np.ndarray  # (2,)
    b: float


class PredictionType(enum.Enum):
    DETERMINISTIC = 0
    GAUSSIAN = 1
    NONGAUSSIAN = 2
    NONE = 3


def mode_positions(mode) -> np.ndarray:
    """(L, 2) positions of one prediction mode; (0, 2) for an empty mode.

    A fresh array on every call, so it never aliases a step's ``position``."""
    return np.array([step.position for step in mode],
                    dtype=float).reshape(-1, 2)
