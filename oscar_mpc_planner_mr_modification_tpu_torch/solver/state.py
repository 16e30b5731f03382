"""Named robot state vector.

Counterpart of the JAX package's ``solver/state.py``: an nx-vector addressed
by state name through the model layout, with the validity check "all finite
and not all zero".
"""

from __future__ import annotations

import numpy as np


class State:
    def __init__(self, model):
        self.model = model
        self._x = np.zeros(model.nx)

    def get(self, name: str) -> float:
        return float(self._x[self.model.state_index(name)])

    def set(self, name: str, value: float) -> None:
        self._x[self.model.state_index(name)] = float(value)

    def get_position(self) -> np.ndarray:
        return np.array([self.get("x"), self.get("y")])

    def as_array(self) -> np.ndarray:
        return self._x.copy()

    def set_array(self, x) -> None:
        self._x[...] = np.asarray(x, dtype=float)

    def has(self, name: str) -> bool:
        return name in self.model.states

    def valid_data(self) -> bool:
        """Finite and not identically zero."""
        if not np.all(np.isfinite(self._x)):
            return False
        return bool(np.any(self._x != 0.0))

    def reset(self) -> None:
        self._x[...] = 0.0

    def __repr__(self) -> str:
        fields = ", ".join(f"{n}={self.get(n):.3f}" for n in self.model.states)
        return f"State({fields})"
