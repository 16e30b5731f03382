"""Named per-stage parameter registry.

Counterpart of the JAX package's ``utils/params.py``: modules register named
parameters at assembly time (objectives first, then constraints, which fixes the
flat per-stage index layout), symbolic module code reads them out of a ``(npar,)``
tensor by name, and the runtime fills a dense numpy ``(N, npar)`` array with
name-indexed setters. The name -> index map is identical to the JAX package's for
the same module list.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class ParameterView:
    """Name-indexed view over a flat parameter tensor ``p`` of shape (npar,).

    Passed to symbolic module functions; ``get("contour")`` returns the 0-d
    tensor. Works unchanged under ``torch.func.vmap``.
    """

    __slots__ = ("_reg", "_p")

    def __init__(self, registry: "ParameterRegistry", p):
        self._reg = registry
        self._p = p

    def get(self, name: str):
        return self._p[self._reg.index(name)]

    def has_parameter(self, name: str) -> bool:
        return self._reg.has_parameter(name)

    def get_bundle(self, bundle_name: str):
        """All parameters of a bundle as a stacked tensor (bundle_size,)."""
        return self._p[list(self._reg.bundle_indices(bundle_name))]


class ParameterRegistry:
    """Ordered named parameter registry with bundles (duplicate adds are
    ignored; indices are assigned in first-add order)."""

    def __init__(self):
        self._indices: Dict[str, int] = {}
        self._bundles: Dict[str, List[int]] = {}
        self.rqt_params: List[str] = []
        self.rqt_param_config_names: List[str] = []
        self.rqt_param_min_values: List[float] = []
        self.rqt_param_max_values: List[float] = []
        self._frozen = False

    # -- definition phase -------------------------------------------------
    def add(self, name: str, add_to_rqt_reconfigure: bool = False,
            bundle_name: Optional[str] = None,
            rqt_config_name: Optional[str] = None,
            rqt_min_value: float = 0.0, rqt_max_value: float = 100.0,
            **_ignored) -> None:
        if self._frozen:
            raise RuntimeError("ParameterRegistry is frozen; cannot add parameters")
        if name in self._indices:
            return
        idx = len(self._indices)
        self._indices[name] = idx
        bundle = bundle_name if bundle_name is not None else name
        self._bundles.setdefault(bundle, []).append(idx)
        if add_to_rqt_reconfigure:
            self.rqt_params.append(name)
            self.rqt_param_config_names.append(
                rqt_config_name if rqt_config_name is not None
                else f'["weights"]["{name}"]')
            self.rqt_param_min_values.append(float(rqt_min_value))
            self.rqt_param_max_values.append(float(rqt_max_value))

    def rqt_range(self, name: str):
        """(min, max) slider range of an rqt-exposed parameter."""
        i = self.rqt_params.index(name)
        return self.rqt_param_min_values[i], self.rqt_param_max_values[i]

    def freeze(self) -> None:
        self._frozen = True

    # -- queries -----------------------------------------------------------
    def length(self) -> int:
        return len(self._indices)

    @property
    def npar(self) -> int:
        return len(self._indices)

    def index(self, name: str) -> int:
        return self._indices[name]

    def has_parameter(self, name: str) -> bool:
        return name in self._indices

    def has_bundle(self, bundle: str) -> bool:
        return bundle in self._bundles

    def bundle_indices(self, bundle: str) -> List[int]:
        return self._bundles[bundle]

    def names(self) -> List[str]:
        return list(self._indices.keys())

    def save_map(self) -> Dict[str, int]:
        """The parameter map (name -> flat index)."""
        return dict(self._indices)

    def view(self, p) -> ParameterView:
        return ParameterView(self, p)

    # -- runtime fill ------------------------------------------------------
    def new_buffer(self, N: int, dtype=np.float64) -> "ParameterBuffer":
        return ParameterBuffer(self, N, dtype)


class ParameterBuffer:
    """Dense numpy (N, npar) per-stage parameter array with name-indexed
    setters, vectorized over stages: ``set("goal_x", 3.0)`` writes all N
    stages; pass an (N,) array for per-stage values."""

    def __init__(self, registry: ParameterRegistry, N: int, dtype=np.float64):
        self.reg = registry
        self.N = int(N)
        self.data = np.zeros((self.N, registry.npar), dtype=dtype)

    def set(self, name: str, value) -> None:
        self.data[:, self.reg.index(name)] = value

    def set_stage(self, k: int, name: str, value: float) -> None:
        self.data[k, self.reg.index(name)] = value

    def set_bundle(self, bundle: str, index: int, value) -> None:
        self.data[:, self.reg.bundle_indices(bundle)[index]] = value

    def set_bundle_stage(self, k: int, bundle: str, index: int, value: float) -> None:
        self.data[k, self.reg.bundle_indices(bundle)[index]] = value

    def get(self, name: str):
        return self.data[:, self.reg.index(name)]

    def copy(self) -> "ParameterBuffer":
        out = ParameterBuffer(self.reg, self.N, self.data.dtype)
        out.data[...] = self.data
        return out
