"""Spline velocity reference along the path, torch counterpart of the JAX
package's ``modules/path_reference_velocity.py``.

It declares the ``spline_v{i}_{a,b,c,d}`` coefficients; the cost itself
lives in :class:`.contouring.ContouringModule` (``w_v (v - v_ref(s))^2``
under ``contouring/dynamic_velocity_reference``), which evaluates the
velocity spline on the path's segment starts. At runtime it fits a cubic
spline to the reference path's velocities over its arc length; without
path velocities it holds the constant ``weights/reference_velocity`` as a
degenerate cubic.
"""

from __future__ import annotations

import numpy as np

from .base import ObjectiveModule
from ..ops.spline_fit import CubicSpline1D


class PathReferenceVelocityModule(ObjectiveModule):
    module_name = "PathReferenceVelocity"
    description = "Tracks a dynamic velocity reference along the path"

    def __init__(self, settings):
        self.settings = settings
        self.num_segments = settings["contouring"]["num_segments"]
        self.velocity_spline: CubicSpline1D | None = None
        self.solver = None

    def define_parameters(self, params) -> None:
        for i in range(self.num_segments):
            params.add(f"spline_v{i}_a", bundle_name="spline_v_a")
            params.add(f"spline_v{i}_b", bundle_name="spline_v_b")
            params.add(f"spline_v{i}_c", bundle_name="spline_v_c")
            params.add(f"spline_v{i}_d", bundle_name="spline_v_d")

    def get_value(self, model, params, settings, stage_idx):
        return 0.0  # the cost is the contouring objective's

    # -- runtime -------------------------------------------------------------
    def on_data_received(self, data, data_name: str) -> None:
        if data_name == "reference_path" and data.reference_path.has_velocity():
            s = data.reference_path.s if data.reference_path.has_distance() else None
            if s is None:
                x = np.asarray(data.reference_path.x)
                y = np.asarray(data.reference_path.y)
                s = np.concatenate(
                    [[0.0], np.cumsum(np.hypot(np.diff(x), np.diff(y)))])
            self.velocity_spline = CubicSpline1D(s, data.reference_path.v)

    def set_parameters(self, buf, data, module_data) -> None:
        if self.velocity_spline is None:
            # no path velocities: v(s) = reference_velocity
            v_ref = float(self.settings["weights"]["reference_velocity"])
            for i in range(self.num_segments):
                buf.set(f"spline_v{i}_a", 0.0)
                buf.set(f"spline_v{i}_b", 0.0)
                buf.set(f"spline_v{i}_c", 0.0)
                buf.set(f"spline_v{i}_d", v_ref)
            return
        first = module_data.current_path_segment
        seg = self.velocity_spline.export_segments(first, self.num_segments)
        for i in range(self.num_segments):
            buf.set(f"spline_v{i}_a", seg["a"][i])
            buf.set(f"spline_v{i}_b", seg["b"][i])
            buf.set(f"spline_v{i}_c", seg["c"][i])
            buf.set(f"spline_v{i}_d", seg["d"][i])
