"""Road-width constraints on the contouring error, torch counterpart of the
JAX package's ``modules/contouring_constraints.py``: two rows
``+-contour_error + w/2 - width_{right,left}(s) - slack <= 0`` with the
widths carried as splines of the path progress on the path's segment starts
(``w`` the model's width, 0.65 unless ``settings["model_object"]`` names
one; slack the model's where it has one, else 0). The runtime fits the
width splines from the received road boundaries and uploads their segment
coefficients (numpy)."""

from __future__ import annotations

import numpy as np
import torch

from .base import ConstraintModule
from ..ops.spline import Spline, Spline2D
from ..ops.spline_fit import CubicSpline1D, CubicSpline2D


class ContouringConstraintModule(ConstraintModule):
    module_name = "ContouringConstraints"
    description = "Constrain the contouring error to stay within road boundaries"
    nh = 2

    def __init__(self, settings):
        self.settings = settings
        self.num_segments = settings["contouring"]["num_segments"]
        self.width_left: CubicSpline1D | None = None
        self.width_right: CubicSpline1D | None = None
        self.solver = None

    def define_parameters(self, params) -> None:
        for i in range(self.num_segments):
            params.add(f"width_right{i}_a", bundle_name="width_right_a")
            params.add(f"width_right{i}_b", bundle_name="width_right_b")
            params.add(f"width_right{i}_c", bundle_name="width_right_c")
            params.add(f"width_right{i}_d", bundle_name="width_right_d")
            params.add(f"width_left{i}_a", bundle_name="width_left_a")
            params.add(f"width_left{i}_b", bundle_name="width_left_b")
            params.add(f"width_left{i}_c", bundle_name="width_left_c")
            params.add(f"width_left{i}_d", bundle_name="width_left_d")

    def get_lower_bound(self):
        return [-np.inf, -np.inf]

    def get_upper_bound(self):
        return [0.0, 0.0]

    @staticmethod
    def half_width(settings) -> float:
        """Half the vehicle width the rows keep inside the road."""
        return getattr(settings.get("model_object", None), "width", 0.65) / 2.0

    def get_constraints(self, model, params, settings, stage_idx):
        pos_x = model.get("x")
        pos_y = model.get("y")
        s = model.get("spline")
        slack = (model.get("slack") if model.has("slack")
                 else torch.zeros((), dtype=pos_x.dtype, device=pos_x.device))

        spline = Spline2D(params, self.num_segments, s)
        path_x, path_y = spline.at(s)
        dx_n, dy_n = spline.deriv_normalized(s)
        contour_error = dy_n * (pos_x - path_x) - dx_n * (pos_y - path_y)

        width_left = Spline(params, "width_left", self.num_segments, s)
        width_right = Spline(params, "width_right", self.num_segments, s)

        # tensors of the state's dtype (also the slack where the model has
        # none): under torch.func a Python float beside a 0-d f32 tensor
        # promotes the derivatives to f64
        w_cur = torch.full((), self.half_width(settings), dtype=pos_x.dtype,
                           device=pos_x.device)
        return [
            contour_error + w_cur - width_right.at(s) - slack,
            -contour_error + w_cur - width_left.at(s) - slack,
        ]

    # -- runtime -----------------------------------------------------------
    def on_data_received(self, data, data_name: str) -> None:
        if data_name != "reference_path":
            return
        if data.left_bound.empty() or data.right_bound.empty():
            return
        center = CubicSpline2D(data.reference_path.x, data.reference_path.y)
        s_knots = center.s_knots
        pts = center.at(s_knots)
        t = center.deriv(s_knots)
        t = t / (np.linalg.norm(t, axis=1, keepdims=True) + 1e-12)
        normal = np.stack([t[:, 1], -t[:, 0]], axis=1)

        def resampled(bound):
            grid = np.linspace(0, s_knots[-1], len(bound.x))
            return np.stack([np.interp(s_knots, grid, bound.x),
                             np.interp(s_knots, grid, bound.y)], axis=1)

        left, right = resampled(data.left_bound), resampled(data.right_bound)
        width_left = np.abs(np.sum((left - pts) * (-normal), axis=1))
        width_right = np.abs(np.sum((right - pts) * normal, axis=1))
        self.width_left = CubicSpline1D(s_knots, width_left)
        self.width_right = CubicSpline1D(s_knots, width_right)

    def set_parameters(self, buf, data, module_data) -> None:
        if self.width_left is None:
            half = float(self.settings["road"]["width"]) / 2.0
            for i in range(self.num_segments):
                for side in ("left", "right"):
                    buf.set(f"width_{side}{i}_a", 0.0)
                    buf.set(f"width_{side}{i}_b", 0.0)
                    buf.set(f"width_{side}{i}_c", 0.0)
                    buf.set(f"width_{side}{i}_d", half)
            return
        first = module_data.current_path_segment
        for side, spline in (("left", self.width_left), ("right", self.width_right)):
            seg = spline.export_segments(first, self.num_segments)
            for i in range(self.num_segments):
                buf.set(f"width_{side}{i}_a", seg["a"][i])
                buf.set(f"width_{side}{i}_b", seg["b"][i])
                buf.set(f"width_{side}{i}_c", seg["c"][i])
                buf.set(f"width_{side}{i}_d", seg["d"][i])

    def is_data_ready(self, data) -> bool:
        return not data.reference_path.empty()
