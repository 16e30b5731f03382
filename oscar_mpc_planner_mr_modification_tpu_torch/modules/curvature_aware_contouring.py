"""Curvature-aware MPC contouring objective (CA-MPC), torch counterpart of
the JAX package's ``modules/curvature_aware_contouring.py``: a cost on the
squared distance to the path and on the projected progress rate
``s_dot = v (cos psi, sin psi) . t_hat / (1 - (p - path) . path'')``
against the reference velocity, no lag cost; the terminal stage adds the
path-angle error and the terminal multiplier on both terms. The runtime is
the contouring module's, plus the constant velocity weights.
"""

from __future__ import annotations

import torch

from .contouring import ContouringModule
from ..ops.spline import Spline, Spline2D
from ..utils.math import haar_difference_without_abs


class CurvatureAwareContouringModule(ContouringModule):
    module_name = "CurvatureAwareContouring"
    description = "CA-MPC: curvature-aware contouring costs"

    def get_value(self, model, params, settings, stage_idx):
        pos_x = model.get("x")
        pos_y = model.get("y")
        psi = model.get("psi")
        v = model.get("v")
        s = model.get("spline")

        contour_weight = params.get("contour")
        velocity_weight = params.get("velocity")

        if self.dynamic_velocity_reference:
            if not params.has_parameter("spline_v0_a"):
                raise IOError(
                    "contouring/dynamic_velocity_reference is enabled, but there is "
                    "no PathReferenceVelocity module.")
            reference_velocity = Spline(params, "spline_v", self.num_segments, s).at(s)
        else:
            reference_velocity = params.get("reference_velocity")

        path = Spline2D(params, self.num_segments, s)
        path_x, path_y = path.at(s)
        path_dx_n, path_dy_n = path.deriv_normalized(s)

        # 1 as a tensor of the state's dtype: under torch.func's second
        # derivatives a Python float beside a 0-d f32 tensor promotes them
        # to f64
        one = torch.ones((), dtype=pos_x.dtype, device=pos_x.device)
        path_ddx, path_ddy = path.deriv2(s)
        projection_ratio = one / (
            one - ((pos_x - path_x) * path_ddx + (pos_y - path_y) * path_ddy))
        s_dot = v * (torch.cos(psi) * path_dx_n
                     + torch.sin(psi) * path_dy_n) * projection_ratio

        contour_error_squared = (pos_x - path_x) ** 2 + (pos_y - path_y) ** 2

        cost = contour_weight * contour_error_squared
        cost = cost + velocity_weight * (s_dot - reference_velocity) ** 2

        if stage_idx == settings["N"] - 1:
            terminal_angle_weight = params.get("terminal_angle")
            terminal_contouring_mp = params.get("terminal_contouring")
            path_angle = torch.atan2(path_dy_n, path_dx_n)
            angle_error = haar_difference_without_abs(psi, path_angle)
            cost = cost + terminal_angle_weight * angle_error**2
            cost = cost + terminal_contouring_mp * contour_weight * contour_error_squared
            cost = cost + terminal_contouring_mp * velocity_weight * (
                s_dot - reference_velocity) ** 2

        return cost

    def set_parameters(self, buf, data, module_data) -> None:
        super().set_parameters(buf, data, module_data)
        if not self.dynamic_velocity_reference:
            buf.set("reference_velocity",
                    float(self.settings["weights"]["reference_velocity"]))
            buf.set("velocity", float(self.settings["weights"]["velocity"]))
