"""MPCC contouring objective (+ road constraint construction), torch
counterpart of the JAX package's ``modules/contouring.py``.

Symbolic cost: contour/lag error versus a sigmoid-spliced spline path, an
optional spline velocity reference, and the terminal angle + terminal
contouring cost at the last stage. Runtime (numpy): fit a cubic spline to the
received reference path, find the closest segment, initialize the spline state,
upload ``num_segments`` segments from the closest one, and optionally build
road-boundary halfspaces. ``self.solver`` is any object with ``N`` and the
warm start ``_x0`` (N+1, nvar).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import ObjectiveModule
from ..ops.spline import Spline, Spline2D
from ..ops.spline_fit import CubicSpline2D
from ..utils.math import haar_difference_without_abs
from ..types import Halfspace


class ContouringModule(ObjectiveModule):
    module_name = "Contouring"
    description = "MPCC: Tracks a 2D reference path with contouring costs"

    def __init__(self, settings):
        self.settings = settings
        self.num_segments = settings["contouring"]["num_segments"]
        self.dynamic_velocity_reference = settings["contouring"][
            "dynamic_velocity_reference"]
        self.add_road_constraints = settings["contouring"].get(
            "add_road_constraints", False)
        self.two_way_road = settings.get("road", {}).get("two_way", False)
        self.spline: CubicSpline2D | None = None
        self.bound_left: CubicSpline2D | None = None
        self.bound_right: CubicSpline2D | None = None
        self.closest_segment = 0
        self.solver = None

    # -- symbolic ----------------------------------------------------------
    def define_parameters(self, params) -> None:
        params.add("contour", add_to_rqt_reconfigure=True)
        params.add("lag", add_to_rqt_reconfigure=True)
        if not params.has_parameter("velocity"):
            params.add("velocity", add_to_rqt_reconfigure=True)
            params.add("reference_velocity", add_to_rqt_reconfigure=True)
        params.add("terminal_angle", add_to_rqt_reconfigure=True)
        params.add("terminal_contouring", add_to_rqt_reconfigure=True)
        for i in range(self.num_segments):
            params.add(f"spline_x{i}_a", bundle_name="spline_x_a")
            params.add(f"spline_x{i}_b", bundle_name="spline_x_b")
            params.add(f"spline_x{i}_c", bundle_name="spline_x_c")
            params.add(f"spline_x{i}_d", bundle_name="spline_x_d")
            params.add(f"spline_y{i}_a", bundle_name="spline_y_a")
            params.add(f"spline_y{i}_b", bundle_name="spline_y_b")
            params.add(f"spline_y{i}_c", bundle_name="spline_y_c")
            params.add(f"spline_y{i}_d", bundle_name="spline_y_d")
            params.add(f"spline{i}_start", bundle_name="spline_start")

    def get_value(self, model, params, settings, stage_idx):
        pos_x = model.get("x")
        pos_y = model.get("y")
        psi = model.get("psi")
        v = model.get("v")
        s = model.get("spline")

        contour_weight = params.get("contour")
        lag_weight = params.get("lag")

        if self.dynamic_velocity_reference:
            if not params.has_parameter("spline_v0_a"):
                raise IOError(
                    "contouring/dynamic_velocity_reference is enabled, but there is "
                    "no PathReferenceVelocity module.")
            path_velocity = Spline(params, "spline_v", self.num_segments, s)
            reference_velocity = path_velocity.at(s)
            velocity_weight = params.get("velocity")

        path = Spline2D(params, self.num_segments, s)
        path_x, path_y = path.at(s)
        path_dx_n, path_dy_n = path.deriv_normalized(s)

        contour_error = path_dy_n * (pos_x - path_x) - path_dx_n * (pos_y - path_y)
        lag_error = path_dx_n * (pos_x - path_x) + path_dy_n * (pos_y - path_y)

        cost = lag_weight * lag_error**2
        cost = cost + contour_weight * contour_error**2

        if self.dynamic_velocity_reference:
            cost = cost + velocity_weight * (v - reference_velocity) ** 2

        if stage_idx == settings["N"] - 1:  # terminal stage
            terminal_angle_weight = params.get("terminal_angle")
            terminal_contouring_mp = params.get("terminal_contouring")
            path_angle = torch.atan2(path_dy_n, path_dx_n)
            angle_error = haar_difference_without_abs(psi, path_angle)
            cost = cost + terminal_angle_weight * angle_error**2
            cost = cost + terminal_contouring_mp * lag_weight * lag_error**2
            cost = cost + terminal_contouring_mp * contour_weight * contour_error**2

        return cost

    # -- runtime -----------------------------------------------------------
    def on_data_received(self, data, data_name: str) -> None:
        if data_name != "reference_path":
            return
        self.spline = CubicSpline2D(data.reference_path.x, data.reference_path.y)
        if (self.add_road_constraints and not data.left_bound.empty()
                and not data.right_bound.empty()):
            self.bound_left = CubicSpline2D(data.left_bound.x, data.left_bound.y)
            self.bound_right = CubicSpline2D(data.right_bound.x, data.right_bound.y)
            self.settings["road"]["width"] = float(
                np.linalg.norm(self.bound_left.at(0.0) - self.bound_right.at(0.0)))
        self.closest_segment = -1

    def is_data_ready(self, data) -> bool:
        return not data.reference_path.empty()

    def missing_data(self, data) -> str:
        return "" if self.is_data_ready(data) else "Reference Path "

    def update(self, state, data, module_data) -> None:
        pos = np.array([state.get("x"), state.get("y")])
        # Local search around the propagated progress state; the full-path
        # pass runs on the first cycle and after resets.
        s_hint = None
        if state.has("spline") and self.closest_segment >= 0:
            s_hint = float(state.get("spline"))
        closest_s = self.spline.closest_s(pos, s_hint=s_hint)
        self.closest_segment = self.spline.segment_index(closest_s)
        state.set("spline", closest_s)
        if module_data.path is None:
            module_data.path = self.spline
        module_data.current_path_segment = self.closest_segment
        if self.add_road_constraints:
            self.construct_road_constraints(data, module_data)

    def refresh_state(self, state, module_data) -> None:
        """Pipelined hook: ``update`` ran with a predicted state, so re-derive
        the progress of the actual state (the hint-windowed closest-s search)
        for xinit. The parameter fill keeps the predicted segment window:
        segments carry absolute starts, so it stays exact."""
        if self.spline is None:
            return
        pos = np.array([state.get("x"), state.get("y")])
        s_hint = None
        if state.has("spline") and self.closest_segment >= 0:
            s_hint = float(state.get("spline"))
        state.set("spline", self.spline.closest_s(pos, s_hint=s_hint))

    def set_parameters(self, buf, data, module_data) -> None:
        w = self.settings["weights"]
        buf.set("contour", float(w["contour"]))
        buf.set("lag", float(w["lag"]))
        buf.set("terminal_angle", float(w["terminal_angle"]))
        buf.set("terminal_contouring", float(w["terminal_contouring"]))
        if self.dynamic_velocity_reference:
            buf.set("velocity", float(w["velocity"]))
            buf.set("reference_velocity", float(w["reference_velocity"]))

        seg = self.spline.export_segments(self.closest_segment, self.num_segments)
        for i in range(self.num_segments):
            buf.set(f"spline_x{i}_a", seg["a_x"][i])
            buf.set(f"spline_x{i}_b", seg["b_x"][i])
            buf.set(f"spline_x{i}_c", seg["c_x"][i])
            buf.set(f"spline_x{i}_d", seg["d_x"][i])
            buf.set(f"spline_y{i}_a", seg["a_y"][i])
            buf.set(f"spline_y{i}_b", seg["b_y"][i])
            buf.set(f"spline_y{i}_c", seg["c_y"][i])
            buf.set(f"spline_y{i}_d", seg["d_y"][i])
            buf.set(f"spline{i}_start", seg["start"][i])

    def is_objective_reached(self, state, data) -> bool:
        if self.spline is None:
            return False
        end = self.spline.at(self.spline.length)
        pos = np.array([state.get("x"), state.get("y")])
        return bool(np.linalg.norm(pos - end) < 1.5)

    def construct_road_constraints(self, data, module_data) -> None:
        """Two halfspaces per stage bounding the road."""
        if self.bound_left is None or self.bound_right is None:
            self._road_constraints_from_centerline(data, module_data)
        else:
            self._road_constraints_from_bounds(data, module_data)

    def _stage_progress_vector(self) -> np.ndarray:
        """(N-1,) warm-start spline values at stages 1..N-1."""
        svar = self.solver.ocp.model.var_index("spline")
        return np.asarray(self.solver._x0[1:self.solver.N, svar], dtype=float)

    def _road_constraints_from_centerline(self, data, module_data) -> None:
        N = self.solver.N
        if module_data.static_obstacles is None:
            module_data.static_obstacles = [[] for _ in range(N)]
        road_width_half = float(self.settings["road"]["width"]) / 2.0
        width_times = 3.0 if self.two_way_road else 1.0
        r = data.robot_area[0].radius
        ss = self._stage_progress_vector()
        p = self.spline.at(ss)  # (N-1, 2)
        t = self.spline.deriv(ss)
        t = t / (np.linalg.norm(t, axis=1, keepdims=True) + 1e-12)
        ortho = np.stack([t[:, 1], -t[:, 0]], axis=1)  # right-hand normal
        bl = np.sum(ortho * (p + ortho * (width_times * road_width_half - r)),
                    axis=1)
        br = np.sum(ortho * (p - ortho * (road_width_half - r)), axis=1)
        for k in range(1, N):
            module_data.static_obstacles[k] = [
                Halfspace(ortho[k - 1], float(bl[k - 1])),
                Halfspace(-ortho[k - 1], float(-br[k - 1]))]

    def _road_constraints_from_bounds(self, data, module_data) -> None:
        N = self.solver.N
        if module_data.static_obstacles is None:
            module_data.static_obstacles = [[] for _ in range(N)]
        r = data.robot_area[0].radius
        ss = self._stage_progress_vector()
        halves = []
        for bound, sign in ((self.bound_left, -1.0), (self.bound_right, 1.0)):
            t = bound.deriv(ss)
            t = t / (np.linalg.norm(t, axis=1, keepdims=True) + 1e-12)
            A = np.stack([t[:, 1], -t[:, 0]], axis=1)
            # Offset the bound inward by the robot radius.
            b = np.sum(A * (bound.at(ss) - sign * A * r), axis=1)
            halves.append((sign * A, sign * b))
        for k in range(1, N):
            module_data.static_obstacles[k] = [
                Halfspace(A[k - 1], float(b[k - 1])) for A, b in halves]

    def reset(self) -> None:
        self.spline = None
        self.closest_segment = -1
