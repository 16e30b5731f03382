"""Static free-space polygon constraints, torch counterpart of the JAX
package's ``modules/decomp_constraints.py``: up to ``max_constraints``
halfspaces per disc and stage, ``a1 px + a2 py - (b + slack) <= 0`` at the
disc position, slack the model's where it has one, else 0.

Runtime (numpy): gather the occupied cells of the costmap, decompose the
free space around the warm start's path (:class:`..ops.decomp.
EllipsoidDecomp2D`, whose backend is decided once, when the module is
built, and kept in ``self.decomp.backend``), and upload the halfspaces per
stage; absent halfspaces are far-away dummies.
"""

from __future__ import annotations

import numpy as np

from .base import ConstraintModule, ego_disc_position
from ..ops.decomp import EllipsoidDecomp2D, occupied_points_from_costmap


class DecompConstraintModule(ConstraintModule):
    module_name = "DecompConstraints"
    description = "Static constraints computed with convex free-space decomposition"

    def __init__(self, settings):
        self.settings = settings
        self.n_discs = settings["n_discs"]
        self.max_constraints = settings["decomp"]["max_constraints"]
        self.range = settings["decomp"]["range"]
        self.use_slack = True
        self.nh = self.max_constraints * self.n_discs
        self.solver = None
        self.decomp = EllipsoidDecomp2D(local_range=self.range,
                                        max_constraints=self.max_constraints)
        self._a1 = self._a2 = self._b = None
        self._dummy_a1, self._dummy_a2, self._dummy_b = 1.0, 0.0, 1000.0

    def _constraint_name(self, index: int, disc_id: int) -> str:
        return f"disc_{disc_id}_decomp_{index}"

    def define_parameters(self, params) -> None:
        for d in range(self.n_discs):
            params.add(f"ego_disc_{d}_offset", bundle_name="ego_disc_offset")
            for i in range(self.max_constraints):
                params.add(self._constraint_name(i, d) + "_a1", bundle_name="decomp_a1")
                params.add(self._constraint_name(i, d) + "_a2", bundle_name="decomp_a2")
                params.add(self._constraint_name(i, d) + "_b", bundle_name="decomp_b")

    def get_lower_bound(self):
        return [-np.inf] * self.nh

    def get_upper_bound(self):
        return [0.0] * self.nh

    def get_constraints(self, model, params, settings, stage_idx):
        constraints = []
        slack = (model.get("slack") if self.use_slack and model.has("slack")
                 else 0.0)
        for d in range(self.n_discs):
            px, py = ego_disc_position(model, params, d)
            for i in range(self.max_constraints):
                a1 = params.get(self._constraint_name(i, d) + "_a1")
                a2 = params.get(self._constraint_name(i, d) + "_a2")
                b = params.get(self._constraint_name(i, d) + "_b")
                constraints.append(a1 * px + a2 * py - (b + slack))
        return constraints

    # -- runtime -----------------------------------------------------------
    def update(self, state, data, module_data) -> None:
        N = self.solver.N
        rows = self.max_constraints
        self._a1 = np.full((self.n_discs, N, rows), self._dummy_a1)
        self._a2 = np.full((self.n_discs, N, rows), self._dummy_a2)
        self._b = np.full((self.n_discs, N, rows), self._dummy_b)

        if data.costmap is None:
            return
        occupied = occupied_points_from_costmap(data.costmap)
        if len(occupied) == 0:
            return

        path = np.stack([
            np.array([self.solver.get_ego_prediction(k, "x"),
                      self.solver.get_ego_prediction(k, "y")])
            for k in range(N)])
        polys = self.decomp.dilate_path(path, occupied)
        for k in range(1, N):
            hs = polys[k]
            for d in range(self.n_discs):
                for i, (a, b) in enumerate(hs[: self.max_constraints]):
                    self._a1[d, k, i] = a[0]
                    self._a2[d, k, i] = a[1]
                    self._b[d, k, i] = b

    def set_parameters(self, buf, data, module_data) -> None:
        for d in range(self.n_discs):
            if len(data.robot_area) > d:
                buf.set(f"ego_disc_{d}_offset", data.robot_area[d].offset)
            for i in range(self.max_constraints):
                name = self._constraint_name(i, d)
                if self._a1 is None:
                    buf.set(name + "_a1", self._dummy_a1)
                    buf.set(name + "_a2", self._dummy_a2)
                    buf.set(name + "_b", self._dummy_b)
                else:
                    buf.set(name + "_a1", self._a1[d, :, i])
                    buf.set(name + "_a2", self._a2[d, :, i])
                    buf.set(name + "_b", self._b[d, :, i])

    def is_data_ready(self, data) -> bool:
        return True  # the costmap is optional: dummies keep the rows inactive
