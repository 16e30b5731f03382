"""Convex free-space decomposition around a seed path, counterpart of the
JAX package's ``ops/decomp.py`` (the role of decomp_util's
``EllipsoidDecomp2D`` in the upstream planner): given point obstacles and a
seed path, grow an obstacle-free ellipse around each segment and extract a
convex polygon of tangent halfspaces. Host-side numpy, or the same algorithm
in ``native/decomp.cpp`` (:mod:`.decomp_native`); the halfspaces feed the
decomp constraint rows.

Algorithm (after Liu et al., "Planning Dynamically Feasible Trajectories for
Quadrotors using Safe Flight Corridors", RA-L 2017):
1. For each path segment, take obstacle points within ``local_range``.
2. Ellipse seeding: aligned with the segment, semi-major = half the segment
   length; shrink the semi-minor axis until no obstacle point is inside.
3. Polygon: repeatedly find the closest obstacle point in the ellipse
   metric, add the tangent halfspace of the scaled ellipse at that point,
   discard the points it cuts off; stop when none remain.

The backend is decided once, when an ``EllipsoidDecomp2D`` is built, and
recorded as ``.backend``: ``"auto"`` takes ``"cpp"`` when the native
library builds and loads, else ``"python"``; ``"cpp"`` raises if it does
not. A call never switches backend.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Halfplane = Tuple[np.ndarray, float]  # (a, b): a.x <= b


def occupied_points_from_costmap(costmap) -> np.ndarray:
    """Extract occupied cell centers (world coords) from a costmap-like object.

    Accepts either an object with ``data`` (2D array), ``resolution``, ``origin``
    attributes, or a plain (points, 2) array (already world points). Mirrors
    decomp_constraints.cpp:122-148 (``getOccupiedGridCells``).
    """
    if isinstance(costmap, np.ndarray):
        if costmap.ndim == 2 and costmap.shape[1] == 2:
            return costmap
        raise ValueError("costmap array must be (n, 2) world points")
    data = np.asarray(costmap.data)
    occ = np.argwhere(data > costmap.threshold if hasattr(costmap, "threshold")
                      else data > 50)
    origin = np.asarray(costmap.origin, dtype=float)
    res = float(costmap.resolution)
    return origin[None, :] + (occ[:, ::-1].astype(float) + 0.5) * res


class EllipsoidDecomp2D:
    def __init__(self, local_range: float = 2.0, max_constraints: int = 12,
                 backend: str = "auto"):
        """backend: "auto" (the native library when it builds, else numpy),
        "cpp" (the native library, or RuntimeError) or "python" (numpy).
        The choice is made here and kept in ``self.backend``."""
        if backend not in ("auto", "cpp", "python"):
            raise ValueError(f"backend must be auto, cpp or python, not "
                             f"{backend!r}")
        self.local_range = local_range
        self.max_constraints = max_constraints
        if backend != "python":
            from . import decomp_native

            if decomp_native.available():
                backend = "cpp"
            elif backend == "cpp":
                raise RuntimeError("native decomp backend unavailable")
            else:
                backend = "python"
        self.backend = backend

    def dilate_path(self, path: np.ndarray, obstacles: np.ndarray
                    ) -> List[List[Halfplane]]:
        """Per path point k>=1, halfspaces of the free polytope around segment
        (path[k-1], path[k]). Returns a list of lists of (a, b) with a.x <= b."""
        if self.backend == "cpp":
            from . import decomp_native

            return decomp_native.dilate_path(
                np.asarray(path, dtype=float),
                np.asarray(obstacles, dtype=float) if len(obstacles)
                else np.zeros((0, 2)),
                self.local_range, self.max_constraints)
        out: List[List[Halfplane]] = [[] for _ in range(len(path))]
        for k in range(1, len(path)):
            out[k] = self.dilate_segment(path[k - 1], path[k], obstacles)
        return out

    def dilate_segment(self, p1: np.ndarray, p2: np.ndarray,
                       obstacles: np.ndarray) -> List[Halfplane]:
        center = 0.5 * (p1 + p2)
        axis = p2 - p1
        seg_len = np.linalg.norm(axis)
        if seg_len < 1e-9:
            axis = np.array([1.0, 0.0])
            seg_len = 1e-6
        e1 = axis / seg_len
        e2 = np.array([-e1[1], e1[0]])
        a = seg_len / 2.0 + 1e-3
        b = a

        # Local obstacle crop
        if len(obstacles) > 0:
            rel = obstacles - center[None, :]
            local = obstacles[np.max(np.abs(rel), axis=1)
                              <= self.local_range + a]
        else:
            local = obstacles

        R = np.stack([e1, e2], axis=0)  # world -> ellipse frame

        def in_ellipse(pts, aa, bb):
            q = (pts - center[None, :]) @ R.T
            return (q[:, 0] / aa) ** 2 + (q[:, 1] / bb) ** 2 < 1.0

        # Shrink semi-minor axis until free (ellipsoid seeding)
        if len(local) > 0:
            for _ in range(40):
                inside = in_ellipse(local, a, b)
                if not np.any(inside):
                    break
                q = (local[inside] - center[None, :]) @ R.T
                # Required b so the closest inside point lies on the boundary
                denom = 1.0 - (q[:, 0] / a) ** 2
                denom = np.maximum(denom, 1e-6)
                b_needed = np.sqrt(q[:, 1] ** 2 / denom)
                b = max(min(b, float(np.min(b_needed))) * 0.999, 1e-3)
                if b <= 1e-3:
                    break

        # Polyhedron: tangent halfspaces at closest points in ellipse metric
        halfspaces: List[Halfplane] = []
        E_inv2 = R.T @ np.diag([1.0 / a**2, 1.0 / b**2]) @ R
        remaining = local.copy() if len(local) else local
        for _ in range(self.max_constraints):
            if len(remaining) == 0:
                break
            d = remaining - center[None, :]
            metric = np.einsum("ni,ij,nj->n", d, E_inv2, d)
            i = int(np.argmin(metric))
            pt = remaining[i]
            # Tangent of the scaled ellipse through pt: normal = E_inv2 (pt - center)
            n = E_inv2 @ (pt - center)
            norm = np.linalg.norm(n)
            if norm < 1e-12:
                break
            n = n / norm
            bb = float(n @ pt)
            halfspaces.append((n, bb))
            keep = (remaining @ n) < bb - 1e-9
            remaining = remaining[keep]
        return halfspaces
