"""Planner visualization, counterpart of the JAX package's
``utils/visualization.py``: each control cycle is captured as a
:class:`SceneFrame` (pose, plan, warm start, guidance, obstacles with their
predictions, reference path, goal), dumped to JSON or rendered to PNG with
matplotlib's Agg backend. Tensors in the captured objects become Python
floats and numpy arrays, so the JSON equals the JAX package's.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch


def _array(x) -> np.ndarray:
    """numpy copy of an array, a tensor on any device or a list of them."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return np.asarray([_array(v) for v in x])
    return np.asarray(x)


def _float(x) -> float:
    return float(x.item()) if isinstance(x, torch.Tensor) else float(x)


@dataclass
class SceneFrame:
    t: float = 0.0
    robot_pose: Optional[List[float]] = None  # [x, y, psi]
    robot_radius: float = 0.325
    planned_trajectory: Optional[np.ndarray] = None  # (N, 2)
    warmstart_trajectory: Optional[np.ndarray] = None
    alternative_trajectories: List[np.ndarray] = field(default_factory=list)
    guidance_trajectories: List[np.ndarray] = field(default_factory=list)
    obstacles: List[dict] = field(default_factory=list)  # {pos, radius, pred}
    halfspaces: List[dict] = field(default_factory=list)  # {A, b}
    reference_path: Optional[np.ndarray] = None
    goal: Optional[List[float]] = None
    selected_planner: int = -1


class SceneRecorder:
    """Collects per-cycle scene frames (the visualize() call equivalent)."""

    def __init__(self):
        self.frames: List[SceneFrame] = []

    def capture(self, t, state, data, planner=None, output=None,
                guidance=None) -> SceneFrame:
        frame = SceneFrame(t=_float(t))
        frame.robot_pose = [_float(state.get(k)) for k in ("x", "y", "psi")]
        if data is not None:
            frame.obstacles = [
                {"pos": [_float(o.position[0]), _float(o.position[1])],
                 "radius": _float(o.radius),
                 "prediction": [[_float(s.position[0]), _float(s.position[1])]
                                for s in (o.prediction.modes[0][:10]
                                          if not o.prediction.empty() else [])]}
                for o in data.dynamic_obstacles]
            if data.goal is not None:
                frame.goal = [_float(data.goal[0]), _float(data.goal[1])]
            if not data.reference_path.empty():
                frame.reference_path = np.stack(
                    [_array(data.reference_path.x),
                     _array(data.reference_path.y)], axis=1)
        if output is not None and output.success:
            frame.planned_trajectory = _array(output.trajectory.positions)
            frame.selected_planner = int(output.selected_planner_index)
        if planner is not None:
            frame.warmstart_trajectory = _array(
                planner.solver.get_ego_prediction_trajectory())
        if guidance is not None:
            frame.guidance_trajectories = [
                _array(guidance.get_guidance_trajectory(i).positions)
                for i in range(guidance.number_of_guidance_trajectories())]
        self.frames.append(frame)
        return frame

    def save_json(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

        def conv(x):
            if isinstance(x, np.ndarray):
                return x.tolist()
            return x

        payload = []
        for f in self.frames:
            payload.append({
                "t": f.t, "robot_pose": f.robot_pose,
                "planned": conv(f.planned_trajectory),
                "warmstart": conv(f.warmstart_trajectory),
                "guidance": [conv(g) for g in f.guidance_trajectories],
                "obstacles": f.obstacles, "halfspaces": f.halfspaces,
                "reference_path": conv(f.reference_path), "goal": f.goal,
                "selected_planner": f.selected_planner,
            })
        with open(path, "w") as fh:
            json.dump(payload, fh)
        return path

    def render(self, path: str, frame_index: int = -1, show_history: bool = True
               ) -> str:
        """Render one frame (PNG) with matplotlib."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        frame = self.frames[frame_index]
        fig, ax = plt.subplots(figsize=(8, 6))
        if frame.reference_path is not None:
            ax.plot(frame.reference_path[:, 0], frame.reference_path[:, 1],
                    "k--", lw=0.8, label="reference path")
        for g in frame.guidance_trajectories:
            ax.plot(g[:, 0], g[:, 1], color="tab:gray", lw=0.8, alpha=0.6)
        if frame.planned_trajectory is not None:
            ax.plot(frame.planned_trajectory[:, 0],
                    frame.planned_trajectory[:, 1], "tab:red", lw=2,
                    label="selected plan")
        for obs in frame.obstacles:
            if obs["pos"][0] > 50:
                continue  # dummy
            circ = plt.Circle(obs["pos"], obs["radius"], color="tab:orange",
                              alpha=0.6)
            ax.add_patch(circ)
            pred = np.asarray(obs.get("prediction", []))
            if len(pred):
                ax.plot(pred[:, 0], pred[:, 1], color="tab:orange", lw=0.8,
                        alpha=0.5)
        if frame.robot_pose is not None:
            ax.add_patch(plt.Circle(frame.robot_pose[:2], frame.robot_radius,
                                    color="tab:blue", alpha=0.8))
        if frame.goal is not None:
            ax.plot(*frame.goal, "g*", markersize=14, label="goal")
        if show_history:
            hist = np.array([f.robot_pose[:2] for f in self.frames
                             if f.robot_pose is not None])
            if len(hist) > 1:
                ax.plot(hist[:, 0], hist[:, 1], "tab:blue", lw=1, alpha=0.5)
        ax.set_aspect("equal")
        ax.legend(loc="upper left", fontsize=8)
        ax.set_title(f"t = {frame.t:.1f} s")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return path
