"""Experiment recording, counterpart of the JAX package's
``utils/datasaver.py``: :class:`DataSaver` keeps named per-iteration data
streams (pose, plans, obstacles, runtimes, statuses) and exports them to
JSON; :class:`ExperimentUtil` segments them into episodes and derives the
per-episode metrics (duration, completed, collisions). Without a
``recording/folder`` setting it writes under the system's temporary
directory.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np


class DataSaver:
    """Named append-only data streams, exported to JSON (+ npz for arrays)."""

    def __init__(self):
        self._data: Dict[str, List[Any]] = {}

    def add(self, name: str, value) -> None:
        if isinstance(value, np.ndarray):
            value = value.tolist()
        self._data.setdefault(name, []).append(value)

    def get(self, name: str) -> List[Any]:
        return self._data.get(name, [])

    def clear(self) -> None:
        self._data = {}

    def save(self, path: str, add_timestamp: bool = False) -> str:
        if add_timestamp:
            base, ext = os.path.splitext(path)
            path = f"{base}_{time.strftime('%Y%m%d_%H%M%S')}{ext or '.json'}"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self._data, f)
        return path


class ExperimentUtil:
    """Per-iteration experiment recorder with episode segmentation
    (experiment_util.cpp:67-157)."""

    def __init__(self, settings: Optional[dict] = None):
        rec = (settings or {}).get("recording", {})
        self.enabled = rec.get("enable", True)
        self.folder = rec.get(
            "folder", os.path.join(tempfile.gettempdir(), "tmpc_experiments"))
        self.file = rec.get("file", "experiment")
        self.timestamp = rec.get("timestamp", True)
        self.num_experiments = rec.get("num_experiments", 0)
        self.save_obstacle_data = rec.get("save_obstacle_data", True)
        self.save_trajectory_plans = rec.get("save_ego_trajectory_plans", True)
        self.saver = DataSaver()
        self.experiment_index = 0
        self.iteration = 0
        self._experiment_start: Optional[float] = None
        self.completed_experiments: List[dict] = []

    def set_start_experiment(self, now: Optional[float] = None) -> None:
        self._experiment_start = now if now is not None else time.monotonic()
        self.iteration = 0

    def update(self, state, data, output, runtime_s: float = 0.0,
               now: Optional[float] = None) -> None:
        """Record one control iteration (experiment_util.cpp:67-118)."""
        if not self.enabled:
            return
        if self._experiment_start is None:
            self.set_start_experiment(now)
        s = self.saver
        s.add("experiment", self.experiment_index)
        s.add("iteration", self.iteration)
        s.add("pose", [state.get("x"), state.get("y"), state.get("psi")])
        s.add("velocity", state.get("v"))
        s.add("status", int(output.exit_code) if output is not None else 0)
        s.add("success", bool(output.success) if output is not None else False)
        s.add("objective", float(output.objective) if output is not None else 0.0)
        s.add("runtime", runtime_s)
        if output is not None and self.save_trajectory_plans and len(
                output.trajectory.positions):
            s.add("plan", np.asarray(output.trajectory.positions))
        if self.save_obstacle_data:
            s.add("obstacles",
                  [[float(o.position[0]), float(o.position[1]), float(o.radius)]
                   for o in data.dynamic_obstacles])
        self.iteration += 1

    def on_task_complete(self, completed: bool, collisions: int = 0,
                         now: Optional[float] = None) -> Optional[str]:
        """Close the episode; export after ``num_experiments`` episodes
        (experiment_util.cpp:125-157). Returns the export path when written."""
        now = now if now is not None else time.monotonic()
        duration = (now - self._experiment_start
                    if self._experiment_start is not None else 0.0)
        self.saver.add("metric_duration", duration)
        self.saver.add("metric_completed", bool(completed))
        self.saver.add("metric_collisions", int(collisions))
        self.completed_experiments.append({
            "index": self.experiment_index, "duration": duration,
            "completed": completed, "collisions": collisions,
            "iterations": self.iteration,
        })
        self.experiment_index += 1
        self._experiment_start = None
        if self.num_experiments and (
                self.experiment_index % self.num_experiments == 0):
            return self.export()
        return None

    def export(self) -> str:
        path = os.path.join(self.folder, f"{self.file}.json")
        return self.saver.save(path, add_timestamp=self.timestamp)

    def summary(self) -> dict:
        exps = self.completed_experiments
        if not exps:
            return {"experiments": 0}
        return {
            "experiments": len(exps),
            "completion_rate": sum(e["completed"] for e in exps) / len(exps),
            "mean_duration": sum(e["duration"] for e in exps) / len(exps),
            "total_collisions": sum(e["collisions"] for e in exps),
        }
