"""The port's host layers against the JAX package's: the terminal and web
dashboards, the scene recorder, the leveled logging, and the repairs of
``Module.visualize`` / ``save_data``, ``Trajectory``'s two methods and
``utils/math.py``'s two numpy helpers. Both packages get the same inputs;
no SQP solve.
"""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import oscar_mpc_planner_mr_modification_tpu as jax_pkg
import oscar_mpc_planner_mr_modification_tpu_torch as port_pkg
from oscar_mpc_planner_mr_modification_tpu import dashboard as jax_dashboard
from oscar_mpc_planner_mr_modification_tpu import (
    dashboard_web as jax_dashboard_web)
from oscar_mpc_planner_mr_modification_tpu import metrics as jax_metrics
from oscar_mpc_planner_mr_modification_tpu import types as jax_types
from oscar_mpc_planner_mr_modification_tpu.utils import logging as jax_logging
from oscar_mpc_planner_mr_modification_tpu.utils import math as jax_math
from oscar_mpc_planner_mr_modification_tpu.utils import (
    visualization as jax_visualization)
from oscar_mpc_planner_mr_modification_tpu_torch import dashboard
from oscar_mpc_planner_mr_modification_tpu_torch import dashboard_web
from oscar_mpc_planner_mr_modification_tpu_torch import metrics
from oscar_mpc_planner_mr_modification_tpu_torch import types
from oscar_mpc_planner_mr_modification_tpu_torch.utils import logging
from oscar_mpc_planner_mr_modification_tpu_torch.utils import math as port_math
from oscar_mpc_planner_mr_modification_tpu_torch.utils import visualization

RECORDS = [
    dict(robot_ns="jackal1", planner_state="PLANNING_ACTIVE",
         solver_success=True, objective=1.5, velocity=1.2, position_x=2.0,
         position_y=-0.5, communicated=True, communication_trigger="TIME",
         planning_time_ms=12.25, selected_topology_id=3,
         num_guidance_found=4),
    dict(robot_ns="jackal2", planner_state="GOAL_REACHED"),
    dict(robot_ns="jackal1", planner_state="WAITING_FOR_TRAJECTORY_DATA",
         solver_success=False, objective=-0.75, velocity=0.3,
         position_x=2.5, communicated=False),
    dict(robot_ns="jackal3", planner_state="PLANNING_ACTIVE",
         solver_success=True, objective=1e3, communicated=True,
         communication_trigger="GEOMETRIC", planning_time_ms=3.5),
]


def metrics_logs():
    logs = (jax_metrics.MetricsLog(), metrics.MetricsLog())
    for rec in RECORDS:
        logs[0].add(jax_metrics.MPCMetrics(**rec))
        logs[1].add(metrics.MPCMetrics(**rec))
    return logs


def test_dashboard_text_and_snapshot_equal_jax():
    jax_log, log = metrics_logs()
    text = dashboard.render_dashboard(log)
    assert text == jax_dashboard.render_dashboard(jax_log)
    assert "jackal1" in text and "bandwidth saving" in text
    assert (dashboard.render_dashboard(log, width=60)
            == jax_dashboard.render_dashboard(jax_log, width=60))
    snap = dashboard_web.snapshot(log)
    assert snap == jax_dashboard_web.snapshot(jax_log)
    assert [r["ns"] for r in snap["robots"]] == ["jackal1", "jackal2",
                                                 "jackal3"]


def test_live_dashboard_frames_equal_jax(capsys, monkeypatch):
    jax_log, log = metrics_logs()
    monkeypatch.setattr("time.sleep", lambda s: None)
    jax_dashboard.live_dashboard(jax_log, n_frames=2)
    want = capsys.readouterr().out
    dashboard.live_dashboard(log, n_frames=2)
    assert capsys.readouterr().out == want


def test_web_dashboard_serves_live_metrics():
    """The port's DashboardServer serves JAX's page and a live snapshot of
    the MetricsLog over real HTTP (tests/test_observability.py:115-160)."""
    log = metrics.MetricsLog()
    log.add(metrics.MPCMetrics(**RECORDS[0]))
    server = dashboard_web.DashboardServer(log).start()
    try:
        page = urllib.request.urlopen(server.url, timeout=5).read().decode()
        assert page == jax_dashboard_web._PAGE
        data = json.loads(urllib.request.urlopen(
            server.url + "metrics.json", timeout=5).read())
        assert data["robots"][0]["state"] == "PLANNING_ACTIVE"
        assert data["robots"][0]["comm"] == "TIME"
        log.add(metrics.MPCMetrics(robot_ns="jackal2",
                                   planner_state="GOAL_REACHED"))
        data = json.loads(urllib.request.urlopen(
            server.url + "metrics.json", timeout=5).read())
        assert [r["ns"] for r in data["robots"]] == ["jackal1", "jackal2"]
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(server.url + "other", timeout=5)
    finally:
        server.stop()


class _Solver:
    def __init__(self, ego):
        self.ego = ego

    def get_ego_prediction_trajectory(self):
        return self.ego


class _Planner:
    def __init__(self, ego):
        self.solver = _Solver(ego)


class _Guidance:
    def __init__(self, trajectories):
        self.trajectories = trajectories

    def number_of_guidance_trajectories(self):
        return len(self.trajectories)

    def get_guidance_trajectory(self, i):
        return type("G", (), {"positions": self.trajectories[i]})()


def scene(pkg, rng_seed, tensors):
    """One scene in ``pkg``'s classes from seeded numpy; ``tensors`` hands
    the planner's warm start, the guidance and the goal over as tensors."""
    from importlib import import_module

    t = import_module(pkg.__name__ + ".types")
    models = import_module(pkg.__name__ + ".models")
    solver = import_module(pkg.__name__ + ".solver")
    rng = np.random.default_rng(rng_seed)
    wrap = torch.as_tensor if tensors else np.asarray

    state = solver.State(models.SecondOrderUnicycleModel())
    state.set("x", 1.0)
    state.set("y", -0.25)
    state.set("psi", 0.3)
    data = t.RealTimeData()
    data.goal = wrap(np.array([5.0, 0.5]))
    data.goal_received = True
    obstacles = []
    for i in range(3):
        steps = [t.PredictionStep(rng.normal(size=2) + [3.0, 0.0], 0.0, 0.3,
                                  0.3) for _ in range(12)]
        pred = t.Prediction(type=t.PredictionType.DETERMINISTIC,
                            modes=[steps], probabilities=[1.0])
        obstacles.append(t.DynamicObstacle(i, rng.normal(size=2) + [3.0, 0.0],
                                           radius=0.4, prediction=pred))
    obstacles.append(t.DynamicObstacle(3, np.array([100.0, 100.0])))
    data.dynamic_obstacles = obstacles
    xs = np.linspace(0.0, 10.0, 11)
    data.reference_path = t.ReferencePath(x=list(xs), y=list(0.1 * xs),
                                          psi=[0.0] * 11)
    out = t.PlannerOutput()
    out.success = True
    out.selected_planner_index = 2
    for p in rng.normal(size=(9, 2)):
        out.trajectory.add(p)
    ego = rng.normal(size=(9, 2))
    guides = [rng.normal(size=(9, 2)) for _ in range(2)]
    return (state, data, _Planner(wrap(ego)), out,
            _Guidance([wrap(g) for g in guides]))


def test_scene_recorder_json_equals_jax_and_renders(tmp_path):
    """tests/test_observability.py:50-70 with obstacle predictions, a
    reference path, a hand-built PlannerOutput, a warm start and guidance."""
    jax_rec = jax_visualization.SceneRecorder()
    rec = visualization.SceneRecorder()
    for k in range(3):
        s, d, planner, out, guidance = scene(jax_pkg, k, tensors=False)
        jax_rec.capture(0.2 * k, s, d, planner=planner, output=out,
                        guidance=guidance)
        s, d, planner, out, guidance = scene(port_pkg, k, tensors=True)
        frame = rec.capture(0.2 * k, s, d, planner=planner, output=out,
                            guidance=guidance)
    assert isinstance(frame.warmstart_trajectory, np.ndarray)
    assert isinstance(frame.goal[0], float)
    want = json.load(open(jax_rec.save_json(str(tmp_path / "jax.json"))))
    got = json.load(open(rec.save_json(str(tmp_path / "port.json"))))
    assert got == want
    assert len(got) == 3 and len(got[0]["obstacles"]) == 4
    assert len(got[0]["obstacles"][0]["prediction"]) == 10
    png = rec.render(str(tmp_path / "scene.png"))
    assert os.path.getsize(png) > 1000


LOGGERS = ("log_debug", "log_mark", "log_info", "log_warn", "log_error")


def _log_all(mod):
    for name in LOGGERS:
        getattr(mod, name)(f"{name} message")
    mod.log_value("speed", 1.25)
    mod.print_header("title")


@pytest.mark.parametrize("debug", [False, True])
def test_logging_writes_jax_bytes(capsys, monkeypatch, debug):
    for mod in (jax_logging, logging):
        monkeypatch.setattr(mod, "debug_enabled", debug)
    _log_all(jax_logging)
    want = capsys.readouterr()
    _log_all(logging)
    got = capsys.readouterr()
    assert got.err == want.err and got.out == want.out == ""
    assert ("[DEBUG]" in got.err) == debug and ("[MARK]" in got.err) == debug
    assert "\033[33m[WARN]\033[0m log_warn message\n" in got.err


def test_log_warn_throttle_writes_jax_bytes(capsys, monkeypatch):
    clock = {"t": 0.0}
    for mod in (jax_logging, logging):
        monkeypatch.setattr(mod, "_throttle_last", {})
        monkeypatch.setattr(mod.time, "monotonic", lambda: clock["t"])
    out = {}
    for mod in (jax_logging, logging):
        for t in (0.0, 0.05, 0.0999, 0.1, 0.15, 0.35):
            clock["t"] = t
            mod.log_warn_throttle(100.0, "slow")
            mod.log_warn_throttle(100.0, "other")
        out[mod] = capsys.readouterr().err
    assert out[logging] == out[jax_logging]
    assert out[logging].count("slow") == 3


def test_planner_visualize_and_save_data_are_no_ops():
    """C4: a planner of each package, built on the CPU and never solved,
    returns None from visualize; every module has save_data."""
    from oscar_mpc_planner_mr_modification_tpu.factory import (
        build_planner as jax_build_planner,
        configuration_basic as jax_configuration_basic)
    from oscar_mpc_planner_mr_modification_tpu.solver import (
        State as JaxState)
    from oscar_mpc_planner_mr_modification_tpu.utils import (
        default_settings as jax_default_settings)
    from oscar_mpc_planner_mr_modification_tpu_torch.factory import (
        build_planner, configuration_basic)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import State
    from oscar_mpc_planner_mr_modification_tpu_torch.utils import (
        default_settings)
    from oscar_mpc_planner_mr_modification_tpu_torch.utils.datasaver import (
        DataSaver)

    jax_settings = jax_default_settings(N=8)
    jax_model, jax_modules = jax_configuration_basic(jax_settings)
    jax_planner = jax_build_planner(jax_model, jax_modules, jax_settings)
    settings = default_settings(N=8)
    model, modules = configuration_basic(settings)
    planner = build_planner(model, modules, settings, device="cpu")
    assert jax_planner.visualize(JaxState(jax_model),
                                 jax_types.RealTimeData()) is None
    assert planner.visualize(State(model), types.RealTimeData()) is None
    saver = DataSaver()
    for m in planner.modules:
        assert m.save_data(saver) is None
    assert saver.get("anything") == []


def test_trajectory_methods_equal_jax():
    """C5: Trajectory.calc_collision_mask_gk and geometric_deviation_trigger
    on seeded random trajectories, exact."""
    rng = np.random.default_rng(3)
    for n_a, n_b in ((12, 12), (12, 9), (0, 4)):
        a, b = rng.normal(size=(n_a, 2)), rng.normal(size=(n_b, 2))
        pair = {}
        for mod in (jax_types, types):
            ta, tb = mod.Trajectory(dt=0.2), mod.Trajectory(dt=0.2)
            for p in a:
                ta.add(p)
            for p in b:
                tb.add(*p)
            pair[mod] = ta, tb
        for sigma in (0.5, 2.0):
            got = pair[types][0].calc_collision_mask_gk(pair[types][1], sigma)
            want = pair[jax_types][0].calc_collision_mask_gk(
                pair[jax_types][1], sigma)
            assert got == want
        for dev in (0.5, 1.5, 3.0):
            got = pair[types][0].geometric_deviation_trigger(pair[types][1],
                                                             dev)
            want = pair[jax_types][0].geometric_deviation_trigger(
                pair[jax_types][1], dev)
            assert got == want


def test_math_helpers_equal_jax():
    """C5: np_haar_difference and wrap_angle on seeded random angles,
    exact; multirobot.interpolation reads the same wrap_angle."""
    from oscar_mpc_planner_mr_modification_tpu_torch.multirobot import (
        interpolation)

    rng = np.random.default_rng(7)
    a1, a2 = rng.uniform(-20.0, 20.0, size=(2, 4096))
    np.testing.assert_array_equal(port_math.np_haar_difference(a1, a2),
                                  jax_math.np_haar_difference(a1, a2))
    np.testing.assert_array_equal(port_math.wrap_angle(a1),
                                  jax_math.wrap_angle(a1))
    assert port_math.wrap_angle(0.5) == jax_math.wrap_angle(0.5)
    assert interpolation.wrap_angle is port_math.wrap_angle
