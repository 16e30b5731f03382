"""The port's system presets and integration interfaces (``systems.py``)
against the JAX package's, on the CPU at f64.

- The three presets (and the rosnavigation alias) equal JAX's settings key
  by key, with and without overrides; ``CONFIGURATIONS`` names the same six
  configurations, and each builds the same OCP sizes in both packages.
- ``WeightTuner``: the declared weights, their (0, 100) ranges and the
  clamping, as in the JAX suite.
- ``LocalPlannerInterface``: the first ``compute_velocity_commands`` cycle
  of the ``basic`` configuration at a converged schedule in both packages.
  Both planners solve through ``Solver.solve`` (the single-instance solve,
  JAX's interior-point algorithm in the port's ``ops/qp.py``), so (v, w)
  agree to 1e-8.
- The entry points default to the card.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import systems as j_sys  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops.sqp import (  # noqa: E402
    SQPConfig as JSQPConfig)
from oscar_mpc_planner_mr_modification_tpu.solver import (  # noqa: E402
    build_ocp as j_build_ocp)
from oscar_mpc_planner_mr_modification_tpu_torch import systems as t_sys  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import SQPConfig  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.sim.environment import (  # noqa: E402
    SimEnvironment)
from oscar_mpc_planner_mr_modification_tpu_torch.solver import build_ocp  # noqa: E402

CONVERGED = dict(n_sqp=8, n_qp_iter=20, mu_min=1e-10)


@pytest.mark.parametrize("preset", ["jackalsimulator_settings",
                                    "jackal_settings", "dingo_settings"])
def test_presets_equal_jax(preset):
    for kw in ({}, {"max_obstacles": 3, "weights": {"goal": 2.0}}):
        a = getattr(t_sys, preset)(**kw)
        b = getattr(j_sys, preset)(**kw)
        assert a == b
        assert type(a).__name__ == type(b).__name__ == "Config"
    assert t_sys.dingo_settings()["robot_radius"] == 0.25
    assert t_sys.jackal_settings()["max_obstacles"] == 6


def test_configurations_equal_jax():
    """The same six names; each configuration builds an OCP of the same
    model, modules, sizes and parameter layout in both packages."""
    assert list(t_sys.CONFIGURATIONS) == list(j_sys.CONFIGURATIONS)
    assert len(t_sys.CONFIGURATIONS) == 6
    for name, conf in t_sys.CONFIGURATIONS.items():
        settings = t_sys.jackalsimulator_settings(N=6)
        a = build_ocp(*conf(settings), settings)
        js = j_sys.jackalsimulator_settings(N=6)
        b = j_build_ocp(*j_sys.CONFIGURATIONS[name](js), js)
        assert type(a.model).__name__ == type(b.model).__name__, name
        assert ([type(m).__name__ for m in a.modules]
                == [type(m).__name__ for m in b.modules]), name
        assert (a.nx, a.nu, a.npar, a.nh) == (b.nx, b.nu, b.npar, b.nh), name
        assert a.registry.save_map() == b.registry.save_map(), name


def test_entry_points_default_to_the_card():
    for fn in (t_sys.make_system_planner, t_sys.LocalPlannerInterface,
               SimEnvironment.__init__):
        params = inspect.signature(fn).parameters
        if "device" in params:
            assert params["device"].default == "cuda", fn
    assert inspect.signature(t_sys.make_system_planner).parameters[
        "device"].default == "cuda"


def test_weight_tuner():
    planner, _, settings = t_sys.make_system_planner(
        "dingo", "goal_tmpc", sqp_config=SQPConfig(
            n_sqp=3, n_qp_iter=8, regularization="gershgorin"),
        device="cpu", N=10, guidance={"n_samples": 15})
    tuner = t_sys.WeightTuner(planner)
    assert "acceleration" in tuner.tunable and "goal_weight" in tuner.tunable
    tuner.set("acceleration", 0.5)
    assert tuner.get("acceleration") == 0.5
    assert settings["weights"]["acceleration"] == 0.5
    with pytest.raises(KeyError):
        tuner.set("not_a_weight", 1.0)
    assert tuner.range("acceleration") == (0.0, 100.0)
    tuner.set("acceleration", -5.0)
    assert tuner.get("acceleration") == 0.0
    tuner.set("acceleration", 1e9)
    assert tuner.get("acceleration") == 100.0


def test_local_planner_interface_first_cycle_equal_to_jax():
    path = np.stack([np.linspace(0, 15, 20), np.zeros(20)], axis=1)
    out = []
    for pkg in ("torch", "jax"):
        if pkg == "torch":
            lp = t_sys.LocalPlannerInterface(
                configuration="basic", N=12, max_obstacles=2, device="cpu",
                sqp_config=SQPConfig(**CONVERGED))
        else:
            lp = j_sys.LocalPlannerInterface(
                configuration="basic", N=12, max_obstacles=2,
                sqp_config=JSQPConfig(**CONVERGED), dtype=jnp.float64)
        assert lp.set_plan(path)
        lp.set_costmap("costmap")
        assert lp.data.costmap == "costmap"
        out.append(lp.compute_velocity_commands((0.0, 0.2, 0.0), 0.5))
        assert not lp.is_goal_reached()
    (vt, wt, ok_t), (vj, wj, ok_j) = out
    assert ok_t and ok_j
    assert vt > 0.3 and abs(wt) < 1.0
    np.testing.assert_allclose([vt, wt], [vj, wj], rtol=0, atol=1e-8)
