"""The port's demos (``examples/``) on the CPU at tiny sizes, and the
Monte-Carlo demo's obstacle-count row against the JAX package's.

The row runs 4 episodes, N=8, 5 ticks, 1 obstacle at f64 on the same
``sample_scenes`` seed through each package's goal evaluator (``"xla"`` on
both sides, JAX's ``"auto"`` on the CPU): the reached and collided flags are
equal and ``min_obstacle_dist`` agrees within 1e-6 (the same algorithm; a
QP frozen at its residual tolerance one iteration sooner or later moves the
trajectory by less). Every demo runs to its end and returns a finite
summary; the fleet-process demo's three robot processes (the JAX demo's
robot) tick for about two seconds and join within bounded waits. Without a card, each demo exits with
code 2 unless asked for the CPU.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu.parallel import (  # noqa: E402
    rollout as j_rollout)
from oscar_mpc_planner_mr_modification_tpu_torch.examples import (  # noqa: E402
    demo_fleet_processes, demo_monte_carlo, demo_multirobot,
    demo_single_robot)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_monte_carlo_row_equals_jax():
    B, N, n_ticks = 4, 8, 5
    row = demo_monte_carlo.obstacle_row(1, B, N, n_ticks, torch.float64,
                                        "cpu")
    rollout, _ = j_rollout.make_batch_rollout(n_obstacles=1, N=N,
                                              n_ticks=n_ticks,
                                              dtype=jnp.float64)
    m = rollout(*map(jnp.asarray, j_rollout.sample_scenes(
        B, 1, seed=demo_monte_carlo.SEED)))
    np.testing.assert_array_equal(row["reached"], np.asarray(m.reached))
    np.testing.assert_array_equal(row["collided"], np.asarray(m.collided))
    np.testing.assert_allclose(row["min_obstacle_dist"],
                               np.asarray(m.min_obstacle_dist), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(row["solve_success_rate"],
                               np.asarray(m.solve_success_rate), rtol=0,
                               atol=0)


def test_demo_monte_carlo_runs(capsys):
    out = demo_monte_carlo.main("cpu", B=4, N=8, n_ticks=3,
                                n_obs_list=(1, 2), sweep=(2, 2, 1))
    assert [r["n_obs"] for r in out["rows"]] == [1, 2]
    for r in out["rows"]:
        assert all(np.isfinite(v) for v in r.values())
    assert out["sweep"]["combos"] == 4 and np.isfinite(
        out["sweep"]["progress"])
    assert "weight sweep (4 combos x 2 scenes" in capsys.readouterr().out


def test_demo_single_robot_runs(tmp_path):
    out = demo_single_robot.main("cpu", N=8, steps=3, out_dir=str(tmp_path),
                                 png=True)
    assert out["steps"] == 3 and out["success"] == 1.0
    assert np.isfinite(out["final_x"]) and out["min_clearance"] > 0
    frames = json.load(open(out["json"]))
    assert len(frames) == 3 and len(frames[0]["robot_pose"]) == 3
    assert os.path.getsize(out["png"]) > 0


def test_demo_multirobot_runs(capsys):
    out = demo_multirobot.main("cpu", n_cycles=6, N=8)
    assert sorted(out) == ["r1", "r2", "r3"]
    for r in out.values():
        assert r["cycles"] > 0 and 0.0 <= r["comm_rate"] <= 1.0
        assert np.all(np.isfinite(r["position"]))
    assert "planning cycles" in capsys.readouterr().out


def test_demo_fleet_processes_robot_is_the_jax_demo_s():
    """The robot of the JAX demo: MPCBase on a and w, goal and ellipsoids
    on SecondOrderUnicycleModel, N=10, 2 obstacles, f64, 4 x 8 under
    "mirror", solved by Solver.solve (no module claims the optimization)."""
    planner, model, settings = demo_fleet_processes.build_robot("cpu")
    assert type(model).__name__ == "SecondOrderUnicycleModel"
    modules = list(planner.modules)
    assert [type(m).__name__ for m in modules] == [
        "MPCBaseModule", "GoalModule", "EllipsoidConstraintModule"]
    assert list(modules[0]._variables_per_function) == ["a", "w"]
    solver = planner.solver
    assert (solver.N, settings["max_obstacles"]) == (10, 2)
    assert solver.dtype == torch.float64
    assert (solver.config.n_sqp, solver.config.n_qp_iter,
            solver.config.regularization) == (4, 8, "mirror")
    assert settings["weights"]["goal"] == 5.0


def test_demo_fleet_processes_runs():
    out = demo_fleet_processes.main("cpu", seconds=2.0)
    assert sorted(out) == ["robot0", "robot1", "robot2"]
    for r in out.values():
        assert r["ticks"] > 0 and 0.0 <= r["comm_rate"] <= 1.0
        assert r["solves"] > 0 and r["launches"] == 0  # the plain solve
        assert r["solve_ms"] > 0.0


@pytest.mark.parametrize("demo", [demo_single_robot, demo_monte_carlo,
                                  demo_multirobot, demo_fleet_processes],
                         ids=lambda d: d.__name__.rsplit(".", 1)[-1])
def test_demo_without_card_exits_2(demo):
    with pytest.raises(SystemExit) as exc:
        demo.main()
    assert exc.value.code == 2
