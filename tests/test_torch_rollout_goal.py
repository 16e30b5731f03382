"""The port's goal-tracking and multi-robot evaluators
(``parallel/rollout.py::make_batch_rollout``, ``make_multirobot_rollout``)
against the JAX package's, on the CPU at f64.

- ``make_batch_rollout`` at N=8, B=4 episodes, 8 ticks, 3 obstacles, and
  ``make_multirobot_rollout`` at N=8, B=2 episodes x 3 robots, 8 ticks, in
  both ``comm`` modes, ``backend="xla"`` on both sides at a one-phase
  schedule of 2 SQP iterations (JAX compiles one program per schedule
  phase): every metric and the final states within atol 1e-6.
- ``first_tick_params`` equal to JAX's bit for bit, and equal to what the
  port's host modules (``GoalModule``, ``EllipsoidConstraintModule``, ...)
  fill for the same scene, as the JAX package's
  ``tests/test_rollout_fill_parity.py`` holds its evaluators: stages 1..N-1
  exactly, stage 0 but for the documented dummy obstacle columns.
- ``comm="bogus"`` raises ``ValueError``; ``"auto"`` resolves to ``"xla"``
  on the CPU; on a CUDA device an OCP that B2 does not cover raises
  ``NotImplementedError`` at build; ``backend="fused"`` runs ``fused_fleet_reference`` on the CPU
  and, where the QPs converge, equals ``"xla"`` within atol 1e-4 (the
  kernel's IP freezes at residuals of 1e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu.ops.sqp import (  # noqa: E402
    SQPConfig as JSQPConfig)
from oscar_mpc_planner_mr_modification_tpu.parallel import (  # noqa: E402
    rollout as jro)
from oscar_mpc_planner_mr_modification_tpu_torch.modules import (  # noqa: E402
    EllipsoidConstraintModule, GoalModule, ModuleManager, MPCBaseModule)
from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (  # noqa: E402
    SQPConfig as TSQPConfig)
from oscar_mpc_planner_mr_modification_tpu_torch.parallel import (  # noqa: E402
    rollout as tro)
from oscar_mpc_planner_mr_modification_tpu_torch.planner.data_preparation import (  # noqa: E402,E501
    get_constant_velocity_prediction)
from oscar_mpc_planner_mr_modification_tpu_torch.solver.state import (  # noqa: E402
    State)
from oscar_mpc_planner_mr_modification_tpu_torch.types import (  # noqa: E402
    Disc, DynamicObstacle, ModuleData, RealTimeData)
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings)

N, TICKS, N_OBS, R = 8, 8, 3, 3
CONFIG = dict(n_sqp=2, n_qp_iter=10, mu_min=1e-8, w_max=1e8, reg_eps=1e-6,
              regularization="gershgorin", track_best=False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def assert_metrics_close(got, want):
    for name in want._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=name)


def goal_scenes(B=4, seed=2):
    """Goal scenes with the obstacles pulled toward the start so that the 8
    ticks meet them."""
    x0, goal, obs0, vel = tro.sample_scenes(B, N_OBS, seed=seed)
    obs0 = obs0.copy()
    obs0[..., 0] = obs0[..., 0] * 0.3 + 0.8
    obs0[..., 1] = obs0[..., 1] * 0.4
    return x0, goal, obs0, vel


def mr_scenes(B=2, seed=1):
    """Antipodal scenes on a circle small enough that the robots meet."""
    return tro.antipodal_circle_scenes(B, R, radius=1.2, seed=seed)


@pytest.fixture(scope="module")
def batch_pair():
    kw = dict(n_obstacles=N_OBS, N=N, n_ticks=TICKS, backend="xla")
    j, jocp = jro.make_batch_rollout(dtype=jnp.float64,
                                     config=JSQPConfig(**CONFIG), **kw)
    t, tocp = tro.make_batch_rollout(dtype=torch.float64, device="cpu",
                                     config=TSQPConfig(**CONFIG), **kw)
    assert (tocp.npar, tocp.nx, tocp.nu) == (jocp.npar, jocp.nx, jocp.nu)
    return j, t


def mr_pair(comm):
    kw = dict(n_robots=R, N=N, n_ticks=TICKS, backend="xla", comm=comm)
    j, _ = jro.make_multirobot_rollout(dtype=jnp.float64,
                                       config=JSQPConfig(**CONFIG), **kw)
    t, _ = tro.make_multirobot_rollout(dtype=torch.float64, device="cpu",
                                       config=TSQPConfig(**CONFIG), **kw)
    return j, t


def test_batch_rollout_matches_jax(batch_pair):
    j, t = batch_pair
    args = goal_scenes()
    want = j(*map(jnp.asarray, args))
    got = t(*args)
    assert t.backend == "xla"
    assert_metrics_close(got, want)
    # not trivial: the robots moved toward the goals and met the obstacles
    assert (got.final_state[:, 0].numpy() > 1.0).all()
    assert got.min_obstacle_dist.min().item() < 1.0
    assert got.solve_success_rate.min().item() > 0.5


@pytest.mark.parametrize("comm", ["always", "triggered"])
def test_multirobot_rollout_matches_jax(comm):
    j, t = mr_pair(comm)
    args = mr_scenes()
    want = j(*map(jnp.asarray, args))
    got = t(*args)
    assert_metrics_close(got, want)
    assert got.min_robot_dist.min().item() < 1.5  # the robots met
    if comm == "triggered":  # some ticks stayed silent, some broadcast
        assert 0.0 < got.comm_rate.min().item() < 1.0
    else:
        assert (got.comm_rate.numpy() == 1.0).all()
    np.testing.assert_array_equal(
        t.first_tick_params(*args).numpy(),
        np.asarray(j.first_tick_params(*map(jnp.asarray, args))))


def test_batch_first_tick_params_equal_jax(batch_pair):
    j, t = batch_pair
    args = goal_scenes(seed=5)
    np.testing.assert_array_equal(
        t.first_tick_params(*args).numpy(),
        np.asarray(j.first_tick_params(*map(jnp.asarray, args))))


# ---------------------------------------------------------------------------
# The evaluators' fill against the port's host modules
# ---------------------------------------------------------------------------
def _goal_modules(settings):
    mm = ModuleManager()
    base = mm.add_module(MPCBaseModule(settings))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    mm.add_module(GoalModule(settings))
    mm.add_module(EllipsoidConstraintModule(settings))
    return mm


def _host_fill(ocp, modules, state, goal, obstacles, robot_radius):
    """The planner's module path: update and set_parameters into a fresh
    (N, npar) buffer."""
    data = RealTimeData()
    data.robot_area = [Disc(0.0, robot_radius)]
    data.goal = np.asarray(goal, float)
    data.goal_received = True
    data.dynamic_obstacles = obstacles
    buf = ocp.registry.new_buffer(ocp.N)
    md = ModuleData()
    for m in modules:
        m.update(state, data, md)
    for m in modules:
        m.set_parameters(buf, data, md)
    return np.asarray(buf.data, float)


def _obstacle(index, pos, vel, radius, dt):
    """A constant-velocity obstacle whose prediction step i lies at
    (i + 1) dt: the host's stage k reads step k - 1, so stage k lands on the
    evaluator's k dt."""
    pos, vel = np.asarray(pos, float), np.asarray(vel, float)
    o = DynamicObstacle(index=index, position=pos.copy(), radius=radius)
    o.prediction = get_constant_velocity_prediction(pos + vel * dt, vel, dt,
                                                    N)
    return o


def _assert_rows_equal(host, evalr, k0_cols):
    """Stages 1..N-1 equal; stage 0 equal but for the dummy obstacle
    columns (the host's k = 0 dummy, the evaluator's current position)."""
    np.testing.assert_allclose(evalr[1:], host[1:], rtol=0, atol=1e-9)
    mask = np.ones(host.shape[1], bool)
    mask[k0_cols] = False
    np.testing.assert_allclose(evalr[0, mask], host[0, mask], rtol=0,
                               atol=1e-9)


def test_goal_fill_matches_host_modules():
    n_obs = 2
    settings = default_settings(N=N, max_obstacles=n_obs)
    rollout, ocp = tro.make_batch_rollout(n_obstacles=n_obs, N=N,
                                          dtype=torch.float64, device="cpu",
                                          settings=settings)
    idx = ocp.registry.save_map()
    robot_radius = float(settings["robot_radius"])
    x0 = np.array([[0.4, -0.2, 0.1, 0.6]])
    goal = np.array([[7.0, 0.5]])
    obs0 = np.array([[[3.0, 1.0], [4.5, -1.2]]])
    vel = np.array([[[0.0, -0.6], [0.15, 0.45]]])
    evalr = rollout.first_tick_params(x0, goal, obs0, vel).numpy()[0]

    state = State(ocp.model)
    for i, name in enumerate(ocp.model.states):
        state.set(name, x0[0, i])
    obstacles = [_obstacle(i, obs0[0, i], vel[0, i], 0.3, ocp.dt)
                 for i in range(n_obs)]
    host = _host_fill(ocp, _goal_modules(settings), state, goal[0],
                      obstacles, robot_radius)
    k0 = [idx[f"ellipsoid_obst_{i}_{c}"] for i in range(n_obs)
          for c in ("x", "y", "r")]
    _assert_rows_equal(host, evalr, k0)


def test_multirobot_fill_matches_host_modules():
    margin = 0.15
    rollout, ocp = tro.make_multirobot_rollout(n_robots=R, N=N,
                                               dtype=torch.float64,
                                               device="cpu", margin=margin)
    idx = ocp.registry.save_map()
    settings = default_settings(N=N, max_obstacles=R - 1)
    robot_radius = float(settings["robot_radius"])
    x0 = np.zeros((1, R, 4))
    x0[0, :, 0] = [0.0, 4.0, 2.0]
    x0[0, :, 1] = [0.0, 0.5, -3.0]
    goals = np.array([[[4.0, 0.0], [0.0, 0.5], [2.0, 3.0]]])
    evalr = rollout.first_tick_params(x0, goals).numpy()
    assert evalr.shape == (1, R, N, ocp.npar)
    k0 = [idx[f"ellipsoid_obst_{i}_{c}"] for i in range(R - 1)
          for c in ("x", "y", "r")]
    for r in range(R):
        state = State(ocp.model)
        state.set("x", x0[0, r, 0])
        state.set("y", x0[0, r, 1])
        # the peers' first broadcast: stationary at their start poses, the
        # radius widened by the staleness margin
        obstacles = [_obstacle(o, x0[0, o, :2], np.zeros(2),
                               robot_radius + margin, ocp.dt)
                     for o in range(R) if o != r]
        host = _host_fill(ocp, _goal_modules(settings), state, goals[0, r],
                          obstacles, robot_radius)
        _assert_rows_equal(host, evalr[0, r], k0)


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------
def test_comm_mode_and_backend_rules():
    with pytest.raises(ValueError, match="comm"):
        tro.make_multirobot_rollout(N=4, comm="bogus", device="cpu")
    rollout, ocp = tro.make_batch_rollout(N=4, n_ticks=1, device="cpu")
    assert rollout.backend == "xla"
    assert (ocp.nx, ocp.nu, type(ocp.model).__name__) == (
        4, 2, "SecondOrderUnicycleModel")
    mr, _ = tro.make_multirobot_rollout(N=4, n_ticks=1, device="cpu")
    assert mr.backend == "xla"
    assert mr.config.qp_iter_schedule == ((4, 4), (4, 8))


@pytest.mark.parametrize("make", ["batch", "multirobot"])
def test_fused_evaluator_raises_for_an_uncovered_ocp(make, monkeypatch):
    """An OCP outside B2's header (here: its model taken out of the
    kernels' models): on a CUDA device ``backend="fused"`` (and ``"auto"``)
    raises ``NotImplementedError`` when the evaluator is built, before it
    touches the device (this machine has none), and never falls back. With
    the model in, two prediction modes per ellipsoid build on the fused
    backend (its plain version on the CPU), one row per obstacle, mode and
    peer."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp_fused

    settings = default_settings(N=6, max_obstacles=2 if make == "multirobot"
                                else N_OBS)
    settings["probabilistic"]["max_modes"] = 2
    build = {"batch": tro.make_batch_rollout,
             "multirobot": tro.make_multirobot_rollout}[make]
    kw = {"n_robots": 3} if make == "multirobot" else {"n_obstacles": N_OBS}
    rollout, ocp = build(N=6, settings=settings, backend="fused",
                         device="cpu", **kw)
    assert rollout.backend == "fused"
    assert rollout.fleet_solve.tables.mh == ocp.nh == 2 * settings[
        "max_obstacles"]
    monkeypatch.setattr(sqp_fused, "MODELS", {
        k: v for k, v in sqp_fused.MODELS.items()
        if k != "SecondOrderUnicycleModel"})
    for backend in ("fused", "auto"):
        with pytest.raises(NotImplementedError, match="SecondOrderUnicycle"):
            build(N=6, settings=settings, backend=backend, device="cuda",
                  **kw)


def test_fused_backend_runs_the_plain_version_and_equals_xla():
    """``backend="fused"`` on the CPU runs ``fused_fleet_reference`` (no
    launch is counted). Its IP iteration is the kernel's, not
    ``solve_qp``'s: it freezes a QP at residuals of 1e-5, so where both
    converge the rollouts agree to atol 1e-4, the tolerance
    tests/test_torch_fleet.py holds converged fused and xla solves to."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp_fused

    cfg = TSQPConfig(n_sqp=3, n_qp_iter=30, mu_min=1e-10, w_max=1e10,
                     reg_eps=1e-6, regularization="gershgorin",
                     track_best=False)
    kw = dict(n_obstacles=N_OBS, N=N, n_ticks=4, dtype=torch.float64,
              device="cpu", config=cfg)
    fused, _ = tro.make_batch_rollout(backend="fused", **kw)
    xla, _ = tro.make_batch_rollout(backend="xla", **kw)
    assert fused.backend == "fused"
    args = goal_scenes(B=2)
    launches = sqp_fused.launches
    got = fused(*args)
    assert sqp_fused.launches == launches
    want = xla(*args)
    assert (want.solve_success_rate.numpy() == 1.0).all()
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name).numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)
