"""The free-space decomposition and the decomp constraints in the port
against the JAX package, on the CPU at f64.

- ``EllipsoidDecomp2D``: the port's numpy backend and its native library
  (``native/decomp.cpp``, built into ``build/decomp/``) give JAX's
  halfspaces on random scenes (1e-9). The backend is decided once, when
  the decomposition is built (``.backend``), and a call never switches it.
- ``DecompConstraintModule``: its rows, on the unicycle and on the bicycle
  (whose slack is an input), and its runtime halfspaces equal JAX's.
- B2's header compiled for the host linearizes the decomp OCP
  (``configuration_no_obstacles`` plus the module: npar 90, 12 rows) as
  ``torch.func`` does (rtol 1e-9, atol 1e-10), and ``fused_fleet_reference``
  solves the decomp fleet as the JAX ``"xla"`` fleet solve does where the
  QPs converge (the same success mask, cost rtol 1e-5, z atol 2e-4).
- JAX's corridor test (tests/test_scenario.py) through the port's planner
  and through ``LocalPlannerInterface.set_costmap`` /
  ``compute_velocity_commands``: success, the plan inside |y| < 1.0,
  progress > 1.5 m.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import factory as jfactory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.modules import (  # noqa: E402
    DecompConstraintModule as JDecomp)
from oscar_mpc_planner_mr_modification_tpu.ops import sqp as jsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops.decomp import (  # noqa: E402
    EllipsoidDecomp2D as JDecomp2D)
from oscar_mpc_planner_mr_modification_tpu.solver import (  # noqa: E402
    build_ocp as jbuild_ocp)
from oscar_mpc_planner_mr_modification_tpu.utils import (  # noqa: E402
    default_settings as jdefault_settings)

from oscar_mpc_planner_mr_modification_tpu_torch import factory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.modules import (  # noqa: E402
    DecompConstraintModule)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import (  # noqa: E402
    decomp_native, qp_cuda, sqp_fused)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp as tsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops.decomp import (  # noqa: E402
    EllipsoidDecomp2D)
from oscar_mpc_planner_mr_modification_tpu_torch.solver import build_ocp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.tools import (  # noqa: E402
    bench_matrix)
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings)

F64 = torch.float64


def _random_scene(seed):
    rng = np.random.default_rng(seed)
    path = np.cumsum(rng.uniform(-0.4, 1.0, size=(rng.integers(3, 8), 2)),
                     axis=0)
    obstacles = rng.uniform(-2.0, 8.0, size=(int(rng.integers(0, 60)), 2))
    return path, obstacles


@pytest.mark.parametrize("backend", ["python", "cpp"])
def test_decomposition_matches_jax(backend):
    if backend == "cpp" and not decomp_native.available():
        pytest.skip("no C++ compiler for native/decomp.cpp")
    decomp = EllipsoidDecomp2D(local_range=2.5, max_constraints=8,
                               backend=backend)
    assert decomp.backend == backend
    n_halfspaces = 0
    for seed in range(8):
        path, obstacles = _random_scene(seed)
        want = JDecomp2D(local_range=2.5, max_constraints=8,
                         backend="python").dilate_path(path, obstacles)
        got = decomp.dilate_path(path, obstacles)
        assert len(got) == len(want)
        for k, (hs_t, hs_j) in enumerate(zip(got, want)):
            assert len(hs_t) == len(hs_j), (seed, k)
            for (a_t, b_t), (a_j, b_j) in zip(hs_t, hs_j):
                np.testing.assert_allclose(a_t, a_j, rtol=0, atol=1e-9)
                assert abs(b_t - b_j) < 1e-9, (seed, k)
                n_halfspaces += 1
    assert n_halfspaces > 20


def test_backend_is_decided_once(monkeypatch):
    assert EllipsoidDecomp2D(backend="python").backend == "python"
    if decomp_native.available():
        auto = EllipsoidDecomp2D()
        assert auto.backend == "cpp"
        assert decomp_native.library_path().parent.name == "decomp"
        assert decomp_native.library_path().parent.parent.name == "build"
        # a library that stops loading after the choice raises: no switch
        monkeypatch.setattr(decomp_native, "_load", lambda: None)
        with pytest.raises(RuntimeError):
            auto.dilate_path(*_random_scene(1))
    monkeypatch.setattr(decomp_native, "available", lambda: False)
    assert EllipsoidDecomp2D().backend == "python"
    with pytest.raises(RuntimeError, match="unavailable"):
        EllipsoidDecomp2D(backend="cpp")
    with pytest.raises(ValueError):
        EllipsoidDecomp2D(backend="mosaic")


def _pair(conf, N=8, **overrides):
    """The JAX and port OCPs of ``conf`` plus the decomp module."""
    js = jdefault_settings(N=N, **overrides)
    jm, jmm = getattr(jfactory, conf)(js)
    jmm.add_module(JDecomp(js))
    ts = default_settings(N=N, **overrides)
    tm, tmm = getattr(factory, conf)(ts)
    tmm.add_module(DecompConstraintModule(ts))
    jo, to = jbuild_ocp(jm, jmm, js), build_ocp(tm, tmm, ts)
    assert to.registry.save_map() == jo.registry.save_map()
    return jo, to


@pytest.mark.parametrize("conf", ["configuration_no_obstacles",
                                  "configuration_bicycle"])
def test_decomp_rows_match_jax(conf):
    from torch.func import vmap

    jo, to = _pair(conf, max_obstacles=1)
    assert to.nh == jo.nh and list(to.ineq_row_spec()) == list(
        jo.ineq_row_spec())
    rng = np.random.default_rng(0)
    P = rng.normal(size=(6, to.npar))
    Z = rng.normal(size=(6, to.nvar))
    got = vmap(to.ineq)(torch.as_tensor(Z), torch.as_tensor(P)).numpy()
    want = np.asarray(jax.vmap(jo.ineq)(jnp.asarray(Z), jnp.asarray(P)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    if conf == "configuration_bicycle":
        # the slack input softens every decomp row
        slack = to.model.var_index("slack")
        Z2 = Z.copy()
        Z2[:, slack] += 1.0
        moved = vmap(to.ineq)(torch.as_tensor(Z2), torch.as_tensor(P))
        np.testing.assert_allclose((moved.numpy() - got)[:, -12:], -1.0,
                                   atol=1e-12)


class _Solver:
    """What the module's update reads of a solver: N and the warm start's
    positions."""

    def __init__(self, N, xy):
        self.N, self._xy = N, xy

    def get_ego_prediction(self, k, name):
        return float(self._xy[k, "xy".index(name)])


def test_decomp_update_matches_jax():
    """Both modules' update on the corridor of JAX's test: the same
    per-stage halfspaces (1e-9) and the same dummies where there are none;
    without a costmap every row is a dummy."""
    from oscar_mpc_planner_mr_modification_tpu.types import (
        RealTimeData as JData)
    from oscar_mpc_planner_mr_modification_tpu_torch.types import (
        RealTimeData)

    N = 12
    xy = np.stack([np.linspace(0.0, 2.2, N), 0.05 * np.sin(np.arange(N))],
                  axis=1)
    mods = []
    for pkg in ("jax", "torch"):
        settings = (jdefault_settings if pkg == "jax" else default_settings)(
            N=N)
        module = (JDecomp if pkg == "jax" else DecompConstraintModule)(
            settings)
        module.solver = _Solver(N, xy)
        data = (JData if pkg == "jax" else RealTimeData)()
        module.update(None, data, None)
        assert (module._b == 1000.0).all()
        data.costmap = bench_matrix.corridor_points(1.0, length=8.0)
        module.update(None, data, None)
        mods.append(module)
    assert mods[1].decomp.backend in ("cpp", "python")
    for name in ("_a1", "_a2", "_b"):
        np.testing.assert_allclose(getattr(mods[1], name),
                                   getattr(mods[0], name), rtol=0,
                                   atol=1e-9, err_msg=name)
    assert (mods[1]._b[0, 1:] < 999.0).any()


@pytest.fixture(scope="module")
def host():
    if qp_cuda.host_compiler() is None:
        pytest.skip("no C++ compiler to build csrc/tmpc_ocp_host.cpp")
    qp_cuda.build_host()


def test_decomp_header_matches_torch_func(host):
    ocp, P, x0, z0 = bench_matrix.build_decomp(8, 4,
                                               np.random.default_rng(0))
    assert (ocp.npar, ocp.nh, len(ocp.ineq_row_spec())) == (90, 12, 26)
    rng = np.random.default_rng(1)
    P = np.concatenate([P, P[:, -1:]], axis=1).astype(np.float64)
    Z = z0.astype(np.float64) + 0.05 * rng.normal(size=z0.shape)
    x0 = x0.astype(np.float64)
    cfg = tsqp.SQPConfig(regularization="gershgorin", reg_eps=1e-4)
    tables = sqp_fused.ocp_tables(ocp, cfg)
    kinds = tables.ints[tables.ints[sqp_fused.TB_OFF_H]:][
        :sqp_fused.H_W * ocp.nh:sqp_fused.H_W]
    assert list(kinds) == [sqp_fused.HK_DECOMP] * 12
    mach = tsqp._make_machinery(ocp, cfg, F64, "cpu")
    got = sqp_fused.host_linearize(tables, P, x0, Z)
    lanes = sqp_fused.host_linearize(tables, P, x0, Z, lanes=True)
    want = sqp_fused.linearize_reference(
        mach, tables, *(torch.as_tensor(a) for a in (P, x0, Z)))
    for name, a, b in zip(sqp_fused.QPData._fields + ("merit", "cost",
                                                      "eq_res"),
                          (*got[0], *got[1:]), (*want[0], *want[1:])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-10, err_msg=name)
    for a, b in zip((*lanes[0], *lanes[1:]), (*got[0], *got[1:])):
        assert torch.equal(a, b)


def test_decomp_fused_reference_matches_jax_xla():
    """The decomp fleet (N=8, 4 corridors, from the warm start) at a
    converged schedule (8 x 20, mu_min 1e-10)."""
    ocp, P, x0, z0 = bench_matrix.build_decomp(8, 4,
                                               np.random.default_rng(2))
    jo, to = _pair("configuration_no_obstacles", max_obstacles=0)
    assert to.registry.save_map() == ocp.registry.save_map()
    P, x0, z0 = (a.astype(np.float64) for a in (P, x0, z0))
    kw = dict(n_sqp=8, n_qp_iter=20, mu_min=1e-10,
              regularization="gershgorin", track_best=False)
    ref = jsqp.make_fleet_sqp_solver(jo, jsqp.SQPConfig(**kw),
                                     dtype=jnp.float64, backend="xla")(
        *map(jnp.asarray, (P, x0, z0)))
    got = tsqp.make_fleet_sqp_solver(to, tsqp.SQPConfig(**kw), dtype=F64,
                                     device="cpu", backend="fused")(
        *(torch.as_tensor(a) for a in (P, x0, z0)))
    ok = np.asarray(ref.success)
    assert ok.all() and (got.success.numpy() == ok).all()
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-5)
    np.testing.assert_allclose(got.z.numpy(), np.asarray(ref.z), rtol=0,
                               atol=2e-4)


def _corridor():
    xs = np.linspace(0, 8, 33)
    return np.concatenate([np.stack([xs, np.full_like(xs, y)], axis=1)
                           for y in (1.0, -1.0)])


def _decomp_configuration(settings):
    model, modules = factory.configuration_no_obstacles(settings)
    modules.add_module(DecompConstraintModule(settings))
    return model, modules


@pytest.mark.parametrize("entry", ["planner", "local_planner_interface"])
def test_corridor_scene_of_the_jax_suite(entry):
    """JAX's tests/test_scenario.py corridor (walls at y = +-1 over 8 m, a
    straight path, N=12, 8 x 12 SQP, f64) through the port's planner, and
    through the local-planner interface with the costmap handed in by
    set_costmap: the tick solves, the decomposition produced halfspaces,
    the plan stays inside |y| < 1.0 and makes progress past x = 1.5."""
    from oscar_mpc_planner_mr_modification_tpu_torch.planner import Planner
    from oscar_mpc_planner_mr_modification_tpu_torch.planner.data_preparation import (  # noqa: E501
        define_robot_area)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import (
        Solver, State)
    from oscar_mpc_planner_mr_modification_tpu_torch.systems import (
        LocalPlannerInterface)
    from oscar_mpc_planner_mr_modification_tpu_torch.types import (
        RealTimeData)

    N = 12
    cfg = tsqp.SQPConfig(n_sqp=8, n_qp_iter=12)
    if entry == "planner":
        settings = default_settings(N=N, max_obstacles=2)
        model, mm = _decomp_configuration(settings)
        solver = Solver(build_ocp(model, mm, settings), settings, dtype=F64,
                        sqp_config=cfg, device="cpu")
        planner = Planner(solver, mm, settings)
        data = RealTimeData()
        data.robot_area = define_robot_area(0.65, 0.65, 1)
        data.reference_path.x = list(np.linspace(0, 15, 16))
        data.reference_path.y = [0.0] * 16
        data.costmap = _corridor()
        planner.on_data_received(data, "reference_path")
        state = State(model)
        state.set("v", 1.0)
        out = planner.solve_mpc(state, data)
        assert out.success
        traj = np.asarray(out.trajectory.positions)
    else:
        lp = LocalPlannerInterface(configuration=_decomp_configuration,
                                   N=N, max_obstacles=2, device="cpu",
                                   sqp_config=cfg)
        lp.set_plan(np.stack([np.linspace(0, 15, 16), np.zeros(16)], axis=1))
        lp.set_costmap(_corridor())
        v, w, ok = lp.compute_velocity_commands((0.0, 0.0, 0.0), 1.0)
        assert ok and v > 0.3 and abs(w) < 1.0
        mm = lp.planner.modules
        traj = lp.planner.solver.get_output_trajectory()[:, [
            lp.model.var_index("x"), lp.model.var_index("y")]]
    dmod = next(m for m in mm if isinstance(m, DecompConstraintModule))
    assert dmod._b is not None and np.any(dmod._b[0, 1:] < 999.0)
    assert np.all(np.abs(traj[:, 1]) < 1.0)
    assert traj[-1, 0] > 1.5
