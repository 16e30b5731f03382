"""Parity of the PyTorch port's model, modules and OCP with the JAX package.

The same inputs, drawn from numpy seeds, go through both packages at float64
on the CPU. Tolerances are stated per test.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import benchmarks as jbench  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu import factory as jfactory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu import solver as jsolver  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu import types as jtypes  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops import sqp as jsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.utils import (  # noqa: E402
    default_settings as j_default_settings)

from oscar_mpc_planner_mr_modification_tpu_torch import benchmarks as tbench  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch import factory as tfactory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch import solver as tsolver  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.models import (  # noqa: E402
    ContouringSecondOrderUnicycleModel)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp as tsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings as t_default_settings)

F64 = torch.float64
CPU = torch.device("cpu")


def _pair(name):
    """(jax_ocp, torch_ocp, P (B, N, npar), Z (B, N+1, nvar), x0 (B, nx)) of a
    configuration, with parameters and iterates around a realistic point."""
    if name == "bench":
        jo, js = jbench.tmpc_bench_ocp(N=6, n_paths=2)
        to, ts = tbench.tmpc_bench_ocp(N=6, n_paths=2)
        params, xinit, z_init, _ = jbench.build_tmpc_fleet(jo, js, 1,
                                                           dtype=np.float64)
        P, Z, x0 = params[0], z_init[0], np.repeat(xinit, params.shape[1], 0)
        idx = jo.registry.save_map()
        P[..., idx["consistency_weight"]] = 0.05
        P[..., idx["prev_traj_x"]] = Z[:, :-1, jo.model.var_index("x")] + 0.1
        P[..., idx["prev_traj_y"]] = Z[:, :-1, jo.model.var_index("y")] - 0.2
    else:
        N = 15
        js, ts = (j_default_settings(N=N, max_obstacles=2),
                  t_default_settings(N=N, max_obstacles=2))
        jo = jsolver.build_ocp(*jfactory.configuration_basic(js), js)
        to = tsolver.build_ocp(*tfactory.configuration_basic(ts), ts)
        gold = np.load(__file__.replace("test_torch_model_ocp.py",
                                        "golden/contouring_2obs.npz"))
        P = np.stack([gold["P"], gold["P"]])
        Z = np.stack([gold["Z"], gold["z_init"]])
        x0 = np.stack([gold["x0"], gold["x0"]])
    rng = np.random.default_rng(7)
    Z = Z + 0.05 * rng.normal(size=Z.shape)
    P = P * (1.0 + 0.01 * rng.normal(size=P.shape))
    return jo, to, P, Z, x0


@pytest.mark.parametrize("name", ["bench", "basic"])
def test_registry_maps_identical(name):
    jo, to, _, _, _ = _pair(name)
    assert to.registry.save_map() == jo.registry.save_map()
    for bundle in ("lin_constraint_a1", "ellipsoid_obst_x", "spline_x_a"):
        if jo.registry.has_bundle(bundle):
            assert (to.registry.bundle_indices(bundle)
                    == jo.registry.bundle_indices(bundle))
    assert to.ineq_row_spec() == jo.ineq_row_spec()
    np.testing.assert_array_equal(to.lh, jo.lh)
    np.testing.assert_array_equal(to.uh, jo.uh)
    np.testing.assert_array_equal(to.lbz, jo.lbz)
    np.testing.assert_array_equal(to.ubz, jo.ubz)
    if name == "bench":
        assert (to.npar, to.nh, len(to.ineq_row_spec())) == (98, 8, 22)
    else:
        assert to.npar == 69


def test_save_maps_match(tmp_path):
    """The parameter map, model map and solver settings YAML files are the
    same text in both packages."""
    from oscar_mpc_planner_mr_modification_tpu.solver.ocp import (
        save_maps as j_save_maps)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver.ocp import (
        save_maps as t_save_maps)

    jo, to, _, _, _ = _pair("bench")
    theirs = j_save_maps(jo, str(tmp_path / "jax"))
    ours = t_save_maps(to, str(tmp_path / "torch"))
    assert set(ours) == set(theirs) == {"parameter_map", "model_map",
                                        "solver_settings"}
    for name in theirs:
        with open(ours[name]) as a, open(theirs[name]) as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
def test_scale_iterations_matches(n):
    """The iteration budget ladder cuts the loose front phases of a schedule
    first, as in the JAX package; a plain config only changes n_sqp.
    Integer tuples, compared exactly."""
    for kw in (dict(qp_iter_schedule=((1, 3), (1, 5), (2, 8))), dict()):
        ours = tsqp.scale_iterations(tsqp.SQPConfig(**kw), n)
        theirs = jsqp.scale_iterations(jsqp.SQPConfig(**kw), n)
        assert ours.n_sqp == theirs.n_sqp == n
        assert ours.qp_iter_schedule == theirs.qp_iter_schedule
        assert tsqp._phases_of(ours) == jsqp._phases_of(theirs)


def test_rk4_known_step():
    """x=(1,0,0,2,1), u=0, dt=0.2: straight line at v=2 -> (1.4,0,0,2,1.4)."""
    model = ContouringSecondOrderUnicycleModel()
    x = torch.tensor([1.0, 0.0, 0.0, 2.0, 1.0], dtype=F64)
    out = model.discrete_dynamics(x, torch.zeros(2, dtype=F64), 0.2)
    np.testing.assert_allclose(out.numpy(), [1.4, 0.0, 0.0, 2.0, 1.4],
                               atol=1e-12)


@pytest.mark.parametrize("name", ["bench", "basic"])
def test_stage_functions_match(name):
    """cost_stage, cost_terminal, ineq and dynamics on the same (z, p) at
    atol 1e-10: the same f64 arithmetic, except that the JAX package's atan2
    is a Newton-polished rational (round-off level)."""
    from torch.func import vmap

    jo, to, P, Z, _ = _pair(name)
    nu = jo.nu
    Pf = np.concatenate([P, P[:, -1:]], axis=1).reshape(-1, P.shape[-1])
    Zf = Z.reshape(-1, Z.shape[-1])
    jz, jp = jnp.asarray(Zf), jnp.asarray(Pf)
    tz, tp = torch.as_tensor(Zf), torch.as_tensor(Pf)
    pairs = [
        (jax.vmap(jo.cost_stage)(jz, jp), vmap(to.cost_stage)(tz, tp)),
        (jax.vmap(jo.cost_terminal)(jz[:, nu:], jp),
         vmap(to.cost_terminal)(tz[:, nu:], tp)),
        (jax.vmap(jo.ineq)(jz, jp), vmap(to.ineq)(tz, tp)),
        (jax.vmap(jo.dynamics)(jz[:, nu:], jz[:, :nu], jp),
         vmap(to.dynamics)(tz[:, nu:], tz[:, :nu], tp)),
    ]
    for i, (a, b) in enumerate(pairs):
        assert b.dtype == F64
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-10, err_msg=f"function {i}")
    mach = jsqp._make_machinery(jo, jsqp.SQPConfig(), jnp.float64)
    np.testing.assert_array_equal(to.stage_mask(), mach.stage_mask)


REGS = ("gershgorin", "mirror")


@pytest.fixture(scope="module")
def jax_bench_qps():
    """JAX ``_make_machinery.build_qp`` of the bench OCP under each
    regularization, compiled as one program (the linearization is shared)."""
    jo, _, P, Z, x0 = _pair("bench")
    machs = [jsqp._make_machinery(
        jo, jsqp.SQPConfig(regularization=reg, reg_eps=1e-4), jnp.float64)
        for reg in REGS]
    Pf = np.concatenate([P, P[:, -1:]], axis=1)
    qps = jax.jit(lambda z, p, x: tuple(jax.vmap(m.build_qp)(z, p, x)
                                        for m in machs))(
        jnp.asarray(Z), jnp.asarray(Pf), jnp.asarray(x0))
    return dict(zip(REGS, zip(machs, qps)))


@pytest.mark.parametrize("reg", REGS)
def test_build_qp_matches(reg, jax_bench_qps):
    """QP fields of the bench OCP's linearization vs JAX
    ``_make_machinery.build_qp``, at atol 1e-9: autodiff in both packages,
    round-off apart; the mirror path adds an eigendecomposition (LAPACK in
    both, another summation order)."""
    _, to, P, Z, x0 = _pair("bench")
    jm, jq = jax_bench_qps[reg]
    tm = tsqp._make_machinery(
        to, tsqp.SQPConfig(regularization=reg, reg_eps=1e-4), F64, CPU)
    Pf = np.concatenate([P, P[:, -1:]], axis=1)
    tq = tm.build_qp(torch.as_tensor(Z), torch.as_tensor(Pf),
                     torch.as_tensor(x0))
    for field in tsqp.QPData._fields:
        a, b = np.asarray(getattr(jq, field)), getattr(tq, field)
        assert b.dtype == F64
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-9,
                                   err_msg=field)
    assert tm.row_meta == tuple(
        meta if meta[0] == "box" else ("h", 0) for meta in jm.row_meta)


def test_build_qp_float32_fields_stay_float32():
    """Every QP field of an f32 linearization is f32 (the kernel takes one
    dtype), including the terminal angle cost's second derivatives."""
    _, to, P, Z, x0 = _pair("bench")
    tm = tsqp._make_machinery(to, tsqp.SQPConfig(regularization="gershgorin"),
                              torch.float32, CPU)
    Pf = np.concatenate([P, P[:, -1:]], axis=1)
    q = tm.build_qp(*(torch.as_tensor(x, dtype=torch.float32)
                      for x in (Z, Pf, x0)))
    assert {getattr(q, f).dtype for f in tsqp.QPData._fields} == {torch.float32}


class _State:
    def __init__(self, model, x):
        self.model, self.x = model, dict(zip(model.states, x))

    def get(self, name):
        return self.x[name]

    def set(self, name, value):
        self.x[name] = float(value)

    def has(self, name):
        return name in self.x


def _scene(N):
    """A RealTimeData with a curved reference path and Gaussian/deterministic
    obstacles (the JAX package's types; the port reads them duck-typed)."""
    data = jtypes.RealTimeData()
    s = np.linspace(0.0, 40.0, 9)
    data.reference_path = jtypes.ReferencePath(x=list(s),
                                               y=list(1.5 * np.sin(s / 8.0)))
    data.robot_area = [jtypes.Disc(offset=0.0, radius=0.325)]
    for i in range(2):
        steps = [jtypes.PredictionStep(np.array([3.0 + i + 0.2 * k, 0.5 - i]),
                                       0.1 * k, 0.3, 0.2) for k in range(N)]
        kind = (jtypes.PredictionType.GAUSSIAN if i == 0
                else jtypes.PredictionType.DETERMINISTIC)
        data.dynamic_obstacles.append(jtypes.DynamicObstacle(
            index=i, position=steps[0].position.copy(), radius=0.4,
            prediction=jtypes.Prediction(type=kind, modes=[steps],
                                         probabilities=[1.0])))
    return data


def test_runtime_parameter_fill_matches():
    """The numpy runtime side (reference-path fit and segment upload, road
    halfspaces, ellipsoid and weight fills) writes the same (N, npar) buffer
    in both packages: identical numpy code, compared exactly."""
    N = 8
    out = []
    for pkg_factory, pkg_solver, settings_fn in (
            (jfactory, jsolver, j_default_settings),
            (tfactory, tsolver, t_default_settings)):
        settings = settings_fn(N=N, max_obstacles=2)
        settings["probabilistic"]["enable"] = True
        model, modules = pkg_factory.configuration_basic(settings)
        ocp = pkg_solver.build_ocp(model, modules, settings)
        data = _scene(N)
        warm = np.zeros((N + 1, ocp.nvar))
        warm[:, model.var_index("spline")] = np.linspace(0.5, 6.0, N + 1)
        fake_solver = types.SimpleNamespace(N=N, _x0=warm, ocp=ocp)
        module_data = jtypes.ModuleData()
        for m in modules:
            m.solver = fake_solver
        state = _State(model, [0.3, 0.2, 0.1, 1.0, 0.0])
        modules.on_data_received(data, "reference_path")
        modules.update_all(state, data, module_data)
        buf = ocp.registry.new_buffer(N)
        modules.set_all_parameters(buf, data, module_data)
        halfspaces = [(h.A.tolist(), h.b) for k in range(1, N)
                      for h in module_data.static_obstacles[k]]
        out.append((buf.data, state.x["spline"], halfspaces))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    assert out[1][1] == out[0][1]
    assert out[1][2] == out[0][2]
