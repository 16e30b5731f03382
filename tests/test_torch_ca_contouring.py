"""The curvature-aware (CA-MPC) models and contouring cost in the port
against the JAX package, on the CPU at f64, with B2's curvature-aware
progress update and CA contouring flag.

- Both CA models' step and Jacobian equal JAX's to 1e-12 on a curved path
  and on a near-straight one (``spline_y{i}_a = 1e-9``, curvature below the
  floor). On an exactly straight path JAX's Jacobian is NaN (the derivative
  of sqrt at 0 times max's 0); the port's is finite and its step and
  Jacobian equal JAX's on the near-straight path to 1e-9 near the path's
  start, where the two paths' tangents part by less than 2e-9 (the floor
  written on the squared curvature; ROADMAP's reference defects).
- ``CurvatureAwareContouringModule``: its cost at a body and the terminal
  stage and its parameter fills equal JAX's; JAX's own CA checks
  (tests/test_scenario.py) hold in the port.
- B2's header compiled for the host linearizes the CA unicycle OCP
  (MPCBase, the CA cost, ellipsoids) as ``torch.func`` does on a curved and
  on a straight path (rtol 1e-9, atol 1e-10, no NaN) and as the JAX lane
  linearizer does on the curved one (rtol 1e-9, atol 1e-9); its solve
  equals ``fused_fleet_reference`` (1e-6 per problem).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import models as jmodels  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.modules import (  # noqa: E402
    CurvatureAwareContouringModule as JCA, EllipsoidConstraintModule as JEll,
    ModuleManager as JMM, MPCBaseModule as JBase)
from oscar_mpc_planner_mr_modification_tpu.ops import sqp as jsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops.linearize import (  # noqa: E402
    make_lane_linearizer, make_lane_merit)
from oscar_mpc_planner_mr_modification_tpu.solver import (  # noqa: E402
    build_ocp as jbuild_ocp)
from oscar_mpc_planner_mr_modification_tpu.types import (  # noqa: E402
    ModuleData as JModuleData, RealTimeData as JRealTimeData)
from oscar_mpc_planner_mr_modification_tpu.utils import (  # noqa: E402
    default_settings as jdefault_settings)

from oscar_mpc_planner_mr_modification_tpu_torch import models as tmodels  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.modules import (  # noqa: E402
    CurvatureAwareContouringModule, ModuleManager)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import (  # noqa: E402
    qp_cuda, sqp_fused)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp as tsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.solver import build_ocp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.tools import (  # noqa: E402
    bench_matrix)
from oscar_mpc_planner_mr_modification_tpu_torch.types import (  # noqa: E402
    ModuleData, RealTimeData)
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings)
from oscar_mpc_planner_mr_modification_tpu_torch.utils.params import (  # noqa: E402
    ParameterRegistry)

F64 = torch.float64
CA_MODELS = ["ContouringSecondOrderUnicycleModelCurvatureAware",
             "BicycleModel2ndOrderCurvatureAware"]


@pytest.fixture(scope="module")
def host():
    if qp_cuda.host_compiler() is None:
        pytest.skip("no C++ compiler to build csrc/tmpc_ocp_host.cpp")
    qp_cuda.build_host()


def path_params(reg, kind):
    """A path along x of 5 segments of 5 m: ``curved`` (y cubic), ``near``
    (y's cubic coefficient 1e-9) or ``straight``."""
    p = np.zeros(reg.npar)
    for i in range(5):
        p[reg.index(f"spline{i}_start")] = 5.0 * i
        p[reg.index(f"spline_x{i}_c")] = 1.0
        p[reg.index(f"spline_x{i}_d")] = 5.0 * i
        if kind == "curved":
            p[reg.index(f"spline_y{i}_a")] = 0.002 * (i + 1)
            p[reg.index(f"spline_y{i}_b")] = 0.04
            p[reg.index(f"spline_y{i}_c")] = 0.3
        elif kind == "near":
            p[reg.index(f"spline_y{i}_a")] = 1e-9
    return p


def _ca_registry():
    reg = ParameterRegistry()
    mm = ModuleManager()
    mm.add_module(CurvatureAwareContouringModule(default_settings()))
    mm.define_parameters(reg)
    return reg


_JAX_STEPS = {}


def _steps(name, kind, xu):
    """Each package's step and Jacobian at xu on the named path: numpy (the
    JAX side jitted once per model, the path's parameters an argument)."""
    jm, tm = getattr(jmodels, name)(), getattr(tmodels, name)()
    reg = _ca_registry()
    p = path_params(reg, kind)
    nx = tm.nx
    if name not in _JAX_STEPS:
        def jf(v, pv):
            ctx = {"params": reg.view(pv), "num_segments": 5}
            return jm.discrete_dynamics(v[:nx], v[nx:], 0.2, ctx=ctx)

        _JAX_STEPS[name] = (jax.jit(jf), jax.jit(jax.jacfwd(jf)))
    jstep, jjac = _JAX_STEPS[name]
    tctx = {"params": reg.view(torch.as_tensor(p)), "num_segments": 5}

    def tf(v):
        return tm.discrete_dynamics(v[:nx], v[nx:], 0.2, ctx=tctx)

    jv, jp = jnp.asarray(xu), jnp.asarray(p)
    return ((np.asarray(jstep(jv, jp)), np.asarray(jjac(jv, jp))),
            (tf(torch.as_tensor(xu)).numpy(),
             torch.func.jacfwd(tf)(torch.as_tensor(xu)).numpy()))


@pytest.mark.parametrize("name", CA_MODELS)
def test_ca_models_match_jax(name):
    jm, tm = getattr(jmodels, name)(), getattr(tmodels, name)()
    assert (tm.nx, tm.nu, tm.states, tm.inputs, tm.nx_integrate, tm.width) \
        == (jm.nx, jm.nu, jm.states, jm.inputs, jm.nx_integrate, jm.width)
    assert (tm.lower_bound, tm.upper_bound) == (jm.lower_bound,
                                                jm.upper_bound)
    rng = np.random.default_rng(0)
    for _ in range(3):
        x = rng.uniform(-0.5, 0.5, tm.nx)
        x[3], x[-1] = 1.5, rng.uniform(1.0, 12.0)
        xu = np.concatenate([x, rng.uniform(-0.5, 0.5, tm.nu)])
        for kind in ("curved", "near"):
            (jv, jJ), (tv, tJ) = _steps(name, kind, xu)
            np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(tJ, jJ, rtol=1e-12, atol=1e-12)
        # exactly straight: JAX's Jacobian is NaN, the port's finite and
        # JAX's near-straight one, near the path's start (s < 0.8, small
        # heading), where the near-straight path's tangent is within 2e-9 of
        # the straight one's
        x[1], x[2], x[-1] = 0.1 * x[1], 0.1 * x[2], rng.uniform(0.1, 0.8)
        xu = np.concatenate([x, rng.uniform(-0.5, 0.5, tm.nu)])
        (jv_s, jJ_s), (tv_s, tJ_s) = _steps(name, "straight", xu)
        assert np.isnan(jJ_s).any() and np.isfinite(jv_s).all()
        assert np.isfinite(tJ_s).all()
        (jv_n, jJ_n), _ = _steps(name, "near", xu)
        np.testing.assert_allclose(tv_s, jv_n, rtol=0, atol=1e-9)
        np.testing.assert_allclose(tJ_s, jJ_n, rtol=0, atol=1e-9)


def test_ca_step_of_the_jax_suite():
    """JAX's tests/test_scenario.py check: on a straight path the spline
    state advances by the projected progress, s + v dt."""
    tm = tmodels.ContouringSecondOrderUnicycleModelCurvatureAware()
    reg = _ca_registry()
    p = np.zeros(reg.npar)
    for i in range(5):
        p[reg.index(f"spline_x{i}_c")] = 1.0
        p[reg.index(f"spline{i}_start")] = 5.0 * i
    ctx = {"params": reg.view(torch.as_tensor(p)), "num_segments": 5}
    xn = tm.discrete_dynamics(torch.tensor([0.0, 0.0, 0.0, 2.0, 1.0],
                                           dtype=F64),
                              torch.zeros(2, dtype=F64), 0.2, ctx=ctx)
    assert abs(float(xn[0]) - 0.4) < 1e-9
    assert abs(float(xn[4]) - 1.4) < 1e-6


def _ca_unicycle_pair(N, max_obstacles=3):
    js = jdefault_settings(N=N, max_obstacles=max_obstacles)
    jm = JMM()
    base = jm.add_module(JBase(js))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    jm.add_module(JCA(js))
    jm.add_module(JEll(js))
    jo = jbuild_ocp(
        jmodels.ContouringSecondOrderUnicycleModelCurvatureAware(), jm, js)
    ts = default_settings(N=N, max_obstacles=max_obstacles)
    to = build_ocp(*bench_matrix.ca_unicycle_modules(ts), ts)
    assert to.registry.save_map() == jo.registry.save_map()
    return jo, to


def test_ca_contouring_cost_matches_jax():
    """The OCP's stage and terminal costs (vmapped over random points on
    the curved path of tools/bench_matrix.py's CA fleet) and the module's
    parameter fills equal JAX's; on the path, aligned and at the reference
    speed the stage cost is 0, and 0.5 m off it w_c 0.25 (JAX's check)."""
    from torch.func import vmap

    jo, to = _ca_unicycle_pair(10)
    _, P, _, z0 = bench_matrix.build_ca_unicycle(
        10, 3, np.random.default_rng(0))
    rng = np.random.default_rng(1)
    Pf = P.reshape(-1, to.npar).astype(np.float64)
    Zf = (z0[:, :-1].reshape(-1, to.nvar)
          + 0.2 * rng.normal(size=(Pf.shape[0], to.nvar)))
    jz, jp = jnp.asarray(Zf), jnp.asarray(Pf)
    tz, tp = torch.as_tensor(Zf), torch.as_tensor(Pf)
    np.testing.assert_allclose(vmap(to.cost_stage)(tz, tp).numpy(),
                               np.asarray(jax.vmap(jo.cost_stage)(jz, jp)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        vmap(to.cost_terminal)(tz[:, 2:], tp).numpy(),
        np.asarray(jax.vmap(jo.cost_terminal)(jz[:, 2:], jp)), rtol=1e-12,
        atol=1e-12)
    np.testing.assert_allclose(
        vmap(to.dynamics)(tz[:, 2:], tz[:, :2], tp).numpy(),
        np.asarray(jax.vmap(jo.dynamics)(jz[:, 2:], jz[:, :2], jp)),
        rtol=1e-12, atol=1e-12)

    # JAX's tests/test_scenario.py values on a straight path
    reg, p = to.registry, np.zeros(to.npar)
    p[reg.index("contour")] = 0.1
    p[reg.index("velocity")] = 0.5
    p[reg.index("reference_velocity")] = 2.0
    for i in range(5):
        p[reg.index(f"spline_x{i}_c")] = 1.0
        p[reg.index(f"spline{i}_start")] = 5.0 * i
    z = torch.tensor([0.0, 0.0, 2.0, 0.0, 0.0, 2.0, 2.0], dtype=F64)
    pt = torch.as_tensor(p)
    assert abs(float(to.cost_stage(z, pt))) < 1e-9
    z[3] = 0.5
    assert abs(float(to.cost_stage(z, pt)) - 0.1 * 0.25) < 1e-6

    class Buf(dict):
        def set(self, name, value):
            self[name] = value

    fills = []
    for pkg in ("jax", "torch"):
        settings = (jdefault_settings if pkg == "jax" else default_settings)()
        module = (JCA if pkg == "jax" else CurvatureAwareContouringModule)(
            settings)
        data = (JRealTimeData if pkg == "jax" else RealTimeData)()
        data.reference_path.x = list(np.linspace(0.0, 20.0, 9))
        data.reference_path.y = list(0.02 * np.linspace(0.0, 20.0, 9) ** 2)
        module.on_data_received(data, "reference_path")
        md = (JModuleData if pkg == "jax" else ModuleData)()
        module.closest_segment = 1
        buf = Buf()
        module.set_parameters(buf, data, md)
        fills.append(buf)
    assert fills[0].keys() == fills[1].keys()
    assert {"velocity", "reference_velocity"} <= fills[1].keys()
    for name, value in fills[0].items():
        assert float(value) == float(fills[1][name]), name


@pytest.fixture(scope="module")
def ca_fleet():
    """The JAX and port CA unicycle OCPs at N=8 and 4 problems of
    tools/bench_matrix.py's CA fleet, moved off the warm start, f64: on its
    curved paths and on the same paths made straight."""
    jo, to = _ca_unicycle_pair(8)
    _, P, x0, z0 = bench_matrix.build_ca_unicycle(
        8, 4, np.random.default_rng(2))
    rng = np.random.default_rng(3)
    P = np.concatenate([P, P[:, -1:]], axis=1).astype(np.float64)
    Z = z0.astype(np.float64) + 0.05 * rng.normal(size=z0.shape)
    straight = P.copy()
    for i in range(5):
        for c in "abcd":
            straight[..., to.registry.index(f"spline_y{i}_{c}")] = 0.0
    return jo, to, {"curved": P, "straight": straight}, x0.astype(
        np.float64), Z


@pytest.mark.parametrize("path", ["curved", "straight"])
def test_ca_header_matches_torch_func(host, ca_fleet, path):
    _, to, Ps, x0, Z = ca_fleet
    P = Ps[path]
    cfg = tsqp.SQPConfig(regularization="gershgorin", reg_eps=1e-4)
    tables = sqp_fused.ocp_tables(to, cfg)
    flags = tables.ints[sqp_fused.TB_FLAGS]
    assert flags & sqp_fused.FL_CA_CONTOUR and not flags & (
        sqp_fused.FL_CONTOUR | sqp_fused.FL_VSPLINE)
    assert tables.model == sqp_fused.MODELS[
        "ContouringSecondOrderUnicycleModelCurvatureAware"]
    assert tables.ints[sqp_fused.TB_CA_VREF] == to.registry.index(
        "reference_velocity")
    mach = tsqp._make_machinery(to, cfg, F64, "cpu")
    got = sqp_fused.host_linearize(tables, P, x0, Z)
    lanes = sqp_fused.host_linearize(tables, P, x0, Z, lanes=True)
    want = sqp_fused.linearize_reference(
        mach, tables, *(torch.as_tensor(a) for a in (P, x0, Z)))
    for name, a, b in zip(sqp_fused.QPData._fields + ("merit", "cost",
                                                      "eq_res"),
                          (*got[0], *got[1:]), (*want[0], *want[1:])):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-10, err_msg=name)
    for a, b in zip((*lanes[0], *lanes[1:]), (*got[0], *got[1:])):
        assert torch.equal(a, b)
    # the progress update moves s with x, y and psi: A's spline row
    assert bool((got[0].A[:, :, 4, :3].abs().sum(-1) > 0).all())


def test_ca_header_matches_jax_lane_linearizer(host, ca_fleet):
    jo, to, Ps, x0, Z = ca_fleet
    P = Ps["curved"]
    cfg = dict(regularization="gershgorin", reg_eps=1e-4)
    tables = sqp_fused.ocp_tables(to, tsqp.SQPConfig(**cfg))
    qp, merit, cost, eq_res = sqp_fused.host_linearize(tables, P, x0, Z)
    jcfg = jsqp.SQPConfig(**cfg)
    lanes = (jnp.asarray(np.transpose(P, (2, 1, 0))),
             jnp.asarray(np.transpose(Z, (1, 2, 0))), jnp.asarray(x0.T))
    lq = make_lane_linearizer(jo, jcfg, jnp.float64)(*lanes)
    lm = make_lane_merit(jo, jcfg, jnp.float64)(*lanes)
    ours = {"H": qp.H, "g": qp.g, "A": qp.A, "B": qp.B, "c": qp.c,
            "D": qp.D[:, :, list(tables.generic)], "e": qp.e, "r0": qp.r0}
    for name, want in zip(lq._fields, lq):
        np.testing.assert_allclose(ours[name].numpy(),
                                   np.moveaxis(np.asarray(want), -1, 0),
                                   rtol=1e-9, atol=1e-9, err_msg=name)
    for name, a, b in zip(("merit", "cost", "eq_res"), (merit, cost, eq_res),
                          lm[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-9, err_msg=name)


def test_ca_header_solve_matches_fused_fleet_reference(host, ca_fleet):
    _, to, Ps, x0, Z = ca_fleet
    cfg = tsqp.SQPConfig(n_sqp=4, n_qp_iter=8, mu_min=1e-6, w_max=1e6,
                         reg_eps=1e-4, regularization="gershgorin",
                         qp_iter_schedule=((2, 5), (2, 8)))
    solve = tsqp.make_fleet_sqp_solver(to, cfg, dtype=F64, device="cpu",
                                       backend="fused")
    args = tuple(torch.as_tensor(a) for a in (Ps["curved"][:, :-1], x0, Z))
    got = solve.host(*args)
    want = solve(*args)
    assert bool((got.success == want.success).all())
    assert bool(want.success.any())
    rel = ((got.z - want.z).abs().amax(dim=(1, 2))
           / (1.0 + want.z.abs().amax(dim=(1, 2))))
    assert rel.max().item() <= 1e-6
