"""The rest of 4a in the port against the JAX package, on the CPU at f64:
``PathReferenceVelocityModule``, the dynamic velocity reference of the
contouring cost in kernel B2's header, and the ``lmpcc`` and ``goal_tmpc``
OCPs.

- The module's parameter fills equal JAX's bit for bit, with and without
  path velocities.
- The header compiled for the host (``csrc/tmpc_ocp_host.cpp``) linearizes
  the dyn-vref T-MPC OCP as ``torch.func`` does (``build_qp`` /
  ``merit_of``; rtol 1e-9, atol 1e-10) and as the JAX lane linearizer does
  (rtol 1e-9, atol 1e-9: JAX's atan2 is its own).
- The header's solve (``solve.host``) equals ``fused_fleet_reference`` per
  problem within 1e-6 relative (the card's gate, ``FUSED_F64_GATE``).
- ``fused_fleet_reference`` equals the JAX ``"xla"`` fleet solve at a
  converged schedule: z atol 1e-4, cost rtol 1e-5 (the kernels' IP freezes
  at residual 1e-5; ROADMAP Queue C's terms).
- The ``lmpcc`` and ``goal_tmpc`` OCPs build B2's tables; their first-tick
  solutions through the port's planners equal JAX's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import factory as jfactory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.modules import (  # noqa: E402
    PathReferenceVelocityModule as JaxPRV)
from oscar_mpc_planner_mr_modification_tpu.ops import sqp as jsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops.linearize import (  # noqa: E402
    make_lane_linearizer, make_lane_merit)
from oscar_mpc_planner_mr_modification_tpu.sim import roadmap as jroadmap  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.solver import (  # noqa: E402
    build_ocp as jbuild_ocp)
from oscar_mpc_planner_mr_modification_tpu.types import (  # noqa: E402
    ModuleData as JModuleData, RealTimeData as JRealTimeData)
from oscar_mpc_planner_mr_modification_tpu.utils import (  # noqa: E402
    default_settings as jdefault_settings)

from oscar_mpc_planner_mr_modification_tpu_torch import benchmarks as tbench  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch import factory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.modules import (  # noqa: E402
    PathReferenceVelocityModule)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import (  # noqa: E402
    qp_cuda, sqp_fused)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp as tsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.sim import roadmap  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.types import (  # noqa: E402
    ModuleData, RealTimeData)
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings)

F64 = torch.float64
FUSED_F64_GATE = 1e-6


class Buf(dict):
    def set(self, name, value):
        self[name] = value


@pytest.fixture(scope="module")
def host():
    if qp_cuda.host_compiler() is None:
        pytest.skip("no C++ compiler to build csrc/tmpc_ocp_host.cpp")
    qp_cuda.build_host()


# ---------------------------------------------------------------------------
# PathReferenceVelocityModule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("velocity", [None, "falling"])
def test_path_reference_velocity_fills_equal_jax(velocity):
    """Both packages' modules fill the same ``spline_v`` values bit for bit:
    the velocity spline fitted over the path's arc length, or the constant
    reference velocity as a degenerate cubic."""
    fills = []
    for pkg in ("jax", "torch"):
        settings = (jdefault_settings if pkg == "jax" else default_settings)()
        module = (JaxPRV if pkg == "jax" else PathReferenceVelocityModule)(
            settings)
        data = (JRealTimeData if pkg == "jax" else RealTimeData)()
        path = (jroadmap if pkg == "jax" else roadmap).s_bend_path(
            length=30.0, amplitude=2.0)
        if velocity:
            path.v = list(np.linspace(2.0, 0.5, len(path.x)))
        else:
            path.v = []
        data.reference_path = path
        module.on_data_received(data, "reference_path")
        md = (JModuleData if pkg == "jax" else ModuleData)()
        md.current_path_segment = 3
        buf = Buf()
        module.set_parameters(buf, data, md)
        fills.append(buf)
    assert fills[0].keys() == fills[1].keys() and len(fills[0]) == 4 * 5
    for name, value in fills[0].items():
        assert float(value) == float(fills[1][name]), name
    if velocity is None:
        assert fills[1]["spline_v0_d"] == default_settings()["weights"][
            "reference_velocity"]


# ---------------------------------------------------------------------------
# B2's header on the dyn-vref T-MPC OCP
# ---------------------------------------------------------------------------
def _jax_dynvref_ocp(N, n_paths, max_obstacles=4):
    settings = jdefault_settings(
        N=N, max_obstacles=max_obstacles, guidance={"n_paths": n_paths},
        JULES={"n_paths": n_paths},
        contouring={"dynamic_velocity_reference": True})
    model, modules = jfactory.configuration_tmpc_consistency_cost(settings)
    return jbuild_ocp(model, modules, settings)


def _dynvref_fleet(N, batch, n_paths=2, seed=0, perturb=True):
    """The port's and JAX's dyn-vref bench OCPs and one f64 fleet flattened
    to B*P problems (P with stage N repeating N-1): the fleet builder's
    falling velocity ramp, each segment's velocity spline perturbed so that
    every coefficient matters, the consistency cost on, and (``perturb``)
    the iterate moved off the warm start."""
    to, ts = tbench.tmpc_bench_ocp(N=N, n_paths=n_paths,
                                   dynamic_velocity_reference=True)
    jo = _jax_dynvref_ocp(N, n_paths)
    assert jo.registry.save_map() == to.registry.save_map()
    params, xinit, z_init, _ = tbench.build_tmpc_fleet(
        to, ts, batch, seed=seed, dtype=np.float64)
    idx = to.registry.save_map()
    rng = np.random.default_rng(seed + 5)
    B, P = params.shape[:2]
    for i in range(5):
        for c, scale in zip("abcd", (1e-3, 1e-2, 0.05, 0.2)):
            params[..., idx[f"spline_v{i}_{c}"]] += scale * rng.normal(
                size=(B, P, 1))
    params[..., idx["velocity"]] = 0.55
    params[..., idx["consistency_weight"]] = 0.05
    params[..., idx["prev_traj_x"]] = z_init[:, :, :N, 2] + 0.1
    params[..., idx["prev_traj_y"]] = z_init[:, :, :N, 3] - 0.2
    Pf = params.reshape(B * P, N, -1)
    x0 = np.repeat(xinit, P, axis=0)
    Z = z_init.reshape(B * P, N + 1, -1)
    if perturb:
        Z = Z + 0.05 * rng.normal(size=Z.shape)
        x0 = x0 + 0.01 * rng.normal(size=x0.shape)
    return jo, to, Pf, x0, Z


def test_dynvref_tables_flag_and_spline_rows():
    """The dyn-vref OCP sets FL_VSPLINE, reads the velocity weight through
    its own slot (MPCBase does not weigh v: TB_VEL is -1) and widens each
    spline row with the segment's ``spline_v`` indices."""
    to, _ = tbench.tmpc_bench_ocp(N=6, n_paths=2,
                                  dynamic_velocity_reference=True)
    tables = sqp_fused.ocp_tables(
        to, tsqp.SQPConfig(regularization="gershgorin"))
    it, idx = tables.ints, to.registry.save_map()
    assert it[sqp_fused.TB_FLAGS] & sqp_fused.FL_VSPLINE
    assert it[sqp_fused.TB_VEL] == -1
    assert it[sqp_fused.TB_VREF_W] == idx["velocity"]
    rows = it[sqp_fused.TB_HEADER:it[sqp_fused.TB_OFF_H]].reshape(
        5, sqp_fused.SP_W)
    assert list(rows[2, sqp_fused.SP_V:sqp_fused.SP_V + 4]) == [
        idx[f"spline_v2_{c}"] for c in "abcd"]
    plain, _ = tbench.tmpc_bench_ocp(N=6, n_paths=2)
    off = sqp_fused.ocp_tables(
        plain, tsqp.SQPConfig(regularization="gershgorin")).ints
    assert not off[sqp_fused.TB_FLAGS] & sqp_fused.FL_VSPLINE


@pytest.mark.parametrize("reg", ["gershgorin", "levenberg"])
def test_dynvref_header_matches_torch_func(host, reg):
    """N=12, 2 plans x 3 planners: every QP field and the merit terms of the
    header (serial and lane form) vs build_qp / merit_of."""
    _, to, P, x0, Z = _dynvref_fleet(N=12, batch=2)
    cfg = tsqp.SQPConfig(regularization=reg, reg_eps=1e-4, levenberg=2e-3)
    tables = sqp_fused.ocp_tables(to, cfg)
    mach = tsqp._make_machinery(to, cfg, F64, "cpu")
    Pt = np.concatenate([P, P[:, -1:]], axis=1)
    got = sqp_fused.host_linearize(tables, Pt, x0, Z)
    lanes = sqp_fused.host_linearize(tables, Pt, x0, Z, lanes=True)
    want = sqp_fused.linearize_reference(
        mach, tables, *(torch.as_tensor(a) for a in (Pt, x0, Z)))
    for name, a, b in zip(tsqp.QPData._fields, got[0], want[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-10, err_msg=name)
    for name, a, b in zip(("merit", "cost", "eq_res"), got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-10, err_msg=name)
    for a, b in zip((*lanes[0], *lanes[1:]), (*got[0], *got[1:])):
        assert torch.equal(a, b)
    # the term is there: v's gradient is nonzero on the body stages
    assert bool((got[0].g[:, 1:-1, 5] != 0).all())


def test_dynvref_header_matches_jax_lane_linearizer(host):
    """N=8: the header vs the JAX package's lane linearizer and merit (the
    functions JAX's fused kernel traces), field by field."""
    jo, to, P, x0, Z = _dynvref_fleet(N=8, batch=2)
    cfg = dict(regularization="gershgorin", reg_eps=1e-4)
    tables = sqp_fused.ocp_tables(to, tsqp.SQPConfig(**cfg))
    Pt = np.concatenate([P, P[:, -1:]], axis=1)
    qp, merit, cost, eq_res = sqp_fused.host_linearize(tables, Pt, x0, Z)
    jcfg = jsqp.SQPConfig(**cfg)
    lanes = (jnp.asarray(np.transpose(Pt, (2, 1, 0))),
             jnp.asarray(np.transpose(Z, (1, 2, 0))), jnp.asarray(x0.T))
    lq = make_lane_linearizer(jo, jcfg, jnp.float64)(*lanes)
    lm = make_lane_merit(jo, jcfg, jnp.float64)(*lanes)
    ours = {"H": qp.H, "g": qp.g, "A": qp.A, "B": qp.B, "c": qp.c,
            "D": qp.D[:, :, list(tables.generic)], "e": qp.e, "r0": qp.r0}
    for name, want in zip(lq._fields, lq):
        want = np.moveaxis(np.asarray(want), -1, 0)
        np.testing.assert_allclose(ours[name].numpy(), want, rtol=1e-9,
                                   atol=1e-9, err_msg=name)
    for name, a, b in zip(("merit", "cost", "eq_res"), (merit, cost, eq_res),
                          lm[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-9, err_msg=name)


def test_dynvref_header_solve_matches_fused_reference(host):
    """The header's whole SQP (B2's per-problem code on 32 emulated lanes)
    vs its plain version, N=8, the bench schedule: the same success mask
    and every problem within FUSED_F64_GATE."""
    _, to, P, x0, Z = _dynvref_fleet(N=8, batch=2, perturb=False)
    cfg = tsqp.SQPConfig(n_sqp=4, n_qp_iter=8, mu_min=1e-6, w_max=1e6,
                         reg_eps=1e-4, regularization="gershgorin",
                         qp_iter_schedule=((1, 3), (1, 5), (2, 8)))
    solve = tsqp.make_fleet_sqp_solver(to, cfg, dtype=F64, device="cpu",
                                       backend="fused")
    args = tuple(torch.as_tensor(a) for a in (P, x0, Z))
    launches = sqp_fused.launches
    got = solve.host(*args)
    want = solve(*args)
    assert sqp_fused.launches == launches
    assert bool((got.success == want.success).all())
    assert bool(want.success.any())
    rel = ((got.z - want.z).abs().amax(dim=(1, 2))
           / (1.0 + want.z.abs().amax(dim=(1, 2))))
    assert rel.max().item() <= FUSED_F64_GATE


def test_dynvref_fleet_solves_match_jax_xla():
    """N=8, 2 plans x 3 planners at a converged schedule (8 x 20, mu_min
    1e-10), against JAX's ``"xla"`` fleet solve of the same problems.

    - The port's ``"xla"`` backend (JAX's interior-point algorithm,
      ``ops/qp.py``): z atol 1e-9, cost rtol 1e-9 on every problem.
    - ``fused_fleet_reference`` (the kernels' algorithm, which freezes a
      QP at residual 1e-5): the same success mask, cost rtol 1e-5 and z
      atol 2e-4 on every problem. The same fleet without the velocity
      reference parts from JAX by up to 1.06e-4 in z on its guided
      planners, from the freeze alone."""
    jo, to, P, x0, Z = _dynvref_fleet(N=8, batch=2, perturb=False)
    kw = dict(n_sqp=8, n_qp_iter=20, mu_min=1e-10,
              regularization="gershgorin", track_best=False)
    ref = jsqp.make_fleet_sqp_solver(jo, jsqp.SQPConfig(**kw),
                                     dtype=jnp.float64, backend="xla")(
        *map(jnp.asarray, (P, x0, Z)))
    rz, rc = np.asarray(ref.z), np.asarray(ref.cost)
    args = tuple(torch.as_tensor(a) for a in (P, x0, Z))
    xla = tsqp.make_fleet_sqp_solver(to, tsqp.SQPConfig(**kw), dtype=F64,
                                     device="cpu", backend="xla")(*args)
    np.testing.assert_allclose(xla.z.numpy(), rz, rtol=0, atol=1e-9)
    np.testing.assert_allclose(xla.cost.numpy(), rc, rtol=1e-9)
    out = tsqp.make_fleet_sqp_solver(to, tsqp.SQPConfig(**kw), dtype=F64,
                                     device="cpu", backend="fused")(*args)
    np.testing.assert_array_equal(out.success.numpy(),
                                  np.asarray(ref.success))
    assert out.success.float().mean().item() >= 0.5
    np.testing.assert_allclose(out.cost.numpy(), rc, rtol=1e-5)
    np.testing.assert_allclose(out.z.numpy(), rz, rtol=0, atol=2e-4)


# ---------------------------------------------------------------------------
# The lmpcc and goal_tmpc OCPs
# ---------------------------------------------------------------------------
#: A converged schedule (as tests/test_torch_tick.py's real tick).
CONVERGED = dict(n_sqp=8, n_qp_iter=20, regularization="gershgorin",
                 track_best=False)


def _first_tick(pkg, name, N=8):
    """One package's planner of configuration ``name`` (N=8, 2 obstacles)
    and its first tick on the configuration sweep's scene: a straight path,
    the goal (6, 0) and one crossing pedestrian."""
    if pkg == "jax":
        from oscar_mpc_planner_mr_modification_tpu.planner import (
            data_preparation as dp)
        from oscar_mpc_planner_mr_modification_tpu.sim import (
            Pedestrian, PedestrianSimulator)
        from oscar_mpc_planner_mr_modification_tpu.solver import State
        fac, settings_fn, types_ = jfactory, jdefault_settings, None
        kw = dict(dtype=jnp.float64, sqp_config=jsqp.SQPConfig(**CONVERGED))
        path_fn, data_cls = jroadmap.straight_path, JRealTimeData
    else:
        from oscar_mpc_planner_mr_modification_tpu_torch.planner import (
            data_preparation as dp)
        from oscar_mpc_planner_mr_modification_tpu_torch.sim import (
            Pedestrian, PedestrianSimulator)
        from oscar_mpc_planner_mr_modification_tpu_torch.solver import State
        fac, settings_fn, types_ = factory, default_settings, None
        kw = dict(dtype=F64, device="cpu",
                  sqp_config=tsqp.SQPConfig(**CONVERGED))
        path_fn, data_cls = roadmap.straight_path, RealTimeData
    del types_
    settings = settings_fn(N=N, max_obstacles=2)
    model, modules = getattr(fac, f"configuration_{name}")(settings)
    planner = fac.build_planner(model, modules, settings, **kw)
    state = State(model)
    state.set("v", 0.6)
    sim = PedestrianSimulator([Pedestrian(np.array([6.0, 2.0]),
                                          np.array([6.0, -2.0]))], dt=0.2)
    data = data_cls()
    data.robot_area = dp.define_robot_area(0.65, 0.65, 1)
    data.reference_path = path_fn(length=20.0)
    data.goal = np.array([6.0, 0.0])
    data.goal_received = True
    data.dynamic_obstacles = dp.ensure_obstacle_size(
        sim.get_obstacles(N), state, 2, N, 0.2)
    for what in ("reference_path", "goal", "dynamic obstacles"):
        planner.on_data_received(data, what)
    return planner, planner.solve_mpc(state, data)


@pytest.mark.parametrize("name", ["lmpcc", "goal_tmpc"])
def test_first_tick_matches_jax(name):
    """The OCP builds B2's tables; the first tick's solution equals JAX's
    at a converged schedule. ``lmpcc`` has no guidance module, so both
    planners run ``Solver.solve`` (the port's single-instance solve is JAX's
    algorithm): z atol 1e-8. ``goal_tmpc`` runs the T-MPC optimizer (the
    port's fused plain version against JAX's ``"xla"``): the selected cost
    within 1e-6 relative and the winner's z within 1e-4, or each side's cost
    of the other's winner within 1e-6 of its own minimum (the rule of
    tests/test_torch_tick.py's real tick)."""
    pt, out_t = _first_tick("torch", name)
    pj, out_j = _first_tick("jax", name)
    tables = sqp_fused.ocp_tables(pt.solver.ocp,
                                  tsqp.SQPConfig(regularization="gershgorin"))
    assert tables.model == (0 if name == "lmpcc" else 1)
    assert out_t.success and out_j.success
    zt, zj = pt.solver._output_z, np.asarray(pj.solver._output_z)
    if name == "lmpcc":
        np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-8)
        return
    ot = next(m for m in pt.modules if hasattr(m, "_optimizer"))._optimizer
    oj = next(m for m in pj.modules if hasattr(m, "_optimizer"))._optimizer
    assert ot.fleet_backend == "fused" and oj._fleet_backends == ["xla"]
    cost_t, cost_j = out_t.trajectory_cost, out_j.trajectory_cost
    assert abs(cost_t - cost_j) <= 1e-6 * abs(cost_j)
    bt, bj = ot.best_planner_index, oj.best_planner_index
    if bt == bj:
        np.testing.assert_allclose(zt, zj, atol=1e-4)
    else:
        for costs, own, other in ((oj.last_objectives, bj, bt),
                                  (ot.last_objectives, bt, bj)):
            assert abs(costs[other] - costs[own]) <= 1e-6 * abs(costs[own])
