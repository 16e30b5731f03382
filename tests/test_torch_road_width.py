"""The road-width constraints (``ContouringConstraintModule``) in the port
against the JAX package, on the CPU at f64, with B2's road-width rows.

- The rows, on the unicycle (no slack) and on the bicycle (slack input),
  equal JAX's (1e-12); the width splines fitted from the road's boundaries
  and the default fill (half the road width) equal JAX's bit for bit.
- B2's header compiled for the host linearizes the road-width rows (with
  the decomp rows on the curvature-aware bicycle, whose slack is an input,
  in one OCP) as
  ``torch.func`` does (rtol 1e-9, atol 1e-10) and as the JAX lane
  linearizer does (rtol 1e-9, atol 1e-9), and the header's solve of the
  road-width bicycle fleet equals ``fused_fleet_reference`` (1e-6 per
  problem); a road-width row without a contouring module is refused.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import factory as jfactory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.modules import (  # noqa: E402
    ContouringConstraintModule as JRoad, DecompConstraintModule as JDecomp)
from oscar_mpc_planner_mr_modification_tpu.ops import sqp as jsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops.linearize import (  # noqa: E402
    make_lane_linearizer, make_lane_merit)
from oscar_mpc_planner_mr_modification_tpu.solver import (  # noqa: E402
    build_ocp as jbuild_ocp)
from oscar_mpc_planner_mr_modification_tpu.types import (  # noqa: E402
    ModuleData as JModuleData, RealTimeData as JRealTimeData)
from oscar_mpc_planner_mr_modification_tpu.utils import (  # noqa: E402
    default_settings as jdefault_settings)

from oscar_mpc_planner_mr_modification_tpu_torch import factory  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.modules import (  # noqa: E402
    ContouringConstraintModule, DecompConstraintModule, GoalModule,
    ModuleManager, MPCBaseModule)
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

F64 = torch.float64


@pytest.fixture(scope="module")
def host():
    if qp_cuda.host_compiler() is None:
        pytest.skip("no C++ compiler to build csrc/tmpc_ocp_host.cpp")
    qp_cuda.build_host()


def _pair(conf, N=8, decomp=False, *args, **overrides):
    """The JAX and port OCPs of ``conf(settings, *args)`` plus the
    road-width module (and, with ``decomp``, the decomp module)."""
    js = jdefault_settings(N=N, **overrides)
    jm, jmm = getattr(jfactory, conf)(js, *args)
    jmm.add_module(JRoad(js))
    ts = default_settings(N=N, **overrides)
    tm, tmm = getattr(factory, conf)(ts, *args)
    tmm.add_module(ContouringConstraintModule(ts))
    if decomp:
        jmm.add_module(JDecomp(js))
        tmm.add_module(DecompConstraintModule(ts))
    jo, to = jbuild_ocp(jm, jmm, js), build_ocp(tm, tmm, ts)
    assert to.registry.save_map() == jo.registry.save_map()
    return jo, to


@pytest.mark.parametrize("conf", ["configuration_no_obstacles",
                                  "configuration_bicycle"])
def test_road_width_rows_match_jax(conf):
    from torch.func import vmap

    jo, to = _pair(conf, max_obstacles=1)
    assert to.nh == jo.nh and list(to.ineq_row_spec()) == list(
        jo.ineq_row_spec())
    _, P, _, _ = bench_matrix.build_bicycle(
        8, 3, np.random.default_rng(0), road_width=True)
    rng = np.random.default_rng(1)
    Pf = rng.normal(size=(6, to.npar))
    # the bicycle fleet's path and road widths (its registry names them
    # at the same indices but for the ellipsoids)
    idx, idx_b = to.registry.save_map(), _road_map()
    for name, i in idx.items():
        if name.startswith(("spline", "width")):
            Pf[:, i] = P.reshape(-1, P.shape[-1])[:6, idx_b[name]]
    Zf = rng.normal(size=(6, to.nvar))
    Zf[:, to.model.var_index("spline")] = rng.uniform(0.0, 30.0, 6)
    got = vmap(to.ineq)(torch.as_tensor(Zf), torch.as_tensor(Pf)).numpy()
    want = np.asarray(jax.vmap(jo.ineq)(jnp.asarray(Zf), jnp.asarray(Pf)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _road_map():
    """The parameter map of tools/bench_matrix.py's road-width fleet."""
    settings = default_settings(N=8)
    model, mm = factory.configuration_bicycle(settings)
    mm.add_module(ContouringConstraintModule(settings))
    return build_ocp(model, mm, settings).registry.save_map()


class Buf(dict):
    def set(self, name, value):
        self[name] = value


@pytest.mark.parametrize("bounds", [False, True])
def test_road_width_fills_match_jax(bounds):
    """The width splines fitted from the received boundaries (a road 2.5 m
    to the left and 3.0 m to the right of a curved centre line) and the
    default fill (half the road width) equal JAX's bit for bit."""
    fills = []
    for pkg in ("jax", "torch"):
        settings = (jdefault_settings if pkg == "jax" else default_settings)()
        module = (JRoad if pkg == "jax" else ContouringConstraintModule)(
            settings)
        data = (JRealTimeData if pkg == "jax" else RealTimeData)()
        xs = np.linspace(0.0, 30.0, 16)
        ys = 0.01 * xs ** 2
        data.reference_path.x, data.reference_path.y = list(xs), list(ys)
        if bounds:
            data.left_bound.x, data.left_bound.y = list(xs), list(ys + 2.5)
            data.right_bound.x, data.right_bound.y = list(xs), list(ys - 3.0)
        module.on_data_received(data, "reference_path")
        md = (JModuleData if pkg == "jax" else ModuleData)()
        md.current_path_segment = 2
        buf = Buf()
        module.set_parameters(buf, data, md)
        fills.append(buf)
    assert fills[0].keys() == fills[1].keys() and len(fills[1]) == 40
    for name, value in fills[0].items():
        assert float(value) == float(fills[1][name]), name
    if not bounds:
        assert fills[1]["width_left0_d"] == default_settings()["road"][
            "width"] / 2.0


@pytest.fixture(scope="module")
def road_fleet():
    """The curvature-aware bicycle with road-width and decomp rows (N=8) in
    both packages and 4 problems of tools/bench_matrix.py's road-width
    fleet, moved off the warm start, the decomp rows set to two walls 2 m
    either side."""
    jo, to = _pair("configuration_bicycle", 8, True, True)
    _, P0, x0, z0 = bench_matrix.build_bicycle(
        8, 4, np.random.default_rng(2), road_width=True)
    idx, idx0 = to.registry.save_map(), _road_map()
    P = np.zeros((4, 9, to.npar))
    P0 = np.concatenate([P0, P0[:, -1:]], axis=1)
    for name, i in idx0.items():
        P[..., idx[name]] = P0[..., i]
    for i in range(12):
        name = f"disc_0_decomp_{i}"
        a2, b = (1.0, 2.0) if i == 0 else (-1.0, 2.0) if i == 1 else (0.0,
                                                                    1e3)
        P[..., idx[name + "_a1"]] = 0.0 if i < 2 else 1.0
        P[..., idx[name + "_a2"]] = a2
        P[..., idx[name + "_b"]] = b
    rng = np.random.default_rng(3)
    Z = z0.astype(np.float64) + 0.05 * rng.normal(size=z0.shape)
    return jo, to, P, x0.astype(np.float64), Z


def test_road_width_header_matches_torch_func(host, road_fleet):
    _, to, P, x0, Z = road_fleet
    cfg = tsqp.SQPConfig(regularization="gershgorin", reg_eps=1e-4)
    tables = sqp_fused.ocp_tables(to, cfg)
    kinds = tables.ints[tables.ints[sqp_fused.TB_OFF_H]:][
        :sqp_fused.H_W * to.nh:sqp_fused.H_W]
    assert list(kinds) == ([sqp_fused.HK_ELLIPSOID] * 4
                           + [sqp_fused.HK_ROADWIDTH] * 2
                           + [sqp_fused.HK_DECOMP] * 12)
    assert tables.reals[4] == 0.65 / 2.0  # RT_HALF_WIDTH
    mach = tsqp._make_machinery(to, cfg, F64, "cpu")
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
    # the road-width rows read x, y, the slack input and the spline state
    rows = [r for r, (k, i) in enumerate(to.ineq_row_spec())
            if k == "hu" and i in (4, 5)]
    D = got[0].D[:, :-1][:, :, rows]
    assert (D[..., [2, 3, 4, 8]].abs().sum(dim=(0, 1)) > 0).all()
    assert (D[..., 2] == 1.0).all()  # -(-slack) in D z + e >= 0


def test_road_width_header_matches_jax_lane_linearizer(host, road_fleet):
    jo, to, P, x0, Z = road_fleet
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


def test_road_width_header_solve_matches_fused_reference(host):
    ocp, P, x0, z0 = bench_matrix.build_bicycle(
        8, 4, np.random.default_rng(4), road_width=True)
    cfg = tsqp.SQPConfig(n_sqp=4, n_qp_iter=8, mu_min=1e-6, w_max=1e6,
                         reg_eps=1e-4, regularization="gershgorin",
                         qp_iter_schedule=((2, 5), (2, 8)))
    solve = tsqp.make_fleet_sqp_solver(ocp, cfg, dtype=F64, device="cpu",
                                       backend="fused")
    args = tuple(torch.as_tensor(a, dtype=F64) for a in (P, x0, z0))
    got = solve.host(*args)
    want = solve(*args)
    assert bool((got.success == want.success).all())
    rel = ((got.z - want.z).abs().amax(dim=(1, 2))
           / (1.0 + want.z.abs().amax(dim=(1, 2))))
    assert rel.max().item() <= 1e-6


def test_road_width_without_contouring_is_refused():
    settings = default_settings(N=6, max_obstacles=1)
    mm = ModuleManager()
    base = mm.add_module(MPCBaseModule(settings))
    base.weigh_variable("a", "acceleration")
    base.weigh_variable("w", "angular_velocity")
    mm.add_module(GoalModule(settings))
    mm.add_module(ContouringConstraintModule(settings))
    from oscar_mpc_planner_mr_modification_tpu_torch.models import (
        ContouringSecondOrderUnicycleModel)

    ocp = build_ocp(ContouringSecondOrderUnicycleModel(), mm, settings)
    with pytest.raises(NotImplementedError, match="road-width"):
        sqp_fused.ocp_tables(ocp, tsqp.SQPConfig(regularization="gershgorin"))
