"""The port's single-instance SQP solve (``ops/sqp.py::make_sqp_solver``), its
``"xla"`` fleet backend, ``parallel/batch.py::make_plan_fn`` and the
``"xla"`` / ``"auto"`` T-MPC step, on the CPU at f64.

- The ``contouring_2obs`` golden (tests/golden, made by the JAX package's
  ``make_sqp_solver``): Z within atol 1e-6 and the cost within rtol 1e-8,
  the tolerances JAX holds its own drift to (tests/test_golden.py).
- ``qp_comp`` is the last QP's complementarity; the fleet backends report
  0, as JAX's do.
- Control flow: a schedule equals chained uniform solves (atol 1e-12, as
  tests/test_sqp.py holds JAX); a stale warm start cannot win the best
  iterate; the ``"xla"`` fleet equals per-instance solves.
- ``make_plan_fn`` and ``make_batched_tmpc_step(backend="xla")`` against
  JAX's ``"xla"`` step on ``build_tmpc_fleet`` inputs at N=8: the same
  success mask and selection, trajectories within atol 1e-8 and costs
  within rtol 1e-9.
- ``"auto"`` resolves from the device at build (``"xla"`` on the CPU), and
  ``backend="pallas"`` raises at build on a CUDA device for sizes the QP
  kernel is not compiled for, before it touches the device.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import benchmarks as jbench  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops import sqp as jsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.parallel.batch import (  # noqa: E402
    make_batched_tmpc_step as jax_step)
from oscar_mpc_planner_mr_modification_tpu_torch import benchmarks as tbench  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.factory import (  # noqa: E402
    configuration_basic)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import qp as qp_ip  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops import qp_cuda  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp as tsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.parallel import (  # noqa: E402
    batch as tbatch, rollout as trollout)
from oscar_mpc_planner_mr_modification_tpu_torch.solver import build_ocp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings)

from test_sqp import contouring_setup  # noqa: E402

F64 = torch.float64
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def port_contouring(N, n_obstacles=2):
    """The port's configuration_basic OCP and the inputs of
    tests/test_sqp.py::contouring_setup (numpy, from the JAX OCP's
    parameter map, which the port's equals)."""
    jocp, P, x0, z_init = contouring_setup(N=N, n_obstacles=n_obstacles)
    settings = default_settings(N=N, max_obstacles=n_obstacles)
    ocp = build_ocp(*configuration_basic(settings), settings)
    assert ocp.registry.save_map() == jocp.registry.save_map()
    return ocp, P, x0, z_init


def test_golden_contouring_2obs():
    gold = np.load(os.path.join(GOLDEN, "contouring_2obs.npz"))
    ocp, P, x0, z_init = port_contouring(N=15)
    np.testing.assert_array_equal(P, gold["P"])
    np.testing.assert_array_equal(z_init, gold["z_init"])
    solve = tsqp.make_sqp_solver(
        ocp, tsqp.SQPConfig(n_sqp=30, n_qp_iter=20, mu_min=1e-10),
        dtype=F64, device="cpu")
    res = solve(gold["P"], gold["x0"], gold["z_init"])
    assert res.z.shape == gold["Z"].shape and res.cost.dim() == 0
    assert bool(res.success) and int(res.exit_code) == 1
    np.testing.assert_allclose(res.z.numpy(), gold["Z"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(res.cost), float(gold["cost"]),
                               rtol=1e-8, atol=1e-8)
    host = tsqp.fetch_result_single(res)
    assert isinstance(host.cost, float) and isinstance(host.success, bool)
    assert isinstance(host.exit_code, int) and host.z.shape == (16, 7)
    np.testing.assert_array_equal(host.z, res.z.numpy())


def test_qp_comp_is_the_last_qps_complementarity():
    """``qp_comp`` of the single-instance solve is the last QP's
    complementarity (Solver.solve's ``info["qp_comp"]`` is held against
    JAX's in tests/test_torch_solver_solve.py); the fleet backends report
    0, as the JAX fleet backends do."""
    ocp, P, x0, z_init = port_contouring(N=8)
    cfg = tsqp.SQPConfig(n_sqp=3, n_qp_iter=10, mu_min=1e-9,
                         track_best=False)
    got = tsqp.make_sqp_solver(ocp, cfg, dtype=F64, device="cpu")(P, x0,
                                                                   z_init)
    before = tsqp.make_sqp_solver(ocp, cfg._replace(n_sqp=2), dtype=F64,
                                  device="cpu")(P, x0, z_init)
    mach = tsqp._make_machinery(ocp, cfg, F64, "cpu")
    Pt = torch.as_tensor(np.concatenate([P, P[-1:]]))[None]
    qp = mach.build_qp(before.z[None], Pt, torch.as_tensor(x0)[None])
    last = qp_ip.solve_qp(
        qp_ip.QPData(qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e,
                     torch.as_tensor(mach.stage_mask), qp.r0),
        nu=ocp.nu, n_iters=10, mu_min=1e-9)
    assert float(got.qp_comp) == float(last.comp[0]) > 0.0
    fleet = tsqp.make_fleet_sqp_solver(ocp, cfg, dtype=F64, device="cpu",
                                       backend="xla")(P[None], x0[None],
                                                      z_init[None])
    assert float(fleet.qp_comp[0]) == 0.0
    assert torch.equal(fleet.z[0], got.z)


def test_schedule_equals_chained_uniform_solves():
    """((2, 4), (2, 8)) equals a uniform (2, 4) solve fed into a uniform
    (2, 8) one: the iteration is Markov in z with track_best off."""
    ocp, P, x0, z_init = port_contouring(N=8)
    kw = dict(mu_min=1e-9, w_max=1e14, track_best=False)
    sched = tsqp.make_sqp_solver(
        ocp, tsqp.SQPConfig(qp_iter_schedule=((2, 4), (2, 8)), **kw),
        dtype=F64, device="cpu")
    s1 = tsqp.make_sqp_solver(ocp, tsqp.SQPConfig(n_sqp=2, n_qp_iter=4, **kw),
                              dtype=F64, device="cpu")
    s2 = tsqp.make_sqp_solver(ocp, tsqp.SQPConfig(n_sqp=2, n_qp_iter=8, **kw),
                              dtype=F64, device="cpu")
    res_sched = sched(P, x0, z_init)
    res_chain = s2(P, x0, s1(P, x0, z_init).z)
    np.testing.assert_allclose(res_sched.z.numpy(), res_chain.z.numpy(),
                               rtol=0, atol=1e-12)
    assert bool(res_sched.success)


def test_stale_warmstart_cannot_win_best_iterate():
    """A dynamically consistent warm start from the wrong start point must
    not come back as the solution: the merit counts the initial-condition
    residual."""
    N = 8
    ocp, P, x0, _ = port_contouring(N=N)
    solve = tsqp.make_sqp_solver(ocp, tsqp.SQPConfig(n_sqp=6, n_qp_iter=12),
                                 dtype=F64, device="cpu")
    x_stale = np.array([-5.0, -2.0, 0.0, 0.8, 0.0])
    z_stale = np.zeros((N + 1, ocp.nvar))
    z_stale[0, ocp.nu:] = x_stale
    xk = torch.as_tensor(x_stale)
    for k in range(N):
        xk = ocp.dynamics(xk, torch.zeros(ocp.nu, dtype=F64),
                          torch.as_tensor(P[k]))
        z_stale[k + 1, ocp.nu:] = xk.numpy()
    res = solve(P, x0, z_stale)
    x_start = res.z[0, ocp.nu:ocp.nu + 2].numpy()
    if bool(res.success):
        assert np.linalg.norm(x_start - x0[:2]) < 1e-3, x_start
    else:
        assert float(res.eq_res) > 1e-2


def test_fleet_xla_matches_per_instance():
    """The "xla" fleet (Gershgorin) reproduces per-instance solves: each
    problem as the single-instance solve of the same config, bit for bit,
    and within atol 1e-4 of the mirror solve, as JAX's test holds it."""
    ocp, P, x0, z_init = port_contouring(N=8)
    cfg = tsqp.SQPConfig(n_sqp=8, n_qp_iter=15, mu_min=1e-9)
    ref = tsqp.make_sqp_solver(ocp, cfg, dtype=F64, device="cpu")(P, x0,
                                                                  z_init)
    g_cfg = cfg._replace(regularization="gershgorin")
    fleet = tsqp.make_fleet_sqp_solver(ocp, g_cfg, dtype=F64, device="cpu",
                                       backend="xla")
    P2 = np.stack([P, P * (1.0 + 1e-3)])  # the second problem differs
    out = fleet(P2, np.tile(x0[None], (2, 1)), np.tile(z_init[None], (2, 1, 1)))
    assert bool(out.success.all())
    one = tsqp.make_sqp_solver(ocp, g_cfg, dtype=F64, device="cpu")
    assert torch.equal(out.z[1], one(P2[1], x0, z_init).z)
    assert not torch.equal(out.z[0], out.z[1])
    np.testing.assert_allclose(out.z[0, :-1, :2].numpy(),
                               ref.z[:-1, :2].numpy(), atol=1e-4)


XLA_STEP = dict(n_sqp=6, n_qp_iter=20, mu_min=1e-10,
                regularization="gershgorin", track_best=False)


@pytest.fixture(scope="module")
def tmpc_fleet():
    """The bench OCP of both packages at N=8, 2+1 planners, 2 plans; one
    planner of plan 1 disabled; JAX's "xla" step on it."""
    jo, js = jbench.tmpc_bench_ocp(N=8, n_paths=2)
    to, _ = tbench.tmpc_bench_ocp(N=8, n_paths=2)
    params, xinit, z_init, disabled = jbench.build_tmpc_fleet(
        jo, js, 2, seed=0, dtype=np.float64)
    idx = jo.registry.save_map()
    params[..., idx["consistency_weight"]] = 0.05
    params[..., idx["prev_traj_x"]] = z_init[:, :, :8, jo.model.var_index("x")]
    params[..., idx["prev_traj_y"]] = z_init[:, :, :8, jo.model.var_index("y")]
    disabled = disabled.copy()
    disabled[1, 0] = True
    fleet = (params, xinit, z_init, disabled)
    ref = jax_step(jo, jsqp.SQPConfig(**XLA_STEP), dtype=jnp.float64,
                   backend="xla")(*map(jnp.asarray, fleet))
    return to, fleet, ref


def test_plan_fn_and_xla_step_match_jax(tmpc_fleet):
    to, fleet, ref = tmpc_fleet
    cfg = tsqp.SQPConfig(**XLA_STEP)
    step = tbatch.make_batched_tmpc_step(to, cfg, dtype=F64, device="cpu",
                                         backend="xla")
    assert step.backend == "xla"
    n0 = qp_cuda.launches
    out = step(*fleet)
    assert qp_cuda.launches == n0
    plan = tbatch.make_plan_fn(to, cfg, dtype=F64, device="cpu")
    params, xinit, z_init, disabled = fleet
    plans = [plan(params[b], xinit[b], z_init[b], disabled[b])
             for b in range(2)]
    assert out.all_success.float().mean().item() >= 0.5
    for name in ("all_success", "best_index", "any_success"):
        want = np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(getattr(out, name).numpy(), want)
        for b in range(2):
            np.testing.assert_array_equal(getattr(plans[b], name).numpy(),
                                          want[b])
    for name, tol in (("best_z", dict(rtol=0, atol=1e-8)),
                      ("all_costs", dict(rtol=1e-9)),
                      ("best_cost", dict(rtol=1e-9))):
        want = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(out, name).numpy(), want, **tol)
        for b in range(2):
            np.testing.assert_allclose(getattr(plans[b], name).numpy(),
                                       want[b], **tol)
    assert not bool(out.all_success[1, 0])  # the disabled planner


def test_mirror_regularization_of_a_nan_matrix_is_nan():
    """A Hessian block with a NaN entry comes out NaN, as JAX's eigh gives
    it, where torch.linalg.eigh alone would raise; the others within 1e-12
    of JAX's projection."""
    rng = np.random.default_rng(3)
    M = rng.normal(size=(3, 5, 5))
    H = M + np.swapaxes(M, 1, 2)
    H[1, 2, 3] = H[1, 3, 2] = np.nan
    want = np.asarray(jsqp._mirror_regularize(jnp.asarray(H), 1e-6))
    got = tsqp._mirror_regularize(torch.as_tensor(H), 1e-6).numpy()
    assert np.isnan(got[1]).all() and np.isnan(want[1]).all()
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=0, atol=1e-12)


def test_auto_resolves_from_the_device():
    to, _ = tbench.tmpc_bench_ocp(N=4, n_paths=1)
    cfg = tsqp.SQPConfig(n_sqp=1, n_qp_iter=2)
    step = tbatch.make_batched_tmpc_step(to, cfg, dtype=F64, device="cpu",
                                         backend="auto")
    assert step.backend == "xla"
    assert tbatch.resolve_backend("auto", "cuda") == "pallas"
    assert tbatch.resolve_backend("auto", torch.device("cuda", 0)) == "pallas"
    assert tbatch.resolve_backend("fused", "cpu") == "fused"
    assert trollout._resolve_backend("auto", "cuda") == "fused"
    assert trollout._resolve_backend("auto", "cpu") == "xla"
    with pytest.raises(ValueError, match="n_qp_iter_warm"):
        tsqp.make_fleet_sqp_solver(to, cfg._replace(n_qp_iter_warm=2),
                                   dtype=F64, device="cpu", backend="xla")
    with pytest.raises(ValueError, match="unknown backend"):
        tsqp.make_fleet_sqp_solver(to, cfg, dtype=F64, device="cpu",
                                   backend="auto")


def test_pallas_backend_checks_the_kernel_sizes_at_build(monkeypatch):
    """With no (nx, nu) instantiated, building the per-iteration backend for
    a CUDA device raises ValueError before anything touches the device (on
    this CPU-only build a device touch would raise another error); the CPU
    build, which runs the plain version, still works."""
    to, _ = tbench.tmpc_bench_ocp(N=4, n_paths=1)
    cfg = tsqp.SQPConfig(n_sqp=1, n_qp_iter=2)
    monkeypatch.setattr(qp_cuda, "INSTANTIATED", ())
    with pytest.raises(ValueError, match=r"compiled for \(nx, nu\)"):
        tsqp.make_fleet_sqp_solver(to, cfg, dtype=F64, device="cuda",
                                   backend="pallas")
    with pytest.raises(ValueError, match=r"compiled for \(nx, nu\)"):
        tbatch.make_batched_tmpc_step(to, cfg, dtype=F64, device="cuda",
                                      backend="auto")
    solve = tsqp.make_fleet_sqp_solver(to, cfg, dtype=F64, device="cpu",
                                       backend="pallas")
    assert callable(solve)
