"""The port's T-MPC++ fleet step as a whole against the JAX package (CPU, f64).

The port solves each SQP iteration's QPs with the kernel's algorithm (freeze
on complementarity and residuals at 1e-5, last iterate returned). The JAX
``backend="xla"`` solver uses ``ops/qp.py::solve_qp`` (a stationarity term in
its freeze at 10 mu_min, best-iterate tracking), so the two agree where the
QPs converge: the comparison runs converged QP solves, at atol 1e-4 on the
selected trajectories and rtol 1e-5 on their costs. Against the JAX
per-iteration Pallas path (the same algorithm, interpret mode) the match is
to round-off.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import benchmarks as jbench  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops.sqp import (  # noqa: E402
    SQPConfig as JaxSQPConfig)
from oscar_mpc_planner_mr_modification_tpu.parallel.batch import (  # noqa: E402
    make_batched_tmpc_step as jax_step)
from oscar_mpc_planner_mr_modification_tpu_torch import benchmarks as tbench  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops import qp_cuda  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import SQPConfig  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.parallel.batch import (  # noqa: E402
    make_batched_tmpc_step, to_torch_fleet)

F64 = torch.float64
BENCH_SCHEDULE = ((1, 3), (1, 5), (2, 8))


def _fleet(N, batch, seed=0):
    """Bench OCPs of both packages and one f64 fleet for both. Each planner
    carries a consistency cost toward its own warm start (weight 0.05), as the
    T-MPC optimizer sets it, so that planners differ in cost and the per-plan
    argmin is decided by more than round-off."""
    jo, js = jbench.tmpc_bench_ocp(N=N, n_paths=2)
    to, _ = tbench.tmpc_bench_ocp(N=N, n_paths=2)
    params, xinit, z_init, disabled = jbench.build_tmpc_fleet(
        jo, js, batch, seed=seed, dtype=np.float64)
    idx = jo.registry.save_map()
    params[..., idx["consistency_weight"]] = 0.05
    params[..., idx["prev_traj_x"]] = z_init[:, :, :N, jo.model.var_index("x")]
    params[..., idx["prev_traj_y"]] = z_init[:, :, :N, jo.model.var_index("y")]
    return jo, to, (params, xinit, z_init, disabled)


def test_fleet_builders_identical():
    """build_tmpc_fleet gives identical arrays in both packages (seed 0), and
    to_torch_fleet carries them over unchanged."""
    jo, js = jbench.tmpc_bench_ocp(N=8, n_paths=2)
    to, ts = tbench.tmpc_bench_ocp(N=8, n_paths=2)
    ours = tbench.build_tmpc_fleet(to, ts, 3, seed=0)
    theirs = jbench.build_tmpc_fleet(jo, js, 3, seed=0)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tensors = to_torch_fleet(*ours, device="cpu", dtype=F64)
    for a, t in zip(ours, tensors):
        assert t.dtype == (torch.bool if a.dtype == bool else F64)
        np.testing.assert_array_equal(t.numpy(), a.astype(t.numpy().dtype))


def test_fleet_step_matches_jax_xla_backend():
    """N=8, 2+1 planners, B=2, f64, converged QP solves (8 SQP iterations of
    20 IP iterations, mu_min 1e-10, Gershgorin shift, last iterate)."""
    jo, to, fleet = _fleet(N=8, batch=2)
    kw = dict(n_sqp=8, n_qp_iter=20, mu_min=1e-10,
              regularization="gershgorin", track_best=False)
    ref = jax_step(jo, JaxSQPConfig(**kw), dtype=jnp.float64,
                   backend="xla")(*map(jnp.asarray, fleet))
    launches = qp_cuda.launches
    out = make_batched_tmpc_step(to, SQPConfig(**kw), dtype=F64,
                                 device="cpu")(*fleet)
    assert qp_cuda.launches == launches  # the CPU path launches no kernel
    # Failure paths are not what gets compared: most planners succeed.
    assert out.all_success.float().mean().item() >= 0.5
    np.testing.assert_array_equal(out.all_success.numpy(),
                                  np.asarray(ref.all_success))
    np.testing.assert_array_equal(out.best_index.numpy(),
                                  np.asarray(ref.best_index))
    np.testing.assert_allclose(out.best_z.numpy(), np.asarray(ref.best_z),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.best_cost.numpy(), np.asarray(ref.best_cost),
                               rtol=1e-5)
    assert out.best_z.dtype == F64 and out.any_success.all()


def test_fleet_step_selection_semantics():
    """Disabled planners are never selected; a plan with every planner
    disabled reports no success, cost inf and index 0."""
    _, to, (params, xinit, z_init, disabled) = _fleet(N=4, batch=2)
    disabled = disabled.copy()
    disabled[0, 2] = True
    disabled[1, :] = True
    cfg = SQPConfig(n_sqp=2, n_qp_iter=6, mu_min=1e-6, w_max=1e6,
                    regularization="gershgorin", track_best=False)
    out = make_batched_tmpc_step(to, cfg, dtype=F64, device="cpu")(
        params, xinit, z_init, disabled)
    assert int(out.best_index[0]) != 2
    assert not bool(out.any_success[1]) and int(out.best_index[1]) == 0
    assert np.isinf(out.all_costs[1].numpy()).all()
    assert out.best_z.shape == (2, 5, to.nvar)


@pytest.mark.slow
def test_fleet_step_matches_jax_pallas_interpret():
    """N=3 at the bench operating point (schedule 1x3+1x5+2x8, Gershgorin,
    last iterate) against the JAX per-iteration Pallas path in interpret
    mode: the same algorithm, so atol 1e-8."""
    jo, to, fleet = _fleet(N=3, batch=1)
    kw = dict(n_sqp=4, n_qp_iter=8, mu_min=1e-6, w_max=1e6, reg_eps=1e-4,
              regularization="gershgorin", track_best=False,
              qp_iter_schedule=BENCH_SCHEDULE)
    ref = jax_step(jo, JaxSQPConfig(**kw), dtype=jnp.float64, backend="pallas",
                   interpret=True)(*map(jnp.asarray, fleet))
    out = make_batched_tmpc_step(to, SQPConfig(**kw), dtype=F64,
                                 device="cpu")(*fleet)
    np.testing.assert_array_equal(out.best_index.numpy(),
                                  np.asarray(ref.best_index))
    np.testing.assert_allclose(out.all_costs.numpy(), np.asarray(ref.all_costs),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(out.best_z.numpy(), np.asarray(ref.best_z),
                               rtol=0, atol=1e-8)


@pytest.mark.slow
def test_golden_contouring_2obs_through_port():
    """The frozen f64 golden (JAX solve_qp SQP) through the port's fleet
    solver: Z atol 1e-4 and cost rtol 1e-5, the tolerances of the JAX suite's
    own Pallas-vs-XLA check (the freeze rules differ)."""
    import os

    from oscar_mpc_planner_mr_modification_tpu_torch.factory import (
        configuration_basic)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        make_fleet_sqp_solver)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import build_ocp
    from oscar_mpc_planner_mr_modification_tpu_torch.utils import (
        default_settings)

    gold = np.load(os.path.join(os.path.dirname(__file__), "golden",
                                "contouring_2obs.npz"))
    settings = default_settings(N=15, max_obstacles=2)
    ocp = build_ocp(*configuration_basic(settings), settings)
    solve = make_fleet_sqp_solver(
        ocp, SQPConfig(n_sqp=30, n_qp_iter=20, mu_min=1e-10), dtype=F64,
        device="cpu")
    res = solve(gold["P"][None], gold["x0"][None], gold["z_init"][None])
    assert bool(res.success[0])
    np.testing.assert_allclose(res.z[0].numpy(), gold["Z"], atol=1e-4)
    np.testing.assert_allclose(float(res.cost[0]), float(gold["cost"]),
                               rtol=1e-5)
