"""The port's contouring evaluator (``parallel/rollout.py``) against the JAX
package's, on the CPU at f64.

- ``make_contouring_rollout`` at N=8, B=4 episodes, 10 ticks, 3 obstacles,
  ``backend="xla"`` on both sides (the plain single-instance solve), at a
  one-phase schedule of 2 SQP iterations (JAX compiles one program per
  schedule phase; this keeps its compile to one): every metric and the
  final state within atol 1e-6, with the default weights and with
  per-episode weights. JAX's evaluator is built once, with per-episode
  weights, and called with the default weights for the first case: its
  fill then writes what the unweighted evaluator's does.
- ``first_tick_params`` equal to JAX's, bit for bit, with and without
  per-episode weights.
- ``"auto"`` resolves to ``"xla"`` on the CPU, also for
  ``constraints="gaussian"`` (BASELINE config 3, held to JAX in
  tests/test_torch_ccmpc.py), whose fused backend builds with one Gaussian
  row per obstacle.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu.ops.sqp import (  # noqa: E402
    SQPConfig as JSQPConfig)
from oscar_mpc_planner_mr_modification_tpu.parallel import (  # noqa: E402
    rollout as jro)
from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (  # noqa: E402
    SQPConfig as TSQPConfig)
from oscar_mpc_planner_mr_modification_tpu_torch.parallel import (  # noqa: E402
    rollout as tro)
from oscar_mpc_planner_mr_modification_tpu_torch.utils import (  # noqa: E402
    default_settings)

N, B, TICKS, N_OBS = 8, 4, 10, 3
WEIGHTS = ("contour", "reference_velocity")
CONFIG = dict(n_sqp=2, n_qp_iter=10, mu_min=1e-8, w_max=1e8, reg_eps=1e-6,
              regularization="gershgorin", track_best=False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def scenes(seed=3):
    """Contouring scenes with obstacles moved close enough to the start
    that the 10 ticks meet them."""
    x0, obs0, vel = tro.contouring_scenes(B, N_OBS, seed=seed)
    obs0 = obs0.astype(np.float64)
    obs0[:, :, 0] = obs0[:, :, 0] * 0.3 + 1.0
    return x0.astype(np.float64), obs0, vel.astype(np.float64)


def weights(default=False):
    if default:  # the settings' weights, which the unweighted fill writes
        w = default_settings(N=N, max_obstacles=N_OBS)["weights"]
        return tuple(np.full(B, float(w[name])) for name in WEIGHTS)
    rng = np.random.default_rng(7)
    return (rng.uniform(0.02, 0.2, B), rng.uniform(1.0, 2.0, B))


@pytest.fixture(scope="module")
def pair():
    """JAX's evaluators (with per-episode weights, run; without, for its
    first tick's buffer) and the port's."""
    kw = dict(n_obstacles=N_OBS, N=N, n_ticks=TICKS, backend="xla")
    jcfg, tcfg = JSQPConfig(**CONFIG), TSQPConfig(**CONFIG)
    j, _ = jro.make_contouring_rollout(dtype=jnp.float64, config=jcfg, **kw)
    t, _ = tro.make_contouring_rollout(dtype=torch.float64, device="cpu",
                                       config=tcfg, **kw)
    jw, _ = jro.make_contouring_rollout(dtype=jnp.float64, config=jcfg,
                                        per_episode_weights=WEIGHTS, **kw)
    tw, _ = tro.make_contouring_rollout(dtype=torch.float64, device="cpu",
                                        config=tcfg,
                                        per_episode_weights=WEIGHTS, **kw)
    return (j, t), (jw, tw)


def assert_metrics_close(got, want):
    for name in want._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=name)


def test_contouring_rollout_matches_jax(pair):
    (_, t), (jw, _) = pair
    args = scenes()
    want = jw(*map(jnp.asarray, args + weights(default=True)))
    got = t(*args)
    assert t.backend == "xla"
    assert_metrics_close(got, want)
    # the scenes are not trivial: the robot moved, the obstacles came near
    assert (got.progress.numpy() > 1.0).all()
    assert got.min_obstacle_dist.min().item() < 1.5
    assert got.solve_success_rate.min().item() > 0.5


def test_first_tick_params_equal_jax(pair):
    (j, t), (jw, tw) = pair
    args = scenes(seed=4)
    np.testing.assert_array_equal(
        t.first_tick_params(*args).numpy(),
        np.asarray(j.first_tick_params(*map(jnp.asarray, args))))
    wts = weights()
    np.testing.assert_array_equal(
        tw.first_tick_params(*args, *wts).numpy(),
        np.asarray(jw.first_tick_params(*map(jnp.asarray, args + wts))))


def test_per_episode_weights_rollout_matches_jax(pair):
    _, (jw, tw) = pair
    args, wts = scenes(seed=5), weights()
    want = jw(*map(jnp.asarray, args + wts))
    got = tw(*args, *wts)
    assert_metrics_close(got, want)
    with pytest.raises(ValueError, match="per-episode weight"):
        tw(*args)


def test_backend_rule_and_gaussian():
    rollout, ocp = tro.make_contouring_rollout(N=4, n_ticks=1,
                                               dtype=torch.float64,
                                               device="cpu")
    assert rollout.backend == "xla"
    assert ocp.nx == 5 and ocp.nu == 2
    fused, _ = tro.make_contouring_rollout(N=4, n_ticks=1, backend="fused",
                                           dtype=torch.float64, device="cpu")
    assert fused.backend == "fused"
    gauss, gocp = tro.make_contouring_rollout(
        N=4, n_ticks=1, constraints="gaussian", backend="auto",
        dtype=torch.float64, device="cpu")
    assert gauss.backend == "xla" and gocp.nh == N_OBS
    gauss, gocp = tro.make_contouring_rollout(
        N=4, n_ticks=1, constraints="gaussian", backend="fused",
        dtype=torch.float64, device="cpu")
    assert gauss.backend == "fused"
    assert gauss.fleet_solve.tables.m == N_OBS + 14
    with pytest.raises(ValueError, match="constraints"):
        tro.make_contouring_rollout(N=4, constraints="box", device="cpu")
