"""The port's T-MPC++ evaluator (``parallel/rollout.py::make_tmpc_rollout``)
and the torch twin of the JAX package's ``jax_signature_vector``, against the
JAX package on the CPU at f64.

- ``make_tmpc_rollout`` at N=8, B=4 episodes x 5 planners (4 guided, 1
  unguided), 6 ticks, 4 obstacles, ``backend="xla"`` on both sides, at a
  one-phase schedule of 2 SQP iterations (JAX compiles one program per
  schedule phase): every metric and the final state within atol 1e-6. The
  scenes are checked free of ties: at every tick of every episode the best
  and the second selection cost part by more than 1e-9 relative, so
  round-off cannot pick another winner on either side.
- ``first_tick_params`` and ``first_tick_seeds`` equal to JAX's, bit for
  bit.
- ``torch_signature_vector`` against ``jax_signature_vector`` (vmapped over
  two batch axes) within 1e-12, and against the port's numpy
  ``signature_batch``.
- ``passing_signature`` takes the first stage of least distance, as JAX's
  ``argmin`` does.
- ``"auto"`` resolves to ``"xla"`` on the CPU; ``"fused"`` builds on the CPU
  (its plain version).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu.guidance.homotopy import (  # noqa: E402
    jax_signature_vector)
from oscar_mpc_planner_mr_modification_tpu.ops.sqp import (  # noqa: E402
    SQPConfig as JSQPConfig)
from oscar_mpc_planner_mr_modification_tpu.parallel import (  # noqa: E402
    rollout as jro)
from oscar_mpc_planner_mr_modification_tpu_torch.guidance.homotopy import (  # noqa: E402
    signature_batch, torch_signature_vector)
from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (  # noqa: E402
    SQPConfig as TSQPConfig)
from oscar_mpc_planner_mr_modification_tpu_torch.parallel import (  # noqa: E402
    rollout as tro)

N, B, TICKS, N_OBS, N_PATHS = 8, 4, 6, 4, 4
SCENE_SEED = 3  # a scene set with no tie at any selection (checked below)
CONFIG = dict(n_sqp=2, n_qp_iter=10, mu_min=1e-8, w_max=1e8, reg_eps=1e-6,
              regularization="gershgorin", track_best=False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    kw = dict(n_obstacles=N_OBS, N=N, n_ticks=TICKS, n_paths=N_PATHS,
              backend="xla")
    j, jocp = jro.make_tmpc_rollout(dtype=jnp.float64,
                                    config=JSQPConfig(**CONFIG), **kw)
    t, tocp = tro.make_tmpc_rollout(dtype=torch.float64, device="cpu",
                                    config=TSQPConfig(**CONFIG), **kw)
    assert (tocp.npar, tocp.nx, tocp.nu) == (jocp.npar, jocp.nx, jocp.nu)
    return j, t


def test_tmpc_rollout_matches_jax(pair):
    j, t = pair
    args = tro.tmpc_scenes(B, N_OBS, seed=SCENE_SEED)
    want = j(*map(jnp.asarray, args))
    t.keep_selection_costs = True
    try:
        got = t(*args)
        sel = t.selection_costs.numpy()
    finally:
        t.keep_selection_costs = False
    assert t.backend == "xla"
    assert sel.shape == (TICKS, B, N_PATHS + 1)
    best2 = np.sort(sel, axis=-1)[..., :2]
    assert np.isfinite(best2).all()
    gap = (best2[..., 1] - best2[..., 0]) / np.abs(best2[..., 0])
    assert gap.min() > 1e-9, f"a selection is a tie: {gap.min():.3e}"
    for name in want._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=name)
    # the scenes are not trivial: the robots moved, guided planners won,
    # and the winning topology switched somewhere
    assert (got.progress.numpy() > 1.0).all()
    assert got.guided_selected_rate.min().item() > 0.5
    assert got.topology_switch_rate.max().item() > 0.0


@pytest.mark.parametrize("seed", [1, SCENE_SEED])
def test_first_tick_params_and_seeds_equal_jax(pair, seed):
    j, t = pair
    args = tro.tmpc_scenes(B, N_OBS, seed=seed)
    jargs = tuple(map(jnp.asarray, args))
    for name in ("first_tick_params", "first_tick_seeds"):
        got = getattr(t, name)(*args).numpy()
        want = np.asarray(getattr(j, name)(*jargs))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_signature_twin_matches_jax():
    rng = np.random.default_rng(0)
    paths = rng.normal(size=(3, 5, 12, 2))
    obs = rng.normal(size=(4, 12, 2))
    sig = jax.vmap(jax.vmap(jax_signature_vector, (0, None)), (0, None))
    want = np.asarray(sig(jnp.asarray(paths), jnp.asarray(obs)))
    got = torch_signature_vector(torch.as_tensor(paths), torch.as_tensor(obs))
    assert got.shape == (3, 5, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), signature_batch(paths[1], obs),
                               rtol=0, atol=1e-12)
    # one path, no batch axis
    np.testing.assert_allclose(
        torch_signature_vector(torch.as_tensor(paths[0, 0]),
                               torch.as_tensor(obs)).numpy(), want[0, 0],
        rtol=0, atol=1e-12)


def test_passing_signature_takes_the_first_closest_stage():
    # one trajectory, one obstacle at the origin: stages 1 and 2 are equally
    # close (above and below); the first decides
    pos = torch.tensor([[[[0.0, 3.0], [0.0, 1.0], [0.0, -1.0],
                          [0.0, -3.0]]]], dtype=torch.float64)
    centers = torch.zeros((1, 4, 1, 2), dtype=torch.float64)
    assert tro.passing_signature(pos, centers).tolist() == [[[1.0]]]
    assert tro.passing_signature(pos.flip(2), centers).tolist() == [[[-1.0]]]


def test_tmpc_backend_rule():
    rollout, ocp = tro.make_tmpc_rollout(N=4, n_ticks=1, dtype=torch.float64,
                                         device="cpu")
    assert rollout.backend == "xla"
    assert (ocp.nx, ocp.nu) == (5, 2)
    fused, _ = tro.make_tmpc_rollout(N=4, n_ticks=1, backend="fused",
                                     dtype=torch.float64, device="cpu")
    assert fused.backend == "fused"
    m = fused(*tro.tmpc_scenes(2, N_OBS, seed=0))
    assert m.final_state.shape == (2, 5)
    assert torch.isfinite(m.final_state).all()
