"""The default regularization, "mirror", on the port's lane path, against
the JAX package on the CPU at float64.

- The linearize entry's mirror variant (``csrc/sqp_linearize_mirror.cu``'s
  per-problem code, ``tmpc_ocp.cuh::linearize_stage`` with MIRROR, compiled
  for the host and run as the entry's lane group:
  ``sqp_fused.host_linearize(..., lanes=True)`` on tables of
  ``REG_MIRROR``) against JAX's ``_make_machinery(..., "mirror").build_qp``
  (vmapped; its ``eigh``), for the bench OCP, the goal OCP, the SH-MPC
  slack model (nz=8) and the bicycle (nz=9): H within 1e-10 (1 + |H|),
  every other field within 1e-12 (1 + |ref|) (the generic D rows and e at
  stage N are the kernel's masked placeholders and are left out); a problem
  with a NaN cost weight at one stage has that stage's H block all NaN, in
  both packages, and every other block equal to the same problem's without
  the NaN. The entry's serial host form equals its lane form. The entry's
  block design (``csrc/mirror_block.cuh``: a stage per lane group, row jets,
  the parallel-ordered Jacobi; ``host_linearize(..., block=True)``, its
  block's threads run in turn) is held to JAX at the same tolerances, the
  same NaN stage and floor, and equals the lane form bit for bit on every
  field but H (the same values, and derivatives along one direction).
- The block design's Jacobi alone (``sqp_fused.host_mirror_jacobi``)
  against ``numpy.linalg.eigh`` on seeded symmetric blocks of n = 1..9:
  random ones, repeated eigenvalues, a zero block, eigenvalues below
  reg_eps; a block with a NaN or an infinite entry comes out all NaN.
- ``backend="lanes"`` under "mirror" on the CPU (the plain versions: the
  linearization with ``torch.linalg.eigh``, then the QP kernel's plain
  field entry) against JAX's per-iteration iteration under "mirror" (its
  ``build_qp``, the program compiled for the goal case above, then the QP
  kernel's algorithm, the full step kept back where it is NaN) on the goal
  OCP, N=6, 4 problems, one phase of 3 SQP x 6 IP iterations: Z within
  1e-8 (1 + max|Z|); and against the port's ``"pallas"`` backend at the
  same inputs, to the same tolerance and with the same success. No kernel
  is launched. The QP kernel's algorithm runs as its plain twin
  (``qp_cuda.ip_solve_reference``), which ``tests/test_torch_qp_kernel.py``
  and ``tests/test_torch_lanes.py`` hold to JAX's Pallas kernel in
  interpret mode: the interpreted kernel takes 40-70 s to prepare even at
  N=4, more than this file's whole budget.

JAX's linearization programs are compiled without XLA's backend
optimizations: each runs once, and compiling them is most of this file's
time.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu.ops import sqp as jsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.parallel import (  # noqa: E402
    rollout as jro)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import (  # noqa: E402
    qp_cuda, sqp_fused)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp as tsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.tools import (  # noqa: E402
    bench_matrix)

from test_torch_bicycle import bicycle_pair  # noqa: E402
from test_torch_goal import goal_tracking_setup  # noqa: E402
from test_torch_lanes import _lane_inputs  # noqa: E402
from test_torch_shmpc import random_problems, shmpc_ocp  # noqa: E402

F64 = torch.float64
N = 6
MIRROR = dict(regularization="mirror", reg_eps=1e-4)
#: The stage whose iterate gets a NaN in the NaN problem.
NAN_STAGE = 2
H_RTOL, FIELD_RTOL, Z_RTOL = 1e-10, 1e-12, 1e-8
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def host():
    if qp_cuda.host_compiler() is None:
        pytest.skip("no C++ compiler to build csrc/tmpc_ocp_host.cpp")
    qp_cuda.build_host()


def _goal(B, seed):
    """The goal OCP of both packages (MPCBase, goal, 3 ellipsoids; N) and B
    problems at the JAX suite's goal-tracking scene, iterates moved off the
    start."""
    to, P1, x1, z1 = goal_tracking_setup(N=N)
    jo, _ = jro._goal_ellipsoid_ocp(3, N)
    rng = np.random.default_rng(seed)
    Z = z1[None] + 0.3 * rng.normal(size=(B,) + z1.shape)
    P = np.tile(np.concatenate([P1, P1[-1:]])[None], (B, 1, 1))
    x0 = np.tile(x1[None], (B, 1)) + 0.01 * rng.normal(size=(B, to.nx))
    return jo, to, P, x0, Z


def _problems(name):
    """(jax ocp, port ocp, P (3, T, npar) with stage N repeating N-1, x0,
    Z), f64 numpy, at N."""
    if name == "bench":
        jo, to, (Pf, x0, Z), _ = _lane_inputs(N=N, batch=1)
        P = np.concatenate([Pf, Pf[:, -1:]], axis=1)
        return jo, to, P[:3], x0[:3], Z[:3]
    if name == "goal":
        return _goal(3, seed=5)
    if name == "shmpc":
        to = shmpc_ocp("torch", N=N)
        return (shmpc_ocp("jax", N=N), to,
                *(a.numpy() for a in random_problems(to, 3, seed=21)))
    ocp, P, x0, z0 = bench_matrix.build_bicycle(N, 3,
                                                np.random.default_rng(3))
    jo, to = bicycle_pair(N)
    P = np.concatenate([P, P[:, -1:]], axis=1).astype(np.float64)
    Z = z0.astype(np.float64) + 0.05 * np.random.default_rng(4).normal(
        size=z0.shape)
    return jo, to, P, x0.astype(np.float64), Z


_BUILD_QP = {}


def _jax_build_qp(name, jo, P, x0, Z):
    """JAX's vmapped ``build_qp`` under "mirror" for ``name``'s OCP,
    compiled once for these shapes (4 problems) and kept for the file."""
    if name not in _BUILD_QP:
        mach = jsqp._make_machinery(jo, jsqp.SQPConfig(**MIRROR), jnp.float64)
        args = tuple(map(jnp.asarray, (Z, P, x0)))
        _BUILD_QP[name] = jax.jit(jax.vmap(mach.build_qp)).lower(
            *args).compile(compiler_options=FAST_XLA)
    return _BUILD_QP[name]


def _close(a, b, rtol, name):
    err = np.abs(a - b) / (1.0 + np.abs(b))
    assert np.array_equal(np.isnan(a), np.isnan(b)), name
    assert np.nanmax(err) <= rtol, (name, np.nanmax(err))


_OCPS = ("bench", "goal", "shmpc", "bicycle")


@pytest.mark.parametrize(
    "name,design", [(n, "warp") for n in _OCPS]
    + [(n, "block") for n in _OCPS],
    ids=list(_OCPS) + [f"{n}-block" for n in _OCPS])
def test_mirror_linearization_matches_jax_build_qp(host, name, design):
    jo, to, P, x0, Z = _problems(name)
    T = N + 1
    # problem 3: problem 0 with a NaN acceleration weight at stage NAN_STAGE
    P, x0, Z = (np.concatenate([a, a[:1]]) for a in (P, x0, Z))
    P[3, NAN_STAGE, to.registry.index("acceleration")] = np.nan
    tables = sqp_fused.ocp_tables(to, tsqp.SQPConfig(**MIRROR), mirror=True)
    assert tables.reg == sqp_fused.REG_MIRROR
    lanes = sqp_fused.host_linearize(tables, P, x0, Z, lanes=True)
    if design == "warp":
        got = lanes
        serial = sqp_fused.host_linearize(tables, P, x0, Z)
        for a, b in zip((*got[0], *got[1:]), (*serial[0], *serial[1:])):
            assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    else:
        got = sqp_fused.host_linearize(tables, P, x0, Z, block=True)
        names = tsqp.QPData._fields + ("merit", "cost", "eq_res")
        for field, a, b in zip(names, (*got[0], *got[1:]),
                               (*lanes[0], *lanes[1:])):
            if field != "H":
                assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)), field

    want = _jax_build_qp(name, jo, P, x0, Z)(*map(jnp.asarray, (Z, P, x0)))

    ok = slice(0, 3)
    for field in ("H", "g", "A", "B", "c", "D", "e", "r0"):
        a = getattr(got[0], field).numpy()[ok]
        b = np.asarray(getattr(want, field))[ok]
        if field in ("D", "e"):  # the stage-N placeholders are the kernel's
            a, b = a[:, :-1], b[:, :-1]
        assert a.shape == b.shape, field
        _close(a, b, H_RTOL if field == "H" else FIELD_RTOL, f"{name} {field}")
    H = got[0].H.numpy()
    w = np.linalg.eigvalsh(H[ok])
    assert w.min() >= 1e-4 * (1 - 1e-9)  # V max(|w|, eps) V^T

    Hn, Hj = H[3], np.asarray(want.H)[3]
    assert np.isnan(Hn[NAN_STAGE]).all() and np.isnan(Hj[NAN_STAGE]).all()
    others = [t for t in range(T) if t != NAN_STAGE]
    np.testing.assert_array_equal(Hn[others], H[0][others])


def test_lanes_backend_under_mirror_matches_jax_per_iteration_path(host):
    jo, to, P, x0, Z = _goal(4, seed=9)
    cfg = dict(n_sqp=3, n_qp_iter=6, mu_min=1e-6, w_max=1e6, **MIRROR)
    # JAX's per-iteration iteration (ops/sqp.py's fleet "pallas" path
    # without track_best): its build_qp, the QP kernel's algorithm, the
    # full step kept back where it is NaN.
    build_qp = _jax_build_qp("goal", jo, P, x0, Z)
    mach = tsqp._make_machinery(to, tsqp.SQPConfig(**cfg), F64, "cpu")
    kw = dict(nu=to.nu, n_iters=cfg["n_qp_iter"], mu_min=cfg["mu_min"],
              w_max=cfg["w_max"], row_meta=mach.row_meta)
    Zj = Z
    for _ in range(cfg["n_sqp"]):
        qp = [torch.as_tensor(np.asarray(f)) for f in build_qp(
            *map(jnp.asarray, (Zj, P, x0)))]
        H, g, A, B, c, D, e, _, r0 = qp
        dz = qp_cuda.ip_solve_reference(H, g, A, B, c, D, e,
                                         mach.stage_mask, r0, **kw).numpy()
        step = Zj + dz
        Zj = np.where(np.isnan(step).any(axis=(1, 2), keepdims=True), Zj,
                      step)
    n0 = sum(_counts().values())
    out = {b: tsqp.make_fleet_sqp_solver(
        to, tsqp.SQPConfig(track_best=False, **cfg), dtype=F64,
        device="cpu", backend=b)(P[:, :-1], x0, Z)
        for b in ("lanes", "pallas")}
    assert sum(_counts().values()) == n0
    lanes, pallas = out["lanes"], out["pallas"]
    assert lanes.success.float().mean().item() >= 0.5
    np.testing.assert_array_equal(lanes.success.numpy(),
                                  pallas.success.numpy())
    for ref in (Zj, pallas.z.numpy()):
        assert np.abs(lanes.z.numpy() - ref).max() <= Z_RTOL * (
            1.0 + np.abs(ref).max())


def _counts():
    return dict(qp=qp_cuda.launches, lanes=qp_cuda.lanes_launches,
                lin=sqp_fused.linearize_launches,
                mirror=sqp_fused.mirror_launches,
                merit=sqp_fused.merit_launches)


def _symmetric(rng, w):
    """Q diag(w) Q^T for a seeded orthogonal Q."""
    Q, _ = np.linalg.qr(rng.normal(size=(len(w), len(w))))
    A = (Q * np.asarray(w, dtype=np.float64)) @ Q.T
    return 0.5 * (A + A.T)


@pytest.mark.parametrize("n", range(1, 10))
def test_block_jacobi_matches_numpy_eigh(host, n):
    eps = MIRROR["reg_eps"]
    rng = np.random.default_rng(100 + n)
    half = (n + 1) // 2
    blocks = [
        _symmetric(rng, rng.normal(scale=3.0, size=n)),   # random
        _symmetric(rng, np.repeat([2.5, -1.0], n)[:n]),   # repeated
        _symmetric(rng, [4.0] * n),                        # one eigenvalue
        np.zeros((n, n)),                                   # zero block
        _symmetric(rng, [1e-6, -3e-5] * half)[:n, :n] if n > 1
        else np.array([[-3e-5]]),                          # below reg_eps
        _symmetric(rng, np.concatenate([[1e-7, -2.0], rng.normal(size=n)])[:n]),
        _symmetric(rng, rng.normal(size=n) * 1e3),
    ]
    nan_block, inf_block = blocks[0].copy(), blocks[0].copy()
    nan_block[n - 1, 0] = nan_block[0, n - 1] = np.nan
    inf_block[n // 2, n // 2] = np.inf
    H = np.stack(blocks + [nan_block, inf_block])
    got = sqp_fused.host_mirror_jacobi(H, eps)
    for k, A in enumerate(blocks):
        w, V = np.linalg.eigh(A)
        want = (V * np.maximum(np.abs(w), eps)) @ V.T
        scale = 1.0 + np.abs(A).max()
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-12 * scale,
                                   err_msg=f"block {k}")
        assert np.linalg.eigvalsh(got[k]).min() >= eps * (1 - 1e-9), k
    assert np.isnan(got[-2]).all() and np.isnan(got[-1]).all()
