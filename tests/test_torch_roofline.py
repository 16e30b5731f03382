"""The port's roofline module (kernel B3's plain version, the FLOP constants,
the bound helper) and the field lists the two packages share.

- ``fma_roof_reference`` against a float64 numpy recurrence with the same
  f32 constants: the plain version rounds twice per step, so after 256
  steps it may be about 256 * 2 * 2^-24 = 3e-5 off in relative terms (rtol
  3e-5, atol 1e-6 for values near 0). The CUDA kernel (one rounding per
  step) is held against the plain version on the card by ``chip_smoke.py``.
- ``fma_roof_emulated`` (the kernel's rounding, which ``chip_smoke.py``
  holds the kernel to within 1 ULP) against exact rational arithmetic
  rounded to f32 once per step.
- ``ALGO_FLOPS_PER_PROBLEM`` is a copy of the JAX bench's constant (pinned
  against XLA cost analysis by ``tests/test_roofline_accounting.py``);
  ``ip_iter_flops``, the hand count of one interior-point iteration of the
  QP kernels, against ``csrc/qp_ip_count.cpp`` (the kernels' header compiled
  for the host with a counting scalar type), exactly but for the
  data-dependent fraction-to-boundary ratios, on small QPs and on the bench
  QPs, where it gives ``IP_ITER_FLOPS``; ``LIN_FLOPS`` against XLA cost
  analysis of the JAX lane linearizer and lane merit at the bench shape
  (10%).
- ``SQPConfig`` and ``SQPResult`` have the JAX fields in the JAX order, so a
  config built positionally means the same in both packages.
"""

import ctypes
import functools
import os
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu.ops import sqp as jsqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops import (  # noqa: E402
    qp_cuda, roofline, sqp_fused)
from oscar_mpc_planner_mr_modification_tpu_torch.ops import sqp as tsqp  # noqa: E402

from test_qp import random_qp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_fma_reference_matches_numpy_recurrence():
    x = np.random.default_rng(0).standard_normal((8, 16, 64)).astype(np.float32)
    a = float(np.float32(roofline.FMA_A))
    b = float(np.float32(roofline.FMA_B))
    want = x.astype(np.float64)
    for _ in range(roofline.FMA_STEPS):
        want = want * a + b
    got = roofline.fma_roof_reference(torch.as_tensor(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=1e-6)
    # The recurrence moves most elements; in f32 some sit at a fixed point.
    assert (got.numpy() != x).mean() > 0.5


def _round_f32(q: Fraction) -> np.float32:
    """q rounded to the nearest float32, ties to even."""
    f = np.float32(float(q))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - q),
                                     int(c.view(np.int32)) & 1))


def test_fma_emulation_rounds_once_per_step():
    x = np.random.default_rng(2).standard_normal(48).astype(np.float32)
    x[:3] = (0.0, 1e-30, -1.0)  # zero, below the exact range, fixed point
    a, b = (Fraction(float(np.float32(v))) for v in (roofline.FMA_A,
                                                      roofline.FMA_B))
    want = []
    for v in x:
        y = np.float32(v)
        for _ in range(roofline.FMA_STEPS):
            y = _round_f32(Fraction(float(y)) * a + b)
        want.append(y)
    got = roofline.fma_roof_emulated(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.array(want, dtype=np.float32))
    plain = roofline.fma_roof_reference(torch.as_tensor(x)).numpy()
    assert (plain != got).any()  # two roundings per step part from one


def test_fma_roof_wrapper_on_cpu():
    x = torch.randn(8, 256, 4, generator=torch.Generator().manual_seed(1))
    n0 = roofline.launches
    assert torch.equal(roofline.fma_roof(x), roofline.fma_roof_reference(x))
    assert roofline.launches == n0  # the CPU path launches no kernel
    with pytest.raises(TypeError, match="float32"):
        roofline.fma_roof(x.double())
    with pytest.raises(ValueError, match="multiple of 2048"):
        roofline.fma_roof(torch.zeros(8, 255))
    assert roofline.fma_flops(x.numel()) == 2 * 256 * x.numel()


def test_bound_ms_picks_the_larger_time():
    ms, by = roofline.bound_ms(67e12 * 2e-3, 1.0)
    assert by == "operations" and ms == pytest.approx(2.0)
    ms, by = roofline.bound_ms(1.0, 3.35e12 * 5e-3)
    assert by == "bytes" and ms == pytest.approx(5.0)
    assert roofline.tensor_bytes(torch.zeros(3, 4), torch.zeros(2,
                                 dtype=torch.float64)) == 64


def test_algo_flops_is_the_jax_bench_constant():
    import bench

    assert roofline.ALGO_FLOPS_PER_PROBLEM == bench.ALGO_FLOPS_PER_PROBLEM


@pytest.fixture(scope="module")
def count_lib(tmp_path_factory):
    """``csrc/qp_ip_count.cpp``: the QP kernels' interior-point code compiled
    for the host with a scalar type that counts its operations."""
    cxx = sqp_fused.host_compiler()
    assert cxx is not None, "no C++ compiler found (set CXX)"
    out = tmp_path_factory.mktemp("count") / "libqp_ip_count.so"
    src = qp_cuda._CSRC / "qp_ip_count.cpp"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
                    str(out), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.qp_ip_count_ops.argtypes = [ptr] * 11 + [i32] * 6 + [f64] * 7 + [ptr]
    lib.qp_ip_count_ops.restype = None
    return lib


def _count_ops(lib, qp, row_mask, row_meta, nu, n_iters):
    """Operations by kind (+/-, *, /, negation, sqrt) of the header's solve
    of the one problem in ``qp`` (batch-major f64 tensors, batch 1)."""
    _, T, nz = qp.g.shape
    m = qp.D.shape[2]
    rows = qp_cuda._rows(row_mask, row_meta, T, m, nz)
    fields = qp_cuda._batch_fields(qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e,
                                   qp.r0, rows)
    mask, table, pairs = qp_cuda._row_tables(
        (rows.row_meta, rows.stage_mask.tobytes(), rows.active), T, m,
        torch.float64, "cpu")
    out = np.zeros(5, dtype=np.int64)
    lib.qp_ip_count_ops(
        *[t.data_ptr() for t in (*fields, mask, table, pairs)], T, nz - nu,
        nu, m, fields.D.shape[0] // (T * nz), n_iters, 1e2, 1e-6, 0.995, 1e6,
        1e-10, 1e-5, rows.n_act, out.ctypes.data)
    return out


def _check_iteration_count(lib, qp, row_mask, row_meta, nx, nu):
    """One iteration's count (3 iterations less 2) against the hand count:
    equal but for the fraction-to-boundary ratios, each a negation and a
    division, at most 4 per unmasked entry of an active row."""
    it = (_count_ops(lib, qp, row_mask, row_meta, nu, 3)
          - _count_ops(lib, qp, row_mask, row_meta, nu, 2))
    hand = roofline.ip_iter_flops(row_meta, row_mask, nx, nu)
    # negations every iteration runs: the SPD inverse's (2 for nu == 2),
    # -K in the factorization and -kff in both vector sweeps, per stage
    hand_neg = (len(row_mask) - 1) * (2 * (nu == 2) + nu * nx + 2 * nu)
    ratios = int(it[3]) - hand_neg
    mask = np.asarray(row_mask) > 0
    assert it[4] == 0 and 0 <= ratios <= 4 * mask[:, mask.any(0)].sum()
    assert int(it[:4].sum()) == hand + 2 * ratios, (it, hand, ratios)
    return hand


@pytest.mark.parametrize("nx,nu", [(5, 2), (3, 1), (4, 3)])
def test_ip_iteration_flops_match_the_kernel_count(count_lib, nx, nu):
    """Generic and box rows, a masked stage, an inactive row, nu 1 to 3."""
    T, m = 6, 5
    raw = random_qp(nx + 10 * nu, T=T, nx=nx, nu=nu, m=m)[1]
    qp = tsqp.QPData(*[torch.as_tensor(np.asarray(x))[None] for x in raw[:7]],
                torch.as_tensor(np.asarray(raw[8]))[None])
    row_meta = (("h", 0), ("box", 1, 1.0), ("h", 2), ("box", 0, -1.0),
                ("box", 2, 1.0))
    row_mask = np.asarray(raw[7]).copy()
    row_mask[0, 1] = 0.0
    row_mask[:, 4] = 0.0  # inactive
    _check_iteration_count(count_lib, qp, row_mask, row_meta, nx, nu)


def test_ip_iteration_flops_at_the_bench_qp(count_lib):
    """IP_ITER_FLOPS is the hand count at the bench OCP's rows and mask, and
    the header's own count on each of the bench fleet's first 9 QPs."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        _make_machinery)
    from oscar_mpc_planner_mr_modification_tpu_torch.tools.common import (
        bench_config, bench_fleet)

    ocp, (params, xinit, z_init, _) = bench_fleet(1, torch.float64, "cpu")
    mach = _make_machinery(ocp, bench_config(), torch.float64, "cpu")
    P = torch.cat([params[0], params[0][:, -1:]], dim=1)
    qp = mach.build_qp(z_init[0], P, xinit.expand(P.shape[0], -1))
    nx = qp.A.shape[-1]
    for b in range(P.shape[0]):
        one = tsqp.QPData(*(x[b:b + 1] for x in qp))
        hand = _check_iteration_count(count_lib, one, mach.stage_mask,
                                      mach.row_meta, nx, mach.nu)
    assert roofline.IP_ITER_FLOPS == hand


def test_linearization_flops_match_cost_analysis():
    """The lane linearizer plus the lane merit of the JAX package at the
    bench shape (N=20, the bench OCP), f32, 16 problems, every scan
    unrolled."""
    from oscar_mpc_planner_mr_modification_tpu.benchmarks import (
        build_tmpc_fleet, tmpc_bench_ocp)
    from oscar_mpc_planner_mr_modification_tpu.ops import linearize as jlin

    B, N = 16, 20
    ocp, settings = tmpc_bench_ocp(N=N, n_paths=8)
    params, xinit, z_init, _ = build_tmpc_fleet(ocp, settings, 2,
                                                dtype=np.float32)
    P = np.concatenate([params, params[:, :, -1:]], axis=2)
    cols = (np.transpose(P.reshape(-1, N + 1, P.shape[-1])[:B], (2, 1, 0)),
            np.transpose(z_init.reshape(-1, N + 1, z_init.shape[-1])[:B],
                         (1, 2, 0)),
            np.repeat(xinit, params.shape[1], axis=0)[:B].T)
    cols = [jnp.asarray(np.ascontiguousarray(x)) for x in cols]
    cfg = jsqp.SQPConfig(mu_min=1e-6, w_max=1e6, reg_eps=1e-4,
                         regularization="gershgorin")
    scan = jax.lax.scan
    jax.lax.scan = functools.partial(scan, unroll=True)
    try:
        flops = 0.0
        for make in (jlin.make_lane_linearizer, jlin.make_lane_merit):
            ca = jax.jit(make(ocp, cfg, jnp.float32)).lower(
                *cols).compile().cost_analysis()
            flops += float((ca[0] if isinstance(ca, list) else ca)["flops"])
    finally:
        jax.lax.scan = scan
    assert roofline.LIN_FLOPS == pytest.approx(flops / B, rel=0.10), (
        roofline.LIN_FLOPS, flops / B)


def test_sqp_flops_count_linearizations_and_ip_iterations():
    sched = ((1, 3), (1, 5), (2, 8))
    want = 4 * roofline.LIN_FLOPS + 24 * roofline.IP_ITER_FLOPS
    assert roofline.sqp_flops(10, sched) == pytest.approx(10 * want)
    assert roofline.ip_flops(10, 8) == pytest.approx(80 * roofline.IP_ITER_FLOPS)
    assert roofline.sqp_flops(1, sched) > 2 * roofline.ALGO_FLOPS_PER_PROBLEM
    # T=2, nx=1, nu=1, m=1, no generic row (one D slot): H 2*3 + g 2*2 +
    # A, B, c 3 + D 2*2 + e 2 + r0 1 + z 2*2 = 24 fields per problem, plus
    # 2 for each multiplier array.
    assert roofline.qp_bytes(2, 1, 1, 1, 0, 4, 8) == 24 * 4 * 8
    assert roofline.qp_bytes(2, 1, 1, 1, 0, 1, 4, lam_in=True,
                             lam_out=True) == 28 * 4


def test_config_and_result_fields_match_jax():
    assert tsqp.SQPConfig._fields == jsqp.SQPConfig._fields
    assert tsqp.SQPResult._fields == jsqp.SQPResult._fields
    assert tsqp.SQPConfig() == tsqp.SQPConfig(*jsqp.SQPConfig())
