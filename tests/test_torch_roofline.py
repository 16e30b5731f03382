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
  QPs, where it gives ``IP_ITER_FLOPS``; ``LIN_FLOPS`` and ``MERIT_FLOPS``
  against the same build's count of the fused kernel's linearization and
  merit (``tmpc_count_ops``) on the bench fleet's QPs, and below XLA's cost
  analysis of the JAX lane linearizer and lane merit at the bench shape.
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
    lib.qp_ip_count_ops.argtypes = [ptr] * 10 + [i32] * 6 + [f64] * 7 + [ptr]
    lib.qp_ip_count_ops.restype = i32
    lib.tmpc_count_ops.argtypes = [ptr] * 5 + [i32] * 6 + [ptr] * 2
    lib.tmpc_count_ops.restype = i32
    return lib


def _count_ops(lib, qp, row_mask, row_meta, nu, n_iters):
    """Operations by kind (+/-, *, /, negation, sqrt) of the header's solve
    of the one problem in ``qp`` (batch-major f64 tensors, batch 1)."""
    _, T, nz = qp.g.shape
    m = qp.D.shape[2]
    rows = qp_cuda._rows(row_mask, row_meta, T, m)
    fields = qp_cuda._batch_fields(qp.H, qp.g, qp.A, qp.B, qp.c, qp.D, qp.e,
                                   qp.r0, rows)
    mask, table = qp_cuda._row_tables(
        (rows.row_meta, rows.stage_mask.tobytes(), rows.active), T, m,
        torch.float64, "cpu")
    out = np.zeros(5, dtype=np.int64)
    assert lib.qp_ip_count_ops(
        *[t.data_ptr() for t in (*fields, mask, table)], T, nz - nu,
        nu, m, fields.D.shape[0] // (T * nz), n_iters, 1e2, 1e-6, 0.995, 1e6,
        1e-10, 1e-5, rows.n_act, out.ctypes.data) == 0
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


@pytest.mark.parametrize("nx,nu", [(5, 2), (4, 2), (6, 2), (6, 3), (3, 1),
                                   (4, 3)])
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


def test_linearization_flops_match_the_kernel_count(count_lib):
    """LIN_FLOPS and MERIT_FLOPS are the fused kernel's own counts of one
    linearization and one merit evaluation (its lane-group code on the host
    with the counting scalar), equal on each of the bench fleet's first 9
    problems (N=20, the bench OCP)."""
    from oscar_mpc_planner_mr_modification_tpu_torch.tools.common import (
        bench_config, bench_fleet)

    ocp, (params, xinit, z_init, _) = bench_fleet(1, torch.float64, "cpu")
    tables = sqp_fused.ocp_tables(ocp, bench_config())
    P = torch.cat([params[0], params[0][:, -1:]], dim=1)
    ins = sqp_fused._lanes_in(P, xinit.expand(P.shape[0], -1), z_init[0])
    itab = np.ascontiguousarray(tables.ints)
    rtab = np.ascontiguousarray(tables.reals)
    for b in range(P.shape[0]):
        cols = [np.ascontiguousarray(x[:, b].numpy()) for x in ins]
        lin, merit = np.zeros(5, np.int64), np.zeros(5, np.int64)
        count_lib.tmpc_count_ops(
            *[c.ctypes.data for c in cols], itab.ctypes.data,
            rtab.ctypes.data, tables.T, tables.npar, tables.m, tables.mh,
            tables.model, tables.reg, lin.ctypes.data, merit.ctypes.data)
        assert int(lin.sum()) == roofline.LIN_FLOPS, lin
        assert int(merit.sum()) == roofline.MERIT_FLOPS, merit


def test_tick_ocp_flops_match_the_kernel_count(count_lib):
    """The TICK_ constants are the hand count and the fused kernel's own
    counts at the planner tick's OCP (``default_settings(N=20,
    max_obstacles=3)``, as ``factory.build_planner`` builds it), equal on
    every planner of two fleets of two seeds each, and ``sqp_flops`` takes
    them in place of the fleet's."""
    from oscar_mpc_planner_mr_modification_tpu_torch.benchmarks import (
        build_tmpc_fleet)
    from oscar_mpc_planner_mr_modification_tpu_torch.factory import (
        configuration_tmpc_consistency_cost)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        _make_machinery)
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel.batch import (
        to_torch_fleet)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import build_ocp
    from oscar_mpc_planner_mr_modification_tpu_torch.tools.common import (
        BENCH_SCHEDULE, bench_config)
    from oscar_mpc_planner_mr_modification_tpu_torch.utils import (
        default_settings)

    settings = default_settings(N=20, max_obstacles=3)
    ocp = build_ocp(*configuration_tmpc_consistency_cost(settings), settings)
    assert ocp.npar == 88
    mach = _make_machinery(ocp, bench_config(), torch.float64, "cpu")
    tables = sqp_fused.ocp_tables(ocp, bench_config())
    itab = np.ascontiguousarray(tables.ints)
    rtab = np.ascontiguousarray(tables.reals)
    nx = ocp.nx
    for seed in (0, 1):
        params, xinit, z_init, _ = to_torch_fleet(
            *build_tmpc_fleet(ocp, settings, 2, seed=seed), device="cpu",
            dtype=torch.float64)
        assert params.shape[1] == 5  # 4 guided planners and 1 unguided
        for fleet in range(2):
            P = torch.cat([params[fleet], params[fleet][:, -1:]], dim=1)
            x0 = xinit[fleet:fleet + 1].expand(P.shape[0], -1)
            qp = mach.build_qp(z_init[fleet], P, x0)
            ins = sqp_fused._lanes_in(P, x0, z_init[fleet])
            for b in range(P.shape[0]):
                one = tsqp.QPData(*(x[b:b + 1] for x in qp))
                assert _check_iteration_count(
                    count_lib, one, mach.stage_mask, mach.row_meta, nx,
                    mach.nu) == roofline.TICK_IP_ITER_FLOPS
                cols = [np.ascontiguousarray(x[:, b].numpy()) for x in ins]
                lin, merit = np.zeros(5, np.int64), np.zeros(5, np.int64)
                count_lib.tmpc_count_ops(
                    *[c.ctypes.data for c in cols], itab.ctypes.data,
                    rtab.ctypes.data, tables.T, tables.npar, tables.m,
                    tables.mh, tables.model, tables.reg, lin.ctypes.data,
                    merit.ctypes.data)
                assert int(lin.sum()) == roofline.TICK_LIN_FLOPS, lin
                assert int(merit.sum()) == roofline.TICK_MERIT_FLOPS, merit
    tick = roofline.sqp_flops(5, BENCH_SCHEDULE, lin=roofline.TICK_LIN_FLOPS,
                              merit=roofline.TICK_MERIT_FLOPS,
                              ip_iter=roofline.TICK_IP_ITER_FLOPS)
    assert tick == 5 * (4 * 157881 + 27822 + 24 * 80954)
    assert tick < roofline.sqp_flops(5, BENCH_SCHEDULE)


@pytest.mark.parametrize("which", ["rollout", "gate"])
def test_contouring_ocp_flops_match_the_kernel_count(count_lib, which):
    """The ROLLOUT_ and GATE_ constants are the hand count and the fused
    kernel's own counts at the contouring evaluator's OCP (N=20, 3
    obstacles) and at the BASELINE f32 gate's (configuration_basic, N=15,
    2 obstacles), equal on every problem: 8 evaluator episodes at their
    first tick; the golden's problem at its start and at its solution."""
    from oscar_mpc_planner_mr_modification_tpu_torch.factory import (
        configuration_basic)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        SQPConfig, _make_machinery)
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel import (
        rollout)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import build_ocp
    from oscar_mpc_planner_mr_modification_tpu_torch.utils import (
        default_settings)

    f64 = torch.float64
    if which == "rollout":
        ro, ocp = rollout.make_contouring_rollout(N=20, n_ticks=1, dtype=f64,
                                                  device="cpu")
        cfg = rollout._default_rollout_config()
        x0, obs0, vel = rollout.contouring_scenes(8, 3, seed=0)
        P = ro.first_tick_params(x0, obs0, vel)
        x0 = torch.as_tensor(x0, dtype=f64)
        Z = x0[:, None].expand(-1, 21, -1)
        Z = torch.cat([torch.zeros(8, 21, 2, dtype=f64), Z], dim=2)
        want = (roofline.ROLLOUT_IP_ITER_FLOPS, roofline.ROLLOUT_LIN_FLOPS,
                roofline.ROLLOUT_MERIT_FLOPS, 76)
    else:
        gold = np.load(os.path.join(os.path.dirname(__file__), "golden",
                                    "contouring_2obs.npz"))
        settings = default_settings(N=15, max_obstacles=2)
        ocp = build_ocp(*configuration_basic(settings), settings)
        cfg = SQPConfig(n_sqp=25, n_qp_iter=15, mu_min=1e-6, w_max=1e6,
                        reg_eps=1e-4, regularization="gershgorin")
        P = torch.as_tensor(gold["P"])[None].expand(2, -1, -1)
        x0 = torch.as_tensor(gold["x0"])[None].expand(2, -1)
        Z = torch.stack([torch.as_tensor(gold["z_init"]),
                         torch.as_tensor(gold["Z"])])
        want = (roofline.GATE_IP_ITER_FLOPS, roofline.GATE_LIN_FLOPS,
                roofline.GATE_MERIT_FLOPS, 69)
    assert ocp.npar == want[3]
    P = torch.cat([P, P[:, -1:]], dim=1).contiguous()
    mach = _make_machinery(ocp, cfg, f64, "cpu")
    tables = sqp_fused.ocp_tables(ocp, cfg)
    itab = np.ascontiguousarray(tables.ints)
    rtab = np.ascontiguousarray(tables.reals)
    qp = mach.build_qp(Z, P, x0)
    ins = sqp_fused._lanes_in(P, x0, Z)
    for b in range(P.shape[0]):
        one = tsqp.QPData(*(x[b:b + 1] for x in qp))
        assert _check_iteration_count(count_lib, one, mach.stage_mask,
                                      mach.row_meta, ocp.nx,
                                      mach.nu) == want[0]
        cols = [np.ascontiguousarray(x[:, b].numpy()) for x in ins]
        lin, merit = np.zeros(5, np.int64), np.zeros(5, np.int64)
        count_lib.tmpc_count_ops(
            *[c.ctypes.data for c in cols], itab.ctypes.data,
            rtab.ctypes.data, tables.T, tables.npar, tables.m, tables.mh,
            tables.model, tables.reg, lin.ctypes.data, merit.ctypes.data)
        assert (int(lin.sum()), int(merit.sum())) == want[1:3]


def _first_tick(which):
    """(ocp, config, P (B, T, npar), x0, Z) of an evaluator's first tick at
    N=20 on the CPU (f64), its default scenes of seed 0."""
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel import (
        rollout)

    f64 = torch.float64
    if which == "goal_rollout":
        ro, ocp = rollout.make_batch_rollout(N=20, n_ticks=1, dtype=f64,
                                             device="cpu")
        x0, goal, obs0, vel = rollout.sample_scenes(4, 3, seed=0)
        P, x0 = ro.first_tick_params(x0, goal, obs0, vel), torch.as_tensor(x0)
    elif which == "multirobot":
        ro, ocp = rollout.make_multirobot_rollout(N=20, n_ticks=1, dtype=f64,
                                                  device="cpu")
        x0, goals = rollout.antipodal_circle_scenes(1, 4, seed=0)
        P = ro.first_tick_params(x0, goals).reshape(4, 20, -1)
        x0 = torch.as_tensor(x0).reshape(4, 4)
    else:
        ro, ocp = rollout.make_tmpc_rollout(N=20, n_ticks=1, dtype=f64,
                                            device="cpu")
        scenes = rollout.tmpc_scenes(1, 4, seed=0)
        P = ro.first_tick_params(*scenes).reshape(5, 20, -1)
        Z = ro.first_tick_seeds(*scenes).reshape(5, 21, -1)
        return ocp, ro.config, P, Z[:, 0, ocp.nu:].contiguous(), Z
    Z = torch.cat([torch.zeros(x0.shape[0], 21, ocp.nu, dtype=f64),
                   x0[:, None].expand(-1, 21, -1)], dim=2)
    return ocp, ro.config, P, x0, Z


@pytest.mark.parametrize("which", ["goal_gate", "goal_rollout", "multirobot",
                                   "tmpc_rollout"])
def test_goal_and_evaluator_ocp_flops_match_the_kernel_count(count_lib,
                                                             which):
    """The GOAL_ constants are the hand count and the fused kernel's own
    counts at BASELINE config 1's OCP (SecondOrderUnicycleModel, N=20, 3
    ellipsoids): on the golden's problem at its start and at its solution,
    and on the first ticks of the goal evaluator and of the multi-robot
    evaluator at 4 robots. The T-MPC evaluator's first tick (4 obstacles,
    5 planners) counts the fleet bench's IP_ITER_FLOPS, LIN_FLOPS and
    MERIT_FLOPS."""
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        SQPConfig, _make_machinery)
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel import (
        rollout)

    f64 = torch.float64
    if which == "goal_gate":
        gold = np.load(os.path.join(os.path.dirname(__file__), "golden",
                                    "goal_tracking_3obs.npz"))
        ocp, _ = rollout._goal_ellipsoid_ocp(3, 20)
        cfg = SQPConfig(n_sqp=25, n_qp_iter=15, mu_min=1e-6, w_max=1e6,
                        reg_eps=1e-4, regularization="gershgorin")
        P = torch.as_tensor(gold["P"])[None].expand(2, -1, -1)
        x0 = torch.as_tensor(gold["x0"])[None].expand(2, -1)
        Z = torch.stack([torch.as_tensor(gold["z_init"]),
                         torch.as_tensor(gold["Z"])])
    else:
        ocp, cfg, P, x0, Z = _first_tick(which)
    want = ((roofline.IP_ITER_FLOPS, roofline.LIN_FLOPS,
             roofline.MERIT_FLOPS, 98) if which == "tmpc_rollout" else
            (roofline.GOAL_IP_ITER_FLOPS, roofline.GOAL_LIN_FLOPS,
             roofline.GOAL_MERIT_FLOPS, 28))
    assert ocp.npar == want[3]
    P = torch.cat([P, P[:, -1:]], dim=1).contiguous()
    mach = _make_machinery(ocp, cfg, f64, "cpu")
    tables = sqp_fused.ocp_tables(ocp, cfg)
    itab = np.ascontiguousarray(tables.ints)
    rtab = np.ascontiguousarray(tables.reals)
    qp = mach.build_qp(Z, P, x0)
    ins = sqp_fused._lanes_in(P, x0, Z)
    for b in range(P.shape[0]):
        one = tsqp.QPData(*(x[b:b + 1] for x in qp))
        assert _check_iteration_count(count_lib, one, mach.stage_mask,
                                      mach.row_meta, ocp.nx,
                                      mach.nu) == want[0]
        cols = [np.ascontiguousarray(x[:, b].numpy()) for x in ins]
        lin, merit = np.zeros(5, np.int64), np.zeros(5, np.int64)
        assert count_lib.tmpc_count_ops(
            *[c.ctypes.data for c in cols], itab.ctypes.data,
            rtab.ctypes.data, tables.T, tables.npar, tables.m, tables.mh,
            tables.model, tables.reg, lin.ctypes.data,
            merit.ctypes.data) == 0
        assert (int(lin.sum()), int(merit.sum())) == want[1:3]


def _first_tick_ccmpc():
    """(ocp, P, x0, Z) of the CC-MPC evaluator's first tick at N=20 (3
    obstacles, 4 episodes of seed 0), stationary iterates."""
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel import (
        rollout)

    f64 = torch.float64
    ro, ocp = rollout.make_contouring_rollout(
        N=20, n_ticks=1, dtype=f64, device="cpu", constraints="gaussian")
    x0, obs0, vel = rollout.contouring_scenes(4, 3, seed=0)
    P = ro.first_tick_params(x0, obs0, vel)
    x0 = torch.as_tensor(x0, dtype=f64)
    Z = torch.cat([torch.zeros(4, 21, ocp.nu, dtype=f64),
                   x0[:, None].expand(-1, 21, -1)], dim=2)
    return ocp, P, x0, Z


@pytest.mark.parametrize("which", ["ccmpc_fleet", "ccmpc_rollout", "ccmpc6",
                                   "shmpc_fleet"])
def test_ccmpc_and_shmpc_ocp_flops_match_the_kernel_count(count_lib, which):
    """The CCMPC_, CCMPC6_ and SHMPC_ constants are the hand count and the
    fused kernel's own counts at BASELINE configs 3 and 5's OCPs (N=20): on
    4 problems each of tools/bench_matrix.py's CC-MPC fleet (3 obstacles),
    the CC-MPC evaluator's first tick, the CC-MPC fleet at config 3's 6
    obstacles and the SH-MPC fleet (nx=6, m=40)."""
    from oscar_mpc_planner_mr_modification_tpu_torch.tools import (
        bench_matrix)

    f64 = torch.float64
    rng = np.random.default_rng(0)
    if which == "ccmpc_rollout":
        ocp, P, x0, Z = _first_tick_ccmpc()
    else:
        build = {"ccmpc_fleet": bench_matrix.build_ccmpc,
                 "ccmpc6": lambda N, B, r: bench_matrix.build_ccmpc(N, B, r,
                                                                    6),
                 "shmpc_fleet": bench_matrix.build_shmpc}[which]
        ocp, *arrays = build(20, 4, rng)
        P, x0, Z = (torch.as_tensor(a, dtype=f64) for a in arrays)
    prefix = {"ccmpc_fleet": "CCMPC", "ccmpc_rollout": "CCMPC",
              "ccmpc6": "CCMPC6", "shmpc_fleet": "SHMPC"}[which]
    want = tuple(getattr(roofline, f"{prefix}_{kind}_FLOPS")
                 for kind in ("IP_ITER", "LIN", "MERIT"))
    assert ocp.npar == {"CCMPC": 73, "CCMPC6": 91, "SHMPC": 127}[prefix]
    cfg = bench_matrix.matrix_config()
    P = torch.cat([P, P[:, -1:]], dim=1).contiguous()
    mach = tsqp._make_machinery(ocp, cfg, f64, "cpu")
    tables = sqp_fused.ocp_tables(ocp, cfg)
    itab = np.ascontiguousarray(tables.ints)
    rtab = np.ascontiguousarray(tables.reals)
    qp = mach.build_qp(Z, P, x0)
    ins = sqp_fused._lanes_in(P, x0, Z)
    for b in range(P.shape[0]):
        one = tsqp.QPData(*(x[b:b + 1] for x in qp))
        assert _check_iteration_count(count_lib, one, mach.stage_mask,
                                      mach.row_meta, ocp.nx,
                                      mach.nu) == want[0]
        cols = [np.ascontiguousarray(x[:, b].numpy()) for x in ins]
        lin, merit = np.zeros(5, np.int64), np.zeros(5, np.int64)
        assert count_lib.tmpc_count_ops(
            *[c.ctypes.data for c in cols], itab.ctypes.data,
            rtab.ctypes.data, tables.T, tables.npar, tables.m, tables.mh,
            tables.model, tables.reg, lin.ctypes.data,
            merit.ctypes.data) == 0
        assert (int(lin.sum()), int(merit.sum())) == want[1:]


def test_linearization_flops_match_cost_analysis():
    """The fused kernel's count of a linearization plus a merit evaluation
    against XLA's cost analysis of the JAX package's lane linearizer plus
    lane merit at the bench shape (N=20, the bench OCP), f32, 16 problems,
    every scan unrolled: the same functions, but XLA's count is several
    times larger (jacfwd over jacrev where the kernel runs forward-mode jets
    on a packed Hessian triangle), so the kernel's own count is the bound's."""
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
    ours = roofline.LIN_FLOPS + roofline.MERIT_FLOPS
    assert 1.0 < flops / B / ours < 10.0, (ours, flops / B)


def test_sqp_flops_count_linearizations_and_ip_iterations():
    sched = ((1, 3), (1, 5), (2, 8))
    want = (4 * roofline.LIN_FLOPS + roofline.MERIT_FLOPS
            + 24 * roofline.IP_ITER_FLOPS)
    assert roofline.sqp_flops(10, sched) == pytest.approx(10 * want)
    assert roofline.ip_flops(10, 8) == pytest.approx(80 * roofline.IP_ITER_FLOPS)
    assert roofline.ip_flops(2, 3, ip_iter=100) == 600
    assert roofline.lin_flops(3) == 3 * (roofline.LIN_FLOPS
                                         + roofline.MERIT_FLOPS)
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


def _counts(count_lib, ocp, P, x0, Z):
    """(IP iteration, linearization, merit) counts of the fused kernel on
    every problem of (P with stage N repeating N-1, x0, Z), f64; each must
    be the same on every problem."""
    from oscar_mpc_planner_mr_modification_tpu_torch.tools.bench_matrix import (  # noqa: E501
        matrix_config)

    cfg = matrix_config()
    mach = tsqp._make_machinery(ocp, cfg, torch.float64, "cpu")
    tables = sqp_fused.ocp_tables(ocp, cfg)
    itab = np.ascontiguousarray(tables.ints)
    rtab = np.ascontiguousarray(tables.reals)
    qp = mach.build_qp(Z, P, x0)
    ins = sqp_fused._lanes_in(P, x0, Z)
    seen = set()
    for b in range(P.shape[0]):
        one = tsqp.QPData(*(x[b:b + 1] for x in qp))
        ip = _check_iteration_count(count_lib, one, mach.stage_mask,
                                    mach.row_meta, ocp.nx, mach.nu)
        cols = [np.ascontiguousarray(x[:, b].numpy()) for x in ins]
        lin, merit = np.zeros(5, np.int64), np.zeros(5, np.int64)
        assert count_lib.tmpc_count_ops(
            *[c.ctypes.data for c in cols], itab.ctypes.data,
            rtab.ctypes.data, tables.T, tables.npar, tables.m, tables.mh,
            tables.model, tables.reg, lin.ctypes.data,
            merit.ctypes.data) == 0
        seen.add((ip, int(lin.sum()), int(merit.sum())))
    assert len(seen) == 1, seen
    return seen.pop()


def _goal_tmpc_tick_problems(B=5):
    """The multi-robot tick's OCP (``systems.make_system_planner(
    "jackalsimulator", "goal_tmpc")``: ``default_settings()``, N=30, 4
    obstacles, goal, consistency, topology halfspaces and ellipsoids on
    ``SecondOrderUnicycleModel``) and B problems around a straight run to
    a goal with the obstacles 2-4 m ahead."""
    from oscar_mpc_planner_mr_modification_tpu_torch.factory import (
        configuration_goal_tmpc)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import build_ocp
    from oscar_mpc_planner_mr_modification_tpu_torch.utils import (
        default_settings)

    settings = default_settings()
    ocp = build_ocp(*configuration_goal_tmpc(settings), settings)
    rng = np.random.default_rng(3)
    T, idx, reg = ocp.N + 1, ocp.registry.save_map(), ocp.registry
    P = np.zeros((B, T, ocp.npar))
    w = settings["weights"]
    for name in ("acceleration", "angular_velocity", "consistency_weight"):
        P[..., idx[name]] = w.get(name, 0.1)
    P[..., idx["goal_weight"]] = 5.0
    P[..., idx["goal_x"]] = 8.0
    P[..., idx["goal_y"]] = 1.0
    P[..., idx["ego_disc_radius"]] = 0.325
    P[..., np.asarray(reg.bundle_indices("lin_constraint_a1"))] = 1.0
    P[..., np.asarray(reg.bundle_indices("lin_constraint_b"))] = 1.0e4
    for i in range(int(settings["max_obstacles"])):
        P[..., idx[f"ellipsoid_obst_{i}_x"]] = rng.uniform(2.0, 4.0, (B, 1))
        P[..., idx[f"ellipsoid_obst_{i}_y"]] = rng.uniform(-1.0, 1.0, (B, 1))
        P[..., idx[f"ellipsoid_obst_{i}_chi"]] = 1.0
        P[..., idx[f"ellipsoid_obst_{i}_r"]] = 0.325
    Z = np.zeros((B, T, ocp.nvar))
    Z[..., ocp.nu] = np.linspace(0.0, 6.0, T)
    Z[..., ocp.nu + 3] = 1.0
    P[..., idx["prev_traj_x"]] = Z[..., ocp.nu]
    x0 = Z[:, 0, ocp.nu:].copy()
    return ocp, *(torch.as_tensor(a) for a in (P, x0, Z))


@pytest.mark.parametrize("which", ["mrtick", "vref", "lmpcc"])
def test_slice9_ocp_flops_match_the_kernel_count(count_lib, which):
    """The MRTICK_, VREF_ and LMPCC_ constants are the hand count and the
    fused kernel's own counts at the multi-robot tick's goal-T-MPC OCP
    (N=30), the dyn-vref T-MPC fleet of ``tools/bench_matrix.py::
    build_dynvref`` (N=20; the velocity spline adds VREF_LIN_FLOPS -
    LIN_FLOPS to a linearization) and its LMPCC fleet (N=20), on every
    problem."""
    from oscar_mpc_planner_mr_modification_tpu_torch.tools import (
        bench_matrix)

    f64 = torch.float64
    if which == "mrtick":
        ocp, P, x0, Z = _goal_tmpc_tick_problems()
        assert (ocp.N, ocp.npar) == (30, 50)
    else:
        if which == "vref":
            ocp, *arrays = bench_matrix.build_dynvref(20, 1)
        else:
            ocp, *arrays = bench_matrix.build_lmpcc(
                20, 4, np.random.default_rng(0))
        P, x0, Z = (torch.as_tensor(a, dtype=f64) for a in arrays)
        P = torch.cat([P, P[:, -1:]], dim=1).contiguous()
    prefix = which.upper()
    want = tuple(getattr(roofline, f"{prefix}_{kind}_FLOPS")
                 for kind in ("IP_ITER", "LIN", "MERIT"))
    assert _counts(count_lib, ocp, P, x0, Z) == want
    if which == "vref":
        assert want[0] == roofline.IP_ITER_FLOPS
        assert want[1] > roofline.LIN_FLOPS


@pytest.mark.parametrize("which", ["bicycle", "bicycle_ca", "road", "ca",
                                   "decomp"])
def test_item_4d_ocp_flops_match_the_kernel_count(count_lib, which):
    """The BICYCLE_, BICYCLE_CA_, ROAD_, CA_ and DECOMP_ constants are the
    hand count and the fused kernel's own counts at tools/bench_matrix.py's
    bicycle fleets (N=30: plain, curvature-aware, with the road-width rows),
    its CA-MPC fleet and its decomp fleet (N=20), on every problem."""
    from oscar_mpc_planner_mr_modification_tpu_torch.tools import (
        bench_matrix)

    rng = np.random.default_rng(0)
    build = {
        "bicycle": lambda: bench_matrix.build_bicycle(30, 3, rng),
        "bicycle_ca": lambda: bench_matrix.build_bicycle(30, 3, rng, True),
        "road": lambda: bench_matrix.build_bicycle(30, 3, rng,
                                                   road_width=True),
        "ca": lambda: bench_matrix.build_ca_unicycle(20, 3, rng),
        "decomp": lambda: bench_matrix.build_decomp(20, 3, rng)}[which]
    ocp, *arrays = build()
    P, x0, Z = (torch.as_tensor(a, dtype=torch.float64) for a in arrays)
    P = torch.cat([P, P[:, -1:]], dim=1).contiguous()
    prefix = which.upper()
    want = tuple(getattr(roofline, f"{prefix}_{kind}_FLOPS")
                 for kind in ("IP_ITER", "LIN", "MERIT"))
    assert _counts(count_lib, ocp, P, x0, Z) == want
