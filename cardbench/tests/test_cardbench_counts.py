"""The benchmark's copy of the work counts against the program's own
(``ops/roofline.py``'s pinned constants) at the bench shapes, and the
configurations' pinned counts against the kernels' per-problem code
compiled for the host with a counting scalar type."""

import ctypes
import json
import subprocess

import numpy as np
import pytest
import torch

from helpers import ROOT

from cardbench import counts
from cardbench.reference import ocp as ref_ocp

P = "oscar_mpc_planner_mr_modification_tpu_torch"


def program():
    import importlib

    return {m: importlib.import_module(f"{P}.{m}") for m in (
        "ops.roofline", "ops.sqp", "ops.sqp_fused", "ops.qp_cuda",
        "benchmarks", "tools.common")}


def test_ip_iteration_count_matches_the_pinned_constants():
    m = program()
    roof, sqp = m["ops.roofline"], m["ops.sqp"]
    cases = [(m["tools.common"].bench_fleet(1, torch.float64, "cpu")[0],
              roof.IP_ITER_FLOPS)]
    from oscar_mpc_planner_mr_modification_tpu_torch.factory import (
        configuration_tmpc_consistency_cost)
    from oscar_mpc_planner_mr_modification_tpu_torch.solver import build_ocp
    from oscar_mpc_planner_mr_modification_tpu_torch.utils import (
        default_settings)

    s = default_settings(N=20, max_obstacles=3)
    cases.append((build_ocp(*configuration_tmpc_consistency_cost(s), s),
                  roof.TICK_IP_ITER_FLOPS))
    for ocp, want in cases:
        mach = sqp._make_machinery(ocp, sqp.SQPConfig(), torch.float64, "cpu")
        assert counts.ip_iter_flops(mach.row_meta, mach.stage_mask, ocp.nx,
                                    ocp.nu) == want


@pytest.mark.parametrize("name", ["jackal_tmpc", "jackal_basic"])
def test_reference_rows_are_the_programs(name):
    """The rows the roofline counts from (the reference OCP's) are the
    program's at the configuration's shape."""
    m = program()
    cfg = json.loads((ROOT / "cardbench" / "configs" / f"{name}.json")
                     .read_text())
    from oscar_mpc_planner_mr_modification_tpu_torch import systems

    planner, _, _ = systems.make_system_planner(
        cfg["system"], cfg["configuration"], device="cpu")
    mach = m["ops.sqp"]._make_machinery(planner.solver.ocp,
                                        m["ops.sqp"].SQPConfig(),
                                        torch.float64, "cpu")
    ocp = ref_ocp.build(cfg["reference"])
    assert ref_ocp.row_meta(ocp) == tuple(mach.row_meta)
    np.testing.assert_array_equal(ref_ocp.stage_mask(ocp), mach.stage_mask)


def test_single_solve_count_and_qp_words_match_the_programs():
    roof = program()["ops.roofline"]
    cfg = json.loads((ROOT / "cardbench" / "configs" / "jackal_basic.json")
                     .read_text())
    c = cfg["counts"]
    assert roof.SingleCounts(**c) == roof.S1_BASIC
    assert counts.single_flops(10, 18, c, 31, 7) == roof.single_flops(
        ((10, 18),), roof.S1_BASIC, 31, 7)
    for T, m, mh in ((21, 22, 8), (31, 22, 8), (31, 18, 4)):
        assert counts.qp_words(T, 5, 2, m, mh) * 8 == roof.qp_bytes(
            T, 5, 2, m, mh, 1, 8)
    assert counts.PEAK_FLOPS["float64"] == roof.PEAK_FP64_FLOPS
    assert counts.PEAK_FLOPS["float32"] == roof.PEAK_FP32_FLOPS
    assert counts.PEAK_BYTES_PER_S == roof.PEAK_BYTES_PER_S


@pytest.fixture(scope="module")
def count_lib(tmp_path_factory):
    m = program()
    cxx = m["ops.sqp_fused"].host_compiler()
    if cxx is None:
        pytest.skip("no C++ compiler")
    out = tmp_path_factory.mktemp("count") / "libcount.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o",
                    str(out), str(m["ops.qp_cuda"]._CSRC / "qp_ip_count.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tmpc_count_ops.argtypes = [ptr] * 5 + [i32] * 6 + [ptr] * 2
    lib.tmpc_count_ops.restype = i32
    lib.linearize_mirror_count_ops.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.linearize_mirror_count_ops.restype = i32
    return lib


def test_pinned_linearization_counts_of_the_tmpc_configuration(count_lib):
    """``configs/jackal_tmpc.json``'s counts: the mirror linearize entry's
    and the merit's operations per problem on the first plan of the
    configuration's fleet (seed 0), the same on every planner."""
    m = program()
    fused = m["ops.sqp_fused"]
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel.batch import (
        to_torch_fleet)

    cfg = json.loads((ROOT / "cardbench" / "configs" / "jackal_tmpc.json")
                     .read_text())
    ref = cfg["reference"]
    ocp, settings = m["benchmarks"].tmpc_bench_ocp(
        N=ref["N"], n_paths=ref["n_paths"], max_obstacles=ref["n_obstacles"])
    params, xinit, z_init, _ = to_torch_fleet(
        *m["benchmarks"].build_tmpc_fleet(ocp, settings, 1, seed=0),
        device="cpu", dtype=torch.float64)
    Pp = torch.cat([params[0], params[0][:, -1:]], dim=1)
    x0, Z = xinit.expand(Pp.shape[0], -1), z_init[0]
    tables = fused.ocp_tables(ocp, m["ops.sqp"].SQPConfig(), mirror=True)
    itab = np.ascontiguousarray(tables.ints)
    rtab = np.ascontiguousarray(tables.reals)
    ins = fused._lanes_in(Pp.contiguous(), x0.contiguous(), Z)
    for b in range(Pp.shape[0]):
        heads = [np.ascontiguousarray(x[:, b].numpy()) for x in ins]
        lin, raw, merit = (np.zeros(5, np.int64) for _ in range(3))
        args = [c.ctypes.data for c in heads] + [itab.ctypes.data,
                                                 rtab.ctypes.data]
        assert count_lib.linearize_mirror_count_ops(
            *args, tables.T, tables.npar, tables.m, tables.mh, tables.model,
            lin.ctypes.data) == 0
        assert count_lib.tmpc_count_ops(
            *args, tables.T, tables.npar, tables.m, tables.mh, tables.model,
            tables.reg, raw.ctypes.data, merit.ctypes.data) == 0
        assert int(lin.sum()) == cfg["counts"]["lin_mirror"]
        assert int(merit.sum()) == cfg["counts"]["merit"]
