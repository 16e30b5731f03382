"""The plain reference and the traffic generators against the program's own
plain versions at small sizes on the CPU: the reference is written apart
from the program, so these agreements are what makes it a yardstick."""

import json

import numpy as np
import pytest
import torch

from helpers import ROOT

from cardbench.reference import ocp as ref_ocp
from cardbench.reference import sqp as ref_sqp
from cardbench.traffic import fleet as fleet_traffic
from cardbench.traffic.scene import Scene

P = "oscar_mpc_planner_mr_modification_tpu_torch"


def config(name, N):
    cfg = json.loads((ROOT / "cardbench" / "configs" / f"{name}.json")
                     .read_text())
    cfg["reference"]["N"] = N
    return cfg


def program_ocp(cfg):
    from oscar_mpc_planner_mr_modification_tpu_torch import systems

    planner, _, _ = systems.make_system_planner(
        cfg["system"], cfg["configuration"], device="cpu",
        N=cfg["reference"]["N"])
    return planner.solver.ocp


def to_program(ocp_prog, ref, params):
    idx = ocp_prog.registry.save_map()
    return np.asarray(params)[..., [ref.index[n] for n in
                                    sorted(idx, key=idx.get)]]


@pytest.mark.parametrize("name", ["jackal_tmpc", "jackal_basic"])
def test_stage_functions_match_the_programs(name):
    cfg = config(name, 6)
    ref = ref_ocp.build(cfg["reference"])
    prog = program_ocp(cfg)
    rng = np.random.default_rng(1)
    for _ in range(5):
        p = rng.uniform(0.1, 2.0, ref.npar)
        z = rng.uniform(-1.0, 1.0, ref_ocp.NZ)
        pt = torch.as_tensor(p)
        pp = torch.as_tensor(to_program(prog, ref, p))
        zt = torch.as_tensor(z)
        for f, g, arg in ((ref.cost_stage, prog.cost_stage, zt),
                          (ref.cost_terminal, prog.cost_terminal,
                           zt[ref_ocp.NU:]),
                          (ref.ineq, prog.ineq, zt)):
            torch.testing.assert_close(f(arg, pt), g(arg, pp), rtol=1e-13,
                                       atol=1e-13)
        torch.testing.assert_close(
            ref.dynamics(zt[ref_ocp.NU:], zt[:ref_ocp.NU]),
            prog.dynamics(zt[ref_ocp.NU:], zt[:ref_ocp.NU], pp), rtol=1e-13,
            atol=1e-13)
    np.testing.assert_array_equal(ref.lh, prog.lh)
    np.testing.assert_array_equal(ref.uh, prog.uh)


def test_fleet_generator_matches_build_tmpc_fleet():
    cfg = config("jackal_tmpc", 8)
    ref = ref_ocp.build(cfg["reference"])
    from oscar_mpc_planner_mr_modification_tpu_torch.benchmarks import (
        build_tmpc_fleet, tmpc_bench_ocp)

    r = cfg["reference"]
    ocp, settings = tmpc_bench_ocp(N=8, n_paths=r["n_paths"],
                                   max_obstacles=r["n_obstacles"])
    want = build_tmpc_fleet(ocp, settings, 3, seed=0, dtype=np.float64)
    got = fleet_traffic.build(ref, r, 3, 0)
    np.testing.assert_allclose(to_program(ocp, ref, got[0]), want[0],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-12, atol=1e-12)


def small_fleet(N=8, B=2):
    cfg = config("jackal_tmpc", N)
    ref = ref_ocp.build(cfg["reference"])
    params, xinit, z_init = fleet_traffic.build(ref, cfg["reference"], B,
                                                [7, 0])
    Pn = params.shape[1]
    return (cfg, ref, params.reshape(-1, *params.shape[2:]),
            np.repeat(xinit, Pn, axis=0), z_init.reshape(-1,
                                                         *z_init.shape[2:]))


def test_reference_sqp_matches_the_programs_plain_lane_solve():
    cfg, ref, params, xinit, z_init = small_fleet()
    ocp = program_ocp(cfg)
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        SQPConfig, make_fleet_sqp_solver)

    s = cfg["reference"]["sqp"]
    sq = SQPConfig(n_sqp=s["n_sqp"], n_qp_iter=s["n_qp_iter"])
    got = make_fleet_sqp_solver(ocp, sq, dtype=torch.float64, device="cpu",
                                backend="lanes")(
        torch.as_tensor(to_program(ocp, ref, params)),
        torch.as_tensor(xinit), torch.as_tensor(z_init))
    want = ref_sqp.solve(ref, s, params, xinit, z_init, variant="lanes")
    torch.testing.assert_close(got.z, want.z, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(got.cost, want.cost, rtol=1e-10, atol=1e-10)
    assert torch.equal(got.success, want.success)


def test_reference_sqp_matches_the_programs_plain_single_solve():
    cfg = config("jackal_basic", 8)
    ref = ref_ocp.build(cfg["reference"])
    ocp = program_ocp(cfg)
    tm = config("jackal_tmpc", 8)
    tref = ref_ocp.build(tm["reference"])
    p, x, z = fleet_traffic.build(tref, tm["reference"], 1, [3, 1])
    # the basic OCP's parameters: the fleet's, by name
    params = np.stack([p[0, k][:, [tref.index[n] for n in ref.names]]
                       for k in range(2)])
    xinit, z_init = np.repeat(x, 2, axis=0), z[0, :2]
    from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (
        SQPConfig, make_sqp_solver)

    s = cfg["reference"]["sqp"]
    sq = SQPConfig(n_sqp=s["n_sqp"], n_qp_iter=s["n_qp_iter"])
    got = make_sqp_solver(ocp, sq, dtype=torch.float64, device="cpu").batched(
        torch.as_tensor(to_program(ocp, ref, params)),
        torch.as_tensor(xinit), torch.as_tensor(z_init))
    want = ref_sqp.solve(ref, s, params, xinit, z_init, variant="single")
    torch.testing.assert_close(got.z, want.z, rtol=1e-10, atol=1e-10)
    assert torch.equal(got.success, want.success)


def test_control_in_single_precision_misses_the_limit():
    """The control: the reference in float32 in the program's place, held
    against the float64 reference, reads far above the cell's limit at a
    size the CPU holds (on the card at the cells' own sizes:
    ``cardbench.control``)."""
    cfg, ref, params, xinit, z_init = small_fleet(N=10, B=3)
    s = cfg["reference"]["sqp"]
    hi = ref_sqp.solve(ref, s, params, xinit, z_init, variant="lanes")
    lo = ref_sqp.solve(ref, s, params, xinit, z_init, variant="lanes",
                       dtype=torch.float32)
    both = (hi.success & lo.success).numpy()
    gap = (np.abs(lo.z.double().numpy() - hi.z.numpy()).max(axis=(1, 2))
           / (1 + np.abs(hi.z.numpy()).max(axis=(1, 2))))
    limits = json.loads((ROOT / "cardbench" / "limits" / "tmpc_tick.json")
                        .read_text())
    assert np.median(gap[both]) > 10 * limits["solve_gap"]


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, -3, 3 * 10 ** 9])
def test_scene_is_made_from_the_seed(seed):
    t = json.loads((ROOT / "cardbench" / "workloads"
                    / "crossing_pedestrians.json").read_text())
    a, b = Scene(t, seed), Scene(t, seed)
    for _ in range(50):
        a.step_pedestrians()
        b.step_pedestrians()
    np.testing.assert_array_equal(a.pos, b.pos)
    # every seed runs the same scenes, in its own order
    assert sorted(map(int, a.order)) == list(range(t["scenes"]))
