"""The port's measuring tools on the CPU: the schedule sweep
(``tools/exp_schedule_hw.py``) against the JAX package's fleet solve, the
tick profile (``tools/profile_e2e_tick.py``) in both modes, what
``tools/kernel_check.py`` covers, that ``tools/s1_sections.py`` names the
section counters of ``csrc/sqp_single.cuh`` in their order, and that each
tool refuses to run without a card unless asked for the CPU.

The sweep runs one one-phase schedule at 2 plans x 9 planners, N=8, f64
through ``"xla"`` on both sides (the same single-instance algorithm): the
per-planner success flags are equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu import benchmarks as j_bench  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu.ops import sqp as j_sqp  # noqa: E402
from oscar_mpc_planner_mr_modification_tpu_torch.ops import (  # noqa: E402
    qp_cuda, sqp_fused)
from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import (  # noqa: E402
    make_fleet_sqp_solver)
from oscar_mpc_planner_mr_modification_tpu_torch.tools import (  # noqa: E402
    build_check, exp_schedule_hw, kernel_check, lin_sections,
    profile_e2e_tick, s1_sections, validate)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_schedule_sweep_success_equals_jax():
    schedule = [["2x5", [[2, 5]]]]
    (row,) = exp_schedule_hw.sweep(schedule, batch=2, device="cpu",
                                   backend="xla", dtype=torch.float64, N=8)
    assert row["step_ms"] is None  # no device time without a card
    flags = row["success_flags"]
    assert flags.shape == (2, 9)

    ocp, settings = j_bench.tmpc_bench_ocp(N=8, n_paths=8)
    params, xinit, z_init, _ = j_bench.build_tmpc_fleet(ocp, settings, 2,
                                                        seed=0)
    cfg = exp_schedule_hw.schedule_config(schedule[0][1])
    j_cfg = j_sqp.SQPConfig(**cfg._asdict())
    fleet = j_sqp.make_fleet_sqp_solver(ocp, j_cfg, dtype=jnp.float64,
                                        backend="xla")
    res = fleet(jnp.asarray(params.reshape(18, *params.shape[2:]),
                            jnp.float64),
                jnp.asarray(np.repeat(xinit, 9, axis=0), jnp.float64),
                jnp.asarray(z_init.reshape(18, *z_init.shape[2:]),
                            jnp.float64))
    want = np.asarray(res.success).reshape(2, 9)
    np.testing.assert_array_equal(flags, want)
    assert row["success"] == pytest.approx(want.mean(), abs=0)
    assert row["plan_success"] == pytest.approx(want.any(axis=1).mean(),
                                                abs=0)


def test_profile_e2e_tick_both_modes(capsys):
    prof = profile_e2e_tick.main("cpu", N=8, warm=1, ticks=2)
    host = profile_e2e_tick.host_only("cpu", N=8, warm=1, ticks=2,
                                      profile=True)
    out = capsys.readouterr().out
    assert "ticks: median" in out and "HOST-ONLY per tick" in out
    assert "solve_mpc" in prof["stats"] and "solve_mpc" in host["stats"]
    for v in (prof["median_ms"], prof["host_median_ms"],
              host["host_median_ms"], host["tick_median_ms"]):
        assert np.isfinite(v) and v > 0


def test_kernel_check_covers_every_instance_model_and_row_kind():
    """B1 at (4, 2), (6, 2), (6, 3); B2's models besides the bench's and the
    h-row kinds besides ellipsoid and halfspace."""
    dims, models, kinds = set(), set(), set()
    for name, (build, b1) in kernel_check.CASES.items():
        ocp, P, x0, Z = build(np.random.default_rng(0))
        assert P.shape[0] == x0.shape[0] == Z.shape[0] == kernel_check.BATCH
        tables = make_fleet_sqp_solver(
            ocp, kernel_check.matrix_config(), dtype=torch.float64,
            device="cpu", backend="fused").tables
        models.add(tables.model)
        off = int(tables.ints[sqp_fused.TB_OFF_H])
        kinds |= {int(tables.ints[off + i * sqp_fused.H_W])
                  for i in range(tables.mh)}
        if b1:
            qp_cuda.check_instantiated(ocp.nx, ocp.nu)
            dims.add((ocp.nx, ocp.nu))
    assert {(4, 2), (6, 2), (6, 3)} <= dims
    assert {sqp_fused.MODELS[m] for m in (
        "SecondOrderUnicycleModel",
        "ContouringSecondOrderUnicycleModelWithSlack",
        "BicycleModel2ndOrder", "BicycleModel2ndOrderCurvatureAware",
        "ContouringSecondOrderUnicycleModelCurvatureAware")} <= models
    assert {sqp_fused.HK_GAUSSIAN, sqp_fused.HK_SCENARIO,
            sqp_fused.HK_ROADWIDTH, sqp_fused.HK_DECOMP} <= kinds


@pytest.mark.parametrize("run", [
    validate.main, exp_schedule_hw.main, kernel_check.main,
    lambda: profile_e2e_tick.main(), lambda: profile_e2e_tick.host_only(),
    lambda: s1_sections.main([]), lambda: lin_sections.main([]),
    lambda: build_check.main([])],
    ids=["validate", "exp_schedule_hw", "kernel_check", "profile_e2e_tick",
         "profile_e2e_tick_host_only", "s1_sections", "lin_sections",
         "build_check"])
def test_tool_without_card_exits_2(run):
    with pytest.raises(SystemExit) as exc:
        run()
    assert exc.value.code == 2


def test_s1_sections_name_the_header_counters():
    """The tool's SECTIONS are the header's SEC_* ids in order (up to
    SEC_COUNT), and split() divides the IP sections by the IP iterations
    and the SQP sections by the SQP iterations."""
    import re

    header = (qp_cuda._CSRC / "sqp_single.cuh").read_text()
    body = header[header.index("SEC_QP = 0"):header.index("SEC_COUNT")]
    ids = re.findall(r"\bSEC_(\w+)", body)
    assert len(ids) == len(s1_sections.SECTIONS)
    assert ids[0] == "QP" and ids[-1] == "TOTAL"
    assert s1_sections.SECTIONS[-3:] == ("n_ip", "n_sqp", "total")
    sec = dict.fromkeys(s1_sections.SECTIONS, 60)
    sec.update(n_ip=20, n_sqp=3, total=999)
    got = s1_sections.split(sec)
    assert set(got["per_ip"].values()) == {3.0}
    assert set(got["per_sqp"].values()) == {20.0}
    assert (got["n_ip"], got["n_sqp"], got["total"]) == (20, 3, 999)


def test_lin_sections_name_the_header_counters():
    """The tool's SECTIONS are the header's LIN_SEC_* ids in order (up to
    LIN_SEC_COUNT), and its macro pattern matches every counter line of
    the kernel sources and no other line."""
    import re

    header = (qp_cuda._CSRC / "tmpc_ocp.cuh").read_text()
    body = header[header.index("LIN_SEC_COST = 0"):
                  header.index("LIN_SEC_COUNT\n")]
    ids = re.findall(r"\bLIN_SEC_(\w+)", body)
    assert [i.lower() for i in ids] == list(lin_sections.SECTIONS)
    hits = 0
    for path in qp_cuda._CSRC.iterdir():
        for line in path.read_text().splitlines():
            if lin_sections._MACRO.match(line):
                hits += 1
                assert "#define" not in line
            elif re.search(r"\bLIN_(CLOCK|LAP|SKIP|INIT|FLUSH)\b", line):
                assert "#define" in line or line.lstrip().startswith("//"), \
                    line
    assert hits >= 14


def test_kernel_check_covers_the_mirror_entry():
    """kernel_check launches the mirror entry in both designs on the bench
    fleet and every case: nz 6, 7, 8 and 9 under "mirror"."""
    from oscar_mpc_planner_mr_modification_tpu_torch.tools.common import (
        bench_fleet)

    assert kernel_check.MIRROR_DESIGNS == ("warp", "block")
    assert set(kernel_check.MIRROR_DESIGNS) <= set(sqp_fused.MIRROR_MAPPINGS)
    cfg = kernel_check.matrix_config()._replace(regularization="mirror")
    nz = {bench_fleet(1, torch.float64, "cpu")[0].nvar}
    for name, (build, _) in kernel_check.CASES.items():
        ocp = build(np.random.default_rng(0))[0]
        tables = sqp_fused.ocp_tables(ocp, cfg, mirror=True)
        assert tables.reg == sqp_fused.REG_MIRROR, name
        nz.add(tables.nx + tables.nu)
    assert {6, 7, 8, 9} <= nz
