"""The sharded fleet step of the port (``parallel/mesh.py`` on
``torch.distributed``) against the JAX package's ``make_sharded_tmpc_step``
and the port's unsharded ``make_batched_tmpc_step``, at f64 on the CPU.

One spawn serves the file: a module fixture starts 4 gloo ranks (a 2x2
grid, a ``file://`` store under a temporary directory) that run every case
and write their results; the tests below assert on them. The ranks run the
port's own ``mesh._rank_main``, so they import neither this module nor
``conftest.py``, and a join timeout kills them if they hang.

Terms: the winner's index equal, its cost within rtol 1e-9, its z within
atol 1e-9 on stages 0..N-1 (tests/test_fused_flavors.py:138-147,
tests/test_multirobot.py:246-249).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from oscar_mpc_planner_mr_modification_tpu.benchmarks import (
    build_tmpc_fleet, tmpc_bench_ocp as jax_bench_ocp)
from oscar_mpc_planner_mr_modification_tpu.ops.sqp import (
    SQPConfig as JaxSQPConfig)
from oscar_mpc_planner_mr_modification_tpu.parallel import mesh as jax_mesh
from oscar_mpc_planner_mr_modification_tpu_torch.benchmarks import (
    tmpc_bench_ocp)
from oscar_mpc_planner_mr_modification_tpu_torch.ops.sqp import SQPConfig
from oscar_mpc_planner_mr_modification_tpu_torch.parallel import mesh
from oscar_mpc_planner_mr_modification_tpu_torch.parallel.batch import (
    make_batched_tmpc_step)

N, N_PATHS, B = 6, 3, 4  # P = 4 planners, 2 per shard; b_loc = 2
GRID = (2, 2)
CFG = dict(n_sqp=2, n_qp_iter=6, regularization="gershgorin")
PAD = 3  # the padded case disables planner 3: P = 3 padded to 4
JOIN_TIMEOUT_S = 120.0


def fleet():
    """The JAX package's build_tmpc_fleet at f64 (numpy, seed 0)."""
    ocp, settings = jax_bench_ocp(N=N, n_paths=N_PATHS)
    return ocp, build_tmpc_fleet(ocp, settings, B, dtype=np.float64)


@pytest.fixture(scope="module")
def inputs():
    return fleet()[1]


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Every case on the 2x2 gloo grid, one spawn: {case: [per rank]}."""
    work = tmp_path_factory.mktemp("mesh")
    params, xinit, z_init, disabled = inputs
    padded = disabled.copy()
    padded[:, PAD] = True
    for name, dis in (("fleet", disabled), ("padded", padded)):
        np.savez(work / f"{name}.npz", params=params, xinit=xinit,
                 z_init=z_init, disabled=dis)
    ocp_kw = dict(N=N, n_paths=N_PATHS)
    cases = [
        mesh.FleetCase("auto", GRID, ocp_kw, SQPConfig(**CFG),
                       str(work / "fleet.npz")),
        mesh.FleetCase("fused", GRID, ocp_kw, SQPConfig(**CFG),
                       str(work / "fleet.npz"), backend="fused"),
        mesh.FleetCase("padded", GRID, ocp_kw, SQPConfig(**CFG),
                       str(work / "padded.npz"), backend="xla"),
    ]
    return mesh.run_ranks(4, cases, work, devices=["cpu"] * 4,
                          dist_backend="gloo", timeout_s=JOIN_TIMEOUT_S)


def unsharded(inputs, backend, n_planners=None):
    """The port's unsharded step on the same inputs (first ``n_planners``)."""
    ocp, _ = tmpc_bench_ocp(N=N, n_paths=N_PATHS)
    step = make_batched_tmpc_step(ocp, SQPConfig(**CFG), dtype=torch.float64,
                                  device="cpu", backend=backend)
    params, xinit, z_init, disabled = inputs
    p = slice(None, n_planners)
    out = step(params[:, p], xinit, z_init[:, p], disabled[:, p])
    return tuple(x.numpy() for x in (out.best_z, out.best_cost,
                                     out.best_index, out.any_success))


def sharded(results):
    return tuple(mesh.gather_rows(results, k)
                 for k in ("best_z", "best_cost", "best_index", "any_ok"))


def assert_same_winners(got, want):
    z, cost, index, ok = got
    np.testing.assert_array_equal(index, want[2])
    np.testing.assert_array_equal(ok, want[3])
    np.testing.assert_allclose(cost, want[1], rtol=1e-9)
    np.testing.assert_allclose(z[:, :-1], want[0][:, :-1], atol=1e-9)


def test_sharded_step_matches_jax_sharded_step(ranks, inputs):
    """The port's 2x2 gloo grid against JAX's make_sharded_tmpc_step on a
    2x2 mesh of conftest's virtual CPU devices; both resolve "auto" to the
    plain solve ("xla") on the CPU."""
    ocp, _ = fleet()
    jmesh = jax_mesh.make_mesh(*GRID)
    step = jax_mesh.make_sharded_tmpc_step(ocp, JaxSQPConfig(**CFG), jmesh,
                                           dtype=jnp.float64)
    assert step.backend == "xla"
    args = jax_mesh.shard_fleet_arrays(jmesh, *map(jnp.asarray, inputs))
    want = tuple(np.asarray(x) for x in step(*args))
    assert {str(r["backend"]) for r in ranks["auto"]} == {"xla"}
    assert {str(r["staging"]) for r in ranks["auto"]} == {"host"}
    assert_same_winners(sharded(ranks["auto"]), want)


def test_sharded_step_matches_unsharded_xla(ranks, inputs):
    assert_same_winners(sharded(ranks["auto"]), unsharded(inputs, "xla"))


def test_sharded_fused_matches_unsharded_fused(ranks, inputs):
    """backend="fused" on the CPU runs the kernel's plain twin
    (fused_fleet_reference) per rank: the composition a card runs."""
    assert {str(r["backend"]) for r in ranks["fused"]} == {"fused"}
    assert_same_winners(sharded(ranks["fused"]), unsharded(inputs, "fused"))


def test_padded_planner_never_wins(ranks, inputs):
    """P = 3 padded to 4 with a disabled planner (a real guided planner,
    which wins some instances when enabled): the result is the 3-planner
    fleet's, and the pad is never the winner."""
    got = sharded(ranks["padded"])
    assert not np.any(got[2] == PAD)
    assert np.any(sharded(ranks["auto"])[2] == PAD), (
        "the pad should win somewhere when enabled, or this case checks "
        "nothing")
    assert_same_winners(got, unsharded(inputs, "xla", n_planners=PAD))


def test_gathered_payload_is_o_shards(ranks, inputs):
    """The counterpart of tests/test_multirobot.py::
    test_sharded_fleet_step_communication_is_o_shards: each rank's
    all-gathers return only its row's champions, never fleet arrays."""
    params = inputs[0]
    ocp, _ = fleet()
    b_loc, S = B // GRID[0], GRID[1]
    champions = b_loc * S * ((N + 1) * ocp.nvar + 2)
    for case in ranks.values():
        for r in case:
            assert 0 < int(r["gathered_elements"]) <= champions
            assert int(r["gathered_elements"]) < params.size / 8


def test_robots_row_ranks_return_the_same_winners(ranks):
    for case in ranks.values():
        by_row = {}
        for r in case:
            by_row.setdefault(int(r["coords"][0]), []).append(r)
        assert sorted(by_row) == [0, 1]
        for row in by_row.values():
            assert len(row) == GRID[1]
            for k in ("best_z", "best_cost", "best_index", "any_ok"):
                for other in row[1:]:
                    np.testing.assert_array_equal(other[k], row[0][k])


def test_make_mesh_needs_a_group_of_the_grid_size(tmp_path):
    with pytest.raises(ValueError, match="initialized"):
        mesh.make_mesh(1, 1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="1 ranks"):
            mesh.make_mesh(2, 2)
        m = mesh.make_mesh(1, 1)
        assert m.shape == {"robots": 1, "planners": 1}
        assert m.axis_names == ("robots", "planners")
        assert m.coords == (0, 0)
    finally:
        dist.destroy_process_group()


def test_staging_is_decided_at_build(tmp_path, monkeypatch):
    """gloo stages the champions through the host; a group that cannot
    gather, and NCCL on a CPU device, raise when the step is built."""
    ocp, _ = tmpc_bench_ocp(N=N, n_paths=N_PATHS)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        grid = mesh.make_mesh(1, 1)
        step = mesh.make_sharded_tmpc_step(ocp, SQPConfig(**CFG), grid,
                                           dtype=torch.float64, device="cpu")
        assert (step.backend, step.staging) == ("xla", "host")
        for backend, device in (("mpi", "cuda"), ("ucc", "cpu"),
                                ("nccl", "cpu")):
            monkeypatch.setattr(mesh.dist, "get_backend",
                                lambda group, b=backend: b)
            with pytest.raises(ValueError, match=backend if backend != "nccl"
                               else "NCCL"):
                mesh.make_sharded_tmpc_step(ocp, SQPConfig(**CFG), grid,
                                            dtype=torch.float32,
                                            device=device)
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()


@pytest.mark.parametrize("grid, match", [((2, 3), "shards"),
                                         ((3, 2), "robot rows")])
def test_shard_fleet_arrays_needs_divisible_axes(inputs, grid, match):
    grid_mesh = mesh.FleetMesh(*grid, coords=(0, 0), planners_group=None,
                               robots_group=None)
    with pytest.raises(ValueError, match=match):
        mesh.shard_fleet_arrays(grid_mesh, *inputs, device="cpu",
                                dtype=torch.float64)


def test_select_backend():
    assert mesh.select_backend("auto", "cuda") == "fused"
    assert mesh.select_backend("auto", torch.device("cuda", 0)) == "fused"
    assert mesh.select_backend("auto", "cpu") == "xla"
    assert mesh.select_backend("pallas", "cpu") == "pallas"


def test_failed_rank_raises_with_its_traceback(tmp_path):
    case = mesh.FleetCase("missing", (1, 2), dict(N=N, n_paths=1),
                          SQPConfig(**CFG), str(tmp_path / "absent.npz"))
    with pytest.raises(RuntimeError, match="absent.npz"):
        mesh.run_ranks(2, [case], tmp_path, devices=["cpu"] * 2,
                       dist_backend="gloo", timeout_s=JOIN_TIMEOUT_S)
