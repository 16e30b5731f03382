"""Sharded fleet step on ``torch.distributed``, counterpart of the JAX
package's ``parallel/mesh.py``.

The fleet, B instances x P planners, is laid out on a ("robots",
"planners") grid of ranks, ``rank = r * S + s`` for R robot rows and S
planner shards. Each rank solves its (B/R, P/S) block as one fleet solve
(:func:`..ops.sqp.make_fleet_sqp_solver`: on a card one launch of the fused
whole-SQP kernel, ``csrc/sqp_fused.cu``) and selects the best planner in two
phases: a local argmin over its planners (a failed or disabled planner costs
``inf``), then an all-gather of each instance's champion (cost, z, global
planner index) over its row's "planners" group and a final argmin. The bytes
moved are O(shards), not O(P); every rank of a row returns the same winners.

How the champions travel is decided once, when the step is built, from the
planners group's backend: NCCL gathers them on the card (``"device"``), gloo
through the host (``"host"``). Nothing is tried and replaced on an exception.

:func:`run_ranks` spawns the ranks of such a grid as processes (a ``file://``
rendezvous, a join timeout after which they are killed) and runs
:class:`FleetCase` s in each; :func:`dryrun_multichip` runs one step on tiny
shapes through it.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from multiprocessing.connection import wait
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.sqp import SQPConfig, make_fleet_sqp_solver
from .batch import to_torch_fleet

AXIS_NAMES = ("robots", "planners")
#: Where each process-group backend gathers the champions.
STAGING = {"nccl": "device", "gloo": "host"}


@dataclass(frozen=True)
class FleetMesh:
    """A (robots, planners) grid of ranks and this rank's place on it."""

    n_robots: int
    n_planner_shards: int
    coords: tuple  # this rank's (r, s)
    planners_group: object  # the ranks of this rank's row (its "planners" axis)
    robots_group: object  # the ranks of this rank's column

    @property
    def shape(self) -> dict:
        return {"robots": self.n_robots, "planners": self.n_planner_shards}

    @property
    def axis_names(self) -> tuple:
        return AXIS_NAMES


def make_mesh(n_robots: int, n_planner_shards: int) -> FleetMesh:
    """The grid over the default process group, which must be initialized
    and hold exactly ``n_robots * n_planner_shards`` ranks (``ValueError``
    otherwise), laid out row-major as JAX's ``devices.reshape(n_robots,
    n_planner_shards)``. Every rank must call this, in the same order: it
    creates one group per row and one per column (``dist.new_group``)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("make_mesh needs an initialized default process "
                         "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != n_robots * n_planner_shards:
        raise ValueError(f"the default process group has {world} ranks, the "
                         f"grid {n_robots} x {n_planner_shards} needs "
                         f"{n_robots * n_planner_shards}")
    S = n_planner_shards
    rows = [dist.new_group([r * S + s for s in range(S)])
            for r in range(n_robots)]
    cols = [dist.new_group([r * S + s for r in range(n_robots)])
            for s in range(S)]
    r, s = divmod(dist.get_rank(), S)
    return FleetMesh(n_robots, S, (r, s), rows[r], cols[s])


def select_backend(backend: str = "auto", device="cuda") -> str:
    """The fleet backend of the sharded step: ``"auto"`` is the fused
    whole-SQP kernel on a CUDA device (the multi-card path is the fast
    path) and the plain single-instance solve (``"xla"``) on the CPU; any
    other name is returned as it is. The fused kernel refuses ``"mirror"``
    when the step is built: a ``"mirror"`` step on cards names
    ``backend="lanes"``."""
    if backend != "auto":
        return backend
    return "fused" if torch.device(device).type == "cuda" else "xla"


def make_sharded_tmpc_step(ocp, config: SQPConfig, mesh: FleetMesh, *, dtype,
                           device="cuda", backend: str = "auto"):
    """Fleet step over ``mesh``.

    ``step(params_loc (b, p, N, npar), xinit_loc (b, nx), z_init_loc (b, p,
    N+1, nvar), disabled_loc (b, p))`` takes this rank's block (see
    :func:`shard_fleet_arrays`) and returns ``(best_z, best_cost,
    best_index, any_ok)`` over its b instances, ``best_index`` global over
    P. Ties and rows where nothing succeeded resolve as in
    :func:`.batch.make_batched_tmpc_step`: the first minimum, planner 0.

    ``step.backend`` and ``step.staging`` record the fleet backend and how
    the champions travel; after each call ``step.gathered_elements`` is the
    number of elements the all-gathers returned (S x b x ((N+1) nvar + 2)).
    Raises ``ValueError`` at build for a planners group whose backend is
    neither NCCL nor gloo, and for NCCL on a CPU device."""
    device = torch.device(device)
    backend = select_backend(backend, device)
    group_backend = str(dist.get_backend(mesh.planners_group))
    staging = STAGING.get(group_backend)
    if staging is None:
        raise ValueError(f"the planners group's backend {group_backend!r} "
                         f"cannot gather the champions (one of {list(STAGING)})")
    if staging == "device" and device.type != "cuda":
        raise ValueError("an NCCL group gathers CUDA tensors; the step's "
                         f"device is {device}")
    gather_device = device if staging == "device" else torch.device("cpu")
    fleet_solve = make_fleet_sqp_solver(ocp, config, dtype=dtype,
                                        device=device, backend=backend)
    S, shard = mesh.n_planner_shards, mesh.coords[1]
    group = mesh.planners_group

    def all_gather(x):
        out = [torch.empty_like(x) for _ in range(S)]
        dist.all_gather(out, x, group=group)
        return torch.stack(out, dim=1).to(device)  # (b, S, ...)

    def step(params_loc, xinit_loc, z_init_loc, disabled_loc):
        params = torch.as_tensor(params_loc, dtype=dtype, device=device)
        xinit = torch.as_tensor(xinit_loc, dtype=dtype, device=device)
        z_init = torch.as_tensor(z_init_loc, dtype=dtype, device=device)
        disabled = torch.as_tensor(disabled_loc, dtype=torch.bool,
                                   device=device)
        b, p = params.shape[:2]
        res = fleet_solve(params.reshape(b * p, *params.shape[2:]),
                          xinit.repeat_interleave(p, dim=0),
                          z_init.reshape(b * p, *z_init.shape[2:]))
        costs = torch.where(res.success.reshape(b, p) & ~disabled,
                            res.cost.reshape(b, p),
                            torch.full((b, p), float("inf"), dtype=dtype,
                                       device=device))
        z = res.z.reshape(b, p, *res.z.shape[1:])
        b_idx = torch.arange(b, device=device)

        # Phase 1: this shard's champion per instance.
        local_best = torch.argmin(costs, dim=1)
        champ = torch.cat([costs[b_idx, local_best][:, None],
                           z[b_idx, local_best].reshape(b, -1)], dim=1)
        champ_index = shard * p + local_best

        # Phase 2: the champions of the row's shards, then the final argmin.
        all_champ = all_gather(champ.to(gather_device))
        all_index = all_gather(champ_index.to(gather_device))
        step.gathered_elements = all_champ.numel() + all_index.numel()
        win = torch.argmin(all_champ[:, :, 0], dim=1)
        best = all_champ[b_idx, win]
        best_cost = best[:, 0]
        return (best[:, 1:].reshape(b, *z.shape[2:]), best_cost,
                all_index[b_idx, win], torch.isfinite(best_cost))

    step.backend, step.staging = backend, staging
    step.fleet_solve, step.gathered_elements = fleet_solve, 0
    return step


def shard_fleet_arrays(mesh: FleetMesh, params, xinit, z_init, disabled, *,
                       device="cuda", dtype):
    """This rank's block of the global fleet (numpy, from either package's
    ``build_tmpc_fleet``) as tensors on ``device``: instances sharded over
    "robots", planners over "planners". ``ValueError`` unless R divides B
    and S divides P (pad the planners with disabled copies)."""
    B, P = np.shape(params)[:2]
    R, S = mesh.n_robots, mesh.n_planner_shards
    if B % R:
        raise ValueError(f"B={B} instances do not split over {R} robot rows")
    if P % S:
        raise ValueError(f"P={P} planners do not split over {S} shards: pad "
                         "the planners with disabled copies")
    r, s = mesh.coords
    rows = slice(r * (B // R), (r + 1) * (B // R))
    cols = slice(s * (P // S), (s + 1) * (P // S))
    return to_torch_fleet(np.asarray(params)[rows, cols],
                          np.asarray(xinit)[rows],
                          np.asarray(z_init)[rows, cols],
                          np.asarray(disabled)[rows, cols],
                          device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Spawned ranks
# ---------------------------------------------------------------------------
class FleetCase(NamedTuple):
    """One sharded step that every spawned rank runs: the bench OCP
    (``benchmarks.tmpc_bench_ocp(**ocp)``), the global fleet in an ``.npz``
    (params, xinit, z_init, disabled), and ``repeat`` calls after the first
    timed by CUDA events (on a card). A rank's
    result holds its winners, its place, the step's backend, staging and
    gathered elements, the median ms, and the kernel launches of its first
    call (``b2_launches`` of the fused kernel, ``b1_launches`` of the QP
    kernel)."""

    name: str
    grid: tuple  # (n_robots, n_planner_shards)
    ocp: dict
    config: SQPConfig
    fleet: str
    dtype: torch.dtype = torch.float64
    backend: str = "auto"
    repeat: int = 0


def _run_case(case: FleetCase, device) -> dict:
    from ..benchmarks import tmpc_bench_ocp

    ocp, _ = tmpc_bench_ocp(**case.ocp)
    mesh = make_mesh(*case.grid)
    step = make_sharded_tmpc_step(ocp, case.config, mesh, dtype=case.dtype,
                                  device=device, backend=case.backend)
    with np.load(case.fleet) as f:
        args = shard_fleet_arrays(mesh, f["params"], f["xinit"], f["z_init"],
                                  f["disabled"], device=device,
                                  dtype=case.dtype)
    from ..ops import qp_cuda, sqp_fused

    n0 = (sqp_fused.launches, qp_cuda.launches)
    best_z, best_cost, best_index, any_ok = step(*args)
    b2_launches = sqp_fused.launches - n0[0]
    b1_launches = qp_cuda.launches - n0[1]
    ms = float("nan")
    if case.repeat:
        from ..tools.common import cuda_time_ms

        ms = cuda_time_ms(lambda: step(*args), reps=case.repeat, warmup=0)[0]
    return dict(best_z=best_z.cpu().numpy(), best_cost=best_cost.cpu().numpy(),
                best_index=best_index.cpu().numpy(),
                any_ok=any_ok.cpu().numpy(), coords=np.asarray(mesh.coords),
                backend=step.backend, staging=step.staging,
                gathered_elements=step.gathered_elements, ms=ms,
                b2_launches=b2_launches, b1_launches=b1_launches)


def _rank_main(rank, world_size, init_method, dist_backend, device, cases,
               workdir, timeout_s):
    """A spawned rank: join the process group, run every case, write one
    ``<case>.rank<r>.npz`` each (a traceback to ``rank<r>.err`` on a
    failure). On a card it loads the kernel libraries its parent built and
    never starts nvcc. The ranks share one host, so gloo's transport binds
    the loopback interface unless ``GLOO_SOCKET_IFNAME`` says otherwise."""
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        device = torch.device(device)
        if device.type == "cuda":
            from ..ops import qp_cuda

            torch.cuda.set_device(device)
            qp_cuda.require_built(("sqp_fused",))
        else:  # the ranks share the host's cores
            torch.set_num_threads(1)
        dist.init_process_group(dist_backend, init_method=init_method,
                                rank=rank, world_size=world_size,
                                timeout=timedelta(seconds=timeout_s))
        try:
            for case in cases:
                np.savez(Path(workdir) / f"{case.name}.rank{rank}.npz",
                         **_run_case(case, device))
        finally:
            dist.destroy_process_group()
    except BaseException:
        (Path(workdir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run_ranks(world_size: int, cases, workdir, *, devices, dist_backend: str,
              timeout_s: float = 120.0) -> dict:
    """Spawn ``world_size`` ranks (``torch.multiprocessing``, start method
    "spawn"; rank r on ``devices[r]``), rendezvous through a ``file://``
    store in ``workdir`` and run ``cases`` in each. Every rank is killed
    when one fails or when ``timeout_s`` passes, and then this raises.
    Returns ``{case name: [rank 0's result, ...]}``."""
    import torch.multiprocessing as mp

    workdir = Path(workdir)
    store = workdir / "rendezvous"
    store.unlink(missing_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        rank, world_size, f"file://{store}", dist_backend, str(devices[rank]),
        list(cases), str(workdir), timeout_s)) for rank in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            left = deadline - time.monotonic()
            if left <= 0:
                break
            wait([p.sentinel for p in procs if p.is_alive()],
                 timeout=min(left, 1.0))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
        for p in procs:
            p.join(10)
    errors = [f"rank {r}: exit code {p.exitcode}" for r, p in enumerate(procs)
              if p.exitcode != 0]
    if errors:
        tracebacks = [f.read_text() for f in sorted(workdir.glob("rank*.err"))]
        reason = (f"killed after {timeout_s:g} s" if hung else "failed")
        raise RuntimeError(f"sharded ranks {reason}: {errors}\n"
                           + "\n".join(tracebacks))
    out = {}
    for case in cases:
        out[case.name] = []
        for rank in range(world_size):
            with np.load(workdir / f"{case.name}.rank{rank}.npz") as f:
                out[case.name].append({k: f[k][()] if f[k].ndim == 0 else f[k]
                                       for k in f.files})
    return out


def gather_rows(results, key: str) -> np.ndarray:
    """The global (B, ...) array of ``key`` from the per-rank results of
    one case: the blocks of the ranks of planner shard 0, in robot-row
    order."""
    firsts = sorted((int(r["coords"][0]), r[key]) for r in results
                    if int(r["coords"][1]) == 0)
    return np.concatenate([block for _, block in firsts])


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One sharded fleet step on ``n_devices`` spawned ranks at tiny shapes
    (N=10, P = 2 x shards, B = 2 x robots, f32): ``n_devices`` factored
    into (robots, planner shards) with 2 shards when it is even, every rank
    on ``device``. The ranks join a gloo group, but one rank on a card an
    NCCL group: NCCL puts no two ranks on one card, so more than one take
    gloo with the champions staged through the host. Raises unless every
    cost is finite; prints and returns the mesh, backend, staging, costs
    and indices."""
    from ..benchmarks import build_tmpc_fleet, tmpc_bench_ocp
    from ..ops import qp_cuda

    device = torch.device(device)
    n_shards = 2 if n_devices % 2 == 0 else 1
    n_robots = n_devices // n_shards
    P, B = 2 * n_shards, 2 * n_robots
    ocp_kw = dict(N=10, n_paths=P - 1)
    config = SQPConfig(n_sqp=5, n_qp_iter=8, mu_min=1e-6, w_max=1e6,
                       reg_eps=1e-4, regularization="gershgorin")
    dist_backend = ("nccl" if device.type == "cuda" and n_devices == 1
                    else "gloo")
    if device.type == "cuda":
        qp_cuda.build_all(("sqp_fused",))
    ocp, settings = tmpc_bench_ocp(**ocp_kw)
    fleet = build_tmpc_fleet(ocp, settings, B)
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "fleet.npz")
        np.savez(path, **dict(zip(("params", "xinit", "z_init", "disabled"),
                                  fleet)))
        case = FleetCase("dryrun", (n_robots, n_shards), ocp_kw, config, path,
                         dtype=torch.float32)
        ranks = run_ranks(n_devices, [case], work,
                          devices=[device] * n_devices,
                          dist_backend=dist_backend)["dryrun"]
    cost = gather_rows(ranks, "best_cost")
    index = gather_rows(ranks, "best_index")
    if cost.shape != (B,) or not np.all(np.isfinite(cost)):
        raise RuntimeError(f"dryrun_multichip: costs of shape (B,) = ({B},) "
                           f"and finite expected, got {cost}")
    summary = dict(mesh={"robots": n_robots, "planners": n_shards}, B=B, P=P,
                   dist_backend=dist_backend, backend=str(ranks[0]["backend"]),
                   staging=str(ranks[0]["staging"]), best_cost=cost,
                   best_index=index)
    print(f"dryrun_multichip: mesh {summary['mesh']} B={B} P={P} "
          f"{dist_backend} backend={summary['backend']} "
          f"staging={summary['staging']} best costs {np.round(cost, 3)} "
          f"indices {index}", flush=True)
    return summary
