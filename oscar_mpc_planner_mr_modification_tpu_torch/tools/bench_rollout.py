"""Closed-loop Monte-Carlo throughput of the port's evaluators on the card
(``parallel/rollout.py``).

    python3 -m oscar_mpc_planner_mr_modification_tpu_torch.tools.bench_rollout

Counterpart of the JAX package's ``tools/bench_rollout.py``, at its shapes
and defaults: the goal evaluator (BASELINE config 1; 4096 episodes, N=20,
60 ticks, 3 obstacles), the multi-robot evaluator (1024 episodes x 4
robots, ``comm="always"``), the contouring evaluator (BASELINE config 2;
4096 episodes) and the T-MPC++ evaluator (819 episodes x 5 planners, 4
obstacles), and beside them the contouring evaluator's CC-MPC flavour
(BASELINE config 3, ``constraints="gaussian"``, risk 0.05, sigma growing by
0.05 sqrt(k + 1); 4096 episodes on the contouring scenes), all f32 with ``backend="auto"`` (kernel B2, one launch per
tick). Each is run once to warm up, then timed on 4 scene sets of other
seeds with the host clock, inputs uploaded and metrics read back inside the
time. Prints one JSON line per evaluator: episodes/s, problems per tick,
wall seconds per batch, the scene metrics and success rates, and the
card's name and power limit (``nvidia-smi``). The environment variables of
the JAX tool set the shapes: ``ROLLOUT_B``, ``ROLLOUT_N``,
``ROLLOUT_TICKS``, ``ROLLOUT_OBS``, ``ROLLOUT_ROBOTS``, ``ROLLOUT_MR_B``,
``ROLLOUT_PATHS``, ``ROLLOUT_TMPC_B``, ``ROLLOUT_TMPC_OBS``.

:func:`evaluators` describes each evaluator (how to build it, its scenes,
its first tick's fleet-solve inputs, its summary and its operation counts);
``chip_smoke.py`` drives the same descriptions.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops import roofline
from ..parallel import rollout as ro
from .common import card_line, require_card


class Evaluator(NamedTuple):
    name: str  # "goal", "multirobot", "contouring", "ccmpc" or "tmpc"
    make: Callable  # (n_ticks, dtype, device, backend) -> (rollout, ocp)
    scenes: Callable  # (B, seed) -> numpy inputs of rollout
    batch: int  # episodes
    planners: int  # fleet problems per episode and tick
    first_tick: Callable  # (rollout, ocp, inputs on the device) -> (P, x, Z)
    summary: Callable  # metrics (numpy dict) -> scene metrics
    counts: tuple  # (lin, merit, ip_iter) operations per problem


def _stationary(x, nu, T):
    """(B, T, nu + nx): the iterate at rest in state x (B, nx)."""
    return torch.cat([x.new_zeros((x.shape[0], T, nu)),
                      x[:, None].expand(-1, T, -1)], dim=2)


def _mean(m, key):
    return float(np.mean(m[key]))


def evaluators(B=4096, N=20, n_ticks=60, n_obs=3, R=4, B_mr=None,
               n_paths=4, B_t=None, n_obs_t=4) -> dict:
    """The evaluators at these shapes, by name (the JAX tool's defaults;
    ``"ccmpc"`` at the contouring evaluator's)."""
    B_mr = B_mr or max(B // R, 1)
    B_t = B_t or max(B // (n_paths + 1), 1)
    goal_counts = (roofline.GOAL_LIN_FLOPS, roofline.GOAL_MERIT_FLOPS,
                   roofline.GOAL_IP_ITER_FLOPS)

    def goal_first(rollout, ocp, args):
        x0 = args[0]
        return rollout.first_tick_params(*args), x0, _stationary(
            x0, ocp.nu, N + 1)

    def mr_first(rollout, ocp, args):
        x0, goals = args
        P = rollout.first_tick_params(x0, goals).reshape(-1, N, ocp.npar)
        x = x0.reshape(-1, ocp.nx)
        return P, x, _stationary(x, ocp.nu, N + 1)

    def contouring_first(rollout, ocp, args):
        x = args[0].clone()
        x[:, ocp.model.state_index("spline")] = torch.clamp(x[:, 0], 0.0,
                                                            50.0)
        return rollout.first_tick_params(*args), x, _stationary(
            x, ocp.nu, N + 1)

    def tmpc_first(rollout, ocp, args):
        P = rollout.first_tick_params(*args).reshape(-1, N, ocp.npar)
        Z = rollout.first_tick_seeds(*args).reshape(-1, N + 1, ocp.nvar)
        return P, Z[:, 0, ocp.nu:].contiguous(), Z

    evs = [
        Evaluator(
            "goal",
            lambda n, dtype, device, backend="auto": ro.make_batch_rollout(
                n_obstacles=n_obs, N=N, n_ticks=n, dtype=dtype,
                device=device, backend=backend),
            lambda b, seed: ro.sample_scenes(b, n_obs, seed=seed), B, 1,
            goal_first,
            lambda m: {"reached_rate": _mean(m, "reached"),
                       "collision_rate": _mean(m, "collided"),
                       "solve_success": _mean(m, "solve_success_rate")},
            goal_counts),
        Evaluator(
            "multirobot",
            lambda n, dtype, device, backend="auto":
                ro.make_multirobot_rollout(n_robots=R, N=N, n_ticks=n,
                                           dtype=dtype, device=device,
                                           backend=backend),
            lambda b, seed: ro.antipodal_circle_scenes(b, R, seed=seed), B_mr,
            R, mr_first,
            lambda m: {"all_reached_rate": _mean(m, "all_reached"),
                       "collision_rate": _mean(m, "collided"),
                       "solve_success": _mean(m, "solve_success_rate"),
                       "comm_rate": _mean(m, "comm_rate")},
            goal_counts),
        Evaluator(
            "contouring",
            lambda n, dtype, device, backend="auto":
                ro.make_contouring_rollout(n_obstacles=n_obs, N=N,
                                           n_ticks=n, dtype=dtype,
                                           device=device, backend=backend),
            lambda b, seed: ro.contouring_scenes(b, n_obs, seed=seed), B, 1,
            contouring_first,
            lambda m: {"mean_progress_m": _mean(m, "progress"),
                       "collision_rate": _mean(m, "collided"),
                       "solve_success": _mean(m, "solve_success_rate")},
            (roofline.ROLLOUT_LIN_FLOPS, roofline.ROLLOUT_MERIT_FLOPS,
             roofline.ROLLOUT_IP_ITER_FLOPS)),
        Evaluator(
            "ccmpc",
            lambda n, dtype, device, backend="auto":
                ro.make_contouring_rollout(n_obstacles=n_obs, N=N,
                                           n_ticks=n, dtype=dtype,
                                           device=device, backend=backend,
                                           constraints="gaussian", risk=0.05,
                                           sigma_step=0.05),
            lambda b, seed: ro.contouring_scenes(b, n_obs, seed=seed), B, 1,
            contouring_first,
            lambda m: {"mean_progress_m": _mean(m, "progress"),
                       "collision_rate": _mean(m, "collided"),
                       "solve_success": _mean(m, "solve_success_rate"),
                       "mean_min_obstacle_dist_m": _mean(
                           m, "min_obstacle_dist")},
            (roofline.CCMPC_LIN_FLOPS, roofline.CCMPC_MERIT_FLOPS,
             roofline.CCMPC_IP_ITER_FLOPS)),
        Evaluator(
            "tmpc",
            lambda n, dtype, device, backend="auto": ro.make_tmpc_rollout(
                n_obstacles=n_obs_t, N=N, n_ticks=n, n_paths=n_paths,
                dtype=dtype, device=device, backend=backend),
            lambda b, seed: ro.tmpc_scenes(b, n_obs_t, seed=seed), B_t,
            n_paths + 1, tmpc_first,
            lambda m: {"mean_progress_m": _mean(m, "progress"),
                       "collision_rate": _mean(m, "collided"),
                       "plan_success": _mean(m, "plan_success_rate"),
                       "planner_success": _mean(m, "planner_success_rate"),
                       "guided_selected_rate": _mean(m,
                                                     "guided_selected_rate"),
                       "topology_switch_rate": _mean(m,
                                                     "topology_switch_rate")},
            (roofline.LIN_FLOPS, roofline.MERIT_FLOPS,
             roofline.IP_ITER_FLOPS)),
    ]
    return {ev.name: ev for ev in evs}


def read_metrics(m) -> dict:
    """Every metric of a rollout in one device-to-host copy, as numpy."""
    flat = torch.cat([x.reshape(x.shape[0], -1).to(torch.float64)
                      for x in m], dim=1).cpu().numpy()
    out, col = {}, 0
    for name, x in zip(m._fields, m):
        n = x[0].numel()
        out[name] = flat[:, col:col + n].reshape(x.shape)
        col += n
    return out


def throughput(ev: Evaluator, rollout, seeds=(1, 2, 3, 4)):
    """``(metrics of the last run, wall seconds per run)``: one batch of
    scenes per seed, each timed from the upload of its inputs to the
    readback of its metrics."""
    walls = []
    for seed in seeds:
        scenes = ev.scenes(ev.batch, seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = read_metrics(rollout(*scenes))
        walls.append(time.perf_counter() - t0)
    return m, walls


def result(ev: Evaluator, m, walls, n_ticks, N, card) -> dict:
    """The JSON line of one evaluator."""
    wall = float(np.median(walls))
    prefix = "closed_loop" if ev.name == "goal" else ev.name  # the JAX names
    return {"metric": f"{prefix}_episodes_per_s",
            "value": ev.batch / wall, "unit": "episodes/s",
            "batch": ev.batch, "problems_per_tick": ev.batch * ev.planners,
            "n_ticks": n_ticks, "horizon": N, "wall_s_per_batch": wall,
            "wall_s": walls,
            "planner_solves_per_s": ev.batch * ev.planners * n_ticks / wall,
            **ev.summary(m), "card": card,
            "device": torch.cuda.get_device_name(0)}


def main():
    require_card("bench_rollout")
    env = os.environ.get
    N, n_ticks = int(env("ROLLOUT_N", "20")), int(env("ROLLOUT_TICKS", "60"))
    B = int(env("ROLLOUT_B", "4096"))
    evs = evaluators(
        B=B, N=N, n_ticks=n_ticks, n_obs=int(env("ROLLOUT_OBS", "3")),
        R=int(env("ROLLOUT_ROBOTS", "4")),
        B_mr=int(env("ROLLOUT_MR_B", "0")) or None,
        n_paths=int(env("ROLLOUT_PATHS", "4")),
        B_t=int(env("ROLLOUT_TMPC_B", "0")) or None,
        n_obs_t=int(env("ROLLOUT_TMPC_OBS", "4")))
    card = card_line()
    for ev in evs.values():
        rollout, _ = ev.make(n_ticks, torch.float32, "cuda")
        read_metrics(rollout(*ev.scenes(ev.batch, 0)))  # build, warm up
        m, walls = throughput(ev, rollout)
        print(json.dumps(result(ev, m, walls, n_ticks, N, card)), flush=True)


if __name__ == "__main__":
    main()
