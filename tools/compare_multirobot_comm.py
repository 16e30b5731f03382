#!/usr/bin/env python
"""The multi-robot evaluator of both packages, side by side, at f64 on the
CPU: the JAX package's and the PyTorch port's ``make_multirobot_rollout``
with ``comm="always"`` and ``comm="triggered"`` (the default trigger
settings: geometric threshold 0.5 m, heartbeat 10 ticks), on the same
``antipodal_circle_scenes`` and seed, ``backend="xla"`` on both sides.
Prints one JSON line per mode: whether each metric is equal, its largest
difference, the per-episode collided flags and the mean comm rate of each
side.

    JAX_PLATFORMS=cpu python tools/compare_multirobot_comm.py [EPISODES] [TICKS]

Defaults: 32 episodes x 4 robots x 60 ticks at N=20 (~6 minutes on 4 CPU
threads).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from oscar_mpc_planner_mr_modification_tpu.parallel import (  # noqa: E402
    rollout as jax_rollout)
from oscar_mpc_planner_mr_modification_tpu_torch.parallel import (  # noqa: E402
    rollout as port_rollout)

N_ROBOTS, N = 4, 20


def main(episodes: int = 32, ticks: int = 60) -> dict:
    x0, goals = port_rollout.antipodal_circle_scenes(episodes, N_ROBOTS,
                                                     seed=0)
    jx0, jgoals = jax_rollout.antipodal_circle_scenes(episodes, N_ROBOTS,
                                                      seed=0)
    if not (np.array_equal(np.asarray(jx0), x0)
            and np.array_equal(np.asarray(jgoals), goals)):
        raise RuntimeError("the two packages' scenes differ")
    out = {}
    for comm in ("always", "triggered"):
        kw = dict(n_robots=N_ROBOTS, N=N, n_ticks=ticks, backend="xla",
                  comm=comm)
        t0 = time.perf_counter()
        jax_fn, _ = jax_rollout.make_multirobot_rollout(dtype=jnp.float64,
                                                        **kw)
        want = {k: np.asarray(v) for k, v in
                jax_fn(jnp.asarray(x0), jnp.asarray(goals))._asdict().items()}
        t1 = time.perf_counter()
        port_fn, _ = port_rollout.make_multirobot_rollout(
            dtype=torch.float64, device="cpu", **kw)
        got = {k: v.numpy() for k, v in port_fn(x0, goals)._asdict().items()}
        t2 = time.perf_counter()
        res = {"episodes": episodes, "ticks": ticks, "jax_s": t1 - t0,
               "port_s": t2 - t1}
        for k in want:
            a, b = got[k].astype(float), want[k].astype(float)
            res[k] = {"equal": bool(np.array_equal(a, b)),
                      "max_abs": float(np.max(np.abs(a - b)))}
        res["collided_flags"] = {"port": got["collided"].astype(int).tolist(),
                                 "jax": want["collided"].astype(int).tolist()}
        res["comm_rate_mean"] = {"port": float(got["comm_rate"].mean()),
                                 "jax": float(want["comm_rate"].mean())}
        out[comm] = res
        print(json.dumps({"comm": comm, **res}), flush=True)
    return out


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
