"""A fleet of robot processes over the socket transport, with the live web
dashboard; the port's counterpart of the JAX package's
``examples/demo_fleet_processes.py``.

    FLEET_SECONDS=20 python -m \\
        oscar_mpc_planner_mr_modification_tpu_torch.examples.demo_fleet_processes

The deployment shape of the reference (one node per robot, a broker in the
middle, a dashboard watching): three spawned ``RobotAgent`` processes
exchange serialized trajectories through a ``transport.TransportBroker``
while the parent serves ``dashboard_web`` on the loopback interface, fed by
the metrics the children send back over a queue. Each robot ticks for
``FLEET_SECONDS`` (20) seconds of wall time, counted from one start that
the parent gives: each child reports ready once its planner is built and
warmed, then waits on a start event, which the parent sets when all three
have reported. A slow spawn spends the start-up budget (``SLACK_S``), never
the ticking window, so no robot ticks alone while a peer is still
building (the robots start synchronized and wait for every peer's first
pose). The JAX demo counts each robot's time from its own start.

Each robot is the JAX demo's (:func:`build_robot`): MPCBase on a and w,
the goal and ellipsoidal obstacles on ``SecondOrderUnicycleModel``
(``tools/common.py::goal_demo_modules``), N=10, 2 obstacles, f64,
``SQPConfig(n_sqp=4, n_qp_iter=8)`` under ``"mirror"``, planned by
``Solver.solve``: on the card one launch of the single-instance kernel S1
per planning tick, on the CPU its plain version. The parent builds the
kernel before it spawns; the children only load it
(``qp_cuda.require_built``). Every join is bounded, and every child is
killed when one fails or overstays.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time

import numpy as np
import torch

from ..tools.common import require_card

STARTS = [(11.0, 0.0, 0.0), (19.0, 0.8, np.pi), (15.0, 4.0, -np.pi / 2)]
#: Goals of comparable norm: the goal weight is normalized by 1 / ||goal||^2.
GOALS = [(19.0, 0.0), (11.0, 0.8), (15.0, -3.0)]
#: Seconds the children may take to report ready (spawn, import, build,
#: warm-up), and again to finish after their ticking window (join).
SLACK_S = 90.0


#: The JAX demo's SQP: 4 iterations of 8 interior-point iterations each,
#: "mirror" (the default regularization).
ROBOT_SQP = dict(n_sqp=4, n_qp_iter=8)


def build_robot(device):
    """The JAX demo's robot: ``(planner, model, settings)``, f64 on
    ``device``."""
    from ..factory import build_planner
    from ..ops.sqp import SQPConfig
    from ..tools.common import goal_demo_modules
    from ..utils import default_settings

    settings = default_settings(N=10, max_obstacles=2, weights={"goal": 5.0},
                                JULES={"synchronized_start": True})
    model, modules = goal_demo_modules(settings)
    planner = build_planner(model, modules, settings, dtype=torch.float64,
                            sqp_config=SQPConfig(**ROBOT_SQP), device=device)
    return planner, model, settings


def robot_main(ns, index, address, start, goal, duration_s, metrics_q,
               device, stats_q, ready_q, go):
    """One robot process: its planner, its ``SocketBus`` on the broker,
    ``ns`` on ``ready_q`` once warmed, then, from when the event ``go`` is
    set (waited on for at most ``SLACK_S``), ticks until ``duration_s``
    have passed, each tick's metrics put on ``metrics_q``; at the end
    ``(ns, solves, S1 launches, median solve ms)`` of its ticks on
    ``stats_q``."""
    from ..factory import prewarm_planner
    from ..multirobot.driver import RobotAgent
    from ..multirobot.transport import SocketBus
    from ..ops import sqp_single
    from ..utils.profiling import BENCHMARKERS

    if torch.device(device).type == "cuda":
        from ..ops import qp_cuda

        qp_cuda.require_built(("sqp_single",))
    planner, model, settings = build_robot(device)
    # Built before joining the fleet: a robot that stalls mid-episode
    # leaves its peers planning on stale trajectories.
    prewarm_planner(planner, model, settings, start_pose=start, goal=goal)
    ready_q.put(ns)
    if not go.wait(timeout=SLACK_S):
        raise RuntimeError(f"{ns}: no start within {SLACK_S} s of ready")
    BENCHMARKERS.reset()
    launches0 = sqp_single.launches
    bus = SocketBus(ns, address)
    try:
        agent = RobotAgent(ns, index, planner, model, settings,
                           goal=np.asarray(goal, float), bus=bus,
                           clock=time.monotonic, start_pose=start)
        agent.set_peers([f"robot{i}" for i in range(len(STARTS))])
        dt = float(settings["integrator_step"])
        t_end = time.monotonic() + duration_s
        while time.monotonic() < t_end:
            metrics_q.put(agent.tick())
            agent.apply_command(dt)
            time.sleep(0.03)
    finally:
        bus.close()
    solves = BENCHMARKERS.get("optimization").durations
    stats_q.put((ns, len(solves), sqp_single.launches - launches0,
                 float(np.median(solves)) * 1e3 if solves else None))


def main(device="cuda", seconds=None) -> dict:
    """The fleet for ``seconds`` (``FLEET_SECONDS``, 20) of ticking; prints
    the dashboard's address, the final dashboard and each robot's ticks and
    communication rate. Returns ``{ns: {ticks, comm_rate, solves,
    launches, solve_ms}}`` (``launches``: the robot's S1 launches, one per
    solve on the card, 0 on the CPU; ``solve_ms``: its median solve, the
    planner's "optimization" span); raises if a child fails or does not
    finish in time."""
    from ..dashboard import render_dashboard
    from ..dashboard_web import DashboardServer
    from ..metrics import MetricsLog
    from ..multirobot.transport import TransportBroker

    cuda = torch.device(device).type == "cuda"
    if cuda:
        require_card("demo_fleet_processes")
        from ..ops import qp_cuda

        qp_cuda.build_all(("sqp_single",))
    duration = float(seconds if seconds is not None
                     else os.environ.get("FLEET_SECONDS", "20"))
    ctx = mp.get_context("spawn")
    broker = TransportBroker()
    q, stats_q, ready_q = ctx.Queue(), ctx.Queue(), ctx.Queue()
    go = ctx.Event()
    procs = [ctx.Process(target=robot_main, name=f"robot{i}",
                         args=(f"robot{i}", i, tuple(broker.address),
                               STARTS[i], GOALS[i], duration, q, str(device),
                               stats_q, ready_q, go))
             for i in range(len(STARTS))]
    log = MetricsLog()
    server = DashboardServer(log).start()
    print(f"live dashboard: {server.url}", flush=True)
    try:
        for p in procs:
            p.start()
        ready = set()
        deadline = time.monotonic() + SLACK_S
        while (len(ready) < len(procs) and time.monotonic() < deadline
               and not any(p.exitcode is not None for p in procs)):
            try:
                ready.add(ready_q.get(timeout=0.5))
            except queue.Empty:
                continue
        if len(ready) < len(procs):
            raise RuntimeError(
                f"robot processes not ready within {SLACK_S} s: ready "
                f"{sorted(ready)}, exit codes "
                f"{ {p.name: p.exitcode for p in procs} }")
        go.set()
        deadline = time.monotonic() + duration + SLACK_S
        while (any(p.is_alive() for p in procs)
               and time.monotonic() < deadline
               and not any(p.exitcode for p in procs)):
            try:
                log.add(q.get(timeout=0.5))
            except queue.Empty:
                continue
        while True:  # drain before joining
            try:
                log.add(q.get_nowait())
            except queue.Empty:
                break
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        broker.close()
        server.stop()
    codes = {p.name: p.exitcode for p in procs}
    if any(c != 0 for c in codes.values()):
        raise RuntimeError(f"robot processes did not finish cleanly: exit "
                           f"codes {codes} (None: still running at the "
                           f"deadline, killed)")
    stats = {}
    while len(stats) < len(procs):
        ns, solves, launches, solve_ms = stats_q.get(timeout=10.0)
        stats[ns] = dict(solves=solves, launches=launches, solve_ms=solve_ms)
    print(render_dashboard(log))
    robots = {}
    for ns in sorted(log.records):
        robots[ns] = dict(ticks=len(log.records[ns]),
                          comm_rate=log.communication_rate(ns), **stats[ns])
        print(f"{ns}: {robots[ns]['ticks']} ticks, comm rate "
              f"{robots[ns]['comm_rate']:.2f}, {stats[ns]['solves']} solves, "
              f"{stats[ns]['launches']} S1 launches, median solve "
              f"{stats[ns]['solve_ms']} ms", flush=True)
    return robots


if __name__ == "__main__":
    main()
