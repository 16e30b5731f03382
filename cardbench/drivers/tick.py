"""One robot's planner ticking back to back in a closed loop on a simulated
clock (:mod:`..traffic.scene`): per tick the pedestrians move one dt, the
planner gets their constant-velocity predictions (the program's data
preparation keeps the ``max_obstacles`` nearest) and plans with
``Planner.solve_mpc``, and the robot moves under the plan's first control
(a brake where the tick failed). A tick is timed from the observations to
the plan on the host.

The end-to-end metrics: ``tick_p95_ms``, the 95th percentile of every
tick's wall time in the window, and ``ticks_per_s``, the ticks completed
over the whole window. A tick fails where the plan reports no success or
ran fewer SQP iterations than the configuration's count."""

from __future__ import annotations

import numpy as np

from ..reference import ocp as ref_ocp
from ..traffic.scene import Scene, path_points
from . import common


class _Clock:
    """The planner's clock: the scene's simulated time."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class Loop:
    """The planner, its scene and the per-tick records."""

    def __init__(self, job: common.Job, pkg_modules, planner, model,
                 settings, clock, trace):
        self.job, self.m = job, pkg_modules
        self.planner, self.model, self.settings = planner, model, settings
        self.clock = clock
        self.cfg = job.config
        self.tmpc = bool(self.cfg["reference"]["tmpc"])
        self.N = planner.solver.N
        self.dt = float(job.traffic["dt"])
        x, y = path_points(job.traffic["path_length"],
                           job.traffic["path_points"])
        self.ref_path = self.m.types.ReferencePath(x=list(x), y=list(y))
        self.robot_area = self.m.prep.define_robot_area(
            settings["robot"]["length"], settings["robot"]["width"],
            settings["n_discs"])
        self.records = []
        self.pending = {}
        self.inner = {}  # the program's calls under the recording; a fault
        # planted in the program replaces one (cardbench.control)
        index = planner.solver.ocp.registry.save_map()
        self.layout = sorted(index, key=index.get)
        self._instrument(trace)

    def _instrument(self, trace):
        """Record what each tick hands the solver and what it returns; in
        a traced run, host spans around the layers' calls."""
        planner = self.planner
        pending = self.pending
        if self.tmpc:
            opt = next(m for m in planner.modules
                       if hasattr(m, "_optimizer"))._optimizer
            self.optimizer = opt
            inner = self.inner
            inner.update(dispatch=opt._dispatch_batch, fetch=opt._fetch_batch)

            def spy_dispatch(params, xinit, warm):
                # copies: the program may write into these arrays later
                pending.update(
                    params=params.copy(), xinit=np.array(xinit),
                    warm=warm.copy(),
                    n_guidance=opt.global_guidance
                    .number_of_guidance_trajectories())
                return inner["dispatch"](params, xinit, warm)

            def spy_fetch():
                res = inner["fetch"]()
                pending.update(z=res.z.copy(), cost=res.cost.copy(),
                               success=res.success.copy())
                return res

            opt._dispatch_batch = common.traced(trace, "dispatch",
                                                spy_dispatch)
            opt._fetch_batch = common.traced(trace, "fetch", spy_fetch)
            opt.update = common.traced(trace, "guidance", opt.update)
        else:
            solver = planner.solver
            inner = self.inner
            inner["solve"] = solver.solve

            def spy_solve():
                pending.update(params=solver.params.data[None].copy(),
                               xinit=solver._xinit.copy(),
                               warm=solver._loaded_warmstart[None].copy(),
                               n_guidance=0)
                code = inner["solve"]()
                pending.update(z=solver._output_z[None].copy(),
                               cost=np.array([solver.info["pobj"]]),
                               success=np.array([code == 1]))
                return code

            solver.solve = common.traced(trace, "solve", spy_solve)
        planner.modules.update_all = common.traced(
            trace, "modules", planner.modules.update_all)

    def release(self):
        """Free the program's state before the reference runs."""
        self.planner = self.optimizer = None
        if self.job.device == "cuda":
            import torch

            torch.cuda.empty_cache()

    def restart(self, seed):
        """A new run of the scene from ``seed``, no records."""
        self.scene = Scene(self.job.traffic, seed)
        self.start_episode(self.scene)
        self.records.clear()

    def start_episode(self, scene):
        self.planner.reset()
        data = self.m.types.RealTimeData()
        data.reference_path = self.ref_path
        self.planner.on_data_received(data, "reference_path")
        self.state = self.m.state.State(self.model)
        self.state.set_array(scene.robot)
        self.episode_tick = 0

    def tick(self, record=True):
        """One tick; returns its wall time (s) and whether it failed."""
        m, N, scene = self.m, self.N, self.scene
        scene.step_pedestrians()
        pos, vel, radius = scene.observations()
        self.state.set_array(scene.robot)
        before = self.state.as_array()
        self.clock.t = scene.clock
        self.pending.clear()
        t0 = common.clock()
        obstacles = []
        for i in range(len(pos)):
            o = m.types.DynamicObstacle(
                index=i, position=pos[i].copy(),
                angle=float(np.arctan2(vel[i, 1], vel[i, 0])), radius=radius)
            o.prediction = m.prep.get_constant_velocity_prediction(
                pos[i], vel[i], self.dt, N)
            obstacles.append(o)
        data = m.types.RealTimeData()
        data.robot_area = self.robot_area
        data.reference_path = self.ref_path
        data.dynamic_obstacles = m.prep.ensure_obstacle_size(
            obstacles, self.state, int(self.settings["max_obstacles"]), N,
            self.dt)
        out = self.planner.solve_mpc(self.state, data)
        t1 = common.clock()
        iters = self.planner.solver.last_iterations_run
        failed = (not out.success) or iters != int(
            self.cfg["reference"]["sqp"]["n_sqp"])
        if out.success:
            a = self.planner.get_solution(0, "a")
            w = self.planner.get_solution(0, "w")
        else:
            a, w = -3.0, 0.0
        if record:
            p = self.pending
            best = (self.optimizer.best_planner_index if self.tmpc
                    else (0 if out.success else -1))
            objectives = (self.optimizer.last_objectives.copy() if self.tmpc
                          else np.array(p.get("cost", [np.nan])))
            self.records.append(dict(
                state=before, obs=(pos, vel, radius), clock=scene.clock,
                params=p.get("params"), xinit=p.get("xinit"),
                warm=p.get("warm"), n_guidance=p.get("n_guidance", 0),
                z=p.get("z"), cost=p.get("cost"), success=p.get("success"),
                best=int(best), objectives=objectives, command=(a, w),
                out_success=bool(out.success),
                progress=self.state.get("spline"), iterations=iters,
                episode_tick=self.episode_tick, seconds=t1 - t0))
        self.episode_tick += 1
        scene.robot = self.state.as_array()
        if scene.advance_robot(a, w):
            scene.reset()
            self.start_episode(scene)
        return t1 - t0, failed


def build(job: common.Job, trace: bool):
    """The planner of the configuration file on the job's device, checked
    against the file, in its loop."""
    import importlib

    cfg, ref = job.config, job.config["reference"]
    pkg = cfg["package"]
    mods = type("Modules", (), {})()
    mods.systems = importlib.import_module(f"{pkg}.systems")
    mods.types = importlib.import_module(f"{pkg}.types")
    mods.prep = importlib.import_module(f"{pkg}.planner.data_preparation")
    mods.state = importlib.import_module(f"{pkg}.solver.state")
    if job.device == "cuda":
        common.module(cfg, "ops.qp_cuda").build_all(tuple(cfg["kernels"]))
    clock = _Clock()
    planner, model, settings = mods.systems.make_system_planner(
        cfg["system"], cfg["configuration"], device=job.device, clock=clock,
        **cfg.get("overrides", {}))
    solver = planner.solver
    common.require_same("N", solver.N, int(ref["N"]))
    common.require_same("dt", solver.dt, float(ref["dt"]))
    common.require_same("dtype", str(solver.dtype).split(".")[-1],
                        cfg["dtype"])
    want = common.sqp_of(cfg, common.module(cfg, "ops.sqp"))
    for field in ("n_sqp", "n_qp_iter", "mu_min", "reg_eps", "w_max",
                  "regularization", "res_eq_tol", "merit_eq_weight",
                  "track_best"):
        common.require_same(f"sqp.{field}", getattr(solver.config, field),
                            getattr(want, field))
    common.require_same("max_obstacles", int(settings["max_obstacles"]),
                        int(ref["n_obstacles"]))
    common.require_same("weights", {k: float(settings["weights"][k])
                                    for k in ref["weights"]},
                        {k: float(v) for k, v in ref["weights"].items()})
    common.require_same("robot_radius", float(settings["robot_radius"]),
                        float(ref["robot_radius"]))
    names = set(solver.ocp.registry.save_map())
    want_names = set(ref_ocp.parameter_names(
        int(ref["n_obstacles"]), int(ref["num_segments"]),
        bool(ref["consistency"]), bool(ref["topology"])))
    common.require_same("the OCP's parameters", sorted(names),
                        sorted(want_names))
    if ref["tmpc"]:
        opt = next(m for m in planner.modules
                   if hasattr(m, "_optimizer"))._optimizer
        common.require_same("planners", opt.n_planners,
                            int(ref["n_paths"]) + 1)
        common.require_same("fleet backend", opt.fleet_backend,
                            cfg["backend"])
    return Loop(job, mods, planner, model, settings, clock, trace)


def window(loop, seconds, trace):
    """Ticks back to back for ``seconds``: the records, each tick's wall
    time, the failures, the window's length, the profiler, the launches
    and the guidance's time."""
    bench = common.module(loop.cfg, "utils.profiling").BENCHMARKERS
    bench.reset()
    before = common.launches(loop.cfg)
    times, failed = [], 0
    with common.profiled(trace) as prof:
        with common.span(trace, "window"):
            t0 = common.clock()
            while common.clock() - t0 < seconds:
                with common.span(trace, "tick"):
                    dt, bad = loop.tick()
                times.append(dt)
                failed += bad
            t_end = common.clock()
    return dict(times=times, failed=failed, window=t_end - t0, prof=prof,
                launches=common.launches_between(
                    before, common.launches(loop.cfg)),
                guidance_s=float(sum(bench.get("guidance").durations)))


def prepare(job: common.Job, trace: bool):
    """The planner built, checked and warmed on the cell's own scene."""
    loop = build(job, trace)
    loop.restart(job.seed)
    for _ in range(int(job.traffic["warmup_ticks"])):
        loop.tick(record=False)
    common.sync(job.device)
    return loop


def run(job: common.Job) -> common.Outcome:
    from .. import judge

    loop = prepare(job, job.trace)
    loop.restart(job.seed)
    setup_s = common.clock() - job.t_start
    w = window(loop, job.seconds, job.trace)
    memory = common.memory_peak(job.device)
    times, n = w["times"], len(w["times"])
    end_to_end = {"tick_p95_ms": float(np.percentile(times, 95) * 1e3),
                  "ticks_per_s": n / w["window"]}
    context = dict(kind="tick", ticks=n, window_s=w["window"],
                   launches=w["launches"], guidance_s=w["guidance_s"],
                   problems=(int(job.config["reference"]["n_paths"]) + 1
                             if loop.tmpc else 1),
                   tick_seconds=times, prof=w["prof"])
    layout, records = loop.layout, loop.records
    loop.release()
    checks = judge.limited(job, *judge.tick_readings(job, records, layout))
    return common.Outcome(n, w["failed"], end_to_end, setup_s, memory,
                          context, checks)
