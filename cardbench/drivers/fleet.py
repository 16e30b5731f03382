"""A fleet of robots planned in one batched T-MPC++ step, back to back in a
closed loop: the step cycles over a few input sets that set-up makes from
the seed (:mod:`..traffic.fleet`) and uploads once, and each step ends
when every robot's plan (chosen planner, its cost and trajectory) is on
the host. ``plans_per_s`` is the robot plans completed over the whole
window; a plan fails where none of its planners succeeded."""

from __future__ import annotations

import numpy as np

from ..reference import ocp as ref_ocp
from ..traffic import fleet as fleet_traffic
from . import common


class Fleet:
    """The program's batched step of the configuration, and the input sets
    of one seed on the device."""

    def __init__(self, job: common.Job):
        import torch

        self.job, cfg = job, job.config
        ref, traffic = cfg["reference"], job.traffic
        self.batch, self.n_sets = int(traffic["robots"]), int(
            traffic["input_sets"])
        self.P = int(ref["n_paths"]) + 1
        bench = common.module(cfg, "benchmarks")
        self.batch_mod = common.module(cfg, "parallel.batch")
        self.sqp_mod = common.module(cfg, "ops.sqp")
        if job.device == "cuda":
            common.module(cfg, "ops.qp_cuda").build_all(tuple(cfg["kernels"]))
        self.ocp_prog, settings = bench.tmpc_bench_ocp(
            N=int(ref["N"]), n_paths=int(ref["n_paths"]),
            max_obstacles=int(ref["n_obstacles"]))
        self.ocp = ref_ocp.build(ref)
        index = self.ocp_prog.registry.save_map()
        common.require_same("the OCP's parameters", sorted(index),
                            sorted(self.ocp.names))
        common.require_same("dt", self.ocp_prog.dt, float(ref["dt"]))
        common.require_same("weights", {k: float(settings["weights"][k])
                                        for k in ref["weights"]},
                            {k: float(v) for k, v in ref["weights"].items()})
        self.to_prog = np.array([self.ocp.index[name] for name in
                                 sorted(index, key=index.get)])
        self.dtype = getattr(torch, cfg["dtype"])
        self.step = self.build_step()

    def build_step(self, wrap=None):
        """The batched step; ``wrap(fleet_solve)`` plants a fault in the
        program's fleet solve (``cardbench.control``)."""
        make = self.batch_mod.make_fleet_sqp_solver
        if wrap is not None:
            self.batch_mod.make_fleet_sqp_solver = (
                lambda *a, **k: wrap(make(*a, **k)))
        try:
            return self.batch_mod.make_batched_tmpc_step(
                self.ocp_prog, common.sqp_of(self.job.config, self.sqp_mod),
                dtype=self.dtype, device=self.job.device,
                backend=self.job.config["backend"])
        finally:
            self.batch_mod.make_fleet_sqp_solver = make

    def load(self, seed):
        """The input sets of ``seed``: kept on the host in the reference
        layout, uploaded in the program's."""
        import torch

        ref, dev = self.job.config["reference"], self.job.device
        self.sets = [fleet_traffic.build(self.ocp, ref, self.batch,
                                         [int(seed) % 2 ** 63, s])
                     for s in range(self.n_sets)]
        self.on_device = [tuple(
            torch.as_tensor(a, dtype=self.dtype, device=dev)
            for a in (params[..., self.to_prog], xinit, z_init)) + (
            torch.zeros((self.batch, self.P), dtype=torch.bool, device=dev),)
            for params, xinit, z_init in self.sets]

    def plan(self, j):
        """Step ``j`` on input set ``j % n_sets``, its plans on the host."""
        out = self.step(*self.on_device[j % self.n_sets])
        return {k: getattr(out, k).cpu().numpy() for k in (
            "best_index", "best_cost", "best_z", "any_success", "all_costs",
            "all_success")}

    def window(self, seconds, trace):
        before = common.launches(self.job.config)
        last, steps, failed = [None] * self.n_sets, 0, 0
        with common.profiled(trace) as prof:
            with common.span(trace, "window"):
                t0 = common.clock()
                while common.clock() - t0 < seconds:
                    with common.span(trace, "step"):
                        host = self.plan(steps)
                    last[steps % self.n_sets] = host
                    failed += int(np.sum(~host["any_success"]))
                    steps += 1
                t_end = common.clock()
        return dict(last=last, steps=steps, failed=failed,
                    window=t_end - t0, prof=prof,
                    launches=common.launches_between(
                        before, common.launches(self.job.config)))

    def release(self):
        self.on_device = self.step = None
        if self.job.device == "cuda":
            import torch

            torch.cuda.empty_cache()


def prepare(job: common.Job):
    fleet = Fleet(job)
    fleet.load(job.seed)
    for j in range(fleet.n_sets * int(job.traffic["warmup_cycles"])):
        fleet.plan(j)
    common.sync(job.device)
    return fleet


def run(job: common.Job) -> common.Outcome:
    from .. import judge

    fleet = prepare(job)
    setup_s = common.clock() - job.t_start
    w = fleet.window(job.seconds, job.trace)
    memory = common.memory_peak(job.device)
    sets = fleet.sets
    fleet.release()
    plans = w["steps"] * fleet.batch
    context = dict(kind="fleet", steps=w["steps"], plans=plans,
                   window_s=w["window"], launches=w["launches"],
                   problems=fleet.batch * fleet.P, prof=w["prof"])
    checks = judge.limited(job, *judge.fleet_readings(job, sets, w["last"]))
    return common.Outcome(plans, w["failed"],
                          {"plans_per_s": plans / w["window"]}, setup_s,
                          memory, context, checks)
