"""The readings that the limits of ``correct`` are set from, on the chip at
a cell's own size:

    python3 -m cardbench.control --workload <name> --seeds <n> ... [--seconds 4]

For every seed, in one process: a short window of the program as it is,
read as a run reads it (the lower readings); the control, the plain
reference in single precision put in the program's place on the same
sampled inputs; and each fault the cell can have, planted in the program
beneath the benchmark's recording:

- ``unchanged``: the solve hands back its warm start as its answer;
- ``half_left_out``: the upper half of the batch (planners of a tick,
  robots of a fleet step) is not solved and reports failure;
- ``answer_altered``: every returned trajectory's first acceleration is
  off by 0.05 where the solve produces it;
- ``fill_off_by_one``: the obstacles' predictions start one step late, so
  that every stage reads the next step's position.

The benchmark's own runs never run this. One JSON line per seed and mode,
then one line with each number's largest program reading and smallest
control and fault readings."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import judge, run as run_mod  # noqa: E402
from .drivers import common  # noqa: E402
from .reference import ocp as ref_ocp  # noqa: E402

IA = ref_ocp.var("a")
SHIFT = 0.05


def _f32_outputs(job):
    solve = judge.reference_solve(job, torch.float32)

    def outputs(params, xinit, warm):
        sol = solve(params, xinit, warm)
        return (sol.z.double().numpy(), sol.cost.double().numpy(),
                sol.success.numpy())

    return outputs


# -- faults of a tick --------------------------------------------------------
def _tick_faults(loop):
    inner, pending = loop.inner, loop.pending
    prep = loop.m.prep
    faults = {}
    if loop.tmpc:
        fetch = inner["fetch"]

        def unchanged():
            res = fetch()
            return res._replace(z=np.array(pending["warm"], dtype=float))

        def half():
            res = fetch()
            z, ok = res.z.copy(), res.success.copy()
            h = len(ok) // 2
            z[h:] = pending["warm"][h:]
            ok[h:] = False
            code = res.exit_code.copy()
            code[h:] = 0
            return res._replace(z=z, success=ok, exit_code=code)

        def altered():
            res = fetch()
            z = res.z.copy()
            z[:, 0, IA] += SHIFT
            return res._replace(z=z)

        faults.update(unchanged=("fetch", unchanged),
                      half_left_out=("fetch", half),
                      answer_altered=("fetch", altered))
    else:
        solve, solver = inner["solve"], loop.planner.solver

        def unchanged():
            code = solve()
            solver._output_z = solver._loaded_warmstart.copy()
            return code

        def altered():
            code = solve()
            solver._output_z[0, IA] += SHIFT
            return code

        faults.update(unchanged=("solve", unchanged),
                      answer_altered=("solve", altered))
    predict = prep.get_constant_velocity_prediction

    def late(position, velocity, dt, steps, probabilistic=False):
        position = np.asarray(position, dtype=float)
        return predict(position + dt * np.asarray(velocity), velocity, dt,
                       steps, probabilistic)

    faults["fill_off_by_one"] = ("prediction", late)
    return faults


def tick_modes(job, seeds, seconds):
    from .drivers import tick

    loop = tick.prepare(job, False)
    faults = _tick_faults(loop)
    prep = loop.m.prep
    for seed in seeds:
        js = job._replace(seed=seed)
        loop.restart(seed)
        tick.window(loop, seconds, False)
        records = list(loop.records)
        yield seed, "program", judge.tick_readings(js, records,
                                                   loop.layout)[0]
        yield seed, "control", judge.tick_readings(
            js, records, loop.layout, outputs=_f32_outputs(js))[0]
        for name, (where, fn) in faults.items():
            if where == "prediction":
                saved = prep.get_constant_velocity_prediction
                prep.get_constant_velocity_prediction = fn
            else:
                saved = loop.inner[where]
                loop.inner[where] = fn
            try:
                loop.restart(seed)
                tick.window(loop, seconds, False)
            finally:
                if where == "prediction":
                    prep.get_constant_velocity_prediction = saved
                else:
                    loop.inner[where] = saved
            yield seed, name, judge.tick_readings(js, list(loop.records),
                                                  loop.layout)[0]


# -- faults of a fleet step ---------------------------------------------------
def _fleet_wraps():
    def unchanged(solve):
        def f(params, xinit, z_init):
            res = solve(params, xinit, z_init)
            return res._replace(z=torch.as_tensor(z_init, dtype=res.z.dtype,
                                                  device=res.z.device))
        return f

    def half(solve):
        def f(params, xinit, z_init):
            res = solve(params, xinit, z_init)
            h = res.z.shape[0] // 2
            z, ok = res.z.clone(), res.success.clone()
            z[h:] = torch.as_tensor(z_init[h:], dtype=z.dtype,
                                    device=z.device)
            ok[h:] = False
            return res._replace(z=z, success=ok)
        return f

    def altered(solve):
        def f(params, xinit, z_init):
            res = solve(params, xinit, z_init)
            z = res.z.clone()
            z[:, 0, IA] += SHIFT
            return res._replace(z=z)
        return f

    return {"unchanged": unchanged, "half_left_out": half,
            "answer_altered": altered}


def _fleet_control(job, sets):
    """The f32 reference's plans for the sampled robots, as a step's
    results."""
    outputs = _f32_outputs(job)
    picks = judge.fleet_picks(job, len(sets), sets[0][0].shape[0])
    results = []
    for (params, xinit, z_init), robots in zip(sets, picks):
        B, P = params.shape[:2]
        z, cost, ok = outputs(*judge.robot_problems(params, xinit, z_init,
                                                    robots))
        cost = np.where(ok, cost, np.inf).reshape(len(robots), P)
        best = np.argmin(cost, axis=1)
        res = {"best_index": np.zeros(B, dtype=int),
               "best_cost": np.full(B, np.inf),
               "best_z": np.zeros((B,) + z_init.shape[2:]),
               "any_success": np.zeros(B, dtype=bool),
               "all_costs": np.full((B, P), np.inf),
               "all_success": np.zeros((B, P), dtype=bool)}
        zz = z.reshape(len(robots), P, *z_init.shape[2:])
        for j, b in enumerate(robots):
            res["best_index"][b] = best[j]
            res["best_cost"][b] = cost[j, best[j]]
            res["best_z"][b] = zz[j, best[j]]
            res["any_success"][b] = np.isfinite(cost[j]).any()
            res["all_costs"][b] = cost[j]
            res["all_success"][b] = np.isfinite(cost[j])
        results.append(res)
    return results


def fleet_modes(job, seeds, seconds):
    from .drivers import fleet as fleet_mod

    fleet = fleet_mod.prepare(job)
    plain = fleet.step
    for seed in seeds:
        js = job._replace(seed=seed)
        fleet.load(seed)
        fleet.step = plain
        w = fleet.window(seconds, False)
        yield seed, "program", judge.fleet_readings(js, fleet.sets,
                                                    w["last"])[0]
        yield seed, "control", judge.fleet_readings(
            js, fleet.sets, _fleet_control(js, fleet.sets))[0]
        for name, wrap in _fleet_wraps().items():
            fleet.step = fleet.build_step(wrap)
            w = fleet.window(seconds, False)
            yield seed, name, judge.fleet_readings(js, fleet.sets,
                                                   w["last"])[0]
        fleet.step = plain


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    root = Path.cwd()
    run_mod.environment(root)
    bench = run_mod.manifest(root)
    cell, _, config, traffic, limits = run_mod.cell_files(root, bench,
                                                          args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("cardbench.control: no CUDA device", file=sys.stderr)
        return 2
    job = common.Job(cell, config, traffic, args.seeds[0], args.seconds,
                     False, args.device, T_START, limits)
    modes = tick_modes if traffic["driver"] == "tick" else fleet_modes
    table = {}
    for seed, mode, readings in modes(job, args.seeds, args.seconds):
        print(json.dumps({"seed": seed, "mode": mode, "readings": readings}),
              flush=True)
        for name, value in readings.items():
            table.setdefault(name, {}).setdefault(mode, []).append(value)
    summary = {name: {mode: (max(v) if mode == "program" else min(v))
                      for mode, v in by_mode.items()}
               for name, by_mode in table.items()}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
