"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (:mod:`.reference`).

Ticks: a sample of the window's ticks, drawn from the seed. For each, the
parameters, initial state and warm starts the tick handed its solver are
worked out again from the scene (``fill_gap``, the largest gap relative to
1 + the value); every planner's problem is solved again by the reference
SQP from those inputs (``solve_gap``, the median over the planners that
both sides solve of the trajectory's largest gap relative to 1 + its
largest entry: the largest swings by rounding, see PERF.md); the cost the
program reports is held against the reference's cost of the program's own
trajectory (``cost_gap``); and the success flags (against the reference's
defect at the program's trajectory), the fair-cost selection and the
command are worked out again (``select_errors``, a count).

Fleet: a sample of robots of each input set, each robot's planners solved
by the reference from the inputs the benchmark made. The chosen planner's
trajectory against the reference's (``solve_gap``, the median over the
sampled robots); its reported cost against the reference's cost of that
trajectory (``cost_gap``); and ``select_errors``: a choice that is not the
first planner of least reported cost, a success flag that the costs or
the trajectory's defect do not bear out, and a robot with no solved
planner where the reference solves one with its defect below half the
tolerance (or the other way round, beyond twice it), the cases that
rounding cannot decide."""

from __future__ import annotations

import sys

import numpy as np
import torch

from .reference import ocp as ref_ocp
from .reference import sqp as ref_sqp
from .reference import tick as ref_tick


def _mapping(layout, ocp):
    """Program column of each reference parameter."""
    where = {name: i for i, name in enumerate(layout)}
    return np.array([where[name] for name in ocp.names])


def relative_gap(a, b):
    """Per problem: max |a - b| / (1 + max |b|) over the trailing axes."""
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    axes = tuple(range(1, a.ndim))
    return np.max(np.abs(a - b), axis=axes) / (1.0 + np.max(np.abs(b),
                                                            axis=axes))


def tick_picks(job, n):
    """The sampled ticks of a window of ``n`` ticks, drawn from the seed."""
    rng = np.random.default_rng([int(job.seed) % 2 ** 63, 7])
    k = min(int(job.traffic["check"]["sample_ticks"]), n)
    return sorted(int(i) for i in rng.choice(n, size=k, replace=False))


def fleet_picks(job, n_sets, batch):
    """The sampled robots of each input set, drawn from the seed."""
    rng = np.random.default_rng([int(job.seed) % 2 ** 63, 11])
    per_set = max(int(job.traffic["check"]["sample_robots"]) // n_sets, 1)
    return [np.sort(rng.choice(batch, size=min(per_set, batch),
                               replace=False)) for _ in range(n_sets)]


def reference_solve(job, dtype=torch.float64):
    """``solve(params, xinit, z_init)`` of the configuration's reference
    SQP in ``dtype``."""
    ref = job.config["reference"]
    ocp = ref_ocp.build(ref)
    return lambda *a: ref_sqp.solve(ocp, ref["sqp"], *a,
                                    variant=ref["variant"], dtype=dtype)


def tick_readings(job, records, layout, outputs=None):
    """The four numbers of a tick run and a description of where each
    worst one lies. ``outputs(params, xinit, warm) -> (z, cost, success)``
    puts another solver's answers in the program's place (the control)."""
    ref = dict(job.config["reference"],
               path_length=float(job.traffic["path_length"]),
               obstacle_dt=float(job.traffic["dt"]))
    ocp = ref_ocp.build(ref)
    cols = _mapping(layout, ocp)
    picks = tick_picks(job, len(records))

    def view(i):
        r = dict(records[i])
        r["params"] = np.asarray(r["params"])[..., cols]
        r["consistency_col"] = ocp.index.get("consistency_weight")
        return r

    def previous(i):
        if i == 0 or records[i]["episode_tick"] == 0:
            return None
        p = records[i - 1]
        ok = p["out_success"] and p["best"] >= 0
        return dict(success=ok, clock=p["clock"],
                    z_best=np.asarray(p["z"][p["best"]]) if ok else None)

    fill, where = 0.0, ""
    problems, owners = [], []
    for i in picks:
        rec, prev = view(i), previous(i)
        gap, at = ref_tick.fill_gap(ref, ocp, rec, prev)
        if gap > fill or not np.isfinite(gap):
            fill, where = gap, f"tick {i}: {at}"
        for p in range(rec["params"].shape[0]):
            problems.append((rec["params"][p], rec["xinit"], rec["warm"][p]))
            owners.append((i, p))
    params = np.stack([q[0] for q in problems])
    xinit = np.stack([q[1] for q in problems])
    warm = np.stack([q[2] for q in problems])
    z_prog = np.stack([np.asarray(records[i]["z"][p]) for i, p in owners])
    cost_prog = np.array([records[i]["cost"][p] for i, p in owners])
    ok_prog = np.array([bool(records[i]["success"][p]) for i, p in owners])
    if outputs is not None:
        z_prog, cost_prog, ok_prog = outputs(params, xinit, warm)

    cost_at, eq_at = ref_sqp.merit_terms(ocp, params, xinit, z_prog)
    cost_at, eq_at = cost_at.numpy(), eq_at.numpy()
    ok_at = (eq_at <= float(ref["sqp"]["res_eq_tol"])) & np.isfinite(
        cost_at) & np.isfinite(z_prog).all(axis=(1, 2))
    finite = np.isfinite(cost_prog) & np.isfinite(cost_at)
    cost_gap = float(np.max(np.abs(cost_prog - cost_at)[finite]
                            / (1.0 + np.abs(cost_at[finite])), initial=0.0))

    sol = reference_solve(job)(params, xinit, warm)
    z_ref, ok_ref = sol.z.double().numpy(), sol.success.numpy()
    both = ok_prog & ok_ref
    gaps = relative_gap(z_prog, z_ref)
    solve_gap = float(np.median(gaps[both])) if both.any() else 0.0
    worst = int(np.argmax(np.where(both, gaps, -1.0))) if both.any() else 0

    errors = []
    j = 0
    for i in picks:
        n = records[i]["params"].shape[0]
        errs = ref_tick.selection_errors(ref, view(i), previous(i),
                                         cost_at[j:j + n], ok_at[j:j + n],
                                         float(job.limits["cost_gap"]))
        errors += [f"tick {i}: {e}" for e in errs]
        j += n
    return ({"fill_gap": fill, "solve_gap": solve_gap, "cost_gap": cost_gap,
             "select_errors": float(len(errors))},
            {"fill_gap": where,
             "solve_gap": f"median of {int(both.sum())}; largest "
                          f"{float(np.max(gaps[both], initial=0.0))!r} at tick "
                          f"{owners[worst][0]} planner {owners[worst][1]}",
             "select_errors": "; ".join(errors[:5])})


def robot_problems(params, xinit, z_init, robots):
    """The sampled robots' planners as one batch of problems."""
    P = params.shape[1]
    return (params[robots].reshape(-1, *params.shape[2:]),
            np.repeat(xinit[robots], P, axis=0),
            z_init[robots].reshape(-1, *z_init.shape[2:]))


def fleet_readings(job, sets, results):
    """The three numbers of a fleet run. ``sets`` are the input sets in the
    reference layout (params, xinit, z_init), ``results`` the program's
    last step on each (best_index, best_cost, best_z, any_success,
    all_costs, all_success) as numpy, or None for a set the window did
    not reach."""
    ref = job.config["reference"]
    ocp = ref_ocp.build(ref)
    tol = float(ref["sqp"]["res_eq_tol"])
    solve = reference_solve(job)
    picks = fleet_picks(job, len(sets), sets[0][0].shape[0])
    gaps, cost_gap, errors = [], 0.0, []
    for s, ((params, xinit, z_init), res) in enumerate(zip(sets, results)):
        if res is None:  # a window too short to reach this set
            continue
        P = params.shape[1]
        robots = picks[s]
        sol = solve(*robot_problems(params, xinit, z_init, robots))
        eq_ref = sol.eq_res.double().numpy().reshape(len(robots), P)
        ok_ref = sol.success.numpy().reshape(len(robots), P)
        z_ref = sol.z.double().numpy().reshape(len(robots), P,
                                               *z_init.shape[2:])
        best = res["best_index"][robots].astype(int)
        cost_at, eq_at = ref_sqp.merit_terms(
            ocp, params[robots, best], xinit[robots], res["best_z"][robots])
        cost_at, eq_at = cost_at.numpy(), eq_at.numpy()
        for j, b in enumerate(robots):
            where = f"set {s} robot {b}"
            costs = res["all_costs"][b]
            if bool(res["any_success"][b]) != bool(np.isfinite(costs).any()):
                errors.append(f"{where}: success flag against its costs")
                continue
            if not res["any_success"][b]:
                if (eq_ref[j] < 0.5 * tol).any():
                    errors.append(f"{where}: no planner solved, the "
                                  "reference solves one")
                continue
            if not (eq_ref[j] <= 2 * tol).any():
                errors.append(f"{where}: a planner solved, the reference "
                              "solves none")
            want = int(np.argmin(costs))
            if best[j] != want or res["best_cost"][b] != costs[want]:
                errors.append(f"{where}: planner {best[j]} chosen, the least "
                              f"cost is planner {want}'s")
            if not (eq_at[j] <= tol and np.isfinite(cost_at[j])):
                errors.append(f"{where}: the chosen trajectory's defect "
                              f"{eq_at[j]!r}")
            cost_gap = max(cost_gap, abs(res["best_cost"][b] - cost_at[j])
                           / (1.0 + abs(cost_at[j])))
            if ok_ref[j, best[j]]:
                gaps.append(float(relative_gap(res["best_z"][b][None],
                                               z_ref[j, best[j]][None])[0]))
    return ({"solve_gap": float(np.median(gaps)) if gaps else 0.0,
             "cost_gap": float(cost_gap),
             "select_errors": float(len(errors))},
            {"solve_gap": f"median of {len(gaps)}; largest "
                          f"{max(gaps, default=0.0)!r}",
             "select_errors": "; ".join(errors[:5])})


def limited(job, readings, notes):
    """{name: (value, limit)} with every note on standard error."""
    limits = job.limits
    for name, note in notes.items():
        if note:
            print(f"cardbench: {name} worst at {note}", file=sys.stderr)
    return {name: (value, float(limits[name]))
            for name, value in readings.items()}
