"""Whole runs of each cell on the CPU at a small size (the look for a card
skipped, everything after it as a run does it), first sound and then with
the timed path broken underneath: ``correct`` holds for the sound run and
fails for each fault the cell can have (a solve that hands back its state
unchanged, half of the batch left out, an answer altered where it is
produced, the obstacles read a step late). The cells run on one card, so
there is no exchange between cards to leave out."""

import json

import numpy as np
import pytest
import torch

from cardbench import run
from cardbench.reference import ocp as ref_ocp

IA = ref_ocp.var("a")
P = "oscar_mpc_planner_mr_modification_tpu_torch"


def one_run(root, monkeypatch, capsys, cell, seed=5, seconds=2.0):
    monkeypatch.chdir(root)
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", "0"], device="cpu")
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def tmpc_fault(monkeypatch, kind):
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel.tmpc import (
        TMPCOptimizer)

    dispatch, fetch = TMPCOptimizer._dispatch_batch, TMPCOptimizer._fetch_batch

    def spy(self, params, xinit, warm):
        self._warm_seen = np.array(warm)
        return dispatch(self, params, xinit, warm)

    def broken(self):
        res = fetch(self)
        z, ok = res.z.copy(), res.success.copy()
        if kind == "unchanged":
            z = self._warm_seen
        elif kind == "half_left_out":
            h = len(ok) // 2
            z[h:], ok[h:] = self._warm_seen[h:], False
        else:
            z[:, 0, IA] += 0.05
        return res._replace(z=z, success=ok)

    monkeypatch.setattr(TMPCOptimizer, "_dispatch_batch", spy)
    monkeypatch.setattr(TMPCOptimizer, "_fetch_batch", broken)


def late_predictions(monkeypatch):
    from oscar_mpc_planner_mr_modification_tpu_torch.planner import (
        data_preparation as prep)

    predict = prep.get_constant_velocity_prediction

    def late(position, velocity, dt, steps, probabilistic=False):
        return predict(np.asarray(position) + dt * np.asarray(velocity),
                       velocity, dt, steps, probabilistic)

    monkeypatch.setattr(prep, "get_constant_velocity_prediction", late)


def solver_fault(monkeypatch, kind):
    from oscar_mpc_planner_mr_modification_tpu_torch.solver.solver import (
        Solver)

    solve = Solver.solve

    def broken(self):
        code = solve(self)
        if kind == "unchanged":
            self._output_z = self._loaded_warmstart.copy()
        else:
            self._output_z[0, IA] += 0.05
        return code

    monkeypatch.setattr(Solver, "solve", broken)


def fleet_fault(monkeypatch, kind):
    from oscar_mpc_planner_mr_modification_tpu_torch.parallel import batch

    make = batch.make_fleet_sqp_solver

    def wrapped(*a, **k):
        solve = make(*a, **k)

        def broken(params, xinit, z_init):
            res = solve(params, xinit, z_init)
            z, ok = res.z.clone(), res.success.clone()
            if kind == "unchanged":
                z = torch.as_tensor(z_init, dtype=z.dtype)
            elif kind == "half_left_out":
                h = z.shape[0] // 2
                z[h:], ok[h:] = torch.as_tensor(z_init[h:]), False
            else:
                z[:, 0, IA] += 0.05
            return res._replace(z=z, success=ok)

        return broken

    monkeypatch.setattr(batch, "make_fleet_sqp_solver", wrapped)


CASES = [("tmpc_tick", None), ("tmpc_tick", "unchanged"),
         ("tmpc_tick", "half_left_out"), ("tmpc_tick", "answer_altered"),
         ("tmpc_tick", "fill_off_by_one"), ("basic_tick", None),
         ("basic_tick", "unchanged"), ("basic_tick", "answer_altered"),
         ("basic_tick", "fill_off_by_one"), ("tmpc_fleet512", None),
         ("tmpc_fleet512", "unchanged"), ("tmpc_fleet512", "half_left_out"),
         ("tmpc_fleet512", "answer_altered")]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_correct_holds_and_each_fault_fails_it(small, monkeypatch, capsys,
                                               cell, fault):
    if fault == "fill_off_by_one":
        late_predictions(monkeypatch)
    elif fault and cell == "tmpc_tick":
        tmpc_fault(monkeypatch, fault)
    elif fault and cell == "basic_tick":
        solver_fault(monkeypatch, fault)
    elif fault:
        fleet_fault(monkeypatch, fault)
    line = one_run(small, monkeypatch, capsys, cell)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0
    assert line["correct"] is (fault is None), line["checks"]
