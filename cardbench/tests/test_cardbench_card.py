"""On the card at the cells' own sizes: the readings that the limits of
``correct`` were set from (``cardbench.control``), three seeds per cell.
The program as it is stays inside every limit; the control (the reference
in float32 in the program's place) and every fault fail at least one.
Run on a machine with an NVIDIA GPU:

    python -m pytest cardbench/tests/test_cardbench_card.py -m card
"""

import json

import pytest

from helpers import ROOT, manifest

from cardbench import control

SEEDS = [3000000011, 2900000023, 2147483999]


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_limits_separate_program_from_control_and_faults(card, cell,
                                                         monkeypatch,
                                                         capsys):
    monkeypatch.chdir(ROOT)
    assert control.main(["--workload", cell, "--seeds", *map(str, SEEDS),
                         "--seconds", "3"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{\"seed\"")]
    limits = json.loads((ROOT / "cardbench" / "limits" / f"{cell}.json")
                        .read_text())
    for line in lines:
        over = [k for k, v in line["readings"].items() if v > limits[k]]
        if line["mode"] == "program":
            assert not over, line
        else:
            assert over, line
