"""On the card (marker `cuda`, skipped where there is none): each
cell at its own size, a short window, once sound and once with the
control planted; the sound run is correct, the control's is not.

    python3 -m pytest -q -m cuda portbench/tests/test_pb_card.py
"""

import json
import subprocess
import sys

import pytest

from portbench import harness
from conftest import ROOT

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


def run_cell(cell, seed, fault=None, seconds=5):
    cmd = [sys.executable, "portbench/run.py", "--workload", cell,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"]
    if fault:
        cmd += ["--fault", fault]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(cuda_device, cell):
    sound = run_cell(cell, 2**31 + 101)
    assert sound["correct"] is True, sound["checks"]
    assert sound["device"]["platform"] == "gpu"
    control = run_cell(cell, 2**31 + 102, fault="control")
    assert control["correct"] is False, control["checks"]
