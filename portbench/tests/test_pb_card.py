"""A short run of each cell on the card: the result line as the contract
has it, correct. Skips where there is no card."""

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.conftest import ROOT

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(cell, card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"]
