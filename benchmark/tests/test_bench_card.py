"""One short run of each cell on the card (skips without one)."""
import json
import subprocess
import sys

import pytest

from benchmark import spec


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(cell, cuda):
    cmd = spec.load_benchmark()["command"]
    proc = subprocess.run([sys.executable, *cmd[1:], "--workload", cell, "--seed", "4242",
                           "--seconds", "2", "--trace", "0"], capture_output=True, text=True,
                          timeout=1200, cwd=spec.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
