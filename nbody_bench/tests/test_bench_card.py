"""On the card (the repository's ``cuda`` marker; they skip without one):
the command itself on each cell with a short window, and the bf16 control
at the cell's own size, which must come out not correct.  Run them on the
H100 with ``python -m pytest nbody_bench/tests -m cuda``."""
import json
import subprocess
import sys

import pytest

from nbody_bench import harness

CELLS = ["galaxy200k.exact", "clusters1m.adaptive"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_command_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "nbody_bench", "--workload", cell, "--seed",
         "2147483999", "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_bf16_control_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "nbody_bench.control", "--workload", cell,
         "--seeds", "2147483998", "--variants", "bf16_state", "--seconds",
         "3"], cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line.get("correct") is not True, line
