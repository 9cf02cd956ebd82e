"""On the card: each cell runs end to end from the command line, prints
its result last and reads correct (python3 -m pytest sdrbench/tests -m
card, from the repo's root, on a machine with a CUDA device)."""

import json
import subprocess
import sys

import pytest

from sdrbench import spec
from sdrbench.tests import small

REPO = small.ROOT.parent
CELLS = [w["name"] for w in spec.load_benchmark(REPO)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "-m", "sdrbench.run", "--workload",
                          workload, "--seed", "2718281828", "--seconds", "2",
                          "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
