"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference (its parts too) and the capture's station
kinds load nothing of the port either."""

import ast
import subprocess
import sys

import pytest

from sdrbench.run import FORBIDDEN
from sdrbench.tests import small

REPO = small.ROOT.parent

RUN = """
import sys, torch
torch.set_num_threads(1)
from sdrbench import control, run
from sdrbench.tests import small
run.run_cell(small.listener(), 5, 0.2, True, device="cpu", limits={})
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""

REF = """
import sys, torch
torch.set_num_threads(1)
from sdrbench import capture
from sdrbench.reference.chain import Reference
from sdrbench.tests import small
for cell in (small.listener(), small.fm_nb()):
    cap = capture.make(cell.traffic, 5, "cpu")
    for precision in ("float64", "tf32"):
        Reference(cell.config, cell.traffic["block_samples"],
                  precision).block(cap, 2)
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _tops(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=300)
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    tops = _tops(RUN)
    assert "cutesdr_tpu_torch" in tops
    assert not tops & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_either_package():
    tops = _tops(REF)
    assert not tops & (set(FORBIDDEN) | {"cutesdr_tpu_torch"})


@pytest.mark.parametrize("folder", ["reference", "stations"])
def test_the_reference_sources_import_no_package(folder):
    paths = sorted((small.ROOT / folder).rglob("*.py"))
    assert paths
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                top = (name or "").split(".")[0]
                assert top not in set(FORBIDDEN) | {"cutesdr_tpu_torch"}, \
                    (path.name, name)
