"""Guards of what the benchmark has measured with: the flagship traffic's
capture and the SSB reference's outputs at the small sizes, bit for bit
as the harness made them before the reference took its stages from
``reference/parts/`` and the generator its kinds from ``stations/``
(digests written from that commit's code, on the CPU)."""

import hashlib

import numpy as np
import pytest

from sdrbench import capture
from sdrbench.reference.chain import Reference
from sdrbench.tests import small

SEED = 2026101822
CASES = {"listener": small.listener, "bank": small.bank}
# (case, precision, block): SHA-256 of the block's BlockOutput
OUTPUTS = {
    ("listener", "float64", 3):
        "87495c1c844668c6d8a51b05d1b614f88b0067fc432a19cdde53a0b11a048899",
    ("listener", "float64", 70):
        "bf216beb815ec0299ee2bfba20e52e56b9f0d9cb929812e5d1197f8dc2b6ac00",
    ("listener", "tf32", 3):
        "9a568489d40c82df4e29e6fafe349e94f22091bf5d6889d1646d7c9310cf635e",
    ("bank", "float64", 2):
        "50b7f12cf9b9468387c300a877f27aee173043b16e77470c01d6e346bac0b310",
    ("bank", "tf32", 2):
        "f9dcd1dd03d1d24127083539c34947aff7e72c67f263a6ac129b0a1436d9f8ba",
}


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def test_flagship_capture_planes():
    re, im = capture.make(small.listener().traffic, SEED, "cpu")
    assert _digest(re.numpy(), im.numpy()) == \
        "828df931ef5da6420ffa4bd7b5ff00ec62b61be88e902f28585b0f63ca1ec817"


@pytest.mark.parametrize("case, precision, block", sorted(OUTPUTS))
def test_ssb_reference_outputs(case, precision, block):
    cell = CASES[case]()
    cap = capture.make(cell.traffic, SEED, "cpu")
    out = Reference(cell.config, cell.traffic["block_samples"],
                    precision).block(cap, block)
    assert _digest(out.m_lo, out.m_hi, *out.audio, out.smeter_ave,
                   out.smeter_peak) == OUTPUTS[case, precision, block]
