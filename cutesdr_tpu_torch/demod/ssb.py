"""SSB / CW demodulator (port of ``cutesdr_tpu/demod/ssb.py``).

The channel filter has already selected the sideband as a complex passband
and the CW offset is applied by the downconverter, so demodulation is the
real part.  Serves usb, lsb, cwu and cwl; stereo is not ported yet.
"""

from __future__ import annotations

import torch


def process(carry: None, x: torch.Tensor) -> tuple[None, torch.Tensor]:
    return carry, x.real
