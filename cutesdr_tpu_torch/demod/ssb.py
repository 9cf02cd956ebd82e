"""SSB / CW demodulator (port of ``cutesdr_tpu/demod/ssb.py``).

The channel filter has already selected the sideband as a complex passband
and the CW offset is applied by the downconverter, so demodulation is the
real part (duplicated into both channels for stereo).  Serves usb, lsb,
cwu and cwl.
"""

from __future__ import annotations

import torch


def process(carry: None, x: torch.Tensor) -> tuple[None, torch.Tensor]:
    return carry, x.real


def process_stereo(carry: None,
                   x: torch.Tensor) -> tuple[None, torch.Tensor]:
    return carry, torch.complex(x.real, x.real)
