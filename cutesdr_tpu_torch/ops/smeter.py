"""S-meter: calibrated dB power with attack/decay averaging (port of
``cutesdr_tpu/ops/smeter.py``).

Per-sample dB power 10*log10((I^2+Q^2)/32767^2), a 10 ms attack and a
500 ms decay EMA with the attack-dominates rule (a rising signal snaps the
decay average up), peak hold that resets when read, +5 dB calibration.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cutesdr_tpu_torch.kernels import scan
from cutesdr_tpu_torch.types import MAX_AMPLITUDE, real_scalar

ATTACK_TIMECONST = 0.01
DECAY_TIMECONST = 0.5
SMETER_CALIBRATION = 5.0
MAX_PWR = MAX_AMPLITUDE * MAX_AMPLITUDE


class SMeterParams(NamedTuple):
    attack_alpha: np.float32
    decay_alpha: np.float32


class SMeterCarry(NamedTuple):
    attack_ave: torch.Tensor   # float32 0-dim
    decay_ave: torch.Tensor
    average_mag: torch.Tensor
    peak_mag: torch.Tensor


def init(sample_rate: float, device) -> tuple[SMeterParams, SMeterCarry]:
    a = 1.0 - np.exp(-1.0 / (sample_rate * ATTACK_TIMECONST))
    d = 1.0 - np.exp(-1.0 / (sample_rate * DECAY_TIMECONST))
    r = lambda v: real_scalar(v, device)
    return (SMeterParams(attack_alpha=np.float32(a), decay_alpha=np.float32(d)),
            SMeterCarry(attack_ave=r(-120.0), decay_ave=r(-120.0),
                        average_mag=r(-120.0), peak_mag=r(0.0)))


def process(params: SMeterParams, carry: SMeterCarry,
            x: torch.Tensor) -> tuple[SMeterCarry, torch.Tensor]:
    """Returns (carry', per-sample dB magnitudes); read the meter through
    the getters.  The averagers' final values come from
    ``kernels.scan.smeter_last`` (one launch on the card).  ``x`` may be a
    [C, n] bank with a leading channel axis on the carry."""
    pwr = (x.real * x.real + x.imag * x.imag) / MAX_PWR
    # floor at -160 dBFS: the reference's 1e-50 guard underflows in float32
    mag = 10.0 * torch.log10(torch.clamp(pwr, min=1e-16))
    peak = torch.maximum(carry.peak_mag, mag.amax(-1))
    a, d = scan.smeter_last(mag, params.attack_alpha, params.decay_alpha,
                            carry.attack_ave, carry.decay_ave)
    return SMeterCarry(attack_ave=a, decay_ave=d, average_mag=d,
                       peak_mag=peak), mag


def get_ave(carry: SMeterCarry) -> torch.Tensor:
    return carry.average_mag + SMETER_CALIBRATION


def get_peak(carry: SMeterCarry) -> tuple[SMeterCarry, torch.Tensor]:
    """Peak hold, reset on read (the reference getter's contract)."""
    return (carry._replace(peak_mag=torch.zeros_like(carry.peak_mag)),
            carry.peak_mag + SMETER_CALIBRATION)
