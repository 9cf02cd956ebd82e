"""Numerically-controlled oscillator / complex mixer (port of
``cutesdr_tpu/ops/nco.py``).

The phase of sample ``n`` is the exact 32-bit DDS accumulator value

    acc_n = acc_0 + n * phase_inc   (mod 2^32)

torch has no uint32 ``add`` or ``arange`` on the CPU, so the accumulator
is held in int64 and every sum is masked with ``& 0xFFFFFFFF``; negative
``n`` (back-dated history samples) wraps the same way unsigned arithmetic
does.  The radian phase is ``float32(acc) * float32(2*pi / 2^32)``, the
JAX package's rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cutesdr_tpu_torch.types import CDTYPE, K_2PI, RDTYPE

_TWO32 = 4294967296.0
MASK = 0xFFFFFFFF
PHASE_SCALE = np.float32(K_2PI / _TWO32)   # radians per DDS count


class NcoParams(NamedTuple):
    phase_inc: int          # uint32 value: round(-freq/fs * 2^32) mod 2^32


class NcoCarry(NamedTuple):
    phase_acc: torch.Tensor  # int64 0-dim, in [0, 2^32)


def phase_increment(freq_hz: float, sample_rate: float) -> int:
    """Fixed-point increment for a mixer that shifts ``+freq_hz`` to DC."""
    frac = -freq_hz / sample_rate
    return int(np.int64(np.round(frac * _TWO32)) & MASK)


def init(freq_hz: float, sample_rate: float,
         device) -> tuple[NcoParams, NcoCarry]:
    return (NcoParams(phase_inc=phase_increment(freq_hz, sample_rate)),
            NcoCarry(phase_acc=torch.zeros((), dtype=torch.int64,
                                           device=device)))


def accumulator(phase_acc: torch.Tensor, phase_inc: int,
                k: torch.Tensor) -> torch.Tensor:
    """``acc_0 + k * inc mod 2^32`` for an int64 index vector ``k``."""
    return (phase_acc + k * phase_inc) & MASK


def oscillator(acc: torch.Tensor) -> torch.Tensor:
    """e^{j phase} of int64 accumulator values, complex64."""
    ang = acc.to(RDTYPE) * PHASE_SCALE
    return torch.complex(torch.cos(ang), torch.sin(ang))


def advance(phase_acc: torch.Tensor, phase_inc: int, n: int) -> torch.Tensor:
    return (phase_acc + n * phase_inc) & MASK


def phases(params: NcoParams, carry: NcoCarry,
           n: int) -> tuple[NcoCarry, torch.Tensor]:
    """Radian phase vector for the next ``n`` samples plus advanced carry."""
    k = torch.arange(n, dtype=torch.int64, device=carry.phase_acc.device)
    acc = accumulator(carry.phase_acc, params.phase_inc, k)
    ang = acc.to(RDTYPE) * PHASE_SCALE
    return (NcoCarry(advance(carry.phase_acc, params.phase_inc, n)), ang)


def process(params: NcoParams, carry: NcoCarry,
            x: torch.Tensor) -> tuple[NcoCarry, torch.Tensor]:
    """Mix a complex block: y = x * e^{j phase}."""
    carry, ang = phases(params, carry, x.shape[-1])
    osc = torch.complex(torch.cos(ang), torch.sin(ang))
    return carry, (x * osc).to(CDTYPE)
