"""Streaming FIR filters, real and complex (port of
``cutesdr_tpu/ops/fir.py``).

A block is one convolution with a carried (taps-1)-sample input tail:

    y[n] = sum_j h[j] * x[n-j]        (causal convolution)

The complex form filters the I and Q planes with their own real tap sets
(hI, hQ), which is what lets a Hilbert bandpass pair impose a 90 degree
phase shift between the planes.  A bank's [C, n] rows are independent
streams with their own tails, through the same taps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cutesdr_tpu_torch.ops.util import strided_corr
from cutesdr_tpu_torch.types import CDTYPE, RDTYPE


class FirParams(NamedTuple):
    taps_i: torch.Tensor
    taps_q: torch.Tensor    # == taps_i for plain (non-Hilbert) filtering


class FirCarry(NamedTuple):
    tail: torch.Tensor      # [L-1] input history (complex or real)


def init(taps, device, taps_q=None,
         complex_input: bool = False) -> tuple[FirParams, FirCarry]:
    ti = torch.tensor(np.asarray(taps, np.float32), device=device)
    tq = ti if taps_q is None else torch.tensor(
        np.asarray(taps_q, np.float32), device=device)
    dtype = CDTYPE if complex_input else RDTYPE
    return (FirParams(taps_i=ti, taps_q=tq),
            FirCarry(tail=torch.zeros(ti.shape[0] - 1, dtype=dtype,
                                      device=device)))


def _new_tail(z: torch.Tensor, L: int) -> FirCarry:
    return FirCarry(tail=z[..., z.shape[-1] - (L - 1):].clone())


def process_real(params: FirParams, carry: FirCarry,
                 x: torch.Tensor) -> tuple[FirCarry, torch.Tensor]:
    z = torch.cat([carry.tail, x], -1)
    y = strided_corr(z, params.taps_i.flip(0))    # flip: true convolution
    return _new_tail(z, params.taps_i.shape[0]), y


def process_complex(params: FirParams, carry: FirCarry,
                    x: torch.Tensor) -> tuple[FirCarry, torch.Tensor]:
    z = torch.cat([carry.tail, x], -1)
    yi = strided_corr(z.real, params.taps_i.flip(0))
    yq = strided_corr(z.imag, params.taps_q.flip(0))
    return _new_tail(z, params.taps_i.shape[0]), torch.complex(yi, yq)
