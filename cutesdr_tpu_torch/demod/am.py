"""AM envelope demodulator (port of ``cutesdr_tpu/demod/am.py``).

Magnitude envelope sqrt(I^2+Q^2), one-pole DC-removal highpass
H(z) = (1-z^-1)/(1-0.99 z^-1) solved by the first-order recurrence (one
launch of the affine scan on the card, ``kernels/scan``), then a post
lowpass FIR at the channel's half-bandwidth (Kaiser, 50 dB, transition
to 1.8 x BW).  A bank's [C, n] rows are
independent channels with [C] states.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cutesdr_tpu_torch.design.fir_kaiser import design_lowpass
from cutesdr_tpu_torch.kernels import scan
from cutesdr_tpu_torch.ops import fir
from cutesdr_tpu_torch.types import real_scalar

DC_ALPHA = 0.99


class AmParams(NamedTuple):
    post_fir: fir.FirParams


class AmCarry(NamedTuple):
    z1: torch.Tensor            # DC-removal filter state, float32 0-dim
    post_fir: fir.FirCarry


def _post_taps(bandwidth: float, sample_rate: float):
    return design_lowpass(1.0, 50.0, bandwidth, bandwidth * 1.8, sample_rate)


def init(bandwidth: float, sample_rate: float,
         device) -> tuple[AmParams, AmCarry]:
    fp, fc = fir.init(_post_taps(bandwidth, sample_rate), device)
    return AmParams(post_fir=fp), AmCarry(z1=real_scalar(0.0, device),
                                          post_fir=fc)


def set_bandwidth(params: AmParams, bandwidth: float,
                  sample_rate: float) -> AmParams:
    """New post-filter taps for a new channel bandwidth; the carry is kept,
    as in the JAX package."""
    fp, _ = fir.init(_post_taps(bandwidth, sample_rate),
                     params.post_fir.taps_i.device)
    return AmParams(post_fir=fp)


def dc_block(z1: torch.Tensor, u: torch.Tensor):
    """z0[n] = u[n] + 0.99*z0[n-1];  y[n] = z0[n] - z0[n-1], along the
    last axis.  Returns (z0 last, y)."""
    z0 = scan.first_order_scan(DC_ALPHA, u, z1)
    z_prev = torch.cat([z1.unsqueeze(-1), z0[..., :-1]], -1)
    return z0[..., -1], z0 - z_prev


def process(params: AmParams, carry: AmCarry,
            x: torch.Tensor) -> tuple[AmCarry, torch.Tensor]:
    z1, y = dc_block(carry.z1, x.abs())
    fc, y = fir.process_real(params.post_fir, carry.post_fir, y)
    return AmCarry(z1=z1, post_fir=fc), y


def process_stereo(params: AmParams, carry: AmCarry,
                   x: torch.Tensor) -> tuple[AmCarry, torch.Tensor]:
    carry, y = process(params, carry, x)
    return carry, torch.complex(y, y)
