"""FFT overlap-save channel bandpass (port of ``cutesdr_tpu/ops/fastfir.py``).

Every overlap-save frame of the block is cut out at once — [n_frames,
NFFT] with hop VALID — and one batched FFT -> *H -> IFFT filters them all.
The only state is the last (NTAPS-1)-sample input tail.  Frame f (over
z = [tail | block]) covers z[f*V : f*V + NFFT] and contributes its last
V = NFFT - (NTAPS-1) samples.

H comes from ``cutesdr_tpu.design.fastfir_design`` and already carries the
1/NFFT scale of the reference's unscaled inverse transform; ``torch.fft.ifft``
scales by 1/NFFT itself, so the result is multiplied back by NFFT once.
This is the plain version behind the fastfir kernel
(``cutesdr_tpu_torch/kernels/fastfir.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cutesdr_tpu_torch.design.fastfir_design import (CONV_FFT_SIZE,
                                                     CONV_FIR_SIZE,
                                                     design_fastfir)
from cutesdr_tpu_torch.types import CDTYPE, complex_tensor


class FastFirParams(NamedTuple):
    h_freq: torch.Tensor   # [NFFT] complex frequency response (incl. 1/NFFT)


class FastFirCarry(NamedTuple):
    tail: torch.Tensor     # [NTAPS-1] complex input history


NFFT = CONV_FFT_SIZE
NFIR = CONV_FIR_SIZE
VALID = NFFT - (NFIR - 1)   # 1024 output samples per frame


def valid_per_frame(nfft: int = NFFT, ntaps: int = NFIR) -> int:
    return nfft - (ntaps - 1)


def init(f_lo_cut: float, f_hi_cut: float, offset: float, sample_rate: float,
         device, nfft: int = NFFT,
         ntaps: int = NFIR) -> tuple[FastFirParams, FastFirCarry]:
    h = design_fastfir(f_lo_cut, f_hi_cut, offset, sample_rate,
                       fft_size=nfft, fir_size=ntaps)
    return (FastFirParams(h_freq=complex_tensor(h, device)),
            FastFirCarry(tail=torch.zeros(ntaps - 1, dtype=CDTYPE,
                                          device=device)))


def retune(params: FastFirParams, f_lo_cut: float, f_hi_cut: float,
           offset: float, sample_rate: float,
           ntaps: int = NFIR) -> FastFirParams:
    h = design_fastfir(f_lo_cut, f_hi_cut, offset, sample_rate,
                       fft_size=params.h_freq.shape[-1], fir_size=ntaps)
    return FastFirParams(h_freq=complex_tensor(h, params.h_freq.device))


def filter_frames(h_freq: torch.Tensor, z: torch.Tensor,
                  ntaps: int = NFIR) -> torch.Tensor:
    """Overlap-save core on an explicit [ntaps-1 + n] history+block buffer;
    returns the n filtered samples.  A bank gives z [C, ntaps-1 + n] and
    one H per channel, h_freq [C, nfft]."""
    nfft = h_freq.shape[-1]
    valid = nfft - (ntaps - 1)
    n = z.shape[-1] - (ntaps - 1)
    if n % valid:
        raise ValueError(f"fastfir block length {n} not a multiple of {valid}")
    frames = z.unfold(-1, nfft, valid)                 # [..., n_frames, nfft]
    spec = torch.fft.fft(frames, dim=-1)
    yf = torch.fft.ifft(spec * h_freq.unsqueeze(-2), dim=-1) * nfft
    y = yf[..., ntaps - 1:]                            # [..., n_frames, valid]
    return y.reshape(y.shape[:-2] + (n,)).to(z.dtype)


def process(params: FastFirParams, carry: FastFirCarry,
            x: torch.Tensor) -> tuple[FastFirCarry, torch.Tensor]:
    """len(x) must be a multiple of the frame's valid length; a bank has a
    leading channel axis on params, carry and x."""
    ntaps = carry.tail.shape[-1] + 1
    z = torch.cat([carry.tail, x], -1)
    y = filter_frames(params.h_freq, z, ntaps)
    return FastFirCarry(tail=z[..., z.shape[-1] - (ntaps - 1):].clone()), y
