"""Overlap-save channel filter kernel (port of
``cutesdr_tpu/kernels/fastfir4.py``, ``FastFirFourStep.filter_frames``).

One CUDA block per frame runs FFT -> *H -> unscaled IFFT in shared memory
(``csrc/fastfir.cu``).  H stays in natural order (the JAX kernel's
pre-permuted ``h2`` answered the TPU's four-step layout) and already holds
1/NFFT, so the inverse is not scaled again.  CPU tensors take the plain
version, ``ops.fastfir.filter_frames``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cutesdr_tpu_torch.kernels import LAUNCHES, _build
from cutesdr_tpu_torch.ops import fastfir as ff_ops
from cutesdr_tpu_torch.types import CDTYPE

filter_frames_plain = ff_ops.filter_frames


@functools.lru_cache(maxsize=8)
def _twiddles(nfft: int, device: str) -> torch.Tensor:
    """exp(-2 pi i k / nfft) for k < nfft/2, computed in float64 and
    rounded once to complex64."""
    w = np.exp(-2j * np.pi * np.arange(nfft // 2) / nfft)
    return torch.from_numpy(w.astype(np.complex64)).to(device)


def filter_frames(h_freq: torch.Tensor, z: torch.Tensor,
                  ntaps: int = ff_ops.NFIR) -> torch.Tensor:
    """Overlap-save core on an explicit [ntaps-1 + n] history+block
    buffer; returns the n filtered samples."""
    if _build.on_cpu(h_freq, z):
        return filter_frames_plain(h_freq, z, ntaps)
    nfft = h_freq.shape[-1]
    valid = nfft - (ntaps - 1)
    n = z.shape[-1] - (ntaps - 1)
    if nfft & (nfft - 1) or not 4 <= nfft <= 8192:
        raise ValueError(f"fastfir kernel needs a power-of-2 nfft <= 8192, "
                         f"got {nfft}")
    if valid <= 0 or n % valid:
        raise ValueError(f"fastfir block length {n} not a multiple of {valid}")
    _build.require(z, "z", CDTYPE)
    _build.require(h_freq, "h_freq", CDTYPE, nfft)
    tw = _twiddles(nfft, str(z.device))
    y = torch.empty(n, dtype=CDTYPE, device=z.device)
    lib = _build.library()
    _build.check(lib.cutesdr_fastfir(
        z.data_ptr(), h_freq.data_ptr(), tw.data_ptr(), y.data_ptr(), nfft,
        ntaps, n // valid, _build.stream(z)), "fastfir")
    LAUNCHES["fastfir"] += 1
    return y


def process(params: ff_ops.FastFirParams, carry: ff_ops.FastFirCarry,
            x: torch.Tensor) -> tuple[ff_ops.FastFirCarry, torch.Tensor]:
    """Streaming form: [tail | x] through ``filter_frames``."""
    ntaps = carry.tail.shape[-1] + 1
    z = torch.cat([carry.tail, x], -1)
    y = filter_frames(params.h_freq, z, ntaps)
    return ff_ops.FastFirCarry(tail=z[z.shape[-1] - (ntaps - 1):].clone()), y
