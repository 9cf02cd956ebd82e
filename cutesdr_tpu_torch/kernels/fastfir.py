"""Overlap-save channel filter kernels (port of
``cutesdr_tpu/kernels/fastfir4.py``): ``filter_frames`` (K2,
``FastFirFourStep.filter_frames``) for one stream and
``filter_frames_batch`` / ``batch_call`` (K6, ``filter_frames_batch`` /
``batch_call``) for a channel bank with one H per channel.

One CUDA block per (frame, channel) runs FFT -> *H -> unscaled IFFT in
shared memory (``csrc/fastfir.cu``); one stream is the one-channel grid.
H stays in natural order (the JAX kernel's pre-permuted ``h2`` answered
the TPU's four-step layout) and already holds 1/NFFT, so the inverse is
not scaled again.  CPU tensors take the plain version,
``ops.fastfir.filter_frames``, which takes either shape.
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


def _launch(h_freq: torch.Tensor, z: torch.Tensor, ntaps: int,
            rows: int | None, name: str) -> torch.Tensor:
    """One launch over every frame of every row of z (rows None: 1-D)."""
    nfft = h_freq.shape[-1]
    valid = nfft - (ntaps - 1)
    n = z.shape[-1] - (ntaps - 1)
    if nfft & (nfft - 1) or not 4 <= nfft <= 8192:
        raise ValueError(f"fastfir kernel needs a power-of-2 nfft <= 8192, "
                         f"got {nfft}")
    if valid <= 0 or n % valid:
        raise ValueError(f"fastfir block length {n} not a multiple of {valid}")
    _build.require(z, "z", CDTYPE, rows=rows)
    _build.require(h_freq, "h_freq", CDTYPE, nfft, rows=rows)
    tw = _twiddles(nfft, str(z.device))
    C = 1 if rows is None else rows
    y = torch.empty(z.shape[:-1] + (n,), dtype=CDTYPE, device=z.device)
    cstride = lambda a: a.stride(0) if rows is not None else 0
    _build.check(_build.library().cutesdr_fastfir(
        z.data_ptr(), h_freq.data_ptr(), tw.data_ptr(), y.data_ptr(), nfft,
        ntaps, n // valid, C, cstride(z), cstride(h_freq), cstride(y),
        _build.stream(z)), name)
    LAUNCHES[name] += 1
    return y


def filter_frames(h_freq: torch.Tensor, z: torch.Tensor,
                  ntaps: int = ff_ops.NFIR) -> torch.Tensor:
    """Overlap-save core on an explicit [ntaps-1 + n] history+block
    buffer; returns the n filtered samples."""
    if _build.on_cpu(h_freq, z):
        return filter_frames_plain(h_freq, z, ntaps)
    return _launch(h_freq, z, ntaps, None, "fastfir")


def filter_frames_batch(h_freq: torch.Tensor, z: torch.Tensor,
                        ntaps: int = ff_ops.NFIR) -> torch.Tensor:
    """The bank form: z [C, ntaps-1 + n] (per-channel history + block) and
    h_freq [C, nfft]; returns [C, n].  One launch for the bank."""
    if _build.on_cpu(h_freq, z):
        return filter_frames_plain(h_freq, z, ntaps)
    return _launch(h_freq, z, ntaps, z.shape[0], "fastfir_batch")


def _stream(params: ff_ops.FastFirParams, carry: ff_ops.FastFirCarry,
            x: torch.Tensor, core) -> tuple[ff_ops.FastFirCarry, torch.Tensor]:
    ntaps = carry.tail.shape[-1] + 1
    z = torch.cat([carry.tail, x], -1)
    y = core(params.h_freq, z, ntaps)
    return (ff_ops.FastFirCarry(tail=z[..., z.shape[-1] - (ntaps - 1):]
                                .clone()), y)


def process(params: ff_ops.FastFirParams, carry: ff_ops.FastFirCarry,
            x: torch.Tensor) -> tuple[ff_ops.FastFirCarry, torch.Tensor]:
    """Streaming form: [tail | x] through ``filter_frames``."""
    return _stream(params, carry, x, filter_frames)


def batch_call(params: ff_ops.FastFirParams, carry: ff_ops.FastFirCarry,
               x: torch.Tensor) -> tuple[ff_ops.FastFirCarry, torch.Tensor]:
    """Streaming bank form: a leading channel axis on params, carry and x,
    through ``filter_frames_batch``."""
    return _stream(params, carry, x, filter_frames_batch)
