"""Overlap-save channel filter kernels (port of
``cutesdr_tpu/kernels/fastfir4.py``): ``filter_frames`` (K2,
``FastFirFourStep.filter_frames``) for one stream and
``filter_frames_batch`` / ``batch_call`` (K6, ``filter_frames_batch`` /
``batch_call``) for a channel bank with one H per channel.

Each frame runs FFT -> *H -> unscaled IFFT as a register-resident
mixed-radix Stockham transform (``csrc/fastfir.cu``; ``fft_plan`` gives
its passes) with a CUDA block holding ``frames_per_block`` frames of one
channel; one stream is the one-channel grid.  The kernel reads each frame
from the carry's tail and the block through two pointers, so the CUDA
path never concatenates them.  H stays in natural order (the JAX
kernel's pre-permuted ``h2`` answered the TPU's four-step layout) and
already holds 1/NFFT, so the inverse is not scaled again.  CPU tensors
take the plain version, ``ops.fastfir.filter_frames``, which takes either
shape.  So does a size the kernel does not take (``kernel_supported``):
a decision from the shape alone, made before any launch, as the JAX
package gates its Pallas filter on ``fastfir4_supported`` and runs other
sizes on the XLA FFT (a latency-sized 16384/8193 filter, nfft = 2000).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cutesdr_tpu_torch.kernels import LAUNCHES, _build
from cutesdr_tpu_torch.ops import fastfir as ff_ops
from cutesdr_tpu_torch.types import CDTYPE

filter_frames_plain = ff_ops.filter_frames


EPT = 16           # complex points a thread holds (FF_EPT in the kernel)
MAX_THREADS = 512  # threads of a block (FF_MAX_THREADS)


@functools.lru_cache(maxsize=16)
def fft_plan(nfft: int) -> tuple[int, tuple[int, ...]]:
    """(points per thread, radices of the passes) of the kernel's FFT:
    passes of radix 16 and a last one of radix nfft / 16^(passes-1)
    (2048 = 16 * 16 * 8); below 16 points one pass of radix nfft."""
    ept = min(nfft, EPT)
    lg = nfft.bit_length() - 1
    n_pass = -(-lg // 4)
    return ept, (16,) * (n_pass - 1) + (nfft >> 4 * (n_pass - 1),)


def kernel_supported(nfft: int, ntaps: int) -> bool:
    """Whether K2/K6 take a filter size: a power-of-2 nfft from 4 to 8192
    and a positive overlap-save hop.  Other sizes run the plain FFT
    route on either device."""
    return (nfft & (nfft - 1) == 0 and 4 <= nfft <= 8192
            and nfft - (ntaps - 1) > 0)


def frames_per_block(nfft: int, frames: int, n_sm: int) -> int:
    """Frames a CUDA block holds: up to 256 threads' worth where the call
    has frames to spare beyond one per SM, else one."""
    tpf = nfft // min(nfft, EPT)
    return max(1, min(256 // tpf, frames // n_sm))


@functools.lru_cache(maxsize=8)
def _twiddles(nfft: int, device: str) -> torch.Tensor:
    """exp(-2 pi i k / nfft) for k < nfft/4, computed in float64 and
    rounded once to complex64; the kernel rotates the other quadrants by
    powers of -i, exactly."""
    w = np.exp(-2j * np.pi * np.arange(max(nfft // 4, 1)) / nfft)
    return torch.from_numpy(w.astype(np.complex64)).to(device)


def _require_rows(t: torch.Tensor, name: str, numel: int,
                  rows: int | None) -> None:
    """A CUDA complex64 tensor [numel] (or [rows, numel]) whose last axis
    is contiguous; its rows may sit at any stride."""
    _build.require(t, name, CDTYPE, numel, contiguous=False, rows=rows)
    if numel > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: expected a contiguous last axis")


def _launch(h_freq: torch.Tensor, tail: torch.Tensor, x: torch.Tensor,
            rows: int | None, name: str) -> torch.Tensor:
    """One launch over every frame of every row of [tail | x] (rows None:
    1-D), read through the two pointers."""
    nfft = h_freq.shape[-1]
    t = tail.shape[-1]
    valid = nfft - t
    n = x.shape[-1]
    if not kernel_supported(nfft, t + 1):
        raise ValueError(f"fastfir kernel needs a power-of-2 nfft <= 8192 "
                         f"and a positive hop, got {nfft}/{t + 1}")
    if n % valid:
        raise ValueError(f"fastfir block length {n} not a multiple of {valid}")
    _require_rows(tail, "tail", t, rows)
    _require_rows(x, "x", n, rows)
    _build.require(h_freq, "h_freq", CDTYPE, nfft, rows=rows)
    tw = _twiddles(nfft, str(x.device))
    C = 1 if rows is None else rows
    frames = n // valid
    fpb = frames_per_block(nfft, frames * C, _build.sm_count(x.device))
    y = torch.empty(x.shape[:-1] + (n,), dtype=CDTYPE, device=x.device)
    cstride = lambda a: a.stride(0) if rows is not None else 0
    _build.check(_build.library().cutesdr_fastfir(
        tail.data_ptr(), x.data_ptr(), h_freq.data_ptr(), tw.data_ptr(),
        y.data_ptr(), nfft, t + 1, frames, C, fpb, cstride(tail), cstride(x),
        cstride(h_freq), cstride(y), _build.stream(x)), name)
    LAUNCHES[name] += 1
    return y


def filter_frames(h_freq: torch.Tensor, z: torch.Tensor,
                  ntaps: int = ff_ops.NFIR) -> torch.Tensor:
    """Overlap-save core on an explicit [ntaps-1 + n] history+block
    buffer; returns the n filtered samples."""
    if _build.on_cpu(h_freq, z) or \
            not kernel_supported(h_freq.shape[-1], ntaps):
        return filter_frames_plain(h_freq, z, ntaps)
    return _launch(h_freq, z[..., :ntaps - 1], z[..., ntaps - 1:], None,
                   "fastfir")


def filter_frames_batch(h_freq: torch.Tensor, z: torch.Tensor,
                        ntaps: int = ff_ops.NFIR) -> torch.Tensor:
    """The bank form: z [C, ntaps-1 + n] (per-channel history + block) and
    h_freq [C, nfft]; returns [C, n].  One launch for the bank."""
    if _build.on_cpu(h_freq, z) or \
            not kernel_supported(h_freq.shape[-1], ntaps):
        return filter_frames_plain(h_freq, z, ntaps)
    return _launch(h_freq, z[..., :ntaps - 1], z[..., ntaps - 1:],
                   z.shape[0], "fastfir_batch")


def _stream(params: ff_ops.FastFirParams, carry: ff_ops.FastFirCarry,
            x: torch.Tensor, name: str
            ) -> tuple[ff_ops.FastFirCarry, torch.Tensor]:
    """[tail | x] through the filter: on the card the kernel reads the two
    directly; on the CPU, and for a size the kernel does not take, the
    plain streaming form concatenates them."""
    tail = carry.tail
    t = tail.shape[-1]
    if _build.on_cpu(params.h_freq, tail, x) or \
            not kernel_supported(params.h_freq.shape[-1], t + 1):
        return ff_ops.process(params, carry, x)
    rows = tail.shape[0] if tail.dim() == 2 else None
    y = _launch(params.h_freq, tail, x, rows, name)
    n = x.shape[-1]
    new_tail = (x[..., n - t:].clone() if n >= t
                else torch.cat([tail, x], -1)[..., n:])
    return ff_ops.FastFirCarry(tail=new_tail), y


def process(params: ff_ops.FastFirParams, carry: ff_ops.FastFirCarry,
            x: torch.Tensor) -> tuple[ff_ops.FastFirCarry, torch.Tensor]:
    """Streaming form: [tail | x] through ``filter_frames``' kernel."""
    return _stream(params, carry, x, "fastfir")


def batch_call(params: ff_ops.FastFirParams, carry: ff_ops.FastFirCarry,
               x: torch.Tensor) -> tuple[ff_ops.FastFirCarry, torch.Tensor]:
    """Streaming bank form: a leading channel axis on params, carry and x,
    through ``filter_frames_batch``'s kernel."""
    return _stream(params, carry, x, "fastfir_batch")
