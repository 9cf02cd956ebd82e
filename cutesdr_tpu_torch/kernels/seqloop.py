"""Exact sequential FM and SAM PLL loops (port of
``cutesdr_tpu/kernels/seqloop.py``).

The demodulators take these when neither parallel tier is exact: during
acquisition, at clamp hits, on carrier-less noise.  CUDA tensors launch
the kernels of ``csrc/seqloop.cu`` (one warp per stream, any n); CPU
tensors run the plain versions below, per-sample torch loops of the same
operations in the same order (the bodies of the JAX demods' ``_pll_scan``,
minus FM's DC tracker, which the caller runs vectorized through
``demod/fm._dc_track``).  Kernel and plain version round alike op by op,
so they agree to the bit.

The gate differs from the TPU's: ``seqloop.use_kernel`` there needs
1024 <= n <= 32768 and whole 1024-sample tiles (SMEM residency, Mosaic's
tile rule); the CUDA kernel streams from global memory and takes every n.

A channel bank gives ``theta`` [C, n] and one initial phase and frequency
per stream: one launch runs the C streams (one warp each), and the plain
loops run unchanged on [C] tensors.  One stream is C = 1.
"""

from __future__ import annotations

import numpy as np
import torch

from cutesdr_tpu_torch.kernels import LAUNCHES, _build
from cutesdr_tpu_torch.ops.pll import INV_2PI, TWO_PI
from cutesdr_tpu_torch.types import RDTYPE


def _state0(phase0, freq0, theta: torch.Tensor) -> torch.Tensor:
    """[..., 2] (phase, freq) per stream of ``theta``."""
    rows = theta.shape[:-1]
    return torch.stack([torch.as_tensor(v, dtype=RDTYPE, device=theta.device)
                        .expand(rows) for v in (phase0, freq0)], -1)


def _consts(alpha, beta, limit) -> tuple[float, float, float]:
    return float(np.float32(alpha)), float(np.float32(beta)), \
        float(np.float32(limit))


def _loop_consts(alpha, beta, limit, like: torch.Tensor):
    """The plain loops' constants as 0-dim float32 tensors: the same
    products as Python scalars give (they are cast to float32 first), at
    half the dispatch cost per operation.  Returns (wrap, alpha, beta,
    -limit, limit) with wrap(e) = e - 2pi*round(e/2pi) (ops/pll.wrap_pi)."""
    c = [torch.tensor(v, dtype=RDTYPE, device=like.device)
         for v in (TWO_PI, INV_2PI, *_consts(alpha, beta, limit))]
    two_pi, inv, a, b, lim = c
    wrap = lambda e: e - two_pi * torch.round(e * inv)
    return wrap, a, b, -lim, lim


# --------------------------------------------------------------------- FM --

def fm_pll_scan_plain(alpha, beta, limit, phase0, freq0, theta: torch.Tensor):
    wrap, a, b, lo, hi = _loop_consts(alpha, beta, limit, theta)
    phase, freq = _state0(phase0, freq0, theta).unbind(-1)
    freqs, errs = [], []
    for th in theta.unbind(-1):
        err = -wrap(th + phase)
        freq = torch.clamp(freq + b * err, lo, hi)
        phase = wrap(phase + freq + a * err)
        freqs.append(freq)
        errs.append(err)
    return (torch.remainder(phase, TWO_PI), freq, torch.stack(freqs, -1),
            torch.stack(errs, -1))


def _launch(entry: str, name: str, alpha, beta, limit, phase0, freq0,
            theta: torch.Tensor, n_out: int):
    """One launch over every stream of ``theta`` ([n] or [C, n]): returns
    the final (phase, freq) and the ``n_out`` output series."""
    n = theta.shape[-1]
    rows = theta.shape[0] if theta.dim() == 2 else None
    _build.require(theta, "theta", RDTYPE, n, rows=rows)
    state0 = _state0(phase0, freq0, theta)
    outs = [torch.empty_like(theta) for _ in range(n_out)]
    state = torch.empty_like(state0)
    _build.check(getattr(_build.library(), entry)(
        theta.data_ptr(), n, 1 if rows is None else rows,
        *_consts(alpha, beta, limit), state0.data_ptr(),
        *(o.data_ptr() for o in outs), state.data_ptr(),
        _build.stream(theta)), name)
    LAUNCHES[name] += 1
    return (state[..., 0], state[..., 1], *outs)


def fm_pll_scan(alpha, beta, limit, phase0, freq0, theta: torch.Tensor):
    """The FM PLL recurrence over float32 ``theta`` ([n], or [C, n] for C
    streams).  Returns (phase', freq', freqs, err): the final state (phase
    mod 2pi), the per-sample NCO frequency and the phase-error series."""
    if _build.on_cpu(theta):
        return fm_pll_scan_plain(alpha, beta, limit, phase0, freq0, theta)
    return _launch("cutesdr_fm_pll", "seqloop_fm", alpha, beta, limit,
                   phase0, freq0, theta, 2)


# -------------------------------------------------------------------- SAM --

def sam_pll_scan_plain(alpha, beta, limit, phase0, freq0,
                       theta: torch.Tensor):
    wrap, a, b, lo, hi = _loop_consts(alpha, beta, limit, theta)
    phase, freq = _state0(phase0, freq0, theta).unbind(-1)
    prev = []
    for th in theta.unbind(-1):
        err = wrap(th - phase)
        freq = torch.clamp(freq + b * err, lo, hi)
        prev.append(phase)
        phase = wrap(phase + freq + a * err)
    return torch.remainder(phase, TWO_PI), freq, torch.stack(prev, -1)


def sam_pll_scan(alpha, beta, limit, phase0, freq0, theta: torch.Tensor):
    """The SAM carrier PLL recurrence over float32 ``theta`` ([n], or
    [C, n] for C streams).  Returns (phase', freq', prev): the final state
    (phase mod 2pi) and the PRE-update phase sequence the baseband
    rotation uses (dsp/samdemod.cpp:78-110)."""
    if _build.on_cpu(theta):
        return sam_pll_scan_plain(alpha, beta, limit, phase0, freq0, theta)
    return _launch("cutesdr_sam_pll", "seqloop_sam", alpha, beta, limit,
                   phase0, freq0, theta, 1)
