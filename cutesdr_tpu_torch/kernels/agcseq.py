"""The AGC's exact sequential averagers (kernel N1, ``csrc/agcseq.cu``).

The AGC solves its attack and decay averagers by guess-verify; where that
does not converge it falls back to the exact per-sample recurrence (JAX
runs it as a ``lax.scan`` under ``lax.cond``, ``cutesdr_tpu/ops/agc.py``
``_averager_scan``).  CUDA tensors launch the kernel: one warp per stream,
all streams of a bank in one launch; CPU tensors run the plain version
below, the per-sample torch loop of the same operations in the same order.
The two agree to the bit.

``peak`` is [n] or [C, n]; the initial states have its leading shape.
``attack`` and ``decay`` are (rise, fall) alphas; ``hang_time`` is None for
the two-rate decay, else the hang-mode hold in samples.  Returns (attack
last, decay last, hang timer, max(attack, decay) series).

The fallback is decided where JAX's ``lax.cond`` decides it, on the
device: with ``skip`` (the guess-verify solve's convergence flag, a 0-dim
bool) and ``out`` (the parallel solve's four results) the call returns
``out`` untouched where the flag holds, and otherwise the exact result,
which the kernel writes over ``out`` in place; ``count`` (an int32 0-dim
counter) gains one on every run that computes.  The kernel reads the
flag itself, so the card's step makes no host read; the plain version
reads its CPU bool (no device sync) and skips the per-sample loop.
"""

from __future__ import annotations

import numpy as np
import torch

from cutesdr_tpu_torch.kernels import LAUNCHES, _build
from cutesdr_tpu_torch.types import RDTYPE


def averager_scan_plain(peak: torch.Tensor, a0, d0, timer0, attack, decay,
                        hang_time: int | None, out=None, skip=None,
                        count=None):
    if skip is not None and bool(skip):
        return out
    if count is not None:
        count += 1
    return _recurrence(peak, a0, d0, timer0, attack, decay, hang_time)


def _recurrence(peak: torch.Tensor, a0, d0, timer0, attack, decay,
                hang_time: int | None):
    dev = peak.device
    r = lambda v: torch.tensor(v, dtype=RDTYPE, device=dev)
    if hang_time is None:
        # both averagers as one [..., 2] state
        rise = r([attack[0], decay[0]])
        fall = r([attack[1], decay[1]])
        s = torch.stack([a0, d0], -1)
        states = torch.empty(peak.shape + (2,), dtype=RDTYPE, device=dev)
        for i, pk in enumerate(peak.unbind(-1)):
            pk = pk.unsqueeze(-1)
            alpha = torch.where(pk > s, rise, fall)
            s = (1.0 - alpha) * s + alpha * pk
            states[..., i, :] = s
        return s[..., 0], s[..., 1], timer0, states.amax(-1)
    ar, af = r(attack[0]), r(attack[1])
    dr, df = decay
    one = np.float32(1.0)
    a, d, timer = a0, d0, timer0
    mag = torch.empty_like(peak)
    for i, pk in enumerate(peak.unbind(-1)):
        alpha = torch.where(pk > a, ar, af)
        a = (1.0 - alpha) * a + alpha * pk
        rising = pk > d
        hold = timer < hang_time
        d = torch.where(rising, (one - dr) * d + dr * pk,
                        torch.where(hold, d, (one - df) * d + df * pk))
        timer = torch.where(rising, 0, torch.where(hold, timer + 1, timer))
        mag[..., i] = torch.maximum(a, d)
    return a, d, timer, mag


def averager_scan(peak: torch.Tensor, a0: torch.Tensor, d0: torch.Tensor,
                  timer0: torch.Tensor, attack, decay,
                  hang_time: int | None, out=None, skip=None, count=None):
    """Both averagers over every stream of ``peak``, sample by sample;
    with ``skip``, over ``out`` unless the flag holds (module notes)."""
    if _build.on_cpu(peak, a0, d0, timer0):
        return averager_scan_plain(peak, a0, d0, timer0, attack, decay,
                                   hang_time, out, skip, count)
    n = peak.shape[-1]
    rows = peak.shape[0] if peak.dim() == 2 else None
    _build.require(peak, "peak", RDTYPE, n, rows=rows)
    lead = peak.shape[:-1]
    n_ch = rows or 1
    for t, name, dtype in ((a0, "a0", RDTYPE), (d0, "d0", RDTYPE),
                           (timer0, "timer0", torch.int32)):
        if t.shape != lead or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} of shape "
                             f"{tuple(lead)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    a0, d0, timer0 = (t.contiguous() for t in (a0, d0, timer0))
    if out is None:
        a, d = torch.empty_like(a0), torch.empty_like(d0)
        timer = timer0 if hang_time is None else torch.empty_like(timer0)
        mag = torch.empty_like(peak)
    else:
        a, d, timer, mag = out
        for t, name, like in ((a, "a", a0), (d, "d", d0),
                              (timer, "timer", timer0), (mag, "mag", peak)):
            if t.shape != like.shape or t.dtype != like.dtype or \
                    not t.is_contiguous():
                raise ValueError(f"out {name}: expected a contiguous "
                                 f"{like.dtype} of shape {tuple(like.shape)}")
    if skip is not None:
        _build.require(skip.reshape(1), "skip", torch.bool, 1)
    if count is not None:
        _build.require(count.reshape(1), "count", torch.int32, 1)
    f = lambda v: float(np.float32(v))
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.check(_build.library().cutesdr_agc_seq(
        peak.data_ptr(), n, n_ch, f(attack[0]), f(attack[1]), f(decay[0]),
        f(decay[1]), -1 if hang_time is None else int(hang_time),
        a0.data_ptr(), d0.data_ptr(), timer0.data_ptr(), a.data_ptr(),
        d.data_ptr(), timer.data_ptr(), mag.data_ptr(), ptr(skip),
        ptr(count), _build.stream(peak)), "agcseq")
    LAUNCHES["agcseq"] += 1
    return a, d, timer, mag
