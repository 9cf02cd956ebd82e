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
"""

from __future__ import annotations

import numpy as np
import torch

from cutesdr_tpu_torch.kernels import LAUNCHES, _build
from cutesdr_tpu_torch.types import RDTYPE


def averager_scan_plain(peak: torch.Tensor, a0, d0, timer0, attack, decay,
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
                  hang_time: int | None):
    """Both averagers over every stream of ``peak``, sample by sample."""
    if _build.on_cpu(peak, a0, d0, timer0):
        return averager_scan_plain(peak, a0, d0, timer0, attack, decay,
                                   hang_time)
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
    a, d = torch.empty_like(a0), torch.empty_like(d0)
    timer = timer0 if hang_time is None else torch.empty_like(timer0)
    mag = torch.empty_like(peak)
    f = lambda v: float(np.float32(v))
    _build.check(_build.library().cutesdr_agc_seq(
        peak.data_ptr(), n, n_ch, f(attack[0]), f(attack[1]), f(decay[0]),
        f(decay[1]), -1 if hang_time is None else int(hang_time),
        a0.data_ptr(), d0.data_ptr(), timer0.data_ptr(), a.data_ptr(),
        d.data_ptr(), timer.data_ptr(), mag.data_ptr(), _build.stream(peak)),
        "agcseq")
    LAUNCHES["agcseq"] += 1
    return a, d, timer, mag
