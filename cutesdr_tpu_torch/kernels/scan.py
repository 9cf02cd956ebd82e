"""Affine prefix scans of the AGC and the S-meter (port of
``cutesdr_tpu/kernels/scan1.py``).

Three TPU kernels map onto two CUDA sources:

* ``first_order_scan`` (scan1.first_order_scan) and ``guess_round``
  (scan1.guess_round) are the same affine solve x[n] = A[n]*x[n-1] + B[n];
  they differ only in how A/B are loaded and what the epilogue emits, so
  ``csrc/scan.cu`` serves both, in mode "plain" and mode "round";
* ``smeter_last`` (scan1.smeter_last) chains the attack EMA into the
  snapped max-affine decay and emits the two final values
  (``csrc/smeter.cu``).

CUDA tensors launch the kernels; CPU tensors take the plain versions
below, which are the JAX package's XLA forms (``ops/util`` solves, the
open-coded guess-verify round of ``ops/agc._two_rate_parallel``).  The
size gates are the JAX package's, so both take the same branch.
"""

from __future__ import annotations

import numpy as np
import torch

from cutesdr_tpu_torch.kernels import LAUNCHES, _build
from cutesdr_tpu_torch.ops.util import (ema, first_order_recurrence,
                                        max_affine_recurrence)
from cutesdr_tpu_torch.types import RDTYPE

ROWS_PER_STEP = 256           # the JAX kernels' block rows (S-meter gate)
MIN_KERNEL_N = 65536          # below this the plain solve is taken
CHUNK = 2048                  # elements per CUDA block (THREADS * ITEMS in
                              # csrc/scan_common.cuh)


def supported(n: int) -> bool:
    return n >= MIN_KERNEL_N


def smeter_supported(n: int) -> bool:
    """The S-meter kernel emits only final values, so its last element
    must be a real sample: whole (256 x 128) blocks only (scan1.py:391)."""
    return n >= MIN_KERNEL_N and n % (ROWS_PER_STEP * 128) == 0


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=RDTYPE, device=like.device).reshape(1)


def _scratch(n: int, k: int, like: torch.Tensor) -> list[torch.Tensor]:
    nb = -(-n // CHUNK)
    return [torch.empty(nb, dtype=RDTYPE, device=like.device)
            for _ in range(k)]


def shift1(x: torch.Tensor, x0) -> torch.Tensor:
    """x[n-1] series along the last axis: [x0, x[0], ..., x[-2]]; ``x0`` a
    scalar or one value per row."""
    x0 = torch.as_tensor(x0, dtype=x.dtype, device=x.device)
    return torch.cat([x0.expand(x.shape[:-1]).unsqueeze(-1), x[..., :-1]],
                     -1)


# ------------------------------------------------------------ mode plain --

first_order_scan_plain = first_order_recurrence


def first_order_scan(a: torch.Tensor, b: torch.Tensor, x0) -> torch.Tensor:
    """x[n] = a[n]*x[n-1] + b[n], x[-1] = x0, for flat float32 tensors."""
    if _build.on_cpu(a, b):
        return first_order_scan_plain(a, b, x0)
    n = b.shape[-1]
    a = a.expand(n).contiguous()
    _build.require(a, "a", RDTYPE, n)
    _build.require(b, "b", RDTYPE, n)
    x0 = _scalar(x0, b)
    x = torch.empty(n, dtype=RDTYPE, device=b.device)
    ta, tb, st = _scratch(n, 3, b)
    _build.check(_build.library().cutesdr_scan_plain(
        a.data_ptr(), b.data_ptr(), x0.data_ptr(), n, x.data_ptr(),
        ta.data_ptr(), tb.data_ptr(), st.data_ptr(), _build.stream(b)),
        "scan_plain")
    LAUNCHES["scan_plain"] += 1
    return x


# ------------------------------------------------------------ mode round --

def guess_round_plain(peak: torch.Tensor, pattern: torch.Tensor, x0,
                      rise_alpha, fall_alpha):
    """One guess-verify round of the two-rate averager (the loop body of
    ops/agc._two_rate_parallel): A/B from the branch pattern, the affine
    solve, x[n-1], the re-derived pattern, and the count of mismatches
    that are not forgiven (exact ties, rounding-identical branches).
    Rows of a [C, n] ``peak`` are independent streams, each with its own
    ``x0`` and count."""
    rise_c = np.float32(1.0) - rise_alpha
    fall_c = np.float32(1.0) - fall_alpha
    rise_b = peak * rise_alpha
    fall_b = peak * fall_alpha
    A = torch.where(pattern, _scalar(rise_c, peak), _scalar(fall_c, peak))
    x = first_order_recurrence(A, torch.where(pattern, rise_b, fall_b), x0)
    prev = shift1(x, x0)
    newpat = peak > prev
    # each branch's update rounds once, as XLA:CPU's FMA contraction of
    # c*prev + b does (float64 holds c*prev exactly).  Rounded twice, the
    # two branches differ by an ulp at many plateau near-ties, and the
    # rounds creep a few samples at a time: 27 rounds where JAX takes 3 on
    # a full-width USB block
    fused = lambda c, b: (prev.double() * float(c) + b.double()).to(RDTYPE)
    same_val = fused(rise_c, rise_b) == fused(fall_c, fall_b)
    mism = (newpat != pattern) & (peak != prev) & ~same_val
    return x, newpat, mism.sum(-1)


def guess_round(peak: torch.Tensor, pattern: torch.Tensor, x0, rise_alpha,
                fall_alpha):
    """(x, new pattern, mismatch count) of one round; ``pattern`` is bool.
    The count is a device tensor: reading it is the caller's host sync."""
    if _build.on_cpu(peak, pattern):
        return guess_round_plain(peak, pattern, x0, rise_alpha, fall_alpha)
    n = peak.shape[-1]
    _build.require(peak, "peak", RDTYPE, n)
    _build.require(pattern, "pattern", torch.bool, n)
    x0 = _scalar(x0, peak)
    x = torch.empty(n, dtype=RDTYPE, device=peak.device)
    newpat = torch.empty(n, dtype=torch.bool, device=peak.device)
    count = torch.zeros(1, dtype=torch.int32, device=peak.device)
    ta, tb, st = _scratch(n, 3, peak)
    _build.check(_build.library().cutesdr_scan_round(
        peak.data_ptr(), pattern.data_ptr(), np.float32(rise_alpha),
        np.float32(fall_alpha), x0.data_ptr(), n, x.data_ptr(),
        newpat.data_ptr(), count.data_ptr(), ta.data_ptr(), tb.data_ptr(),
        st.data_ptr(), _build.stream(peak)), "scan_round")
    LAUNCHES["scan_round"] += 1
    return x, newpat, count[0]


# ---------------------------------------------------------------- smeter --

def smeter_last_plain(mag: torch.Tensor, attack_alpha, decay_alpha, a0, d0):
    a_series = ema(attack_alpha, mag, a0)
    d_series = max_affine_recurrence(np.float32(1.0) - decay_alpha,
                                     mag * decay_alpha, a_series, d0)
    return a_series[-1], d_series[-1]


def smeter_last(mag: torch.Tensor, attack_alpha, decay_alpha, a0, d0):
    """(a_last, d_last) of the S-meter averager pair over ``mag``:
        a[n] = (1-aa)*a[n-1] + aa*m[n]
        d[n] = max((1-ad)*d[n-1] + ad*m[n], a[n])
    Callers check ``smeter_supported(len(mag))``."""
    if _build.on_cpu(mag):
        return smeter_last_plain(mag, attack_alpha, decay_alpha, a0, d0)
    n = mag.shape[-1]
    if not smeter_supported(n):
        raise ValueError(f"smeter kernel needs whole 32768-sample blocks, "
                         f"got {n}")
    _build.require(mag, "mag", RDTYPE, n)
    a0, d0 = _scalar(a0, mag), _scalar(d0, mag)
    out = torch.empty(2, dtype=RDTYPE, device=mag.device)
    ta, tb, st, mc, mu, mv = _scratch(n, 6, mag)
    _build.check(_build.library().cutesdr_smeter(
        mag.data_ptr(), np.float32(attack_alpha), np.float32(decay_alpha),
        a0.data_ptr(), d0.data_ptr(), n, out.data_ptr(), ta.data_ptr(),
        tb.data_ptr(), st.data_ptr(), mc.data_ptr(), mu.data_ptr(),
        mv.data_ptr(), _build.stream(mag)), "smeter")
    LAUNCHES["smeter"] += 1
    return out[0], out[1]
