"""Affine prefix scans of the AGC and the S-meter (port of
``cutesdr_tpu/kernels/scan1.py``).

Three TPU kernels map onto two CUDA sources:

* ``first_order_scan`` (scan1.first_order_scan) is the affine solve
  x[n] = A[n]*x[n-1] + B[n] (``csrc/scan.cu``, three launches);
* ``guess_round`` (scan1.guess_round) builds A/B from the AGC branch
  pattern and re-derives the pattern; the port runs it inside
  ``guess_verify_solve``, which also takes the loop around it from JAX's
  ``ops/agc._two_rate_parallel`` (warm start, rounds until one validates
  or ``n_iters`` ran) into ONE cooperative launch with no host read
  (``csrc/scan.cu``); ``guess_round`` is that launch for one round from a
  given pattern;
* ``smeter_last`` (scan1.smeter_last) chains the attack EMA into the
  snapped max-affine decay and emits the two final values
  (``csrc/smeter.cu``).

CUDA tensors launch the kernels; CPU tensors take the plain versions
below, which are the JAX package's XLA forms (``ops/util`` solves, the
open-coded guess-verify round and loop of ``ops/agc._two_rate_parallel``).
The size gates are the JAX package's, so both take the same branch.
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


def guess_verify(body, carry, n_iters: int):
    """Guess-verify rounds ``body(carry) -> (carry', ok)`` until every row
    validates or ``n_iters`` rounds ran; ``ok`` is one flag per row (0-dim
    for the single stream).  A row that has validated is frozen, as the
    JAX package's vmapped ``lax.while_loop`` leaves a converged channel
    alone: another round could still move it (the tie forgiveness).  One
    host read per round but the last.  Returns (carry, every row
    converged, rounds run): ``True`` where a read saw it, else the flag
    as a 0-dim device bool, left for the caller to read."""
    carry, ok = body(carry)
    rounds = 1
    while rounds < n_iters:
        if bool(ok.all()):                               # host sync
            return carry, True, rounds
        new, new_ok = body(carry)
        if ok.dim() == 0:
            carry = new
        else:
            keep = ok.unsqueeze(-1)
            carry = tuple(torch.where(keep, old, nw)
                          for old, nw in zip(carry, new))
        ok = ok | new_ok
        rounds += 1
    return carry, ok.all(), rounds


def warm_rate(rise_alpha, fall_alpha) -> np.float32:
    """The warm start's geometric-mean rate."""
    return np.float32(np.sqrt(np.float32(rise_alpha) * np.float32(fall_alpha)))


def guess_verify_solve_plain(peak: torch.Tensor, x0, rise_alpha, fall_alpha,
                             n_iters: int):
    """The two-rate averager x[n] = (1-a[n])*x[n-1] + a[n]*pk[n], a[n] =
    rise if pk[n] > x[n-1] else fall, by guess-verify: a warm start at the
    geometric-mean rate derives the first pattern, then rounds of
    ``guess_round_plain`` until one has no unforgiven mismatch or
    ``n_iters`` ran (rows of a [C, n] ``peak`` are independent streams,
    frozen once they validate).  Returns (x, every row converged, rounds
    run), as ``guess_verify``."""
    ag = warm_rate(rise_alpha, fall_alpha)
    xg = first_order_recurrence((np.float32(1.0) - ag) * torch.ones_like(peak),
                                peak * ag, x0)

    def body(c):
        x, pattern, count = guess_round_plain(peak, c[1], x0, rise_alpha,
                                              fall_alpha)
        return (x, pattern), count == 0

    (x, _), ok, rounds = guess_verify(body, (xg, peak > shift1(xg, x0)),
                                      n_iters)
    return x, ok, rounds


def _solve_launch(peak: torch.Tensor, pattern, x0, rise_alpha, fall_alpha,
                  n_iters: int):
    """One launch of the solve: (x, last pattern, int32 [n_iters + 3] =
    per-round counts [n_iters + 1], ok, rounds), all on the device."""
    n = peak.shape[-1]
    _build.require(peak, "peak", RDTYPE, n)
    if pattern is not None:
        _build.require(pattern, "pattern", torch.bool, n)
    x0 = _scalar(x0, peak)
    x = torch.empty(n, dtype=RDTYPE, device=peak.device)
    newpat = torch.empty(n, dtype=torch.bool, device=peak.device)
    ints = torch.empty(n_iters + 3, dtype=torch.int32, device=peak.device)
    ta, tb = _scratch(n, 2, peak)
    _build.check(_build.library().cutesdr_scan_solve(
        peak.data_ptr(), None if pattern is None else pattern.data_ptr(),
        np.float32(rise_alpha), np.float32(fall_alpha),
        warm_rate(rise_alpha, fall_alpha), x0.data_ptr(), n, n_iters,
        x.data_ptr(), newpat.data_ptr(), ints.data_ptr(),
        ints.data_ptr() + 4 * (n_iters + 1), ta.data_ptr(), tb.data_ptr(),
        _build.stream(peak)), "scan_solve")
    LAUNCHES["scan_solve"] += 1
    return x, newpat, ints


def guess_verify_solve(peak: torch.Tensor, x0, rise_alpha, fall_alpha,
                       n_iters: int):
    """(x, ok, rounds) of ``guess_verify_solve_plain`` for one stream: the
    plain loop for CPU tensors, one launch of the kernel for CUDA ones, its
    ok (0-dim bool) and round count (0-dim int32) left on the device."""
    if _build.on_cpu(peak):
        return guess_verify_solve_plain(peak, x0, rise_alpha, fall_alpha,
                                        n_iters)
    x, _, ints = _solve_launch(peak, None, x0, rise_alpha, fall_alpha,
                               n_iters)
    return x, ints[n_iters + 1] != 0, ints[n_iters + 2]


def guess_round(peak: torch.Tensor, pattern: torch.Tensor, x0, rise_alpha,
                fall_alpha):
    """(x, new pattern, mismatch count) of one round; ``pattern`` is bool.
    On the card the solve's launch for one round.  The count is a device
    tensor: reading it is the caller's host sync."""
    if _build.on_cpu(peak, pattern):
        return guess_round_plain(peak, pattern, x0, rise_alpha, fall_alpha)
    x, newpat, ints = _solve_launch(peak, pattern, x0, rise_alpha,
                                    fall_alpha, 1)
    return x, newpat, ints[1]


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
