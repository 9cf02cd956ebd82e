"""Exact FM and SAM PLL loops (port of ``cutesdr_tpu/kernels/seqloop.py``),
and FM's chunked guess-verify tier (``cutesdr_tpu/ops/pll.chunked_scan``
as ``demod/fm._pll_chunked`` calls it) in the same launch.

The demodulators take these when their linear tier is not exact: during
acquisition, at clamp hits, on carrier-less noise.  CUDA tensors launch
the kernels of ``csrc/seqloop.cu``; CPU tensors run the plain versions
below, per-sample torch loops of the same operations in the same order
(the bodies of the JAX demods' ``_pll_scan``, minus FM's DC tracker,
which the caller runs vectorized through ``demod/fm._dc_track``).  Kernel
and plain version round alike op by op, so they agree to the bit.

* K8 (``sam_pll_scan``) walks each stream on one lane, a bank's streams
  packed 32 to a warp.
* K7 (``fm_pll_chunked``; ``fm_pll_scan`` is its outputs without the
  flag) runs blocks of at least ``MIN_CHUNKS`` chunks of ``CHUNK`` as the
  JAX chunked tier's schedule (pass 1 through a ``halo``, pass 2, the
  boundary check) and repairs the chunks whose boundary failed with a
  walker inside the same launch, so its outputs are the sequential
  loop's at every n; it also returns the first check's flag, which for
  a chunkable block (``demod/fm._chunkable``) is JAX's ``valid``.
  Shorter blocks take the walker alone (flag False).
  ``fm_pll_chunked_plain`` is that schedule in torch (the CPU tests'
  yardstick of the repair order); ``fm_pll_scan_plain`` is the loop.

The gate differs from the TPU's: ``seqloop.use_kernel`` there needs
1024 <= n <= 32768 and whole 1024-sample tiles (SMEM residency, Mosaic's
tile rule); the CUDA kernels stream from global memory and take every n.

A channel bank gives ``theta`` [C, n] and one initial phase and frequency
per stream; the plain loops run unchanged on [C] tensors.  One stream is
C = 1.

The demodulators decide their tier on the device, as JAX's ``lax.cond``
does: ``fm_pll_chunked`` and ``sam_pll_scan`` take the linear tier's
validity (``skip``, a 0-dim bool) and its outputs (``out``); the kernel
reads the flag and returns at once where it holds, leaving ``out`` as it
is, and otherwise writes the exact loop's outputs over it.  So the step
reads nothing on the host.  The plain versions take the same arguments
and branch on their CPU bool.
"""

from __future__ import annotations

import numpy as np
import torch

from cutesdr_tpu_torch.kernels import LAUNCHES, _build, scan
from cutesdr_tpu_torch.ops.pll import INV_2PI, TWO_PI
from cutesdr_tpu_torch.types import RDTYPE

CHUNK = 128           # K7's chunk and default halo: the JAX FM demod's
HALO = 128            # PLL_CHUNK and PLL_HALO
MIN_CHUNKS = 4        # fewer chunks: the walker alone
GROUP = 32            # chunks a CUDA block (one a lane)
STEPS = 32            # samples a group of the walker (csrc PLL_STEPS)
# the kernels' fast wrap needs limit + 4*|alpha| <= 7 (csrc/seqloop.cu);
# other parameters take the plain form
FAST_BOUND = 7.0


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

def _fm_walk(consts, phase, freq, theta: torch.Tensor):
    """The FM loop over the last axis of ``theta`` from (phase, freq), one
    per stream of its leading axes: (phase', freq', [freq], [err])."""
    wrap, a, b, lo, hi = consts
    freqs, errs = [], []
    for th in theta.unbind(-1):
        err = -wrap(th + phase)
        freq = torch.clamp(freq + b * err, lo, hi)
        phase = wrap(phase + freq + a * err)
        freqs.append(freq)
        errs.append(err)
    return phase, freq, freqs, errs


def fm_pll_scan_plain(alpha, beta, limit, phase0, freq0, theta: torch.Tensor):
    consts = _loop_consts(alpha, beta, limit, theta)
    phase, freq = _state0(phase0, freq0, theta).unbind(-1)
    phase, freq, freqs, errs = _fm_walk(consts, phase, freq, theta)
    return (torch.remainder(phase, TWO_PI), freq, torch.stack(freqs, -1),
            torch.stack(errs, -1))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _repair(consts, theta, e1, e2, freqs, errs, K: int):
    """K7's walker on one stream (``theta`` [n]; ``e1``, ``e2`` the
    passes' end states, each a (phase [K], freq [K]) pair; ``freqs``,
    ``errs`` [K, CHUNK] pass-2 outputs, rewritten in place): from the
    first boundary whose pass-2 end differs bitwise from its pass-1 end,
    re-run each chunk to its right from the true state; where the true end
    equals the pass-1 end the next chunk consumed, jump to the next failed
    boundary.  Then the tail past K chunks.  Returns (phase, freq, tail
    freqs, tail errs)."""
    bad = ((_bits(e1[0]) != _bits(e2[0])) | (_bits(e1[1]) != _bits(e2[1])))
    bad = bad[:K - 1].tolist() + [True]

    def next_failed(k):
        return bad.index(True, k)               # K - 1 when none is left

    k = next_failed(0)
    phase, freq = e2[0][k], e2[1][k]
    while k < K - 1:
        k += 1
        span = theta[k * CHUNK:(k + 1) * CHUNK]
        phase, freq, fr, er = _fm_walk(consts, phase, freq, span)
        freqs[k], errs[k] = torch.stack(fr), torch.stack(er)
        if k == K - 1:
            break
        if (_bits(phase) == _bits(e1[0][k])) and (_bits(freq)
                                                  == _bits(e1[1][k])):
            k = next_failed(k + 1)              # chunk k + 1 started true
            phase, freq = e2[0][k], e2[1][k]
    phase, freq, fr, er = _fm_walk(consts, phase, freq, theta[K * CHUNK:])
    return phase, freq, fr, er


def _skipped(skip, out) -> bool:
    """Whether a plain version's call is skipped (``skip`` holds; it then
    needs ``out``)."""
    if skip is None or not bool(skip):
        return False
    if out is None:
        raise ValueError("skip needs out: the outputs it leaves as they are")
    return True


def fm_pll_chunked_plain(alpha, beta, limit, phase0, freq0,
                         theta: torch.Tensor, halo: int = HALO, skip=None,
                         out=None):
    """K7's schedule in torch, with ``fm_pll_scan_plain``'s operations:
    pass 1 (every chunk from the initial state through ``halo`` samples of
    the previous chunk and its own; chunk 0 from the true state), pass 2
    (every chunk from its left neighbour's pass-1 end), the first check's
    flag (every boundary's pass-2 end == the pass-1 end its right
    neighbour consumed, as ``ops/pll.chunked_scan``), then the walker's
    repairs in the kernel's order.  Returns (valid, phase', freq', freqs,
    err), the last four bitwise the sequential loop's; below
    ``MIN_CHUNKS`` chunks the loop alone with valid False.  Where ``skip``
    holds, (False, *out)."""
    n = theta.shape[-1]
    K = n // CHUNK
    lead = theta.shape[:-1]
    if _skipped(skip, out):
        return (torch.zeros(lead, dtype=torch.bool, device=theta.device),
                *out)
    if K < MIN_CHUNKS:
        return (torch.zeros(lead, dtype=torch.bool, device=theta.device),
                *fm_pll_scan_plain(alpha, beta, limit, phase0, freq0, theta))
    if not 0 <= halo <= CHUNK:
        raise ValueError(f"fm_pll_chunked: halo {halo} outside 0..{CHUNK}")
    consts = _loop_consts(alpha, beta, limit, theta)
    th = theta.reshape(-1, n)                               # [R, n]
    phase0, freq0 = _state0(phase0, freq0, th).unbind(-1)
    main = th[:, :K * CHUNK].reshape(-1, K, CHUNK)
    guess = lambda v: v.unsqueeze(-1).expand(-1, K)
    first = torch.zeros(K, dtype=torch.bool, device=theta.device)
    first[0] = True

    halos = torch.cat([th.new_zeros(th.shape[0], 1, halo),
                       main[:, :-1, CHUNK - halo:]], 1)
    p, f, _, _ = _fm_walk(consts, guess(phase0), guess(freq0), halos)
    p, f = (torch.where(first, guess(v0), v)
            for v0, v in ((phase0, p), (freq0, f)))
    e1 = _fm_walk(consts, p, f, main)[:2]

    left = [torch.cat([v0.unsqueeze(-1), v[:, :-1]], -1)
            for v0, v in zip((phase0, freq0), e1)]
    p, f, fr, er = _fm_walk(consts, *left, main)
    e2 = (p, f)
    freqs, errs = torch.stack(fr, -1), torch.stack(er, -1)   # [R, K, CHUNK]
    valid = ((e1[0] == e2[0]) & (e1[1] == e2[1]))[:, :-1].all(-1)

    ends, tails = [], []
    for r in range(th.shape[0]):
        phase, freq, tf, te = _repair(consts, th[r], (e1[0][r], e1[1][r]),
                                      (e2[0][r], e2[1][r]), freqs[r],
                                      errs[r], K)
        ends.append((phase, freq))
        tails.append((tf, te))
    series = []
    for i, full in enumerate((freqs, errs)):
        parts = [full.reshape(-1, K * CHUNK)]
        if n > K * CHUNK:
            parts.append(torch.stack([torch.stack(t[i], -1) for t in tails]))
        series.append(torch.cat(parts, -1).reshape(theta.shape))
    phase, freq = (torch.stack([e[i] for e in ends]).reshape(lead)
                   for i in (0, 1))
    return (valid.reshape(lead), torch.remainder(phase, TWO_PI), freq,
            *series)


def _checked_consts(alpha, beta, limit, fast_round: bool):
    """The kernel's float32 constants and whether its fast wrap (the
    magic-constant round and one FMA) may be used; raises on a negative
    limit (the clamp's rails)."""
    a, b, lim = _consts(alpha, beta, limit)
    if not lim >= 0.0:
        raise ValueError(f"PLL limit {lim} must be >= 0")
    fast = fast_round and lim + 4.0 * abs(a) <= FAST_BOUND
    return a, b, lim, int(fast)


def _streams(theta: torch.Tensor):
    """(n, rows or None, C) of a [n] or [C, n] float32 CUDA theta."""
    n = theta.shape[-1]
    rows = theta.shape[0] if theta.dim() == 2 else None
    _build.require(theta, "theta", RDTYPE, n, rows=rows)
    return n, rows, 1 if rows is None else rows


def _skip_ptr(skip) -> int | None:
    if skip is None:
        return None
    _build.require(skip.reshape(1), "skip", torch.bool, 1)
    return skip.data_ptr()


def _outputs(theta: torch.Tensor, state0: torch.Tensor, out, series: int):
    """The kernel's (state [.., 2], series...) buffers: fresh, or ``out``'s
    (phase, freq, series...) where the call may leave them as they are."""
    if out is None:
        return (torch.empty_like(state0),
                *(torch.empty_like(theta) for _ in range(series)))
    phase, freq, *rest = out
    for t in rest:
        _build.require(t, "out", RDTYPE, theta.shape[-1],
                       rows=theta.shape[0] if theta.dim() == 2 else None)
    return (torch.stack([phase, freq], -1).to(RDTYPE), *rest)


def _fm_launch(alpha, beta, limit, phase0, freq0, theta: torch.Tensor,
               halo: int = HALO, fast_round: bool = True, clocks=None,
               stager_ns: int = 0, skip=None, out=None):
    """One launch of K7 over every stream of ``theta``: (valid, phase',
    freq', freqs, err); ``clocks`` (int64 [3]) takes the walker's clock
    probe, which walks every n; ``stager_ns`` delays the stager warp after
    each group's barrier (a check of the walk's ordering); ``skip`` and
    ``out`` as the module notes say."""
    n, rows, c = _streams(theta)
    if not 0 <= halo <= CHUNK:
        raise ValueError(f"fm_pll_chunked: halo {halo} outside 0..{CHUNK}")
    consts = _checked_consts(alpha, beta, limit, fast_round)
    state0 = _state0(phase0, freq0, theta).contiguous()
    state, freqs, errs = _outputs(theta, state0, out, 2)
    valid = torch.empty(theta.shape[:-1], dtype=torch.uint8,
                        device=theta.device)
    K = n // CHUNK
    chunked = K >= MIN_CHUNKS and clocks is None
    groups = -(-K // GROUP)
    ends = torch.empty(2, c, K, 2, dtype=RDTYPE, device=theta.device) \
        if chunked else None
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.library()
    err = scan.launch_ordered(
        theta, 2 * c * groups if chunked else 0,
        lambda flags, _agg, ticket: lib.cutesdr_fm_pll(
            theta.data_ptr(), n, c, *consts, halo, state0.data_ptr(),
            freqs.data_ptr(), errs.data_ptr(), state.data_ptr(),
            valid.data_ptr(), ptr(ends), None if ends is None else
            ends[1].data_ptr(), flags, ticket, ptr(clocks), stager_ns,
            _skip_ptr(skip), _build.stream(theta)))
    _build.check(err, "seqloop_fm")
    LAUNCHES["seqloop_fm"] += 1
    return valid.view(torch.bool), state[..., 0], state[..., 1], freqs, errs


def fm_pll_chunked(alpha, beta, limit, phase0, freq0, theta: torch.Tensor,
                   halo: int = HALO, stager_ns: int = 0, skip=None,
                   out=None):
    """The FM PLL recurrence over float32 ``theta`` ([n], or [C, n] for C
    streams), exact, and the chunked tier's flag.  Returns (valid, phase',
    freq', freqs, err): whether every chunk boundary held at the first
    check (JAX's chunked-tier ``valid`` where n is chunkable; False below
    ``MIN_CHUNKS`` chunks), the final state (phase mod 2pi), the
    per-sample NCO frequency and the phase-error series.  One launch of
    K7 on the card; ``stager_ns`` there sleeps the kernel's stager warp
    after each 32-sample group (0 in use; the smoke's check that a repair
    walk's stop does not race the stores).  With ``skip`` (FM's linear
    tier held) and ``out`` (its (phase', freq', freqs, err)): (False,
    *out) where the flag holds, else the exact outputs, written over
    ``out`` on the card."""
    if _build.on_cpu(theta):
        return fm_pll_chunked_plain(alpha, beta, limit, phase0, freq0, theta,
                                    halo, skip, out)
    return _fm_launch(alpha, beta, limit, phase0, freq0, theta, halo,
                      stager_ns=stager_ns, skip=skip, out=out)


def fm_pll_scan(alpha, beta, limit, phase0, freq0, theta: torch.Tensor):
    """The FM PLL recurrence over float32 ``theta`` ([n], or [C, n] for C
    streams).  Returns (phase', freq', freqs, err): the final state (phase
    mod 2pi), the per-sample NCO frequency and the phase-error series."""
    if _build.on_cpu(theta):
        return fm_pll_scan_plain(alpha, beta, limit, phase0, freq0, theta)
    return _fm_launch(alpha, beta, limit, phase0, freq0, theta)[1:]


# -------------------------------------------------------------------- SAM --

def sam_pll_scan_plain(alpha, beta, limit, phase0, freq0,
                       theta: torch.Tensor, skip=None, out=None):
    if _skipped(skip, out):
        return tuple(out)
    wrap, a, b, lo, hi = _loop_consts(alpha, beta, limit, theta)
    phase, freq = _state0(phase0, freq0, theta).unbind(-1)
    prev = []
    for th in theta.unbind(-1):
        err = wrap(th - phase)
        freq = torch.clamp(freq + b * err, lo, hi)
        prev.append(phase)
        phase = wrap(phase + freq + a * err)
    return torch.remainder(phase, TWO_PI), freq, torch.stack(prev, -1)


def _sam_launch(alpha, beta, limit, phase0, freq0, theta: torch.Tensor,
                fast_round: bool = True, clocks=None, skip=None, out=None):
    n, rows, c = _streams(theta)
    consts = _checked_consts(alpha, beta, limit, fast_round)
    state0 = _state0(phase0, freq0, theta).contiguous()
    state, prev = _outputs(theta, state0, out, 1)
    _build.check(_build.library().cutesdr_sam_pll(
        theta.data_ptr(), n, c, *consts, state0.data_ptr(), prev.data_ptr(),
        state.data_ptr(), None if clocks is None else clocks.data_ptr(),
        _skip_ptr(skip), _build.stream(theta)), "seqloop_sam")
    LAUNCHES["seqloop_sam"] += 1
    return state[..., 0], state[..., 1], prev


def sam_pll_scan(alpha, beta, limit, phase0, freq0, theta: torch.Tensor,
                 skip=None, out=None):
    """The SAM carrier PLL recurrence over float32 ``theta`` ([n], or
    [C, n] for C streams).  Returns (phase', freq', prev): the final state
    (phase mod 2pi) and the PRE-update phase sequence the baseband
    rotation uses (dsp/samdemod.cpp:78-110).  One launch of K8 on the
    card.  With ``skip`` (SAM's linear tier held) and ``out`` (its
    (phase', freq', prev)): ``out`` where the flag holds, else the exact
    outputs, written over ``out`` on the card."""
    if _build.on_cpu(theta):
        return sam_pll_scan_plain(alpha, beta, limit, phase0, freq0, theta,
                                  skip, out)
    return _sam_launch(alpha, beta, limit, phase0, freq0, theta, skip=skip,
                       out=out)


def chain_cycles(kind: str, alpha, beta, limit, theta: torch.Tensor,
                 fast_round: bool = True) -> tuple[float, float]:
    """Cycles a sample of one stream's walk on the card (``kind`` "fm" or
    "sam"; ``theta`` [n] on the card, n >= 96) from the walker's clock64()
    probe in block 0: (the walk's, from its second 32-sample group to its
    last; the steps' alone, over the second group).  ``fast_round`` False
    keeps the plain wrap (rintf).  Counts as a launch of the kernel."""
    clocks = torch.zeros(3, dtype=torch.int64, device=theta.device)
    if kind == "fm":
        _fm_launch(alpha, beta, limit, 0.0, 0.0, theta, HALO, fast_round,
                   clocks)
    else:
        _sam_launch(alpha, beta, limit, 0.0, 0.0, theta, fast_round, clocks)
    groups = -(-theta.shape[-1] // STEPS)
    c0, c1, c2 = clocks.tolist()
    return (c2 - c0) / (STEPS * (groups - 2)), (c1 - c0) / STEPS
