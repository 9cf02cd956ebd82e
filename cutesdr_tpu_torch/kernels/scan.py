"""Affine prefix scans of the AGC, the S-meter and the demodulators'
one-pole filters (port of ``cutesdr_tpu/kernels/scan1.py``), and the
AGC's guess-verify solves.

Three TPU kernels map onto two CUDA sources, and one solve without a
Pallas kernel joins them:

* ``first_order_scan`` (scan1.first_order_scan) is the affine solve
  x[n] = A[n]*x[n-1] + B[n] over ``[..., n]`` rows with per-row initial
  states, A per sample or one scalar (``csrc/scan.cu``, one launch: a
  single-pass decoupled look-back scan); ``ema`` is the exponential
  moving average through it, its alpha folded into the kernel;
* ``guess_round`` (scan1.guess_round) builds A/B from the AGC branch
  pattern and re-derives the pattern; the port runs it inside
  ``guess_verify_solve``, which also takes the loop around it from JAX's
  ``ops/agc._two_rate_parallel`` (warm start, rounds until one validates
  or ``n_iters`` ran) into ONE launch with no host read, over one stream
  or a bank's [C, n] rows (each row its own stream, frozen once it
  validates; ``csrc/scan.cu``: rows of one 2,048-sample chunk a block
  each, rows of more one cooperative launch); ``guess_round`` is that
  launch for one round from a given pattern;
* ``hang_solve`` (N3h, no Pallas counterpart: JAX's
  ``ops/agc._hang_decay_parallel``, a ``lax.while_loop`` of solves) is
  hang mode's decay solve in ONE launch of the same two forms: the
  distance since the last rise (a max carried across chunks), the hold
  window, the rates, K3's affine solve, the re-derived pattern and its
  exact count, every round on the device;
* ``smeter_last`` (scan1.smeter_last) chains the attack EMA into the
  snapped max-affine decay and emits the two final values of every row
  (``csrc/smeter.cu``, one launch, one pass).

CUDA tensors launch the kernels at every size; CPU tensors take the
plain versions, which are the JAX package's XLA forms (``ops/util``
solves, the open-coded guess-verify round and loop of
``ops/agc._two_rate_parallel`` and ``_hang_decay_parallel``, their rounds
driven from Python with one host read a round), so every CPU parity test
sees the numbers the plain solves give.  The JAX package's size gates
(``MIN_KERNEL_N``, ``smeter_supported``), set by TPU timing, are kept for
the parity tests; the CUDA kernels do not need them.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from cutesdr_tpu_torch.kernels import LAUNCHES, _build
from cutesdr_tpu_torch.ops import util
from cutesdr_tpu_torch.ops.util import first_order_recurrence
from cutesdr_tpu_torch.types import RDTYPE

ROWS_PER_STEP = 256           # the JAX kernels' block rows (S-meter gate)
MIN_KERNEL_N = 65536          # the JAX kernels' size gate (TPU-timed)
CHUNK = 2048                  # elements per CUDA block (THREADS * ITEMS in
                              # csrc/scan_common.cuh)


def smeter_supported(n: int) -> bool:
    """The JAX package's S-meter gate: its kernel emits only final values,
    so its last element must be a real sample: whole (256 x 128) blocks
    only (scan1.py:391).  The CUDA kernel takes every n."""
    return n >= MIN_KERNEL_N and n % (ROWS_PER_STEP * 128) == 0


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=RDTYPE, device=like.device).reshape(1)


def shift1(x: torch.Tensor, x0) -> torch.Tensor:
    """x[n-1] series along the last axis: [x0, x[0], ..., x[-2]]; ``x0`` a
    scalar or one value per row."""
    x0 = torch.as_tensor(x0, dtype=x.dtype, device=x.device)
    return torch.cat([x0.expand(x.shape[:-1]).unsqueeze(-1), x[..., :-1]],
                     -1)


# -------------------------------------------------------- look-back state --

class Lookback:
    """The status memory of the one-pass scans (K3, K5) and of K7: status
    words and chunk maps (one slot a chunk of each look-back phase) and
    the ticket counter.  Each call zeroes its status words and the ticket
    with one fill on its stream before its launch (``claim``), so the
    kernels take no per-call number from the host, a call never reads a
    word an earlier call left, and a CUDA graph that captures the fill
    with the launch replays correctly.  Grown, never shrunk (a graph's is
    sized by its warm-up step, so a capture never grows it)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.slots = 0
        self.words = self.agg = None      # int32 [1 + slots]: ticket, flags

    def claim(self, slots: int) -> tuple:
        """Pointers (flags, agg, ticket) for a call of ``slots`` status
        slots (all phases), zeroed on the current stream."""
        if slots > self.slots:
            self.slots = max(slots, 2 * self.slots)
            z = lambda *shape: torch.zeros(*shape, dtype=torch.int32,
                                           device=self.device)
            # a slot's map: two 16-byte words
            self.words, self.agg = z(1 + self.slots), z(self.slots, 8)
        self.words[:1 + slots].zero_()
        return (self.words.data_ptr() + 4, self.agg.data_ptr(),
                self.words.data_ptr())


_lookbacks: dict[tuple, Lookback] = {}
_lookback_lock = threading.Lock()
_owned = threading.local()


@contextlib.contextmanager
def own_lookback(lb: Lookback):
    """Launches of this thread inside the block use ``lb`` (a CUDA graph's
    own look-back memory) instead of their stream's."""
    kept = getattr(_owned, "lb", None)
    _owned.lb = lb
    try:
        yield lb
    finally:
        _owned.lb = kept


def launch_ordered(t: torch.Tensor, slots: int, launch) -> int:
    """Launch a kernel whose blocks order themselves through look-back
    memory: ``launch(flags, agg, ticket)`` enqueues it with ``slots``
    status slots (0: none, all three null) and returns its CUDA error,
    which is returned.  The memory is the thread's own (``own_lookback``)
    or that of ``t``'s stream, shared by every kernel of the stream (the
    scans here, K7 in ``kernels/seqloop``), which the stream's order keeps
    apart."""
    if not slots:
        return launch(None, None, None)
    lb = getattr(_owned, "lb", None)
    with _lookback_lock:
        if lb is None:
            key = (t.device.index, _build.stream(t))
            lb = _lookbacks.get(key)
            if lb is None:
                lb = _lookbacks[key] = Lookback(t.device)
        return launch(*lb.claim(slots))


def _launch_chained(t: torch.Tensor, rows: int, n: int, phases: int,
                    launch) -> int:
    """Launch a one-pass scan over ``rows`` rows of ``n`` on ``t``'s stream
    with ``phases`` look-back phases (``launch_ordered``).  Rows of one
    chunk use no look-back memory."""
    nchunks = -(-n // CHUNK)
    return launch_ordered(t, phases * rows * nchunks if nchunks > 1 else 0,
                          launch)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as contiguous float32 [rows, n] (a view where it can be)."""
    return t.reshape(-1, t.shape[-1]).to(RDTYPE).contiguous()


def _state(x0, rows: int, like: torch.Tensor) -> tuple:
    """(pointer, stride, value) of initial states: a host number (null
    pointer), one device value for every row (stride 0) or one per row."""
    if not isinstance(x0, torch.Tensor):
        return None, 0, float(np.float32(x0))
    x0 = x0.to(device=like.device, dtype=RDTYPE).reshape(-1).contiguous()
    if x0.numel() not in (1, rows):
        raise ValueError(f"initial states: expected 1 or {rows} values, got "
                         f"{x0.numel()}")
    return x0, int(x0.numel() == rows and rows > 1), 0.0


def _aligned(*ts: torch.Tensor) -> int:
    """1 if every tensor's data is 16-byte aligned and rows are whole
    16-byte vectors (the kernels' vector loads and stores)."""
    return int(all(t.data_ptr() % 16 == 0 and t.shape[-1] % 4 == 0
                   for t in ts))


# ------------------------------------------------------------ mode plain --

first_order_scan_plain = first_order_recurrence
ema_plain = util.ema


def _affine(a, b: torch.Tensor, x0, b_scale: float = 1.0) -> torch.Tensor:
    """One launch of the affine scan: x[i] = A[i]*x[i-1] + b_scale*b[i]
    along the last axis of ``b``; ``a`` a host number or a tensor that
    broadcasts to ``b``; ``x0`` a host number, one value or one per row."""
    shape = b.shape
    if b.numel() == 0:
        return torch.empty(shape, dtype=RDTYPE, device=b.device)
    b2 = _rows(b)
    rows, n = b2.shape
    if isinstance(a, torch.Tensor):
        a2, a_scalar = _rows(a.to(RDTYPE).expand(shape)), 0.0
    else:
        a2, a_scalar = None, float(np.float32(a))
    x0t, x0_stride, x0_value = _state(x0, rows, b2)
    x = torch.empty((rows, n), dtype=RDTYPE, device=b.device)
    vec = _aligned(b2, x, *(() if a2 is None else (a2,)))
    lib = _build.library()
    _build.check(_launch_chained(b2, rows, n, 1, lambda *lb: (
        lib.cutesdr_scan_affine(
            None if a2 is None else a2.data_ptr(), a_scalar, b2.data_ptr(),
            float(b_scale), None if x0t is None else x0t.data_ptr(),
            x0_stride, x0_value, n, rows, vec, x.data_ptr(), *lb,
            _build.stream(b2)))), "scan_plain")
    LAUNCHES["scan_plain"] += 1
    return x.reshape(shape)


def first_order_scan(a, b: torch.Tensor, x0) -> torch.Tensor:
    """x[n] = a[n]*x[n-1] + b[n] along the last axis of ``b`` ([n] or
    [..., n] rows), x[-1] = x0: ``a`` a scalar or a tensor broadcasting to
    ``b``; ``x0`` a scalar or one value per row."""
    if _build.on_cpu(b, *(t for t in (a, x0) if isinstance(t, torch.Tensor))):
        return first_order_scan_plain(a, b, x0)
    return _affine(a, b, x0)


def ema(alpha, x: torch.Tensor, init) -> torch.Tensor:
    """Exponential moving average y[n] = (1-alpha)*y[n-1] + alpha*x[n]
    along the last axis (``ops/util.ema``): on the card one launch of the
    affine scan with the scalar 1 - alpha and B = alpha*x formed inside."""
    if _build.on_cpu(x, *(t for t in (init,) if isinstance(t, torch.Tensor))):
        return ema_plain(alpha, x, init)
    return _affine(1.0 - alpha, x, init, b_scale=float(np.float32(alpha)))


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


def _rows_of(peak: torch.Tensor, x0, name: str) -> tuple:
    """``peak`` ([n] or [C, n]) as contiguous float32 rows and ``x0`` (a
    number, one value or one per row) as [rows] on its device."""
    p2 = peak.reshape(-1, peak.shape[-1])
    rows, n = p2.shape
    _build.require(p2, name, RDTYPE, n, rows=rows)
    x0 = torch.as_tensor(x0, dtype=RDTYPE, device=peak.device).reshape(-1)
    if x0.numel() not in (1, rows):
        raise ValueError(f"{name}: {x0.numel()} initial states for {rows} "
                         "rows")
    return p2, x0.expand(rows).contiguous()


def _launch_rounds(t: torch.Tensor, rows: int, n: int, slots: int,
                   launch) -> None:
    """Launch a guess-verify solve over ``rows`` rows of ``n``: rows of
    one chunk take a block each, and more than one of them a zeroed
    two-word ``done`` (the look-back memory's ticket and first status
    word); rows of several chunks take ``slots`` look-back map slots
    (``launch(agg, done)``; unused pointers are null)."""
    if n > CHUNK:
        if not slots:
            return launch(None, None)
        return launch_ordered(t, slots, lambda flags, agg, ticket:
                              launch(agg, None))
    if rows == 1:
        return launch(None, None)
    return launch_ordered(t, 1, lambda flags, agg, ticket:
                          launch(None, ticket))


def _solve_launch(peak: torch.Tensor, pattern, x0, rise_alpha, fall_alpha,
                  n_iters: int, tally=None):
    """One launch of the solve over the rows of ``peak`` ([n] or [C, n]):
    (x, last pattern, int32 [rows * (n_iters + 1) + 1] = each row's
    per-round counts, then the rounds run; bool [rows + 1] = each row
    converged, then all rows), all on the device, x and the pattern in
    ``peak``'s shape.  ``tally``: an int32 [2] on the device, or None,
    to which the kernel adds the rounds run and 1."""
    p2, x0 = _rows_of(peak, x0, "peak")
    rows, n = p2.shape
    if pattern is not None:
        _build.require(pattern, "pattern", torch.bool, n)
    x = torch.empty_like(p2)
    newpat = torch.empty((rows, n), dtype=torch.bool, device=p2.device)
    ints = torch.empty(rows * (n_iters + 1) + 1, dtype=torch.int32,
                       device=p2.device)
    ok = torch.empty(rows + 1, dtype=torch.bool, device=p2.device)
    ta, tb = (torch.empty(rows * -(-n // CHUNK), dtype=RDTYPE,
                          device=p2.device) for _ in range(2))
    lib = _build.library()
    _build.check(_launch_rounds(p2, rows, n, 0, lambda agg, done: (
        lib.cutesdr_scan_solve(
            p2.data_ptr(), None if pattern is None else pattern.data_ptr(),
            np.float32(rise_alpha), np.float32(fall_alpha),
            warm_rate(rise_alpha, fall_alpha), x0.data_ptr(), n, rows,
            n_iters, x.data_ptr(), newpat.data_ptr(), ints.data_ptr(),
            ints.data_ptr() + 4 * rows * (n_iters + 1), ok.data_ptr(),
            ta.data_ptr(), tb.data_ptr(), done,
            None if tally is None else tally.data_ptr(),
            _build.stream(p2)))),
        "scan_solve")
    LAUNCHES["scan_solve"] += 1
    return x.reshape(peak.shape), newpat.reshape(peak.shape), ints, ok


def guess_verify_solve(peak: torch.Tensor, x0, rise_alpha, fall_alpha,
                       n_iters: int, tally=None):
    """(x, ok, rounds) of ``guess_verify_solve_plain`` for one stream ([n])
    or a bank's rows ([C, n], ``x0`` one value or one per row): the plain
    loop for CPU tensors, one launch of the kernel for CUDA ones, its ok
    (every row converged, a 0-dim bool) and round count (0-dim int32)
    left on the device.  ``tally``, where given, is an int32 [2] on
    ``peak``'s device that gains the rounds run and 1 (on the card the
    kernel adds them: no host read, and a graph counts every replay)."""
    if _build.on_cpu(peak, *(t for t in (x0,) if isinstance(t, torch.Tensor))):
        x, ok, rounds = guess_verify_solve_plain(peak, x0, rise_alpha,
                                                 fall_alpha, n_iters)
        if tally is not None:
            tally += torch.tensor([rounds, 1], dtype=tally.dtype)
        return x, ok, rounds
    x, _, ints, ok = _solve_launch(peak, None, x0, rise_alpha, fall_alpha,
                                   n_iters, tally)
    return x, ok[-1], ints[-1]


def guess_verify_solve_rows(peak: torch.Tensor, x0, rise_alpha, fall_alpha,
                            n_iters: int):
    """``guess_verify_solve`` with each row's flag: (x, row ok [rows] bool,
    ok, rounds), on the card only."""
    x, _, ints, ok = _solve_launch(peak, None, x0, rise_alpha, fall_alpha,
                                   n_iters)
    return x, ok[:-1], ok[-1], ints[-1]


def guess_round(peak: torch.Tensor, pattern: torch.Tensor, x0, rise_alpha,
                fall_alpha):
    """(x, new pattern, mismatch count) of one round; ``pattern`` is bool.
    On the card the solve's launch for one round.  The count is a device
    tensor: reading it is the caller's host sync."""
    if _build.on_cpu(peak, pattern):
        return guess_round_plain(peak, pattern, x0, rise_alpha, fall_alpha)
    x, newpat, ints, _ = _solve_launch(peak, pattern, x0, rise_alpha,
                                       fall_alpha, 1)
    return x, newpat, ints[1]


# ------------------------------------------------------------- hang mode --

def hang_solve_plain(peak: torch.Tensor, d0, timer0, rise_alpha, fall_alpha,
                     hang_time: int, n_iters: int):
    """Guess-verify solve of the hang-mode decay averager (JAX's
    ``ops/agc._hang_decay_parallel``): rise while pk > d, HOLD for
    hang_time samples, then release.  The pattern is the rising flags
    alone; the hold window is `distance since the last rise <
    hang_time`, and the timer is min(distance, hang_time).  A tie resets
    the timer even where the value cannot change, so the check is exact
    pattern equality (no forgiveness).  Each round's solve is the affine
    scan (``first_order_scan``); the rounds run from Python
    (``guess_verify``).  Returns (trajectory, timer, every row
    converged, as ``guess_verify``)."""
    dev = peak.device
    rise, fall, zero = (torch.tensor(v, dtype=RDTYPE, device=dev) for v in
                        (rise_alpha, fall_alpha, 0.0))

    def body(c):
        pattern = c[0]
        dist = util.distance_since_last_true(pattern, timer0)
        hold = ~pattern & (shift1(dist, timer0) < hang_time)
        alpha = torch.where(pattern, rise, torch.where(hold, zero, fall))
        d = first_order_scan(1.0 - alpha, alpha * peak, d0)
        new = peak > shift1(d, d0)
        return (new, d, dist), (new == pattern).all(-1)

    pattern0 = peak > shift1(peak, d0)
    (_, d, dist), ok, _ = guess_verify(body, (pattern0, None, None), n_iters)
    timer = torch.clamp(dist[..., -1], max=hang_time).to(torch.int32)
    return d, timer, ok


def _hang_launch(peak: torch.Tensor, d0, timer0, rise_alpha, fall_alpha,
                 hang_time: int, n_iters: int):
    """One launch of N3h over the rows of ``peak``: (d, timer, int32
    counts and rounds, bool flags) as ``_solve_launch``."""
    p2, d0 = _rows_of(peak, d0, "peak")
    rows, n = p2.shape
    timer0 = torch.as_tensor(timer0, dtype=torch.int32,
                             device=p2.device).reshape(-1)
    if timer0.numel() not in (1, rows):
        raise ValueError(f"timer0: {timer0.numel()} values for {rows} rows")
    timer0 = timer0.expand(rows).contiguous()
    d = torch.empty_like(p2)
    timer = torch.empty(rows, dtype=torch.int32, device=p2.device)
    pattern = torch.empty((rows, n), dtype=torch.bool, device=p2.device)
    ints = torch.empty(rows * (n_iters + 1) + 1, dtype=torch.int32,
                       device=p2.device)
    ok = torch.empty(rows + 1, dtype=torch.bool, device=p2.device)
    items = rows * -(-n // CHUNK)
    last, carry = (torch.empty(items, dtype=torch.int32, device=p2.device)
                   for _ in range(2))
    lib = _build.library()
    _build.check(_launch_rounds(p2, rows, n, items, lambda agg, done: (
        lib.cutesdr_hang_solve(
            p2.data_ptr(), d0.data_ptr(), timer0.data_ptr(),
            float(np.float32(rise_alpha)), float(np.float32(fall_alpha)),
            int(hang_time), n, rows, n_iters, d.data_ptr(), timer.data_ptr(),
            pattern.data_ptr(), ints.data_ptr(),
            ints.data_ptr() + 4 * rows * (n_iters + 1), ok.data_ptr(),
            last.data_ptr(), carry.data_ptr(), agg, done,
            _build.stream(p2)))), "hang_solve")
    LAUNCHES["hang_solve"] += 1
    lead = peak.shape[:-1]
    return d.reshape(peak.shape), timer.reshape(lead), ints, ok


def hang_solve(peak: torch.Tensor, d0, timer0, rise_alpha, fall_alpha,
               hang_time: int, n_iters: int):
    """(d, timer, ok) of ``hang_solve_plain`` for one stream ([n]) or a
    bank's rows ([C, n]; ``d0``, ``timer0`` one value or one per row): the
    plain rounds for CPU tensors, one launch of N3h for CUDA ones (every
    round on the device, no host read), ok (every row converged) a 0-dim
    device bool."""
    if _build.on_cpu(peak, *(t for t in (d0, timer0)
                             if isinstance(t, torch.Tensor))):
        return hang_solve_plain(peak, d0, timer0, rise_alpha, fall_alpha,
                                hang_time, n_iters)
    d, timer, _, ok = _hang_launch(peak, d0, timer0, rise_alpha, fall_alpha,
                                   hang_time, n_iters)
    return d, timer, ok[-1]


def hang_solve_rows(peak: torch.Tensor, d0, timer0, rise_alpha, fall_alpha,
                    hang_time: int, n_iters: int):
    """``hang_solve`` with each row's flag and the rounds run: (d, timer,
    row ok [rows] bool, ok, rounds), on the card only."""
    d, timer, ints, ok = _hang_launch(peak, d0, timer0, rise_alpha,
                                      fall_alpha, hang_time, n_iters)
    return d, timer, ok[:-1], ok[-1], ints[-1]


# ---------------------------------------------------------------- smeter --

def smeter_last_plain(mag: torch.Tensor, attack_alpha, decay_alpha, a0, d0):
    a_series = util.ema(attack_alpha, mag, a0)
    d_series = util.max_affine_recurrence(np.float32(1.0) - decay_alpha,
                                          mag * decay_alpha, a_series, d0)
    return a_series[..., -1], d_series[..., -1]


def smeter_last(mag: torch.Tensor, attack_alpha, decay_alpha, a0, d0):
    """(a_last, d_last) of the S-meter averager pair along the last axis
    of ``mag`` ([n] or [..., n] rows, any n >= 1):
        a[n] = (1-aa)*a[n-1] + aa*m[n]
        d[n] = max((1-ad)*d[n-1] + ad*m[n], a[n])
    ``a0``, ``d0``: one value or one per row.  On the card one launch."""
    if _build.on_cpu(mag, *(t for t in (a0, d0)
                            if isinstance(t, torch.Tensor))):
        return smeter_last_plain(mag, attack_alpha, decay_alpha, a0, d0)
    m2 = _rows(mag)
    rows, n = m2.shape
    states = [torch.as_tensor(v, dtype=RDTYPE, device=mag.device)
              .reshape(-1).contiguous() for v in (a0, d0)]
    stride = states[0].numel() == rows and rows > 1
    for v in states:
        if v.numel() != (rows if stride else 1):
            raise ValueError(f"smeter_last: initial states of {v.numel()} "
                             f"values for {rows} rows")
    aa, ad = np.float32(attack_alpha), np.float32(decay_alpha)
    # 1 - alpha as the plain version rounds it (ops/util.ema, the decay's
    # float32 subtraction), on the host: no tensor, so no scalar read
    ca = float(np.float32(1.0 - attack_alpha))
    cd = float(np.float32(1.0) - ad)
    out = torch.empty(2, rows, dtype=RDTYPE, device=mag.device)
    lib = _build.library()
    _build.check(_launch_chained(m2, rows, n, 2, lambda *lb: (
        lib.cutesdr_smeter(
            m2.data_ptr(), float(aa), ca, float(ad), cd, states[0].data_ptr(),
            states[1].data_ptr(), int(stride), n, rows, _aligned(m2),
            out.data_ptr(), *lb, _build.stream(m2)))), "smeter")
    LAUNCHES["smeter"] += 1
    lead = mag.shape[:-1]
    return out[0].reshape(lead), out[1].reshape(lead)
