"""Runtime metrics and observability.

Reference analogue: the status-bar / qDebug monitors scattered through the
reference — UDP missed-packet counter (interface/netiobase.cpp:488-496),
sound queue depth + ppm rate error + over/underflow messages
(interface/soundout.cpp), keepalive watchdog, A/D overload flag, S-meter.
Here: one structured metrics registry updated per superblock, queryable as
a dict and renderable as a status line (``StreamMetrics``, the port's own
copy of ``cutesdr_tpu/metrics.py``).

Beside it, the process's spans and counters: where the host's time goes
inside an entry call (``Receiver``/``ChannelBank.process_planes``), a
session's pump and set-up, and one piece of an entry call timed on the
card (the input copies).

* A span (``span(name)``, a context manager) keeps a count, a total and
  a maximum, the count and total of its records made while the profiler
  was not running (the means read them: the profiler's cost on the host
  left out), and a ring of the newest ``RING`` records: (block number,
  start, duration), in ``time.perf_counter_ns()`` nanoseconds.  Spans of
  one block share its number: the entry numbers its block
  (``next_block``), unless a session's pump numbered it first.
  Parentage is by name and nesting: ``entry`` is the parent of
  ``entry.input``; a session's ``pump.step`` encloses the ``entry`` of
  its block.  Nothing is written to disk.
* Tracing is off by default.  It turns on with ``tracing(True)``, or at
  the first entry call or pump that finds ``torch.profiler`` running, and
  then stays on.  Off, an entry call tests two module-level flags (this
  module's ``tracing_on`` and the profiler's) and does nothing else of
  tracing's.  On, a span stamps ``perf_counter_ns`` twice and writes one
  ring slot, and while the profiler runs it also opens a
  ``record_function`` of its name, so that the program's spans sit on the
  profiler's clock beside the device's events.
* Set-up spans (``setup.kernels``, ``setup.warmup``, ``setup.capture``)
  are recorded whether tracing is on or not: a few stamps a process.
* A device span (``device_marks``) times a piece of a call on the card
  with a pair of CUDA events from a pool made at its first use; finished
  pairs are folded into its span's device count and total by ``query``
  at the next call or when a reader reads, so the program never waits
  for the card to time it.
* ``COUNTERS``: named numbers a process counts once (``setup.
  kernels_built``: 1 where this process compiled the kernel library).
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
from torch.autograd import profiler as _profiler

RING = 4096           # records a span keeps, the newest
EVENT_PAIRS = 16      # timing event pairs a device span's pool holds


class Span:
    """A named span's count, total and longest duration (ns), the count
    and total of its records made with no profiler running (``quiet``),
    its newest ``RING`` records (block number, start ns, duration ns)
    and, for a span also timed on the card, its device count and total
    (ms)."""

    __slots__ = ("name", "count", "total_ns", "max_ns", "quiet_count",
                 "quiet_ns", "ring", "device_count", "device_ms")

    def __init__(self, name: str):
        self.name = name
        self.count = self.total_ns = self.max_ns = 0
        self.quiet_count = self.quiet_ns = 0
        self.ring: list = [None] * RING
        self.device_count = 0
        self.device_ms = 0.0

    def add(self, seq: int, start: int, dur: int, quiet: bool = True) -> None:
        self.ring[self.count % RING] = (seq, start, dur)
        self.count += 1
        self.total_ns += dur
        if dur > self.max_ns:
            self.max_ns = dur
        if quiet:
            self.quiet_count += 1
            self.quiet_ns += dur

    def add_device(self, ms: float) -> None:
        self.device_count += 1
        self.device_ms += ms

    def records(self) -> list:
        """The ring's records, oldest first."""
        if self.count <= RING:
            return self.ring[:self.count]
        k = self.count % RING
        return self.ring[k:] + self.ring[:k]


SPANS: dict[str, Span] = {}
COUNTERS: dict[str, int] = {}
tracing_on = False      # read by the entry call; set by ``tracing``
_seq = 0                # the current block's number
_held = False           # a pump numbered the block its entry will run
_pools: dict = {}       # (span name, device) -> _EventPool


def tracing(on: bool) -> None:
    """Turn tracing of entry calls and pumps on or off (set-up spans are
    recorded either way)."""
    global tracing_on
    tracing_on = bool(on)


def wanted() -> bool:
    """Whether a call traces: tracing on, or torch's profiler running,
    which turns it on for the rest of the process."""
    global tracing_on
    if not tracing_on and _profiler._is_profiler_enabled:
        tracing_on = True
    return tracing_on


def reset() -> None:
    """Forget every span, counter, block number and pending device mark
    (tracing stays as it is)."""
    global _seq, _held
    SPANS.clear()
    COUNTERS.clear()
    _pools.clear()
    _seq, _held = 0, False


def next_block(hold: bool = False) -> int:
    """The number of the block about to run: a new one, unless a pump
    numbered it and its entry has not yet run.  A pump passes ``hold``,
    so that the entry of its block takes the same number."""
    global _seq, _held
    if not _held:
        _seq += 1
    _held = hold
    return _seq


def _span(name: str) -> Span:
    s = SPANS.get(name)
    if s is None:
        s = SPANS[name] = Span(name)
    return s


class _Timed:
    """One span's record: opened by ``with``, added on exit."""

    __slots__ = ("span", "block", "seq", "start", "annotation")

    def __init__(self, span: Span, block: bool):
        self.span = span
        self.block = block

    def __enter__(self):
        self.seq = next_block() if self.block else _seq
        self.annotation = None
        if _profiler._is_profiler_enabled:
            self.annotation = _profiler.record_function(self.span.name)
            self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.span.add(self.seq, self.start,
                      time.perf_counter_ns() - self.start,
                      self.annotation is None)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()      # the span of a call that does not trace


def span(name: str, on: bool = True, block: bool = False):
    """A context manager that records one span of ``name`` (module notes);
    with ``block``, the span numbers a new block first (``next_block``).
    With ``on`` False it records nothing."""
    return _Timed(_span(name), block) if on else _OFF


def count(name: str) -> None:
    COUNTERS[name] = COUNTERS.get(name, 0) + 1


class _EventPool:
    """Timing event pairs on one device for one span (module notes): a
    pair is taken from ``free``, recorded around the piece on the device's
    current stream, and folded back once its end has run; with none free
    the piece goes untimed.  The current stream's object is kept while the
    stream stays the same (making one costs more than a record)."""

    def __init__(self, span: Span, device: torch.device):
        self.span = span
        self.index = device.index
        self.free = deque((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
                          for _ in range(EVENT_PAIRS))
        self.pending: deque = deque()
        self._stream = (None, None)       # (current stream's key, Stream)

    def _current(self):
        key = torch._C._cuda_getCurrentStream(self.index)
        if key != self._stream[0]:
            self._stream = (key, torch.cuda.Stream(
                stream_id=key[0], device_index=key[1], device_type=key[2]))
        return self._stream[1]

    def start(self):
        """A pair with its start recorded (None: none free)."""
        self.fold()
        if not self.free:
            return None
        pair = self.free.popleft()
        pair[0].record(self._current())
        return pair

    def stop(self, pair) -> None:
        if pair is not None:
            pair[1].record(self._stream[1])
            self.pending.append(pair)

    def fold(self) -> None:
        while self.pending and self.pending[0][1].query():
            pair = self.pending.popleft()
            self.span.add_device(pair[0].elapsed_time(pair[1]))
            self.free.append(pair)


def device_marks(name: str, device: torch.device) -> _EventPool:
    """The event pool that times span ``name``'s piece on ``device`` (a
    CUDA device with its index; made at first use)."""
    key = (name, device)
    pool = _pools.get(key)
    if pool is None:
        pool = _pools[key] = _EventPool(_span(name), device)
    return pool


# ------------------------------------------------------------- readers ---

def mean_ms(name: str) -> float | None:
    """Mean duration (ms) of ``name``'s quiet records (None: none)."""
    s = SPANS.get(name)
    if s is None or not s.quiet_count:
        return None
    return 1e-6 * s.quiet_ns / s.quiet_count


def self_ms(name: str) -> float | None:
    """Mean self time (ms) of ``name``'s quiet records: their duration
    less its direct children's (``name.x``, run inside them)."""
    s = SPANS.get(name)
    if s is None or not s.quiet_count:
        return None
    inner = sum(c.quiet_ns for c in SPANS.values()
                if c.name.startswith(name + ".")
                and "." not in c.name[len(name) + 1:])
    return 1e-6 * (s.quiet_ns - inner) / s.quiet_count


def total_s(name: str) -> float | None:
    """Total seconds of every record of ``name`` (None: none)."""
    s = SPANS.get(name)
    return 1e-9 * s.total_ns if s is not None and s.count else None


def device_mean_ms(name: str) -> float | None:
    """Mean device ms of ``name``'s timed pieces, after folding every pair
    that has finished (None: none timed)."""
    for pool in list(_pools.values()):
        pool.fold()
    s = SPANS.get(name)
    if s is None or not s.device_count:
        return None
    return s.device_ms / s.device_count


def span_means() -> dict[str, float]:
    """Each span's mean ms (``mean_ms``), by name."""
    return {name: mean_ms(name) for name in sorted(SPANS)
            if SPANS[name].quiet_count}


@dataclass
class StreamMetrics:
    started_at: float = field(default_factory=time.monotonic)
    samples_in: int = 0
    blocks: int = 0
    audio_samples_out: int = 0
    missed_packets: int = 0
    audio_overflows: int = 0
    audio_underflows: int = 0
    ppm_error: int = 0
    smeter_ave_db: float = -120.0
    smeter_peak_db: float = -120.0
    squelch_open: bool = True
    # PLL solver-tier counters (probes-enabled SAM/FM sessions only):
    # blocks solved by tier 0 = parallel linear, 1 = chunked guess-verify,
    # 2 = sequential scan — a persistent all-tier-2 stream flags a silent
    # fallback regression (ADVICE r4)
    pll_tier_blocks: list = field(default_factory=lambda: [0, 0, 0])
    # the A/D-overload flag's source (a session's display analyzer, whose
    # flag stays on the device): read when the metrics are reported, not
    # on every block
    overload_flag: Optional[Callable[[], bool]] = field(default=None,
                                                        repr=False)

    @property
    def overload(self) -> bool:
        return bool(self.overload_flag()) if self.overload_flag else False

    @property
    def elapsed(self) -> float:
        return time.monotonic() - self.started_at

    @property
    def throughput_msps(self) -> float:
        e = self.elapsed
        return self.samples_in / e / 1e6 if e > 0 else 0.0

    def as_dict(self) -> dict:
        """The counts, and while tracing is on each span's mean ms
        (``spans_ms``)."""
        d = {
            "elapsed_s": round(self.elapsed, 2),
            "samples_in": self.samples_in,
            "blocks": self.blocks,
            "throughput_msps": round(self.throughput_msps, 3),
            "audio_samples_out": self.audio_samples_out,
            "missed_packets": self.missed_packets,
            "audio_overflows": self.audio_overflows,
            "audio_underflows": self.audio_underflows,
            "ppm_error": self.ppm_error,
            "smeter_ave_db": round(self.smeter_ave_db, 1),
            "smeter_peak_db": round(self.smeter_peak_db, 1),
            "overload": self.overload,
            "squelch_open": self.squelch_open,
        }
        if tracing_on:
            d["spans_ms"] = span_means()
        return d

    def status_line(self) -> str:
        """The status-bar string (connection metrics + S-meter + rate),
        and while tracing is on the pump's and its step's mean ms."""
        line = (f"{self.throughput_msps:6.2f} Msps | "
                f"S {self.smeter_ave_db:6.1f} dB | "
                f"gap {self.missed_packets} | ppm {self.ppm_error:+d} | "
                f"{'OVR ' if self.overload else ''}"
                f"{'SQ' if not self.squelch_open else ''}")
        pump = mean_ms("pump") if tracing_on else None
        if pump is not None:
            step = mean_ms("pump.step")
            line += f" | pump {pump:.3f} ms" + (
                "" if step is None else f", step {step:.3f}")
        return line
