"""Receiver session (port of ``cutesdr_tpu/session.py``): wires a sample
source (radio / file / generator) to the receiver on the card, the
spectrum display path, the rate-locked audio queue and the metrics.

Reference analogue: MainWindow's orchestration (gui/mainwindow.cpp):
create the interface, wire signals, run/stop, live parameter plumbing,
minus the Qt widgets.

On the card the host and the device overlap as in the JAX package:

* ``pump_planes`` hands each block's planes to an ingest thread, which
  stages them in pinned memory and copies them on its own CUDA stream
  (``non_blocking``, recorded by an event); the compute stream waits on
  that event before the step, so block k+1 uploads while block k runs.
* Each step's outputs are copied back ``non_blocking`` into pinned
  buffers behind an event, and delivered (audio queue, meters) one block
  later (``pipeline_depth=2``), waiting on that event alone.
* The kernel library is built when the session is made, not inside the
  first audio block.
* The probe scope (``set_probe``, ``probe_frame``) switches to the
  receiver with ``probes`` on, as a mode switch does.  Its spectrum view
  averages the selected tap on the card; its scope view copies the tap's
  real part to pinned memory with the step's other outputs.  Neither
  reads the device inside ``pump``.

``DiversitySession`` runs the dual-RX combiner (``shard/coherent``) in
front of one receiver chain, with the same staged delivery.  Its
re-blocking buffer is one block of pinned memory: each piece is copied
into the block it completes, and the receiver copies a full block from
there into its graph's static input ``non_blocking``.
"""

from __future__ import annotations

import queue
import threading
from collections import OrderedDict
from dataclasses import astuple, dataclass, field, replace
from typing import Callable, Optional

import numpy as np
import torch

from cutesdr_tpu_torch import metrics as spans
from cutesdr_tpu_torch.io.audio_sink import RateLockedQueue
from cutesdr_tpu_torch.kernels import _build
from cutesdr_tpu_torch.metrics import StreamMetrics
from cutesdr_tpu_torch.pipeline.receiver import (MODE_LIMITS, Receiver,
                                                 ReceiverConfig, StepOutput,
                                                 migrate_state)
from cutesdr_tpu_torch.pipeline.spectrum import (SpectrumAnalyzer,
                                                 SpectrumConfig)
from cutesdr_tpu_torch.settings import SessionSettings
from cutesdr_tpu_torch.shard.coherent import DiversityReceiver
from cutesdr_tpu_torch.testbench.probes import (ProbeSpectrum,
                                                TriggeredCapture,
                                                TriggerMode)
from cutesdr_tpu_torch.types import CDTYPE, resolve_device


class _Staged:
    """One step's outputs on their way to the host: audio (stereo as
    [..., cap, 2] left/right), the scalars (n_audio, S-meter average and
    peak; a row each, [3] or [3, C] for a bank) and, for the probe
    scope's view, one tap (a real tensor) copied ``non_blocking`` into
    pinned memory behind one event on the card; the tensors themselves
    on the CPU.  The device tensors are held until the copies have
    landed.  ``tier`` is the step's PLL tier where its probes report one
    (a 0-dim device tensor), copied with the scalars (a fourth row): read
    once landed, with no read of its own."""

    def __init__(self, out: StepOutput, tap: Optional[torch.Tensor] = None,
                 tier: Optional[torch.Tensor] = None):
        audio = out.audio
        if audio.is_complex():
            audio = torch.view_as_real(audio)
        scalars = torch.stack([out.n_audio.double(),
                               out.smeter_ave_db.double(),
                               out.smeter_peak_db.double()]
                              + ([] if tier is None
                                 else [tier.double().expand(
                                     out.n_audio.shape)]))
        tensors = [audio, scalars] + ([tap] if tap is not None else [])
        self.event = None
        self._held = None
        if audio.device.type == "cuda":
            self._held = tensors
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in tensors]
            for h, t in zip(host, tensors):
                h.copy_(t, non_blocking=True)
            tensors = host
            self.event = torch.cuda.Event()
            self.event.record()
        self.audio, self.scalars = tensors[:2]
        self.tap = tensors[2] if tap is not None else None
        self.has_tier = tier is not None

    def arrays(self) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """(audio, scalars, tap or None) as numpy once the copies have
        landed."""
        if self.event is not None:
            self.event.synchronize()
        self._held = None
        tap = None if self.tap is None else self.tap.numpy()
        return self.audio.numpy(), self.scalars.numpy(), tap

    def result(self) -> tuple[np.ndarray, int, float, float]:
        """(valid audio, n_audio, S-meter average, peak) of a single
        stream."""
        audio, scalars, _ = self.arrays()
        n, ave, peak = scalars.tolist()[:3]
        return audio[:int(n)], int(n), ave, peak

    def tier(self) -> Optional[int]:
        """The PLL tier, once landed (None where the probes report
        none)."""
        return int(self.arrays()[1][3]) if self.has_tier else None


class _StagedSession:
    """What ReceiverSession, DiversitySession and BankSession share over
    their ``cfg``, ``settings``, ``device`` and ``pipeline_depth``: the
    lock, queue and metrics, a step's entry (its copies to the host
    started, the probe tap handed to the scope), its delivery
    pipeline_depth-1 steps later, ``start``/``stop``/``flush`` and the
    click rounding.  BankSession, whose steps carry a row per channel,
    overrides ``_probe_leaf`` and ``_finish``.

    While tracing is on (``metrics``) a pump is a ``pump`` span over
    ``pump.reblock`` (its input cut into blocks: once a pump, or a pull
    of the diversity session's staging) and, a block each,
    ``pump.display``, ``pump.step`` (the entry call, whose ``entry``
    spans nest in it) and ``pump.audio`` (``_enter``); the spans of one
    block share its number."""

    def _setup(self) -> None:
        """The state every session starts with, on its device (the kernel
        library is built now, not in the first block)."""
        self.device = resolve_device(self.device)
        if self.device.type == "cuda":
            _build.library()
        # serializes the pump loop against switches from other threads
        # (the reference's reconfigure-vs-process mutexes,
        # dsp/demodulator.cpp:109/166), one lock at session level
        self._lock = threading.RLock()
        self.audio_queue = RateLockedQueue(stereo=self.cfg.stereo)
        self.metrics = self._new_metrics()
        self._inflight: list[_Staged] = []  # dispatched, not yet delivered
        # the probe scope's instrument (set_probe)
        self._probe_tap: Optional[str] = None
        self._probe_view = "spectrum"
        self._probe_inst = None
        self.running = False

    def _analyzer(self, spectrum_cfg: Optional[SpectrumConfig] = None
                  ) -> SpectrumAnalyzer:
        """The display path over the raw stream, sized from the settings
        unless ``spectrum_cfg`` is given."""
        if spectrum_cfg is None:
            spectrum_cfg = SpectrumConfig(
                fft_size=self.settings.display.fft_size,
                ave_size=self.settings.display.fft_ave,
                sample_rate=self.cfg.input_rate)
        return SpectrumAnalyzer(
            spectrum_cfg,
            max_display_rate=self.settings.display.max_display_rate,
            device=self.device)

    def _new_metrics(self) -> StreamMetrics:
        """Fresh metrics whose overload flag is the display analyzer's,
        read when the metrics are reported."""
        return StreamMetrics(overload_flag=lambda: self.analyzer.overload)

    def start(self) -> None:
        self.running = True
        self.metrics = self._new_metrics()

    def stop(self) -> None:
        """Deliver everything in flight and stop."""
        self.flush()
        self.running = False

    def flush(self) -> int:
        """Deliver the steps in flight (call before reading the final
        state); returns how many."""
        with self._lock:
            n = len(self._inflight)
            for staged in self._inflight:
                self._finish(staged)
            self._inflight.clear()
            return n

    @staticmethod
    def _pump_span():
        """(whether this pump traces, its ``pump`` span), the pump's
        first block numbered where it does."""
        on = spans.wanted()
        if on:
            spans.next_block(hold=True)
        return on, spans.span("pump", on)

    def _show(self, chunk: np.ndarray) -> None:
        """A block of the raw (pre-mix) stream into the display path."""
        if self.analyzer.feed(chunk) and self.on_spectrum:
            self.on_spectrum(self.analyzer.spectrum_db())

    def _block(self, on: bool, chunk, show, entry) -> None:
        """One block of a pump: shown (``show(chunk)``), then ``_step``."""
        if on:
            spans.next_block(hold=True)
        with spans.span("pump.display", on):
            show(chunk)
        self._step(on, entry, chunk)

    def _step(self, on: bool, entry, x) -> None:
        """A block stepped (``entry(x)``) and entered, each a span where
        ``on``."""
        if on:
            spans.next_block(hold=True)
        with spans.span("pump.step", on):
            out = entry(x)
        with spans.span("pump.audio", on):
            self._enter(out)

    def _probe_leaf(self, probes: dict) -> Optional[torch.Tensor]:
        """The selected tap of a step's probes, as the scope takes it."""
        return probes.get(self._probe_tap)

    def _enter(self, out: StepOutput) -> None:
        """Count a dispatched step, start its copies to the host (with the
        scope view's tap) or feed the spectrum view's tap on the device,
        and deliver the steps at least pipeline_depth-1 behind it."""
        self.metrics.samples_in += self.cfg.block_size
        self.metrics.blocks += 1
        probes = out.probes or {}
        leaf = (self._probe_leaf(probes) if self._probe_inst is not None
                else None)
        tap = None
        if leaf is not None:
            if self._probe_view == "scope":
                tap = scope_plane(leaf)
            else:
                self._probe_inst.feed(leaf)
        self._inflight.append(_Staged(out, tap, probes.get("pll_tier")))
        while len(self._inflight) >= max(1, self.pipeline_depth):
            self._finish(self._inflight.pop(0))

    def _finish(self, staged: _Staged) -> None:
        """Deliver one dispatched step (samples_in and blocks were counted
        at dispatch; here the audio, the meters, the queue's counts, the
        PLL tier and the scope view's tap)."""
        audio, n_aud, ave, peak = staged.result()
        self._feed_scope(staged.tap)
        tier = staged.tier()
        if tier is not None and 0 <= tier <= 2:
            self.metrics.pll_tier_blocks[tier] += 1
        self._deliver(audio, n_aud, ave, peak)

    def _feed_scope(self, tap) -> None:
        """The scope view's tap, landed on the host, into the instrument."""
        if tap is not None and self._probe_inst is not None:
            self._probe_inst.feed(np.asarray(tap))

    def _deliver(self, audio: np.ndarray, n_aud: int, ave: float,
                 peak: float) -> None:
        """One step's valid audio into the queue, its meters and the
        queue's counts into the metrics."""
        self.audio_queue.put_block(
            np.clip(audio, -32767, 32767).astype(np.int16))
        self.metrics.audio_samples_out += n_aud
        self.metrics.smeter_ave_db = ave
        self.metrics.smeter_peak_db = peak
        self.metrics.audio_overflows = self.audio_queue.overflows
        self.metrics.audio_underflows = self.audio_queue.underflows

    def tune_clicked(self, freq_hz: float) -> float:
        """Click-to-tune rounded to the mode's click resolution
        (gui/plotter.cpp roundFreq with m_ClickResolution)."""
        res = max(1, int(self.settings.demod[self.cfg.mode]
                         .filter_click_resolution))
        rounded = round(freq_hz / res) * res
        self.tune(rounded)
        return rounded


class _LiveSession(_StagedSession):
    """What ReceiverSession and DiversitySession share over their one
    ``receiver``: the rate-lock loop and the live controls."""

    def _setup(self) -> None:
        super()._setup()
        self._nominal_ratio = (self.cfg.output_rate /
                               (self.cfg.audio_rate or self.cfg.output_rate))
        self._last_correction = 0.0
        self.current_tune = self.cfg.tune_freq
        self.current_low, self.current_hi = self.cfg.low_cut, self.cfg.hi_cut

    def _rate_lock(self) -> None:
        """Close the rate-lock loop when the consumer's correction moved."""
        corr = self.audio_queue.rate_correction
        if corr != self._last_correction and self.cfg.audio_rate:
            self._last_correction = corr
            self.metrics.ppm_error = self.audio_queue.ppm_error
            self.receiver.set_resample_ratio(
                self._nominal_ratio * (1.0 + corr))

    def tune(self, freq_hz: float) -> None:
        self.receiver.set_tune_freq(freq_hz)
        self.current_tune = freq_hz

    def set_filter(self, low_cut: float, hi_cut: float) -> tuple[float, float]:
        """Set the channel-filter edges, clamped to the mode's limit table
        and mirrored for symmetric modes (gui/mainwindow.cpp:1000-1054).
        Returns the edges applied."""
        hi_min, hi_max, low_min, low_max, sym = MODE_LIMITS[self.cfg.mode]
        lo = float(min(max(low_cut, low_min), low_max))
        hi = float(min(max(hi_cut, hi_min), hi_max))
        if sym:
            m = max(hi, -lo)
            lo, hi = -m, m
        self.receiver.set_filter(lo, hi)
        self.current_low, self.current_hi = lo, hi
        return lo, hi

    def set_volume(self, vol: int) -> None:
        self.settings.volume = vol
        self.receiver.set_volume(vol)


# --- the probe scope (gui/testbench.cpp:583-898), shared with BankSession --
PROBE_TAPS = ("p1_downconvert", "p2_fastfir", "p3_agc", "p4_demod",
              "p5_resampled", "p6_pll", "p7_blanker")
_SHORT_TAPS = {k[:2]: k for k in PROBE_TAPS}
_TRIGGER_MODES = {"free": TriggerMode.FREE_RUN, "pos": TriggerMode.NORM_POS,
                  "neg": TriggerMode.NORM_NEG,
                  "single+": TriggerMode.SINGLE_POS,
                  "single-": TriggerMode.SINGLE_NEG}


def probe_tap_name(tap: Optional[str]) -> Optional[str]:
    """The full tap name of ``tap`` (short names p1..p7 allowed); None for
    off (None, "", "off")."""
    if tap in (None, "", "off"):
        return None
    return _SHORT_TAPS.get(tap, tap)


def check_probe_tap(cfg: ReceiverConfig, tap: str,
                    taps=PROBE_TAPS) -> None:
    """Raise ValueError where ``cfg`` has no tap ``tap``."""
    if tap not in taps:
        raise ValueError(f"unknown probe tap {tap!r}")
    if tap == "p7_blanker" and not cfg.nb_on:
        raise ValueError("p7 requires the noise blanker (nb_on)")
    if tap == "p5_resampled" and cfg.audio_rate is None:
        raise ValueError("p5 requires the 48 kHz resampler (audio_rate)")
    if tap == "p6_pll" and (cfg.mode not in ("sam", "fm") or cfg.stereo):
        raise ValueError("p6 requires a mono PLL mode (sam/fm)")


def tap_rate(cfg: ReceiverConfig, tap: str) -> float:
    """The sample rate of a tap."""
    if tap == "p7_blanker":
        return cfg.input_rate
    if tap == "p5_resampled":
        return cfg.audio_rate or cfg.output_rate
    return cfg.output_rate


def probe_instrument(rate: float, view: str, trigger_mode: str,
                     trigger_level: float, length: int, device):
    """The scope view's TriggeredCapture or the spectrum view's
    ProbeSpectrum (on ``device``)."""
    if view != "scope":
        return ProbeSpectrum(rate, device=device)
    if trigger_mode not in _TRIGGER_MODES:
        raise ValueError(f"unknown trigger mode {trigger_mode!r}")
    return TriggeredCapture(
        length=length, pre_samples=length // 4, level=trigger_level,
        hysteresis=max(1.0, abs(trigger_level) * 0.05),
        mode=_TRIGGER_MODES[trigger_mode])


def scope_plane(leaf: torch.Tensor) -> torch.Tensor:
    """The plane of a tap the scope view captures: its real part."""
    return leaf.real if leaf.is_complex() else leaf


def probe_frame_of(inst, tap: str, view: str, rate: float,
                   **extra) -> dict:
    """A probe display frame for the server."""
    base = {"tap": tap, "view": view, **extra, "sample_rate": rate}
    if view == "scope":
        rec = inst.record
        if rec is None:
            return {**base, "record": None}
        return {**base, "record": [round(float(v), 2) for v in rec]}
    return {**base, "db": [round(float(v), 1) for v in inst.spectrum_db()]}


class _IngestWorker:
    """Double-buffered host -> device uploader: a thread stages each
    block's planes in pinned memory and copies them on its own CUDA
    stream, so the host uploads block k+1 while the card computes block k
    (the reference's FIFO-decoupled UDP -> DSP handoff,
    interface/netiobase.cpp:571-600).  A copy from pageable memory would
    be synchronous; the pinned staging is what lets it overlap.  The
    bounded input queue is the backpressure.  On the CPU the planes pass
    through as tensors."""

    def __init__(self, device: torch.device, depth: int = 2):
        self.device = device
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)
        self._in: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._out: queue.Queue = queue.Queue()
        self.pending = 0               # submitted, not yet polled out
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="cutesdr-ingest")
        self._t.start()

    def _upload(self, re: np.ndarray, im: np.ndarray):
        planes = [torch.from_numpy(np.ascontiguousarray(p)) for p in (re, im)]
        if self._stream is None:
            return planes[0], planes[1], None
        with torch.cuda.stream(self._stream):
            dev = [p.pin_memory().to(self.device, non_blocking=True)
                   for p in planes]
            event = torch.cuda.Event()
            event.record(self._stream)
        return dev[0], dev[1], event

    def _run(self):
        while True:
            item = self._in.get()
            if item is None:
                return
            try:
                self._out.put(self._upload(*item))
            except Exception as e:      # surfaced by poll()
                self._out.put(e)

    def submit(self, re, im) -> None:
        self.pending += 1
        self._in.put((re, im))

    def poll(self, block: bool = False):
        """The next uploaded (re, im) pair on the compute stream's side of
        its copy event, or None if none is ready."""
        if self.pending == 0:
            return None
        try:
            item = self._out.get(block=block)
        except queue.Empty:
            return None
        self.pending -= 1
        if isinstance(item, Exception):
            raise item
        re, im, event = item
        if event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(event)
            # the planes were allocated on the ingest stream: keep their
            # memory from reuse until the compute stream is done with them
            re.record_stream(compute)
            im.record_stream(compute)
        return re, im

    def close(self) -> None:
        self._in.put(None)
        self._t.join(timeout=10.0)


class _Reblocker:
    """Re-blocks [rows, n] complex pieces (any n) into [rows, block]
    blocks in one staging buffer, pinned on the card: each piece is
    copied into the block it completes, and a full block is handed on as
    the buffer itself, which its consumer copies to the card
    ``non_blocking``.  The buffer is refilled once the consumer's work
    queued on the current stream has run (an event)."""

    def __init__(self, rows: int, block: int, device: torch.device):
        cuda = device.type == "cuda"
        self.buf = torch.empty((rows, block), dtype=CDTYPE, pin_memory=cuda)
        self._done = torch.cuda.Event() if cuda else None
        self.fill = 0                   # samples pending in the buffer

    def push(self, piece: np.ndarray):
        """Each full block that ``piece`` completes (the staging buffer,
        valid until the next block is pushed)."""
        host = self.buf.numpy()
        block = host.shape[1]
        pos, n = 0, piece.shape[1]
        while pos < n:
            if self._done is not None:
                self._done.synchronize()    # at once if never recorded
            take = min(block - self.fill, n - pos)
            host[:, self.fill:self.fill + take] = piece[:, pos:pos + take]
            self.fill += take
            pos += take
            if self.fill < block:
                return
            self.fill = 0
            yield self.buf
            if self._done is not None:
                self._done.record()


@dataclass
class ReceiverSession(_LiveSession):
    """Pull-based session: call ``pump()`` with raw IQ (any length) or
    ``pump_planes()`` with re/im planes; it re-blocks to the receiver's
    block size, runs the receiver and the display FFT, pushes audio into
    the rate-locked queue and keeps metrics.  Runs on the card unless
    ``device`` says otherwise.

    The audio consumer (sound card thread, WAV writer) calls
    ``audio_queue.get(n)``; the queue-depth P controller's correction
    feeds back into the resampler ratio, closing the reference's
    clock-tracking loop (interface/soundout.cpp:456-468)."""
    cfg: ReceiverConfig
    spectrum_cfg: Optional[SpectrumConfig] = None
    settings: SessionSettings = field(default_factory=SessionSettings)
    on_spectrum: Optional[Callable[[np.ndarray], None]] = None
    # with depth D up to D-1 steps stay in flight and each is delivered
    # (device -> host) one step behind; depth 1 delivers every step at once
    pipeline_depth: int = 2
    # receivers kept for configurations seen (least recently used dropped
    # beyond this; their state migrates forward on every switch)
    max_cached_programs: int = 12
    device: str = "cuda"

    def __post_init__(self):
        self._setup()
        self.receiver = Receiver(self.cfg, self.device)
        self.receiver.set_volume(self.settings.volume)
        self._receivers: OrderedDict = OrderedDict(
            {self._cfg_key(self.cfg): self.receiver})
        self.analyzer = self._analyzer(self.spectrum_cfg)
        self.spectrum_cfg = self.analyzer.cfg
        self._pending = np.zeros(0, np.complex64)
        self._pending_re = np.zeros(0, np.float32)   # plane-path re-block
        self._pending_im = np.zeros(0, np.float32)
        self._ingest: Optional[_IngestWorker] = None  # made by pump_planes

    def stop(self) -> None:
        """Deliver everything in flight and stop the ingest thread."""
        super().stop()
        with self._lock:
            if self._ingest is not None:
                self._ingest.close()
                self._ingest = None

    # ------------------------------------------------------------- data ---
    def flush(self) -> int:
        """Deliver in-flight uploads and steps (call before reading the
        final state); returns the steps delivered."""
        with self._lock:
            if self._ingest is not None:
                while self._ingest.pending:
                    self._dispatch_uploaded(self._ingest.poll(block=True))
            return super().flush()

    def pump(self, iq: np.ndarray) -> int:
        """Feed raw complex IQ samples; returns the receiver blocks run."""
        if not self.running:
            return 0
        with self._lock:
            on, pump = self._pump_span()
            with pump:
                with spans.span("pump.reblock", on):
                    buf = np.concatenate([self._pending,
                                          np.asarray(iq, np.complex64)])
                    bs = self.cfg.block_size
                    n = len(buf) // bs
                    chunks = [buf[k * bs:(k + 1) * bs] for k in range(n)]
                for chunk in chunks:
                    # the display path takes the raw (pre-mix) stream
                    self._block(on, chunk, self._show, self.receiver.process)
                self._pending = buf[n * bs:]
                self._rate_lock()
                return n

    def _dispatch_uploaded(self, item, on: bool = False) -> None:
        """Run the receiver step on an uploaded plane pair (its spans
        where ``on``)."""
        if item is not None:
            self._step(on, lambda planes: self.receiver.process_planes(
                *planes), item)

    def pump_planes(self, re, im) -> int:
        """High-rate ingest: separate re/im planes, int16 straight off the
        radio's 16-bit wire format (half the upload bytes; K1 reads them
        on the card as they are) or float32.  Uploads run on the ingest thread, double
        buffered against dispatch; the display FFT is fed at the
        throttle's sample granularity without copying skipped samples."""
        if not self.running:
            return 0
        with self._lock:
            on, pump = self._pump_span()
            with pump:
                return self._pump_planes_locked(re, im, on)

    def _pump_planes_locked(self, re, im, on: bool) -> int:
        if self._ingest is None:
            self._ingest = _IngestWorker(self.device,
                                         depth=max(1, self.pipeline_depth))
        with spans.span("pump.reblock", on):
            re, im = np.asarray(re), np.asarray(im)
            if not len(self._pending_re):
                self._pending_re = self._pending_re.astype(re.dtype)
                self._pending_im = self._pending_im.astype(im.dtype)
            elif self._pending_re.dtype != re.dtype:
                # a wire-dtype change with a partial block pending: promote
                # both sides to float32 (int16 would wrap float values)
                self._pending_re = self._pending_re.astype(np.float32)
                self._pending_im = self._pending_im.astype(np.float32)
                re, im = re.astype(np.float32), im.astype(np.float32)
            buf_re = np.concatenate([self._pending_re, re])
            buf_im = np.concatenate([self._pending_im, im])
            if buf_re.dtype not in (np.int16, np.float32):
                buf_re = buf_re.astype(np.float32)
                buf_im = buf_im.astype(np.float32)
            bs = self.cfg.block_size
            n = len(buf_re) // bs
            pairs = [(buf_re[k * bs:(k + 1) * bs], buf_im[k * bs:(k + 1) * bs])
                     for k in range(n)]
        for rb, ib in pairs:
            if on:
                spans.next_block(hold=True)
            with spans.span("pump.display", on):
                if self.analyzer.feed_planes(rb, ib) and self.on_spectrum:
                    self.on_spectrum(self.analyzer.spectrum_db())
            self._ingest.submit(rb, ib)
            self._dispatch_uploaded(self._ingest.poll(), on)
        self._pending_re, self._pending_im = buf_re[n * bs:], buf_im[n * bs:]
        # dispatch the uploads that completed meanwhile
        while (item := self._ingest.poll()) is not None:
            self._dispatch_uploaded(item, on)
        self._rate_lock()
        return n

    # ----------------------------------------------- mode / rate switches --
    @staticmethod
    def _cfg_key(cfg: ReceiverConfig):
        return astuple(cfg)

    def _touch(self, key) -> None:
        """Mark a cached receiver most recently used and evict beyond the
        bound (never the touched one or the active receiver)."""
        self._receivers.move_to_end(key)
        keep = {key, self._cfg_key(self.cfg)}
        while len(self._receivers) > max(1, self.max_cached_programs):
            oldest = next((k for k in self._receivers if k not in keep), None)
            if oldest is None:
                break
            self._receivers.pop(oldest)

    def _switch_to(self, new_cfg: ReceiverConfig) -> None:
        """Swap the receiver and migrate the stream state.  Pending input
        samples are kept (re-blocked at the new block size), so nothing is
        dropped; the carries migrate per ``receiver.migrate_state``, like
        the reference's live SetDemod (dsp/demodulator.cpp:107-157)."""
        with self._lock:
            self.flush()                  # deliver in-flight steps first
            old_cfg, old_state = self.cfg, self.receiver.state
            key = self._cfg_key(new_cfg)
            nxt = self._receivers.get(key)
            if nxt is None:
                nxt = Receiver(new_cfg, self.device)
                self._receivers[key] = nxt
            self._touch(key)
            nxt.state = migrate_state(old_cfg, old_state, new_cfg, nxt.state)
            nxt.params = nxt.params._replace(
                audio_gain=self.receiver.params.audio_gain,
                dc_offset=self.receiver.params.dc_offset)
            self.receiver = nxt
            self.cfg = new_cfg
            # a cached receiver's tune / filter / AGC may have drifted:
            # re-pin them; the user's current tune survives the switch
            self.receiver.set_tune_freq(self.current_tune)
            self.receiver.set_filter(new_cfg.low_cut, new_cfg.hi_cut)
            self.receiver.set_agc()
            self.current_low, self.current_hi = new_cfg.low_cut, new_cfg.hi_cut
            self._nominal_ratio = (new_cfg.output_rate /
                                   (new_cfg.audio_rate or new_cfg.output_rate))
            if self.cfg.audio_rate:
                self.receiver.set_resample_ratio(
                    self._nominal_ratio * (1.0 + self._last_correction))

    def _warm(self, cfg: ReceiverConfig) -> Receiver:
        """A receiver for ``cfg`` that has run one zero block (the FFT
        plans and convolution algorithms picked), its state as fresh."""
        rx = Receiver(cfg, self.device)
        saved = rx.state
        rx.process(np.zeros(cfg.block_size, np.complex64))
        rx.state = saved
        return rx

    def _mode_cfg(self, mode: str) -> ReceiverConfig:
        """The current configuration in ``mode`` with its persisted
        per-mode settings (the m_DemodSettings[] array)."""
        d = self.settings.demod[mode]
        return replace(
            self.cfg, mode=mode, low_cut=d.low_cut, hi_cut=d.hi_cut,
            cw_offset=d.offset, squelch_ui=d.squelch_value,
            agc_on=d.agc_on, agc_hang=d.agc_hang_on,
            agc_thresh_db=d.agc_thresh, agc_manual_gain_db=d.agc_manual_gain,
            agc_slope=d.agc_slope, agc_decay_ms=d.agc_decay)

    def set_mode(self, mode: str) -> None:
        """Live demod-mode change with the persisted per-mode settings,
        without dropping stream samples.  An unseen mode's receiver is
        built outside the session lock first (the stream keeps running);
        ``precompile`` at start-up removes even that wait."""
        new_cfg = self._mode_cfg(mode)
        key = self._cfg_key(new_cfg)
        if key not in self._receivers:
            rx = self._warm(new_cfg)
            with self._lock:
                self._receivers.setdefault(key, rx)
        self._switch_to(new_cfg)
        self.settings.demod_mode = mode

    def set_input_rate(self, input_rate: float) -> None:
        """Live input-rate change (the radio's bandwidth switch): a new
        decimation plan, migrated state, pending samples kept."""
        self._switch_to(replace(self.cfg, input_rate=input_rate))

    def precompile(self, modes) -> None:
        """Build and warm the receivers of a set of modes ahead, so that
        set_mode() is glitch-free on first use."""
        for mode in modes:
            self._prebuild(self._mode_cfg(mode))

    def _prebuild(self, cfg: ReceiverConfig) -> None:
        """Build and warm the receiver of ``cfg`` unless it is cached."""
        key = self._cfg_key(cfg)
        if key not in self._receivers:
            self._receivers[key] = self._warm(cfg)
            self._touch(key)

    # ----------------------------------------------------- probe scope ----
    PROBE_TAPS = PROBE_TAPS

    def _tap_rate(self, key: str) -> float:
        return tap_rate(self.cfg, key)

    def set_probe(self, tap: Optional[str], view: str = "spectrum",
                  trigger_mode: str = "free", trigger_level: float = 0.0,
                  length: int = 1024) -> Optional[str]:
        """Select a live probe tap for the serving UI, the testbench's
        probe scope (gui/testbench.cpp:583-898): any named tap as an
        averaged spectrum (``view="spectrum"``) or a level-triggered time
        capture (``"scope"``; ``trigger_mode`` free, pos, neg, single+ or
        single-).  Short names p1..p7 are taken.  A tap switches to the
        receiver with probes on, off (None, "", "off") back to the one
        without, each as a mode switch does: the stream state migrates
        and no sample is dropped.  A receiver not seen yet is built and
        warmed outside the session lock.  Returns the applied tap (None =
        off)."""
        name = probe_tap_name(tap)
        if name is not None:
            check_probe_tap(self.cfg, name)
        target = replace(self.cfg, probes=name is not None)
        key = self._cfg_key(target)
        if target != self.cfg and key not in self._receivers:
            rx = self._warm(target)
            with self._lock:
                self._receivers.setdefault(key, rx)
        with self._lock:
            return self._set_probe_locked(name, view, trigger_mode,
                                          trigger_level, length)

    def _set_probe_locked(self, tap, view, trigger_mode, trigger_level,
                          length) -> Optional[str]:
        # the steps in flight are delivered to the instrument they were
        # taken for
        self.flush()
        if tap is None:
            if self.cfg.probes:
                self._switch_to(replace(self.cfg, probes=False))
            self._probe_tap = self._probe_inst = None
            return None
        check_probe_tap(self.cfg, tap)
        inst = probe_instrument(self._tap_rate(tap), view, trigger_mode,
                                trigger_level, length, self.device)
        if not self.cfg.probes:
            self._switch_to(replace(self.cfg, probes=True))
        self._probe_tap, self._probe_view, self._probe_inst = tap, view, inst
        return tap

    def probe_frame(self) -> Optional[dict]:
        """The latest probe display frame for the server (or None)."""
        with self._lock:
            if self._probe_tap is None or self._probe_inst is None:
                return None
            return probe_frame_of(self._probe_inst, self._probe_tap,
                                  self._probe_view,
                                  self._tap_rate(self._probe_tap))

    # ---------------------------------------------------------- controls --
    def status_line(self) -> str:
        return self.metrics.status_line()


@dataclass
class DiversitySession(_LiveSession):
    """Dual-RX session: coherent [2, block_size] IQ stacks -> MRC combine
    -> one receiver chain -> rate-locked audio + spectrum + metrics, on
    the card unless ``device`` says otherwise.

    The reference defines the dual-channel modes
    (interface/protocoldefs.h:143-152) but never demodulates channel 2;
    here the display shows branch 0's raw spectrum, the audio is the
    combined stream (up to +3 dB of SNR), and ``gain`` reads the tracked
    complex channel-balance estimate.  Each step's outputs are staged to
    pinned memory and delivered one step later (``pipeline_depth``), as
    in ``ReceiverSession``; after ``flush()`` the audio queue holds what
    the JAX package's synchronous session holds."""
    cfg: ReceiverConfig
    settings: SessionSettings = field(default_factory=SessionSettings)
    on_spectrum: Optional[Callable[[np.ndarray], None]] = None
    smoothing_blocks: float = 8.0
    pipeline_depth: int = 2
    device: str = "cuda"

    def __post_init__(self):
        self._setup()
        self.receiver = DiversityReceiver(self.cfg, self.smoothing_blocks,
                                          device=self.device)
        self.receiver.set_volume(self.settings.volume)
        self.analyzer = self._analyzer()
        self._blocks = _Reblocker(2, self.cfg.block_size, self.device)

    def pump(self, iq_stack) -> int:
        """Feed a [2, n] coherent complex stack (any n; re-blocked through
        pinned staging); returns the receiver blocks run."""
        if not self.running:
            return 0
        with self._lock:
            on, pump = self._pump_span()
            with pump:
                blocks = 0
                pieces = self._blocks.push(np.asarray(iq_stack, np.complex64))
                while True:
                    # the staging buffer is filled as a block is pulled
                    with spans.span("pump.reblock", on):
                        block = next(pieces, None)
                    if block is None:
                        break
                    self._block(on, block, lambda b: self._show(b[0].numpy()),
                                self.receiver.process)
                    blocks += 1
                self._rate_lock()
                return blocks

    # ---------------------------------------------------------- controls --
    @property
    def gain(self) -> complex:
        return self.receiver.last_gain

    def status_line(self) -> str:
        g = self.gain
        return (self.metrics.status_line()
                + f" | rx2 gain {abs(g):.3f} \u2220"
                f"{np.degrees(np.angle(g)):.1f}\u00b0")
