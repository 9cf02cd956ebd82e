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

Left out: the probe scope (``set_probe``, ``probe_frame``: ROADMAP Queue 1,
item 19, the probe taps) and ``DiversitySession`` (it needs
``shard/coherent``: ROADMAP Queue 1, shard).
"""

from __future__ import annotations

import queue
import threading
from collections import OrderedDict
from dataclasses import astuple, dataclass, field, replace
from typing import Callable, Optional

import numpy as np
import torch

from cutesdr_tpu_torch.io.audio_sink import RateLockedQueue
from cutesdr_tpu_torch.kernels import _build
from cutesdr_tpu_torch.metrics import StreamMetrics
from cutesdr_tpu_torch.pipeline.receiver import (MODE_LIMITS, Receiver,
                                                 ReceiverConfig, StepOutput,
                                                 migrate_state)
from cutesdr_tpu_torch.pipeline.spectrum import (SpectrumAnalyzer,
                                                 SpectrumConfig)
from cutesdr_tpu_torch.settings import SessionSettings
from cutesdr_tpu_torch.types import resolve_device


class _Staged:
    """One step's outputs on their way to the host: audio (stereo as
    [cap, 2] left/right) and the scalars (n_audio, S-meter average and
    peak) copied ``non_blocking`` into pinned memory behind an event on
    the card; the tensors themselves on the CPU."""

    def __init__(self, out: StepOutput):
        audio = out.audio
        if audio.is_complex():
            audio = torch.view_as_real(audio)
        scalars = torch.stack([out.n_audio.double(),
                               out.smeter_ave_db.double(),
                               out.smeter_peak_db.double()])
        self.event = None
        if audio.device.type == "cuda":
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in (audio, scalars)]
            for h, t in zip(host, (audio, scalars)):
                h.copy_(t, non_blocking=True)
            audio, scalars = host
            self.event = torch.cuda.Event()
            self.event.record()
        self.audio, self.scalars = audio, scalars

    def result(self) -> tuple[np.ndarray, int, float, float]:
        """(valid audio, n_audio, S-meter average, peak) once the copies
        have landed."""
        if self.event is not None:
            self.event.synchronize()
        n, ave, peak = self.scalars.tolist()
        return self.audio.numpy()[:int(n)], int(n), ave, peak


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


@dataclass
class ReceiverSession:
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
        self.device = resolve_device(self.device)
        if self.device.type == "cuda":
            _build.library()           # nvcc now, not in the first block
        # serializes the pump loop against switches from other threads
        # (the reference's reconfigure-vs-process mutexes,
        # dsp/demodulator.cpp:109/166), one lock at session level
        self._lock = threading.RLock()
        self.receiver = Receiver(self.cfg, self.device)
        self.receiver.set_volume(self.settings.volume)
        self._receivers: OrderedDict = OrderedDict(
            {self._cfg_key(self.cfg): self.receiver})
        if self.spectrum_cfg is None:
            self.spectrum_cfg = SpectrumConfig(
                fft_size=self.settings.display.fft_size,
                ave_size=self.settings.display.fft_ave,
                sample_rate=self.cfg.input_rate)
        self.analyzer = SpectrumAnalyzer(
            self.spectrum_cfg,
            max_display_rate=self.settings.display.max_display_rate,
            device=self.device)
        self.audio_queue = RateLockedQueue(stereo=self.cfg.stereo)
        self.metrics = StreamMetrics()
        self._pending = np.zeros(0, np.complex64)
        self._pending_re = np.zeros(0, np.float32)   # plane-path re-block
        self._pending_im = np.zeros(0, np.float32)
        self._ingest: Optional[_IngestWorker] = None  # made by pump_planes
        self._inflight: list[_Staged] = []  # dispatched, not yet delivered
        self._nominal_ratio = (self.cfg.output_rate /
                               (self.cfg.audio_rate or self.cfg.output_rate))
        self._last_correction = 0.0
        self.current_tune = self.cfg.tune_freq
        self.current_low, self.current_hi = self.cfg.low_cut, self.cfg.hi_cut
        self.running = False

    def start(self) -> None:
        self.running = True
        self.metrics = StreamMetrics()

    def stop(self) -> None:
        """Deliver everything in flight and stop the ingest thread."""
        self.flush()
        with self._lock:
            if self._ingest is not None:
                self._ingest.close()
                self._ingest = None
        self.running = False

    # ------------------------------------------------------------- data ---
    def _finish(self, staged: _Staged) -> None:
        """Deliver one dispatched step (samples_in and blocks were counted
        at dispatch; here the audio, the meters and the queue's counts)."""
        audio, n_aud, ave, peak = staged.result()
        self.audio_queue.put_block(
            np.clip(audio, -32767, 32767).astype(np.int16))
        self.metrics.audio_samples_out += n_aud
        self.metrics.smeter_ave_db = ave
        self.metrics.smeter_peak_db = peak
        self.metrics.audio_overflows = self.audio_queue.overflows
        self.metrics.audio_underflows = self.audio_queue.underflows

    def _enter(self, out: StepOutput) -> None:
        """Count a dispatched step, start its copies to the host and
        deliver the steps at least pipeline_depth-1 behind it."""
        self.metrics.samples_in += self.cfg.block_size
        self.metrics.blocks += 1
        self._inflight.append(_Staged(out))
        while len(self._inflight) >= max(1, self.pipeline_depth):
            self._finish(self._inflight.pop(0))

    def flush(self) -> int:
        """Deliver in-flight uploads and steps (call before reading the
        final state); returns the steps delivered."""
        with self._lock:
            if self._ingest is not None:
                while self._ingest.pending:
                    self._dispatch_uploaded(self._ingest.poll(block=True))
            n = len(self._inflight)
            for staged in self._inflight:
                self._finish(staged)
            self._inflight.clear()
            return n

    def _rate_lock(self) -> None:
        """Close the rate-lock loop when the consumer's correction moved."""
        corr = self.audio_queue.rate_correction
        if corr != self._last_correction and self.cfg.audio_rate:
            self._last_correction = corr
            self.metrics.ppm_error = self.audio_queue.ppm_error
            self.receiver.set_resample_ratio(
                self._nominal_ratio * (1.0 + corr))

    def pump(self, iq: np.ndarray) -> int:
        """Feed raw complex IQ samples; returns the receiver blocks run."""
        if not self.running:
            return 0
        with self._lock:
            buf = np.concatenate([self._pending,
                                  np.asarray(iq, np.complex64)])
            bs = self.cfg.block_size
            blocks = 0
            while len(buf) >= bs:
                chunk, buf = buf[:bs], buf[bs:]
                # the display path takes the raw (pre-mix) stream
                if self.analyzer.feed(chunk) and self.on_spectrum:
                    self.on_spectrum(self.analyzer.spectrum_db())
                self.metrics.overload = self.analyzer.overload
                self._enter(self.receiver.process(chunk))
                blocks += 1
            self._pending = buf
            self._rate_lock()
            return blocks

    def _dispatch_uploaded(self, item) -> None:
        """Run the receiver step on an uploaded plane pair."""
        if item is not None:
            self._enter(self.receiver.process_planes(*item))

    def pump_planes(self, re, im) -> int:
        """High-rate ingest: separate re/im planes, int16 straight off the
        radio's 16-bit wire format (half the upload bytes; cast to float32
        on the card) or float32.  Uploads run on the ingest thread, double
        buffered against dispatch; the display FFT is fed at the
        throttle's sample granularity without copying skipped samples."""
        if not self.running:
            return 0
        with self._lock:
            return self._pump_planes_locked(re, im)

    def _pump_planes_locked(self, re, im) -> int:
        if self._ingest is None:
            self._ingest = _IngestWorker(self.device,
                                         depth=max(1, self.pipeline_depth))
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
        blocks = 0
        while len(buf_re) >= bs:
            rb, buf_re = buf_re[:bs], buf_re[bs:]
            ib, buf_im = buf_im[:bs], buf_im[bs:]
            if self.analyzer.feed_planes(rb, ib) and self.on_spectrum:
                self.on_spectrum(self.analyzer.spectrum_db())
            self.metrics.overload = self.analyzer.overload
            self._ingest.submit(rb, ib)
            self._dispatch_uploaded(self._ingest.poll())
            blocks += 1
        self._pending_re, self._pending_im = buf_re, buf_im
        # dispatch the uploads that completed meanwhile
        while (item := self._ingest.poll()) is not None:
            self._dispatch_uploaded(item)
        self._rate_lock()
        return blocks

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
            key = self._cfg_key(self._mode_cfg(mode))
            if key in self._receivers:
                continue
            self._receivers[key] = self._warm(self._mode_cfg(mode))
            self._touch(key)

    # ----------------------------------------------------- probe scope ----
    def set_probe(self, *args, **kwargs):
        raise NotImplementedError("not ported yet: the probe scope (ROADMAP "
                                  "Queue 1, item 19: probe taps)")

    def probe_frame(self):
        raise NotImplementedError("not ported yet: the probe scope (ROADMAP "
                                  "Queue 1, item 19: probe taps)")

    # ---------------------------------------------------------- controls --
    def tune(self, freq_hz: float) -> None:
        self.receiver.set_tune_freq(freq_hz)
        self.current_tune = freq_hz

    def tune_clicked(self, freq_hz: float) -> float:
        """Click-to-tune rounded to the mode's click resolution
        (gui/plotter.cpp roundFreq with m_ClickResolution)."""
        res = max(1, int(self.settings.demod[self.cfg.mode]
                         .filter_click_resolution))
        rounded = round(freq_hz / res) * res
        self.tune(rounded)
        return rounded

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

    def status_line(self) -> str:
        return self.metrics.status_line()


class DiversitySession:
    """Dual-RX session of the JAX package (``cutesdr_tpu/session.py``):
    not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("not ported yet: DiversitySession needs "
                                  "shard/coherent (ROADMAP Queue 1: shard)")
