"""Channel-bank session (port of ``cutesdr_tpu/bank.py``): N demodulators
over one wideband stream, with a shared display path and a monitor
channel feeding the audio queue.

Reference analogue: none; CuteSDR runs exactly one demodulator chain
(dsp/demodulator.cpp).  The session keeps ReceiverSession's contract
(``pump``, the controls, the metrics, the probe scope) so the web UI
drives either.  It runs on the card unless ``device`` says otherwise.

Each bank step's outputs (every channel's audio, n_audio and S-meters,
and for the probe scope's view the monitor channel's row of the selected
tap) are copied to pinned memory behind one event and delivered one step
later (``pipeline_depth``), as in ``ReceiverSession``; the probe scope's
spectrum view averages the monitor's row of the tap on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Optional, Sequence

import numpy as np

from cutesdr_tpu_torch import metrics as spans
from cutesdr_tpu_torch.pipeline.receiver import ReceiverConfig, volume_params
from cutesdr_tpu_torch.pipeline.spectrum import SpectrumConfig
from cutesdr_tpu_torch.session import (PROBE_TAPS, _Staged, _StagedSession,
                                       check_probe_tap, probe_frame_of,
                                       probe_instrument, probe_tap_name,
                                       tap_rate)
from cutesdr_tpu_torch.settings import SessionSettings
from cutesdr_tpu_torch.shard.channels import ChannelBank

SPECTRA_BINS = 48       # per-channel mini-spectrum width (UI sparkline)
# p6 (PLL internals) is single-session only: the bank demodulates through
# the bank-voted PLL, which has no probed form
BANK_PROBE_TAPS = tuple(t for t in PROBE_TAPS if t != "p6_pll")


@dataclass
class BankSession(_StagedSession):
    """Pull-based session over a ChannelBank.

    One wideband IQ stream in; per-channel S-meters out every block; the
    *monitor* channel's audio goes to the rate-locked queue (the operator
    listens to one channel; the bank demodulates all of them for metering
    and recording)."""
    cfg: ReceiverConfig
    tune_freqs: Sequence[float]
    spectrum_cfg: Optional[SpectrumConfig] = None
    settings: SessionSettings = field(default_factory=SessionSettings)
    on_spectrum: Optional[Callable[[np.ndarray], None]] = None
    monitor: int = 0
    # depth D keeps D-1 steps in flight, delivered one step behind
    pipeline_depth: int = 2
    device: str = "cuda"

    def __post_init__(self):
        # the server's handler threads call set_probe / select / tune while
        # the main loop is inside pump(): the session's one lock
        self._setup()
        self.tune_freqs = list(self.tune_freqs)
        self.bank = ChannelBank(self.cfg, self.tune_freqs, self.device)
        self.analyzer = self._analyzer(self.spectrum_cfg)
        self.spectrum_cfg = self.analyzer.cfg
        n = len(self.tune_freqs)
        self.smeter_db = np.full(n, -160.0, np.float32)
        self.smeter_peak_db = np.full(n, -160.0, np.float32)
        # per-channel audio mini-spectra (dB, SPECTRA_BINS bins to ~6 kHz)
        self.channel_spectra = np.full((n, SPECTRA_BINS), -120.0, np.float32)
        self._pending = np.zeros(0, np.complex64)

    # ------------------------------------------------------------- data ---
    def _probe_leaf(self, probes: dict):
        """The monitor channel's row of the selected tap (the bank's taps
        lead with the channel axis)."""
        leaf = probes.get(self._probe_tap)
        return None if leaf is None else leaf[self.monitor]

    def _finish(self, staged: _Staged) -> None:
        """Deliver one dispatched bank step: the meters, the mini-spectra,
        the monitor's audio and the scope view's tap row."""
        all_audio, scalars, tap = staged.arrays()
        self._feed_scope(tap)
        n_audio = scalars[0].astype(np.int64)
        self.smeter_db = scalars[1].astype(np.float32)
        self.smeter_peak_db = scalars[2].astype(np.float32)
        # stereo audio lands as [C, cap, 2] left/right planes
        self._update_spectra(all_audio[..., 0] if all_audio.ndim == 3
                             else all_audio, n_audio)
        m = self.monitor
        n_aud = int(n_audio[m])
        self._deliver(all_audio[m, :n_aud], n_aud, float(self.smeter_db[m]),
                      float(self.smeter_peak_db[m]))

    def pump(self, iq: np.ndarray) -> int:
        """Feed raw wideband IQ; returns the bank steps run."""
        with self._lock:
            if not self.running:
                return 0
            on, pump = self._pump_span()
            with pump:
                with spans.span("pump.reblock", on):
                    buf = np.concatenate([self._pending,
                                          np.asarray(iq, np.complex64)])
                    bs = self.cfg.block_size
                    n = len(buf) // bs
                    chunks = [buf[k * bs:(k + 1) * bs] for k in range(n)]
                for chunk in chunks:
                    self._block(on, chunk, self._show, self.bank.process)
                self._pending = buf[n * bs:]
                return n

    # ---------------------------------------------------------- controls --
    @property
    def n_channels(self) -> int:
        return len(self.tune_freqs)

    def select(self, channel: int) -> int:
        """Make ``channel`` the monitor (audio) channel."""
        with self._lock:
            self.monitor = int(channel) % self.n_channels
            return self.monitor

    def tune_channel(self, channel: int, freq_hz: float) -> float:
        with self._lock:
            self.tune_freqs[channel] = float(freq_hz)
            self.bank.set_tune_freqs(self.tune_freqs)
            return float(freq_hz)

    def set_volume(self, vol: int) -> None:
        """The web UI's volume (0..99 -> -50..0 dB) of the monitor audio:
        one gain for the bank (the queue carries only the monitor)."""
        with self._lock:
            self.settings.volume = int(vol)
            self.bank.params = volume_params(self.bank.params, int(vol))

    def tune(self, freq_hz: float) -> None:
        """Tune the monitor channel (``tune_clicked`` rounds first)."""
        self.tune_channel(self.monitor, freq_hz)

    def _update_spectra(self, audio: np.ndarray, n_audio: np.ndarray) -> None:
        """Per-channel audio-band mini-spectrum (what the operator scans the
        bank with): SPECTRA_BINS log-power bins over 0..fs_audio/8."""
        n = int(n_audio.min())
        if n < 4 * SPECTRA_BINS:
            return
        a = audio[:, :n]
        w = np.hanning(n)
        spec = np.abs(np.fft.rfft(a * w, axis=-1)) ** 2
        # keep the bottom eighth of the band (voice) folded to SPECTRA_BINS
        k = max(1, (spec.shape[-1] // 8) // SPECTRA_BINS)
        spec = spec[:, :k * SPECTRA_BINS].reshape(len(a), SPECTRA_BINS, k)
        power = spec.max(axis=-1)
        ref = (32767.0 * w.sum() / 2.0) ** 2
        self.channel_spectra = (10.0 * np.log10(
            np.maximum(power / ref, 1e-12))).astype(np.float32)

    def channel_info(self) -> list[dict]:
        return [{"id": i, "tune_hz": float(f),
                 "smeter_db": round(float(self.smeter_db[i]), 1),
                 "monitor": i == self.monitor,
                 "spec": [round(float(v), 1)
                          for v in self.channel_spectra[i]]}
                for i, f in enumerate(self.tune_freqs)]

    # ----------------------------------------------------- probe scope ----
    def set_probe(self, tap: Optional[str], view: str = "spectrum",
                  trigger_mode: str = "free", trigger_level: float = 0.0,
                  length: int = 1024) -> Optional[str]:
        """The probe scope on the MONITOR channel's taps (no p6).  Turning
        probes on or off rebuilds the bank, whose carries restart (a
        bounded fill-in transient, as in the JAX package: there is no
        per-configuration migration cache for N-channel state).  Returns
        the applied tap (None = off)."""
        with self._lock:
            tap = probe_tap_name(tap)
            if tap is None:
                if self.cfg.probes:
                    self._rebuild(False)
                self._probe_tap = self._probe_inst = None
                return None
            check_probe_tap(self.cfg, tap, BANK_PROBE_TAPS)
            inst = probe_instrument(self._tap_rate(tap), view, trigger_mode,
                                    trigger_level, length, self.device)
            if not self.cfg.probes:
                self._rebuild(True)
            self.flush()
            self._probe_tap, self._probe_view = tap, view
            self._probe_inst = inst
            return tap

    def _rebuild(self, probes: bool) -> None:
        self.flush()
        self.cfg = replace(self.cfg, probes=probes)
        self.bank = ChannelBank(self.cfg, self.tune_freqs, self.device)

    def _tap_rate(self, key: str) -> float:
        return tap_rate(self.cfg, key)

    def probe_frame(self) -> Optional[dict]:
        """The monitor channel's latest probe frame for the server (or
        None)."""
        with self._lock:
            if self._probe_tap is None or self._probe_inst is None:
                return None
            return probe_frame_of(self._probe_inst, self._probe_tap,
                                  self._probe_view,
                                  self._tap_rate(self._probe_tap),
                                  channel=self.monitor)

    def status_line(self) -> str:
        return (f"{self.n_channels} ch | monitor {self.monitor} | "
                + self.metrics.status_line())
