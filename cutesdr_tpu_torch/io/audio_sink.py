"""Rate-locked audio output queue.

Reference analogue: CSoundOut (interface/soundout.{h,cpp}): a 16384-sample
ring queue between the DSP thread and the sound card, with a half-fill
startup gate, ±quarter-queue self-healing on under/overflow, and an adaptive
rate lock — a P controller on the averaged queue depth whose output trims
the fractional-resampler ratio so the radio clock tracks the sink clock
(P gain 2.38e-7, 1 Hz updates, >500 ppm alarm).

The controller/queue logic is kept identical; the device behind it is
pluggable (a callback consumer: WAV writer, network sink, or a real
soundcard wrapper if the host has one).  The resampler itself runs on the
card inside the receiver; the controller's correction feeds
Receiver.set_resample_ratio between blocks.

The port's own copy of ``cutesdr_tpu/io/audio_sink.py`` (numpy and
threading).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

OUTQSIZE = 16384
FILTERQLEVEL_ALPHA = 0.001
P_GAIN = 2.38e-7
PPM_ALARM = 500


@dataclass
class RateLockedQueue:
    """Audio ring queue with queue-depth rate estimation."""
    stereo: bool = False
    size: int = OUTQSIZE

    def __post_init__(self):
        shape = (self.size, 2) if self.stereo else (self.size,)
        self._buf = np.zeros(shape, np.int16)
        self._head = 0
        self._tail = 0
        self._level = 0
        self._ave_level = self.size / 2
        self._startup = True
        self._rate_correction = 0.0
        self._ppm_error = 0
        self._samples_since_update = 0
        self._consumer_rate = 48000
        self._lock = threading.Lock()
        self.overflows = 0
        self.underflows = 0

    # ---- producer side (DSP output) ----
    def put(self, samples: np.ndarray) -> None:
        """Append int16 audio; on overflow drop a quarter queue (the
        reference's self-healing jump, interface/soundout.cpp:228-235)."""
        with self._lock:
            for s in np.atleast_1d(samples):
                self._buf[self._head] = s
                self._head = (self._head + 1) & (self.size - 1)
                self._level += 1
                if self._head == self._tail:
                    self._tail = (self._tail + self.size // 4) & (self.size - 1)
                    self._level -= self.size // 4
                    self.overflows += 1
                    self._ave_level = self._level
                    break
            self._ave_level = ((1 - FILTERQLEVEL_ALPHA) * self._ave_level
                               + FILTERQLEVEL_ALPHA * self._level)

    def put_block(self, samples: np.ndarray) -> None:
        """Vectorized put for whole blocks (the common path)."""
        samples = np.atleast_1d(samples)
        n = len(samples)
        with self._lock:
            if self._level + n >= self.size:
                self._tail = (self._tail + self.size // 4) & (self.size - 1)
                self._level -= self.size // 4
                self.overflows += 1
                self._ave_level = self._level
                if self._level + n >= self.size:   # still too much: drop input
                    n = self.size - 1 - self._level
                    samples = samples[:n]
            idx = (self._head + np.arange(n)) & (self.size - 1)
            self._buf[idx] = samples
            self._head = (self._head + n) & (self.size - 1)
            self._level += n
            self._ave_level = ((1 - FILTERQLEVEL_ALPHA) * self._ave_level
                               + FILTERQLEVEL_ALPHA * self._level)

    # ---- consumer side (sound device / file) ----
    def get(self, n: int) -> np.ndarray:
        """Pull n samples; silence during startup until half full, quarter-
        queue rewind on underflow (interface/soundout.cpp:312-377)."""
        out_shape = (n, 2) if self.stereo else (n,)
        with self._lock:
            if self._startup:
                if self._level > self.size // 2:
                    self._startup = False
                    self._samples_since_update = -5 * self._consumer_rate
                    self._ppm_error = 0
                    self._ave_level = self._level
                else:
                    return np.zeros(out_shape, np.int16)
            if self._level < n:
                self._tail = (self._tail - self.size // 4) & (self.size - 1)
                self._level += self.size // 4
                self.underflows += 1
                self._ave_level = self._level
            idx = (self._tail + np.arange(n)) & (self.size - 1)
            out = self._buf[idx].copy()
            self._tail = (self._tail + n) & (self.size - 1)
            self._level -= n
            self._ave_level = ((1 - FILTERQLEVEL_ALPHA) * self._ave_level
                               + FILTERQLEVEL_ALPHA * self._level)
            self._samples_since_update += n
            if self._samples_since_update >= self._consumer_rate:
                self._update_rate_error()
                self._samples_since_update = 0
            return out

    def _update_rate_error(self) -> None:
        error = (self._ave_level - self.size / 2) * P_GAIN
        self._rate_correction = error
        self._ppm_error = int(error * 1e6)

    @property
    def rate_correction(self) -> float:
        """Multiply the nominal resample ratio by (1 + rate_correction)."""
        return self._rate_correction

    @property
    def ppm_error(self) -> int:
        return self._ppm_error

    @property
    def alarm(self) -> bool:
        return abs(self._ppm_error) > PPM_ALARM

    @property
    def level(self) -> int:
        return self._level
