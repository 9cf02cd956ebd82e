"""Deterministic test-signal generators: swept/fixed tone, pulse modulation,
calibrated Gaussian noise.

Reference analogue: CTestBench::CreateGeneratorSamples
(gui/testbench.cpp:352-447): a phase-accumulator sweep generator with pulse
gating and Box-Muller noise at a dB-set power, injected at the very top of
the DSP chain in place of radio samples.  This module is the framework's
verification instrument: every golden test drives the pipeline with these
signals (see tests/).

Amplitudes are in dB relative to full scale (32767), matching the reference
calibration (amp = 32767·10^(dB/20), gui/testbench.cpp:531-532).

The port's own copy of ``cutesdr_tpu/testbench/generators.py`` (numpy,
with the port's ``types`` constants); a test holds its code equal to the
JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cutesdr_tpu_torch.types import K_2PI, MAX_AMPLITUDE


@dataclass
class GenConfig:
    sample_rate: float
    sweep_start_hz: float = 0.0
    sweep_stop_hz: float = 0.0
    sweep_rate_hz_per_sec: float = 0.0
    signal_power_db: float = -10.0     # dBFS
    noise_power_db: float = -160.0     # dBFS; <= -160 disables noise
    pulse_width_sec: float = 0.0       # 0 disables pulse modulation
    pulse_period_sec: float = 0.0
    seed: int = 1234


class SignalGenerator:
    """Streaming generator; successive next_block calls are phase-continuous."""

    def __init__(self, cfg: GenConfig):
        self.cfg = cfg
        self.reset()

    def reset(self) -> None:
        c = self.cfg
        self._freq = c.sweep_start_hz
        self._freq_norm = K_2PI / c.sample_rate
        self._acc = 0.0
        self._rate_inc = c.sweep_rate_hz_per_sec / c.sample_rate
        self._amp = MAX_AMPLITUDE * 10.0 ** (c.signal_power_db / 20.0)
        self._noise_amp = MAX_AMPLITUDE * 10.0 ** (c.noise_power_db / 20.0)
        self._pulse_timer = 0.0
        self._rng = np.random.default_rng(c.seed)

    def next_block(self, n: int, complex_out: bool = True) -> np.ndarray:
        c = self.cfg
        # sweep frequency trajectory (stops at sweep_stop)
        freqs = self._freq + self._rate_inc * np.arange(n)
        if self._rate_inc != 0.0:
            freqs = np.minimum(freqs, c.sweep_stop_hz)
        # phase accumulator: phi[k] = acc + cumsum of freq steps
        phase = self._acc + np.cumsum(freqs * self._freq_norm)
        phase = np.concatenate([[self._acc], phase])
        self._acc = float(np.mod(phase[-1], K_2PI))
        self._freq = float(freqs[-1] + (self._rate_inc if self._rate_inc else 0.0))
        ph = phase[:-1]

        amp = np.full(n, self._amp)
        if c.pulse_width_sec > 0.0:
            t = self._pulse_timer + np.arange(1, n + 1) / c.sample_rate
            tmod = np.mod(t, c.pulse_period_sec)
            amp = np.where(tmod > c.pulse_width_sec, 0.0, amp)
            self._pulse_timer = float(tmod[-1])

        if complex_out:
            sig = amp * np.exp(1j * ph)
        else:
            sig = 3.0 * amp * np.cos(ph)

        if c.noise_power_db > -160.0:
            if complex_out:
                sig = sig + self._noise_amp * (
                    self._rng.standard_normal(n)
                    + 1j * self._rng.standard_normal(n))
            else:
                sig = sig + self._noise_amp * self._rng.standard_normal(n)
        return sig.astype(np.complex128 if complex_out else np.float64)


def tone(n: int, freq_hz: float, sample_rate: float, power_db: float = -10.0,
         phase0: float = 0.0) -> np.ndarray:
    """Convenience: fixed complex tone at dBFS power."""
    amp = MAX_AMPLITUDE * 10.0 ** (power_db / 20.0)
    ph = phase0 + K_2PI * freq_hz / sample_rate * np.arange(n)
    return (amp * np.exp(1j * ph)).astype(np.complex128)
