"""Narrowband FM demodulation (CuteSDR's CFmDemod, dsp/fmdemod.cpp:45-152,
SURVEY.md's row), in float64, sample by sample on the host, as the AGC's
averagers run.

* A PLL tracks the carrier: 6 kHz loop bandwidth, damping 0.707, its
  frequency held to +-6 kHz (:45-49).  Each sample is turned by the NCO's
  phase, the phase error is minus its angle, the frequency moves by beta
  times the error, the phase by the frequency plus alpha times the error
  (:62-89).
* The audio is the NCO's frequency less its DC, a one-pole average of the
  frequency (time constant ``FMDC_S``), times ``MAX_FMOUT`` over the lock
  limit (:183-187).
* The noise squelch (:104-152): a high-pass FIR above the voice band (the
  channel's high cut as its passband edge, stop band at 0.6 of it, 50 dB)
  feeds a rectified one-pole average (``SQUELCH_S``); at the end of each
  call the average is held against the threshold of ``squelch_ui``
  (``SQUELCH_MAX`` less its share of 99) with ``SQUELCH_HYSTERESIS`` either
  way: a closed squelch zeroes the call's audio, an open one passes it
  through the 3 kHz biquad low-pass (:143-151), whose state holds while
  closed.  A threshold of 0 (99 on the dial) closes it for good.
* The optional one-pole de-emphasis of ``fm_deemphasis_us`` (none at 0).

A call is one block of the stream: the span's blocks are gated one by one
(a span starts at a block's first sample).  Cold, the loop, averages and
filters start at zero, the squelch closed.  The high-pass and biquad
designs are the reference's own (``design.kaiser_highpass``,
``design.biquad_lowpass``).

Departures from CuteSDR, each with its reason:

* the NCO's phase is wrapped into (-pi, pi] after every sample, not once a
  call (``fmod``): equal in exact arithmetic, and it keeps the sine and
  cosine of a float64 phase as exact as its first samples';
* the constants SURVEY.md does not give (``FMDC_S``, ``MAX_FMOUT``,
  ``SQUELCH_S``, the high-pass's stop edge and attenuation, the biquad's
  Q of 1) are fmdemod.cpp's as the JAX package's ``demod/fm.py`` records
  them; nothing of either package is imported.

In the control every intermediate value is rounded to TF32
(``stage.tf32_scalar`` in the loops, ``round_tf32`` around the FIR).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sdrbench.reference import design
from sdrbench.reference.stage import Part as _Part
from sdrbench.reference.stage import round_tf32, tf32_scalar

STAGE = "demod"
FMPLL_RANGE = 6000.0          # Hz either way
VOICE_BANDWIDTH = 3000.0
FMPLL_BW = 2.0 * VOICE_BANDWIDTH
FMPLL_ZETA = 0.707
FMDC_S = 0.01
MAX_FMOUT = 25000.0
SQUELCH_MAX = 5000.0
SQUELCH_S = 0.02
SQUELCH_HYSTERESIS = 100.0
HP_ASTOP_DB = 50.0
HP_STOP = 0.6                 # the high-pass's stop edge, of its pass edge
LP_Q = 1.0


def takes(rx: dict) -> bool:
    return rx.get("mode") == "fm" and not rx.get("stereo", False)


def _same(x: float) -> float:
    return x


class Part(_Part):

    def __init__(self, rx, rates, precision, device):
        super().__init__(rx, rates, precision, device)
        fs = rates.output
        norm = 2.0 * math.pi / fs
        self.alpha = 2.0 * FMPLL_ZETA * FMPLL_BW * norm
        self.beta = self.alpha ** 2 / (4.0 * FMPLL_ZETA ** 2)
        self.limit = FMPLL_RANGE * norm
        self.gain = MAX_FMOUT / self.limit
        self.dc_alpha = 1.0 - math.exp(-1.0 / (fs * FMDC_S))
        self.sq_alpha = 1.0 - math.exp(-1.0 / (fs * SQUELCH_S))
        self.threshold = SQUELCH_MAX - SQUELCH_MAX * int(
            rx.get("squelch_ui", 0)) / 99.0
        hi = float(rx["hi_cut"])
        self.hp = design.kaiser_highpass(HP_ASTOP_DB, hi, HP_STOP * hi, fs)
        self.lp = design.biquad_lowpass(VOICE_BANDWIDTH, LP_Q, fs)
        tau = float(rx.get("fm_deemphasis_us", 0.0))
        self.de_alpha = (1.0 - math.exp(-1.0 / (fs * tau * 1e-6))
                         if tau > 0.0 else None)
        # twelve of the slowest average's time constants, and the first
        # block's gate, taken cold
        self.warm_s = (12.0 * max(FMDC_S, SQUELCH_S, tau * 1e-6)
                       + rates.block / rates.input)
        self.s = tf32_scalar if self.tf32 else _same

    def __call__(self, leveled: torch.Tensor) -> torch.Tensor:
        """The audio [C, n] of the levelled [C, 2, n] rows."""
        x = leveled.double().cpu().numpy()
        out = [self._squelch(self._pll(x[c, 0].tolist(), x[c, 1].tolist()))
               for c in range(x.shape[0])]
        return torch.tensor(np.stack(out), dtype=self.dtype,
                            device=leveled.device)

    def _pll(self, re: list, im: list) -> np.ndarray:
        """The loop, the DC tracker and the gain: the unsquelched audio
        of one row."""
        r = self.s
        a, b, lim = r(self.alpha), r(self.beta), r(self.limit)
        gain, da = r(self.gain), r(self.dc_alpha)
        keep = r(1.0 - self.dc_alpha)
        pi, two_pi = math.pi, 2.0 * math.pi
        sin, cos, atan2 = math.sin, math.cos, math.atan2
        phase = freq = dc = 0.0
        out = [0.0] * len(re)
        for i, (xr, xi) in enumerate(zip(re, im)):
            s, c = r(sin(phase)), r(cos(phase))
            tr = r(r(c * xr) - r(s * xi))
            ti = r(r(c * xi) + r(s * xr))
            err = -r(atan2(ti, tr))
            freq = r(freq + r(b * err))
            if freq > lim:
                freq = lim
            elif freq < -lim:
                freq = -lim
            phase = r(phase + r(freq + r(a * err)))
            if phase > pi:
                phase = r(phase - two_pi)
            elif phase <= -pi:
                phase = r(phase + two_pi)
            dc = r(r(keep * dc) + r(da * freq))
            out[i] = r(r(freq - dc) * gain)
        return np.array(out)

    def _squelch(self, audio: np.ndarray) -> np.ndarray:
        """The noise squelch, call by call (a block each), the biquad
        where it is open, and the de-emphasis: the audio of one row."""
        r = self.s
        n, blk = len(audio), self.rates.block_out
        if self.tf32:
            hp = round_tf32(np.convolve(round_tf32(audio.astype(np.float32)),
                                        round_tf32(self.hp))[:n])
        else:
            hp = np.convolve(audio, self.hp)[:n]
        noise = np.abs(hp).tolist()
        x = audio.tolist()
        sa, keep = r(self.sq_alpha), r(1.0 - self.sq_alpha)
        b0, b1, b2, a1, a2 = (r(float(v)) for v in self.lp)
        lo, hi = self.threshold - SQUELCH_HYSTERESIS, \
            self.threshold + SQUELCH_HYSTERESIS
        y = [0.0] * n
        ave, closed, w1, w2 = 0.0, True, 0.0, 0.0
        for start in range(0, n, blk):
            end = min(n, start + blk)
            for v in noise[start:end]:
                ave = r(r(keep * ave) + r(sa * v))
            closed = (self.threshold == 0.0
                      or ave >= (lo if closed else hi))
            if closed:
                continue
            for i in range(start, end):
                w0 = r(r(x[i] - r(a1 * w1)) - r(a2 * w2))
                y[i] = r(r(r(b0 * w0) + r(b1 * w1)) + r(b2 * w2))
                w2, w1 = w1, w0
        if self.de_alpha is not None:
            da, keep = r(self.de_alpha), r(1.0 - self.de_alpha)
            d = 0.0
            for i in range(n):
                d = r(r(keep * d) + r(da * y[i]))
                y[i] = d
        return np.array(y)
