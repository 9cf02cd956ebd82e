"""The two-rate AGC (dsp/agc.cpp:174-296), or the manual gain where the
AGC is off: the filtered [C, 2, n] rows to the levelled rows.

The peak of each sample's larger rail over the AGC's window feeds its
attack and decay averagers (from -5 decades, on the host); the gain
follows the larger of the two above the knee, and is applied to the rows
delayed by the AGC's delay.  Its memory is the decay averager's: the
warm-up spans twelve of its time constants (e^-12 of a gap is left where
it only falls) and at least ``WARM_MIN_S``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sdrbench.reference import design
from sdrbench.reference.stage import Part as _Part

STAGE = "levels"
# the least warm-up: two of the S-meter's 500 ms decay constants, and
# several syllables of the captures' 2-3 Hz envelopes, whose rises bring
# the S-meter's decay average onto its attack average
WARM_MIN_S = 1.0


def takes(rx: dict) -> bool:
    return not rx.get("agc_hang", False) or not rx.get("agc_on", True)


class Part(_Part):

    def __init__(self, rx, rates, precision, device):
        super().__init__(rx, rates, precision, device)
        self.agc_on = bool(rx.get("agc_on", True))
        self.agc = design.AgcConstants(
            rates.output, float(rx["agc_thresh_db"]), float(rx["agc_slope"]),
            float(rx["agc_decay_ms"]), float(rx["agc_manual_gain_db"]))
        self.warm_s = max(12.0 * float(rx["agc_decay_ms"]) * 1e-3,
                          WARM_MIN_S)

    def __call__(self, filt: torch.Tensor) -> torch.Tensor:
        """The levelled [C, 2, n] rows of the filtered rows ``filt``."""
        fr, fi = filt[:, 0], filt[:, 1]
        r = self._r
        ac = self.agc
        if not self.agc_on:
            return r(filt * ac.manual_gain)
        inst = torch.maximum(fr.abs(), fi.abs())
        mag = r(torch.log10(inst + 3.2767e-4) - math.log10(design.FULL_SCALE))
        hist = torch.full(mag.shape[:-1] + (ac.window - 1,), -16.0,
                          dtype=mag.dtype, device=mag.device)
        peak = torch.nn.functional.max_pool1d(
            torch.cat([hist, mag], -1)[:, None], ac.window, 1)[:, 0]
        magsel = torch.tensor(self._averagers(peak.cpu().numpy()),
                              device=mag.device)
        gain = r(torch.where(magsel <= ac.knee, ac.fixed_gain,
                             0.7 * 10.0 ** (magsel * (ac.slope - 1.0))))
        delayed = torch.nn.functional.pad(filt, (ac.delay, 0))[..., :-ac.delay]
        return r(delayed * gain[:, None])

    def _averagers(self, peak: np.ndarray) -> np.ndarray:
        """max(attack, decay) of the AGC's two-rate averagers, row by
        row, sample by sample, from -5 decades (on the host)."""
        ac = self.agc
        if not self.tf32 and peak.shape[0] == 1:
            return _averagers_scalar(peak[0].tolist(), ac)[None]
        rows, n = peak.shape
        dt = peak.dtype
        r = self._r
        # the attack averager's rows, then the decay averager's
        x = np.full(2 * rows, -5.0, dt)
        rise = np.repeat(np.array([ac.a_rise, ac.d_rise], dt), rows)
        fall = np.repeat(np.array([ac.a_fall, ac.d_fall], dt), rows)
        pt = np.ascontiguousarray(np.concatenate([peak, peak]).T)
        out = np.empty((n, 2 * rows), dt)
        g = np.empty_like(x)
        for i in range(n):
            np.subtract(pt[i], x, out=g)
            a = np.where(g > 0, rise, fall)
            if self.tf32:
                x = r(x + r(a * r(g)))
            else:
                np.multiply(a, g, out=g)
                np.add(x, g, out=x)
            out[i] = x
        return np.maximum(out[:, :rows], out[:, rows:]).T


def _averagers_scalar(peak: list, ac) -> np.ndarray:
    att = dec = -5.0
    ar, af, dr, df = ac.a_rise, ac.a_fall, ac.d_rise, ac.d_fall
    out = [0.0] * len(peak)
    for i, p in enumerate(peak):
        att += (ar if p > att else af) * (p - att)
        dec += (dr if p > dec else df) * (p - dec)
        out[i] = att if att > dec else dec
    return np.array(out)
