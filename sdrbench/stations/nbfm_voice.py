"""A narrowband FM voice stand-in: a constant-envelope carrier at
``carrier_hz`` and ``level_dbfs``, frequency-modulated by ``tones_hz``,
each tone at its own peak deviation (``deviation_hz``, a list beside the
tones).

Its phase is sum_i (df_i / f_i) sin(2 pi k_i n / N + phi_i): tone i, at
k_i whole periods over the capture (f_i = k_i rate / N), swings the
frequency by +-df_i.  The carrier is a whole number of periods too, so a
repeated capture has no seam.  The seed draws only the phases phi_i.
Narrowband FM on 12.5 kHz channels peaks at +-2.5 kHz.
"""

from __future__ import annotations

import math

import torch

FULL_SCALE = 32767.0


class Station:

    def __init__(self, k_carrier: int, amp: float, tones: list, n: int):
        self.k, self.amp, self.tones, self.n = k_carrier, amp, tones, n

    def fixed(self):
        return self.k, self.amp, [(k, index) for k, index, _ in self.tones]

    def __call__(self, idx: torch.Tensor):
        n = self.n
        scale = 2.0 * math.pi / n
        ang = torch.remainder(idx * self.k, n).double() * scale
        for k, index, phase in self.tones:
            ang = ang + index * torch.sin(
                torch.remainder(idx * k, n).double() * scale + phase)
        return self.amp * torch.cos(ang), self.amp * torch.sin(ang)


def parts(st: dict, rate: float, n: int, rng) -> Station:
    tones = [float(f) for f in st["tones_hz"]]
    devs = [float(d) for d in st["deviation_hz"]]
    if len(devs) != len(tones):
        raise ValueError(f"{len(tones)} tones with {len(devs)} deviations")
    phases = rng.uniform(0.0, 2.0 * math.pi, len(tones))
    mod = []
    for f, df, ph in zip(tones, devs, phases):
        k = int(round(f * n / rate))
        if k <= 0:
            raise ValueError(f"tone {f} Hz has no whole period in the "
                             f"capture")
        mod.append((k, df / (k * rate / n), float(ph)))
    amp = FULL_SCALE * 10.0 ** (float(st["level_dbfs"]) / 20.0)
    return Station(int(round(float(st["carrier_hz"]) * n / rate)), amp, mod,
                   n)
