"""A train of impulses, as a spark ignition puts on a band (a four-cylinder
engine at 3,000 rpm sparks 100 times a second): pulses at ``rate_hz``,
rounded to a whole number over the capture and spread evenly over it,
each ``width_us`` long at peak ``level_dbfs``, ringing at ``carrier_hz``
from its start (0: a baseband pulse).  A level at full scale is clipped
by the generator's int16 clamp with what it lands on.

The seed draws nothing: every seed gives the same train, and so the same
work to a blanker.  Pulse j of K over N samples starts at floor(j N / K).
"""

from __future__ import annotations

import math

import torch

FULL_SCALE = 32767.0


class Station:

    def __init__(self, count: int, width: int, amp: float, step: float,
                 n: int):
        self.count, self.width, self.amp, self.step, self.n = \
            count, width, amp, step, n

    def fixed(self):
        return self.count, self.width, self.amp, self.step

    def __call__(self, idx: torch.Tensor):
        m = torch.remainder(idx, self.n)
        j = ((m + 1) * self.count - 1) // self.n     # the last pulse begun
        off = m - (j * self.n) // self.count
        on = off < self.width
        ang = off.double() * self.step
        zero = ang.new_zeros(())
        return (torch.where(on, self.amp * torch.cos(ang), zero),
                torch.where(on, self.amp * torch.sin(ang), zero))


def parts(st: dict, rate: float, n: int, rng) -> Station:
    count = max(1, int(round(float(st["rate_hz"]) * n / rate)))
    width = max(1, int(round(float(st["width_us"]) * 1e-6 * rate)))
    if width >= n // count:
        raise ValueError(f"pulses of {width} samples overlap at "
                         f"{count} over {n} samples")
    amp = FULL_SCALE * 10.0 ** (float(st["level_dbfs"]) / 20.0)
    step = 2.0 * math.pi * float(st["carrier_hz"]) / rate
    return Station(count, width, amp, step, n)
