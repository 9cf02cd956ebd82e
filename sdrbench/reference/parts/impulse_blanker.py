"""The impulse noise blanker (CuteSDR's CNoiseProc, dsp/noiseproc.cpp:
121-176, SURVEY.md's row), on the raw planes at the input rate, before
DC cal.

Sample by sample: the magnitude is max(|I|, |Q|); a moving sum runs
over the last 5 ms of magnitudes; a sample triggers where magnitude
times ``Ratio`` exceeds the sum, ``Ratio = 0.005 * threshold *
mag_samples``; a trigger zeroes the next ``Width`` samples of a delayed
copy of the input, and the delayed copy is the output.  Two of
CNoiseProc's ring buffers wrap one slot late (the moving sum's, :142-147,
and the delay line's): its sum spans ``mag_samples + 1`` magnitudes and
its delay is ``Width / 2 + 1`` samples, and so do this part's.  Its
change detection's ``SampleRate == SampleRate`` self-compare (:82) is a
fault of CuteSDR's and has no counterpart here: the part is built once
for its configuration.

The magnitudes are integer counts, and their sums in float64 stay far
below 2^53, so every trigger is exact.  The part runs in whole-span
tensor operations on ``device``: the sums and the blanking (any trigger
among the last ``Width`` samples) as differences of cumulative sums.
Cold, it starts with empty histories (zero magnitudes, a zero delay
line), as the stream does.  In the control the magnitude, each sum and
each product are rounded to TF32 (a sum as a box filter over TF32
inputs, its total rounded).
"""

from __future__ import annotations

import torch

from sdrbench.reference.stage import Part as _Part

STAGE = "input"
MAGAVE_S = 0.005          # the moving sum's window (dsp/noiseproc.cpp:53)


def takes(rx: dict) -> bool:
    return bool(rx.get("nb_on", False))


class Part(_Part):

    def __init__(self, rx, rates, precision, device):
        super().__init__(rx, rates, precision, device)
        fs = rates.input
        self.width = max(1, int(float(rx["nb_width_us"]) * 1e-6 * fs))
        self.mag_samples = int(MAGAVE_S * fs)
        self.delay = self.width // 2 + 1
        self.ratio = 0.005 * float(rx["nb_threshold"]) * self.mag_samples
        self.warm_s = (self.mag_samples + 1 + self.width + self.delay) / fs

    def __call__(self, xr: torch.Tensor, xi: torch.Tensor):
        """The blanked planes of the raw planes ``xr``, ``xi`` of a span
        (the same length, delayed by ``delay`` samples)."""
        r = self._r
        n = xr.shape[-1]
        mag = r(torch.maximum(xr.abs(), xi.abs()))
        sums = r(_window_sums(mag.double(), self.mag_samples + 1)
                 .to(self.dtype))
        trig = r(mag * self.ratio) > sums
        blank = _window_sums(trig.double(), self.width) > 0
        pad = (self.delay, 0)
        dr = torch.nn.functional.pad(xr, pad)[..., :n]
        di = torch.nn.functional.pad(xi, pad)[..., :n]
        zero = dr.new_zeros(())
        return torch.where(blank, zero, dr), torch.where(blank, zero, di)


def _window_sums(x: torch.Tensor, window: int) -> torch.Tensor:
    """Sum of the last ``window`` values at each position (fewer at the
    start), float64, as a difference of cumulative sums: exact for
    integer values whose total stays below 2^53."""
    c = torch.nn.functional.pad(torch.cumsum(x, -1), (1, 0))
    lo = torch.clamp(torch.arange(1, x.shape[-1] + 1, device=x.device)
                     - window, min=0)
    return c[..., 1:] - c[..., lo]
