"""Impulse noise blanker (port of ``cutesdr_tpu/ops/noiseblanker.py``).

Reference analogue: CNoiseProc (dsp/noiseproc.cpp:121-176): magnitude
peak -> 5 ms moving average -> when mag*Ratio exceeds the moving sum, zero
the next ``width`` samples of a Width/2-delayed signal path.  As in the JAX
package everything is parallel: the moving sum is a cumulative-sum
difference, the countdown is a dilation of the trigger sequence (the
sliding maximum over ``width`` samples), the delay line a slice of
[tail | block].

The reference's quirky effective windows are kept exactly: the magnitude
average spans mag_samples+1 samples and the delay is delay_samples+1 (its
ring buffers wrap one slot late).  The ``SampleRate==SampleRate``
self-compare of its change detection (dsp/noiseproc.cpp:82) is not
replicated.

``process_planes`` takes the float32 re/im planes the receiver's front end
works on; ``process_int16`` the radio's int16 planes, as the graphed
receiver holds them (one launch of K10, ``kernels/blanker``: the moving sum
in integers, exact, and int16 planes out; on the CPU its plain version);
``process`` a complex block; ``process_with_history`` the
stateless form over [history | block] that the time-sharded receiver
runs.  The carry is the JAX package's:
magnitude and trigger histories and the complex delay-line tail.  A
leading axis is a bank of streams.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from cutesdr_tpu_torch.kernels import blanker
from cutesdr_tpu_torch.ops.util import moving_sum, sliding_window_max
from cutesdr_tpu_torch.types import CDTYPE, RDTYPE

MAX_WIDTH = 4096
MAGAVE_TIME = 0.005


@dataclass(frozen=True)
class BlankerConfig:
    on: bool
    threshold: float        # 0..99 UI scale
    width_usec: float       # impulse blanking width, microseconds
    sample_rate: float

    @property
    def width_samples(self) -> int:
        return max(1, min(int(self.width_usec * 1e-6 * self.sample_rate),
                          MAX_WIDTH))

    @property
    def mag_samples(self) -> int:
        return int(MAGAVE_TIME * self.sample_rate)

    @property
    def delay_samples(self) -> int:
        return self.width_samples // 2

    @property
    def ratio(self) -> float:
        return 0.005 * self.threshold * self.mag_samples


class BlankerCarry(NamedTuple):
    mag_tail: torch.Tensor    # [mag_samples] magnitude history
    trig_tail: torch.Tensor   # [width_samples-1] trigger history
    sig_tail: torch.Tensor    # [delay_samples+1] complex64 input history


def init_carry(cfg: BlankerConfig, device) -> BlankerCarry:
    return BlankerCarry(
        mag_tail=torch.zeros(cfg.mag_samples, dtype=RDTYPE, device=device),
        trig_tail=torch.zeros(cfg.width_samples - 1, dtype=RDTYPE,
                              device=device),
        sig_tail=torch.zeros(cfg.delay_samples + 1, dtype=CDTYPE,
                             device=device))


def history_len(cfg: BlankerConfig) -> int:
    """Raw-sample history needed to compute one output exactly: the delayed
    signal path reaches back delay+1 samples, and the trigger for the oldest
    dilation position needs a further mag-window of history."""
    return max(cfg.delay_samples + 1,
               (cfg.width_samples - 1) + (cfg.mag_samples + 1))


def process_with_history(cfg: BlankerConfig, z: torch.Tensor,
                         n: int) -> torch.Tensor:
    """Stateless form over the complex64 z = [history | block]: the last
    ``n`` outputs, exact where the history holds ``history_len`` samples.
    The time-sharded receiver gives it a neighbour shard's tail as the
    history in place of the carried tails."""
    if not cfg.on:
        return z[..., z.shape[-1] - n:]
    total = z.shape[-1]
    mag = torch.maximum(z.real.abs(), z.imag.abs())
    # the moving sum at every position the dilation can see
    need = n + cfg.width_samples - 1
    wm = cfg.mag_samples + 1
    c = torch.cumsum(mag[..., total - (need + wm - 1):], -1)
    c = torch.cat([c.new_zeros(c.shape[:-1] + (1,)), c], -1)
    sums = c[..., wm:] - c[..., :-wm]
    trig = (mag[..., total - need:] * cfg.ratio > sums).to(RDTYPE)
    blank, _ = sliding_window_max(trig[..., cfg.width_samples - 1:],
                                  cfg.width_samples,
                                  trig[..., :cfg.width_samples - 1])
    delayed = z[..., total - n - (cfg.delay_samples + 1):
                total - (cfg.delay_samples + 1)]
    return torch.where(blank > 0.5, delayed.new_zeros(()), delayed)


def _gate(cfg: BlankerConfig, carry: BlankerCarry, re: torch.Tensor,
          im: torch.Tensor):
    """The blanker's carry', keep mask and delayed planes of one block."""
    n = re.shape[-1]
    mag = torch.maximum(re.abs(), im.abs())
    mag_sum, mag_tail = moving_sum(mag, cfg.mag_samples + 1, carry.mag_tail)
    trig = (mag * cfg.ratio > mag_sum).to(RDTYPE)
    blank, trig_tail = sliding_window_max(trig, cfg.width_samples,
                                          carry.trig_tail)
    zr = torch.cat([carry.sig_tail.real, re], -1)      # delay line
    zi = torch.cat([carry.sig_tail.imag, im], -1)
    carry = BlankerCarry(mag_tail=mag_tail, trig_tail=trig_tail,
                         sig_tail=torch.complex(zr[..., n:], zi[..., n:]))
    return carry, blank <= 0.5, zr[..., :n], zi[..., :n]


def process_planes(cfg: BlankerConfig, carry: BlankerCarry, re: torch.Tensor,
                   im: torch.Tensor):
    """One block as float32 planes: returns (carry', re', im') with the
    blanked samples zero and the output delayed by delay_samples+1."""
    if not cfg.on:
        return carry, re, im
    carry, keep, zr, zi = _gate(cfg, carry, re, im)
    zero = zr.new_zeros(())
    return carry, torch.where(keep, zr, zero), torch.where(keep, zi, zero)


def process_int16(cfg: BlankerConfig, carry: BlankerCarry, re: torch.Tensor,
                  im: torch.Tensor):
    """One block as int16 planes: returns (carry', re', im') with re', im'
    int16, the blanked samples zero and the output delayed by
    delay_samples+1.  The same blanker as ``process_planes`` with its sums
    exact: where ``process_planes``' float32 sums are exact too, the same
    samples are blanked and the outputs are its outputs' values."""
    if not cfg.on:
        return carry, re, im
    out_re, out_im, mag, trig, sig = blanker.blank_int16(
        re, im, carry.mag_tail, carry.trig_tail, carry.sig_tail,
        cfg.mag_samples, cfg.width_samples, cfg.ratio)
    return BlankerCarry(mag_tail=mag, trig_tail=trig, sig_tail=sig), \
        out_re, out_im


def process_joined(cfg: BlankerConfig, carry: BlankerCarry,
                   re: torch.Tensor, im: torch.Tensor):
    """``process_planes`` with the two output planes written into one
    complex64 block: returns (carry', blanked block); its ``.real`` and
    ``.imag`` views are the planes ``process_planes`` returns."""
    if not cfg.on:
        return carry, torch.complex(re, im)
    carry, keep, zr, zi = _gate(cfg, carry, re, im)
    zero = zr.new_zeros(())
    y = torch.empty(zr.shape, dtype=CDTYPE, device=zr.device)
    planes = torch.view_as_real(y)
    torch.where(keep, zr, zero, out=planes[..., 0])
    torch.where(keep, zi, zero, out=planes[..., 1])
    return carry, y


def process(cfg: BlankerConfig, carry: BlankerCarry, x: torch.Tensor):
    """One complex64 block: returns (carry', blanked block)."""
    if not cfg.on:
        return carry, x
    return process_joined(cfg, carry, x.real, x.imag)
