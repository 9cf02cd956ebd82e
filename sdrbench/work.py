"""The work of each layer at a cell's shapes, and the least time the card
could do it in.

The counts come from the cell's configuration and traffic alone (through
``reference.design``), never from a kernel, so a layer reads the same
work whatever kernel implements it.  Each input byte is counted read
once and each output byte written once; operations are float32
operations (a multiply-add is two), counted for the cheapest form of the
layer's function that is known here, so the least time is a lower bound
and a share of it cannot pass 100% unless the time is short of the work.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet):
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from sdrbench.reference import design

HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
C8 = 8          # bytes of a complex64 sample
F4 = 4          # bytes of a float32 sample


@dataclass(frozen=True)
class Shapes:
    """A cell's shapes: the block, the channels and the chain's sizes."""
    block: int              # input samples a block
    channels: int
    input_rate: float
    mode: str
    nfft: int
    ntaps: int
    audio_rate: float | None
    periods: int

    @property
    def decimation(self) -> int:
        return 1 << len(design.stages(self.input_rate, self.mode))

    @property
    def demod(self) -> int:
        """Demodulated samples a block, each channel."""
        return self.block // self.decimation


def shapes(config: dict, traffic: dict) -> Shapes:
    rx = config["receiver"]
    ch = config.get("channels")
    return Shapes(block=int(traffic["block_samples"]),
                  channels=int(ch["count"]) if ch else 1,
                  input_rate=float(rx["input_rate"]), mode=rx["mode"],
                  nfft=int(rx["fastfir_nfft"]), ntaps=int(rx["fastfir_ntaps"]),
                  audio_rate=rx.get("audio_rate"),
                  periods=int(rx["resampler_periods"]))


def least_s(nbytes: float, flops: float) -> float:
    """The least seconds for work that moves ``nbytes`` and does
    ``flops``: the larger of the two over the card's peaks."""
    return max(nbytes / HBM_BYTES_S, flops / F32_FLOP_S)


def front_end(s: Shapes) -> tuple[float, float]:
    """(bytes, flops) of DC cal + NCO mix + decimation of one block: the
    complex input read once (shared by a bank's channels), each channel's
    input history read once and its decimated block written once; a
    complex multiply
    (6) an input sample a channel, and the half-band cascade's
    multiply-adds (4 a non-zero real tap on a complex sample) at each
    stage's output rate."""
    names = design.stages(s.input_rate, s.mode)
    n_out = s.demod
    macs = 0
    for k, name in enumerate(names):
        taps = sum(1 for v in design.stage_taps(name) if v != 0.0)
        macs += taps * n_out * (1 << (len(names) - 1 - k))
    hist = len(design.decimator(s.input_rate, s.mode)[0]) - 1
    nbytes = s.block * C8 + s.channels * (hist * C8 + n_out * C8)
    flops = s.channels * (6 * s.block + 4 * macs)
    return float(nbytes), float(flops)


def channel_filter(s: Shapes) -> tuple[float, float]:
    """(bytes, flops) of the overlap-save filter of one block: each
    channel's tail, block and response read once and its filtered block
    written once; a forward and an inverse FFT (4 N log2 N each, the
    split-radix count's leading term) and the complex product (6 N) a
    frame."""
    tail = s.ntaps - 1
    frames = s.demod // (s.nfft - tail)
    nbytes = s.channels * ((tail + 2 * s.demod) * C8 + s.nfft * C8)
    flops = s.channels * frames * (8 * s.nfft * math.log2(s.nfft)
                                   + 6 * s.nfft)
    return float(nbytes), float(flops)


def resampler(s: Shapes) -> tuple[float, float]:
    """(bytes, flops) of the resampler of one block: each channel's real
    demodulated block and history read once and its audio written once;
    a multiply-add a tap of each output."""
    if s.audio_rate is None:
        return 0.0, 0.0
    fs_out = s.input_rate / s.decimation
    outputs = s.demod * float(s.audio_rate) / fs_out
    nbytes = s.channels * ((s.periods + s.demod) * F4 + outputs * F4)
    flops = s.channels * outputs * s.periods * 2
    return float(nbytes), float(flops)
