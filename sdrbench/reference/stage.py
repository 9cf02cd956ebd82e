"""What the reference's chain and its parts share: the precisions, TF32
rounding, the rates a part is built at, and the base of a part.

A part (``reference/parts/``) is one stage of the chain: ``input`` (the
raw planes at the input rate, before DC cal), ``levels`` (the filtered
rows to the levelled rows) or ``demod`` (the levelled rows to audio).
It is built from ``(rx, rates, precision, device)``: the configuration's
``receiver`` dict, the chain's ``Rates``, ``"float64"`` or ``"tf32"``, and
the device its heavy work runs on.  Its call works the whole span of
blocks ``b0 .. b`` from a cold state, and ``warm_s`` is the longest
memory it has, in seconds of signal: the chain's warm-up covers the
largest of its parts'.

In the control (``"tf32"``) a part rounds every intermediate value to
TF32's 10-bit mantissa, as the chain does with ``_r``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

PRECISIONS = ("float64", "tf32")


def round_tf32(x):
    """``x`` (float32, numpy or torch) rounded to TF32: 10 mantissa bits,
    to nearest, ties to even."""
    if isinstance(x, torch.Tensor):
        b = x.contiguous().view(torch.int32)
        b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
        return b.view(torch.float32)
    a = np.ascontiguousarray(x, np.float32)
    b = a.view(np.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(np.float32)


def tf32_scalar(x: float) -> float:
    """A Python float rounded to TF32's 11 significant bits, to nearest,
    ties to even (from float64 directly: the host loops' form of
    ``round_tf32``)."""
    m, e = math.frexp(x)
    return math.ldexp(round(m * 2048.0) / 2048.0, e)


@dataclass(frozen=True)
class Rates:
    """The rates and block lengths of a chain: input and demodulated
    samples a second, input and demodulated samples a block.  A span
    always starts at a block's first sample."""
    input: float
    output: float
    block: int
    block_out: int


class Part:
    """The base of a part: its rates, precision and dtype, and ``_r``, a
    value as the precision keeps it.  A part's tensors stay on the device
    of those it is called with."""

    warm_s = 0.0

    def __init__(self, rx: dict, rates: Rates, precision: str, device):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.rates = rates
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64

    def _r(self, x):
        """A value as the precision keeps it (TF32 rounding in the
        control, else itself)."""
        return round_tf32(x) if self.tf32 else x
