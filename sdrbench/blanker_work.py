"""The work of the impulse noise blanker at a cell's shapes, and the least
time the card could do it in (``work.least_s``), beside ``work.py``'s
layers and counted the same way: from the cell's configuration and
traffic alone (``work.shapes``), each input byte read once and each output
byte written once.

The blanker of a stream of int16 wire planes reads the two planes and
writes the blanked planes at the same width (8 bytes a sample), and reads
and writes its carried magnitude history (the last 5 ms of float32
magnitudes at the input rate).  Its trigger and delay-line tails depend on
the blanking width, which the shapes do not carry; they are left out
(under 1 KB a block at the widths a listener sets), so the least time
stays a lower bound.  Its operations (a max, a sum difference, a compare
and a select a sample) are far below the bytes' time.
"""

from __future__ import annotations

from sdrbench import work
from sdrbench.reference.parts.impulse_blanker import MAGAVE_S

I2 = 2            # bytes of an int16 plane sample


def blanker(s: work.Shapes) -> tuple[float, float]:
    """(bytes, flops) of the blanker over one block of each channel's
    int16 planes."""
    mag_hist = int(MAGAVE_S * s.input_rate)
    nbytes = s.channels * (4 * I2 * s.block + 2 * work.F4 * mag_hist)
    return float(nbytes), 0.0
