"""resamp_roofline: the least time of the work of the banded resampler (K9)
at the cell's shapes (``work.resampler`` over the card's peaks), as a
percent of the device time its kernels take a block."""

from sdrbench import work

UNIT = "%"
LAYER = "tail"
MOVES = "msps"


def read(ctx):
    t = ctx.device_s(LAYER)
    if not t:
        return None
    least = work.least_s(*work.resampler(ctx.shapes))
    return 100.0 * least * ctx.blocks / t
