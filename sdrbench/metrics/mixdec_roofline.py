"""mixdec_roofline: the least time of the work of DC cal + NCO mix +
decimation (K1) at the cell's shapes (``work.front_end`` over the card's
peaks), as a percent of the device time its kernels take a block."""

from sdrbench import work

UNIT = "%"
LAYER = "front_end"
MOVES = "msps"


def read(ctx):
    t = ctx.device_s(LAYER)
    if not t:
        return None
    least = work.least_s(*work.front_end(ctx.shapes))
    return 100.0 * least * ctx.blocks / t
