"""fastfir_roofline: the least time of the work of the overlap-save channel
filter (K2/K6) at the cell's shapes (``work.channel_filter`` over the
card's peaks), as a percent of the device time its kernels take a block."""

from sdrbench import work

UNIT = "%"
LAYER = "channel_filter"
MOVES = "msps"


def read(ctx):
    t = ctx.device_s(LAYER)
    if not t:
        return None
    least = work.least_s(*work.channel_filter(ctx.shapes))
    return 100.0 * least * ctx.blocks / t
