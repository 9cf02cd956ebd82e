"""blanker_roofline: the least time of the impulse noise blanker's work at
the cell's shapes (``blanker_work.blanker`` over the card's peaks: the
int16 planes read once, the blanked planes written once, the magnitude
history), as a percent of the device time its kernel (K10) takes a block.
None where the kernel did not run."""

from sdrbench import blanker_work, work

UNIT = "%"
LAYER = "blanker"
MOVES = "msps"


def read(ctx):
    t = ctx.device_s(LAYER)
    if not t:
        return None
    least = work.least_s(*blanker_work.blanker(ctx.shapes))
    return 100.0 * least * ctx.blocks / t
