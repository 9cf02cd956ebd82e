"""step_device_ms: device milliseconds of every kernel and copy in the
traced window, a block."""

UNIT = "ms"
LAYER = "step_graph"
MOVES = "msps"


def read(ctx):
    t = ctx.device_s(LAYER)
    return None if t is None else 1e3 * t / ctx.blocks
