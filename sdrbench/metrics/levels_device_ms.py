"""levels_device_ms: device milliseconds a block of the levels' kernels
(the AGC's solves and fallback, the S-meter, the AGC's window peak)."""

UNIT = "ms"
LAYER = "levels"
MOVES = "msps"


def read(ctx):
    t = ctx.device_s(LAYER)
    return None if t is None else 1e3 * t / ctx.blocks
