"""device_ops: kernels and copies on the device a block in the traced
window."""

UNIT = "ops/block"
LAYER = "step_graph"
MOVES = "msps"


def read(ctx):
    n = ctx.device_items()
    return n / ctx.blocks if n else None
