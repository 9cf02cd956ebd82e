"""blanker_device_ms: device milliseconds a block of the impulse noise
blanker's kernel (K10, ``blanker_kernel``: the int16 planes blanked in one
launch).  None where it did not run, as at a program whose blanker is
plain torch operations (their kernels carry the generic names every
layer's glue carries)."""

UNIT = "ms"
LAYER = "blanker"
MOVES = "msps"


def read(ctx):
    t = ctx.device_s(LAYER)
    return None if t is None else 1e3 * t / ctx.blocks
