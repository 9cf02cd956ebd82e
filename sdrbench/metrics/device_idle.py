"""device_idle: percent of the traced run's untraced blocks (after the
profiler stops) in which the card's compute stream waited for the host
between blocks, from timed CUDA events around each block's work.  The
profiled part is left out: the profiler's cost on the host paces it."""

UNIT = "%"
LAYER = "device"
MOVES = "msps"


def read(ctx):
    idle, timed = ctx.stream_idle
    if timed <= 0:
        return None
    return 100.0 * idle / timed
