"""submit_ms: host milliseconds of the entry call (``process_planes``), the
benchmark's own span, mean over the window's untraced blocks."""

UNIT = "ms"
LAYER = "entry"
MOVES = "block_p95_ms"


def read(ctx):
    s = ctx.spans.get("submit") or []
    return 1e3 * sum(s) / len(s) if s else None
