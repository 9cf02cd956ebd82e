"""entry_self_ms: host milliseconds of the entry call outside its three
parts (the program's span ``entry`` less ``entry.input``,
``entry.replay`` and ``entry.outputs``: the planes' move to the device,
the graph rule and the graph's key), mean over the blocks the program
traced with no profiler running: the window's untraced tail, which
``submit_ms`` reads too (``cutesdr_tpu_torch.metrics``, tracing on from
the first entry call under the profiler)."""

UNIT = "ms"
LAYER = "entry"
MOVES = "block_p95_ms"


def read(ctx):
    from cutesdr_tpu_torch import metrics
    self_ms = getattr(metrics, "self_ms", None)
    return None if self_ms is None else self_ms("entry")
