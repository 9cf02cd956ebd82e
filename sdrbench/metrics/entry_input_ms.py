"""entry_input_ms: host milliseconds of the entry call's input part (the
program's span ``entry.input``: the block's fit and the int16 planes'
copies into the graph's static block, enqueued), mean over the blocks
the program traced with no profiler running (``cutesdr_tpu_torch.
metrics``; the window's untraced tail, as ``submit_ms``)."""

UNIT = "ms"
LAYER = "entry"
MOVES = "block_p95_ms"


def read(ctx):
    from cutesdr_tpu_torch import metrics
    mean_ms = getattr(metrics, "mean_ms", None)
    return None if mean_ms is None else mean_ms("entry.input")
