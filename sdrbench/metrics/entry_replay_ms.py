"""entry_replay_ms: host milliseconds of the entry call's graph replay
(the program's span ``entry.replay``: ``graph.replay()`` and the launch
count), mean over the blocks the program traced with no profiler running
(``cutesdr_tpu_torch.metrics``; the window's untraced tail, as
``submit_ms``)."""

UNIT = "ms"
LAYER = "entry"
MOVES = "block_p95_ms"


def read(ctx):
    from cutesdr_tpu_torch import metrics
    mean_ms = getattr(metrics, "mean_ms", None)
    return None if mean_ms is None else mean_ms("entry.replay")
