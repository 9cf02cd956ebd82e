"""setup_graph_s: seconds of set-up in the entry's CUDA graphs: the
warm-up step before each capture (cuFFT plans, cached tables, look-back
memory) and the capture, the program's set-up spans ``setup.warmup`` and
``setup.capture`` summed over every graph the process built
(``cutesdr_tpu_torch.metrics``)."""

UNIT = "s"
LAYER = "setup"
MOVES = "setup_s"


def read(ctx):
    from cutesdr_tpu_torch import metrics
    total_s = getattr(metrics, "total_s", None)
    if total_s is None:
        return None
    parts = [t for t in (total_s("setup.warmup"), total_s("setup.capture"))
             if t is not None]
    return sum(parts) if parts else None
