"""setup_kernels_s: seconds of the kernel library's first load in the
process: the hash of the sources, the nvcc build where the library is
missing, and the load (the program's set-up span ``setup.kernels``,
``cutesdr_tpu_torch.metrics``; ``COUNTERS["setup.kernels_built"]`` says
whether it built)."""

UNIT = "s"
LAYER = "setup"
MOVES = "setup_s"


def read(ctx):
    from cutesdr_tpu_torch import metrics
    total_s = getattr(metrics, "total_s", None)
    return None if total_s is None else total_s("setup.kernels")
