"""input_device_ms: device milliseconds a block of the entry call's input
copies (the int16 planes copied as they are, int16 to int16, into the
graph's static int16 block), from the pair of timing CUDA events the
program records around them on the compute stream while tracing (``cutesdr_tpu_torch.metrics``, the device
span of ``entry.input``), mean over every timed block."""

UNIT = "ms"
LAYER = "input"
MOVES = "msps"


def read(ctx):
    from cutesdr_tpu_torch import metrics
    device_mean_ms = getattr(metrics, "device_mean_ms", None)
    return None if device_mean_ms is None else device_mean_ms("entry.input")
