"""Common dtypes, constants and device helpers of the PyTorch port.

The constants are declared here with the JAX package's values
(``cutesdr_tpu/types.py``), so both packages calibrate to the same full
scale; a test holds them equal.  The port
runs in float32 / complex64 throughout; there is no float64 "golden" mode.
Parameters the JAX package keeps as float32 device scalars are host
``np.float32`` values here, so host arithmetic on them rounds like the
device's.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["K_2PI", "K_PI", "MAX_AMPLITUDE", "RDTYPE", "CDTYPE",
           "real_scalar", "complex_tensor", "resolve_device"]

K_PI = 3.14159265358979323846
K_2PI = 2.0 * K_PI
# full scale of the 16-bit A/D convention (dsp/agc.cpp:69, dsp/smeter.cpp:47)
MAX_AMPLITUDE = 32767.0

RDTYPE = torch.float32
CDTYPE = torch.complex64


def real_scalar(v, device) -> torch.Tensor:
    """0-dim float32 tensor on ``device`` (carried levels, time offsets)."""
    return torch.tensor(float(np.float32(v)), dtype=RDTYPE, device=device)


def complex_tensor(a, device) -> torch.Tensor:
    """Host complex array -> complex64 tensor on ``device`` (a copy)."""
    return torch.tensor(np.asarray(a, np.complex64), device=device)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  The entry points default to
    "cuda"; without a CUDA device that raises rather than falling back to
    the CPU, which only a caller who asks for it gets."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return device
