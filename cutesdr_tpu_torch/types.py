"""Common dtypes, constants and device helpers of the PyTorch port.

The constants are the JAX package's own (``cutesdr_tpu/types.py`` is
numpy-only), so both packages calibrate to the same full scale.  The port
runs in float32 / complex64 throughout; there is no float64 "golden" mode.
Parameters the JAX package keeps as float32 device scalars are host
``np.float32`` values here, so host arithmetic on them rounds like the
device's.
"""

from __future__ import annotations

import numpy as np
import torch

from cutesdr_tpu.types import K_2PI, K_PI, MAX_AMPLITUDE

__all__ = ["K_2PI", "K_PI", "MAX_AMPLITUDE", "RDTYPE", "CDTYPE",
           "real_scalar", "complex_tensor"]

RDTYPE = torch.float32
CDTYPE = torch.complex64


def real_scalar(v, device) -> torch.Tensor:
    """0-dim float32 tensor on ``device`` (carried levels, time offsets)."""
    return torch.tensor(float(np.float32(v)), dtype=RDTYPE, device=device)


def complex_tensor(a, device) -> torch.Tensor:
    """Host complex array -> complex64 tensor on ``device`` (a copy)."""
    return torch.tensor(np.asarray(a, np.complex64), device=device)
