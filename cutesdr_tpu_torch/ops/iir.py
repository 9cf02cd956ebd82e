"""Biquad IIR filter (direct form 2), solved in parallel (port of
``cutesdr_tpu/ops/iir.py``).

    w0 = x[n] - a1*w1 - a2*w2
    y[n] = b0*w0 + b1*w1 + b2*w2 ;  w2 <- w1 ; w1 <- w0

With the state s[n] = [w[n], w[n-1]] the recurrence is the affine map
s[n] = A s[n-1] + [x[n], 0], A = [[-a1, -a2], [1, 0]], so the block is one
prefix over (A, b) pairs: the JAX package's ``lax.associative_scan``.
On the card it is one launch of kernel N2 (``kernels/iir.biquad``, a
chunked scan of the 2x2 maps), on the CPU its plain version, a
Hillis-Steele prefix in torch ops like ``util.affine_prefix``.  The
matrices stay real, so a complex x (``init(complex_input=True)``, which
no path of the port takes) filters both planes with the same real
coefficients: on the card as two rows of the same launch.  A bank's
[C, n] rows are independent streams with [C] states.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cutesdr_tpu_torch.design.iir_biquad import Biquad
from cutesdr_tpu_torch.kernels import iir as iir_k
from cutesdr_tpu_torch.types import CDTYPE, RDTYPE


class IirParams(NamedTuple):
    b0: np.float32
    b1: np.float32
    b2: np.float32
    a1: np.float32
    a2: np.float32


class IirCarry(NamedTuple):
    w1: torch.Tensor        # 0-dim, real or complex
    w2: torch.Tensor


def init(coefs: Biquad, device,
         complex_input: bool = False) -> tuple[IirParams, IirCarry]:
    dtype = CDTYPE if complex_input else RDTYPE
    zero = torch.zeros((), dtype=dtype, device=device)
    return (IirParams(*(np.float32(c) for c in coefs)),
            IirCarry(w1=zero, w2=zero.clone()))


def process(params: IirParams, carry: IirCarry,
            x: torch.Tensor) -> tuple[IirCarry, torch.Tensor]:
    y, w1, w2 = iir_k.biquad(x, params, carry.w1, carry.w2)
    return IirCarry(w1=w1, w2=w2), y
