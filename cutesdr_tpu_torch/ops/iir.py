"""Biquad IIR filter (direct form 2), solved in parallel (port of
``cutesdr_tpu/ops/iir.py``).

    w0 = x[n] - a1*w1 - a2*w2
    y[n] = b0*w0 + b1*w1 + b2*w2 ;  w2 <- w1 ; w1 <- w0

With the state s[n] = [w[n], w[n-1]] the recurrence is the affine map
s[n] = A s[n-1] + [x[n], 0], A = [[-a1, -a2], [1, 0]], so the block is one
log-depth prefix over (A, b) pairs: the JAX package's
``lax.associative_scan``, here a Hillis-Steele prefix in torch ops like
``util.affine_prefix``.  The matrices stay real; b takes x's dtype, so a
complex x filters both planes with the same real coefficients.  A bank's
[C, n] rows are independent streams with [C] states.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cutesdr_tpu_torch.design.iir_biquad import Biquad
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


def _second_order_recurrence(a1, a2, x: torch.Tensor, w1_0, w2_0):
    """Parallel solve of w[n] = x[n] - a1*w[n-1] - a2*w[n-2]; returns the
    w[n] and w[n-1] series.  Each step folds the prefix ending ``s``
    samples earlier (f) into every element (g): g after f is
    (A_g A_f, A_g b_f + b_g)."""
    n = x.shape[-1]
    full = lambda v: torch.full((n,), float(v), dtype=RDTYPE, device=x.device)
    c00, c01, c10, c11 = full(-a1), full(-a2), full(1.0), full(0.0)
    cb0, cb1 = x, torch.zeros_like(x)
    s = 1
    while s < n:
        f00, f01, f10, f11 = (t[:-s] for t in (c00, c01, c10, c11))
        fb0, fb1 = cb0[..., :-s], cb1[..., :-s]
        g00, g01, g10, g11 = (t[s:] for t in (c00, c01, c10, c11))
        gb0, gb1 = cb0[..., s:], cb1[..., s:]
        keep = lambda t, new: torch.cat([t[..., :s], new], -1)
        c00, c01, c10, c11, cb0, cb1 = (
            keep(c00, g00 * f00 + g01 * f10), keep(c01, g00 * f01 + g01 * f11),
            keep(c10, g10 * f00 + g11 * f10), keep(c11, g10 * f01 + g11 * f11),
            keep(cb0, g00 * fb0 + g01 * fb1 + gb0),
            keep(cb1, g10 * fb0 + g11 * fb1 + gb1))
        s *= 2
    w1_0, w2_0 = w1_0.unsqueeze(-1), w2_0.unsqueeze(-1)
    w0 = c00 * w1_0 + c01 * w2_0 + cb0      # w[n]
    w1 = c10 * w1_0 + c11 * w2_0 + cb1      # w[n-1]
    return w0, w1


def process(params: IirParams, carry: IirCarry,
            x: torch.Tensor) -> tuple[IirCarry, torch.Tensor]:
    b0, b1, b2, a1, a2 = (float(c) for c in params)
    w0, w1 = _second_order_recurrence(a1, a2, x, carry.w1, carry.w2)
    w2 = torch.cat([carry.w2.unsqueeze(-1).to(w1.dtype), w1[..., :-1]],
                   -1)                                            # w[n-2]
    y = b0 * w0 + b1 * w1 + b2 * w2
    return IirCarry(w1=w0[..., -1], w2=w1[..., -1]), y
