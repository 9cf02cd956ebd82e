"""The biquad (direct form 2) in one launch (kernel N2, ``csrc/iir.cu``).

    w[n] = x[n] - a1*w[n-1] - a2*w[n-2]
    y[n] = b0*w[n] + b1*w[n-1] + b2*w[n-2]

The JAX package solves it as a ``lax.associative_scan`` of 2x2 affine
maps (``cutesdr_tpu/ops/iir.py``); it has no Pallas kernel.  The plain
version here (``biquad_plain``) is that prefix as a Hillis-Steele scan in
torch ops (``_second_order_recurrence``), the form every CPU tensor takes.
CUDA tensors launch the kernel: real float32 rows [..., n] with one
(w[-1], w[-2]) per row, one launch for all rows (a chunked scan of the
2x2 maps with a one-pass look-back, ``csrc/iir.cu``).  A complex block
(``ops/iir.init(complex_input=True)``; no path of the port calls it)
filters its real and imaginary planes as two rows of the same launch,
since the coefficients are real.

Returns (y, w[n-1], w[n-2]): the output series and the row's new state.
"""

from __future__ import annotations

import numpy as np
import torch

from cutesdr_tpu_torch.kernels import LAUNCHES, _build, scan
from cutesdr_tpu_torch.types import RDTYPE


def _second_order_recurrence(a1, a2, x: torch.Tensor, w1_0, w2_0):
    """Parallel solve of w[n] = x[n] - a1*w[n-1] - a2*w[n-2]; returns the
    w[n] and w[n-1] series.  With the state s[n] = [w[n], w[n-1]] the
    recurrence is the affine map s[n] = A s[n-1] + [x[n], 0], A = [[-a1,
    -a2], [1, 0]]; each step folds the prefix ending ``s`` samples earlier
    (f) into every element (g): g after f is (A_g A_f, A_g b_f + b_g).
    The matrices stay real; b takes x's dtype."""
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


def biquad_plain(x: torch.Tensor, coefs, w1: torch.Tensor, w2: torch.Tensor):
    """(y, w[n-1], w[n-2]) of the biquad with ``coefs`` = (b0, b1, b2, a1,
    a2) over the last axis of ``x``, from (w[-1], w[-2]) = (w1, w2)."""
    b0, b1, b2, a1, a2 = (float(c) for c in coefs)
    w0, w1s = _second_order_recurrence(a1, a2, x, w1, w2)
    w2s = torch.cat([w2.unsqueeze(-1).to(w1s.dtype), w1s[..., :-1]],
                    -1)                                           # w[n-2]
    y = b0 * w0 + b1 * w1s + b2 * w2s
    return y, w0[..., -1], w1s[..., -1]


def biquad(x: torch.Tensor, coefs, w1: torch.Tensor, w2: torch.Tensor):
    """``biquad_plain`` for CPU tensors; one launch of N2 for CUDA ones
    (real float32 or complex64 ``x`` of [n] or [..., n] rows, ``w1``,
    ``w2`` of its leading shape)."""
    if _build.on_cpu(x, w1, w2):
        return biquad_plain(x, coefs, w1, w2)
    if x.is_complex():
        planes = lambda t: torch.stack([t.real, t.imag])
        y, f1, f2 = biquad(planes(x), coefs, planes(w1), planes(w2))
        return (torch.complex(y[0], y[1]), torch.complex(f1[0], f1[1]),
                torch.complex(f2[0], f2[1]))
    lead, n = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, n).to(RDTYPE).contiguous()
    rows = x2.shape[0]
    states = [t.to(RDTYPE).reshape(-1).expand(rows).contiguous()
              for t in (w1, w2)]
    y = torch.empty_like(x2)
    w_out = torch.empty(2, rows, dtype=RDTYPE, device=x.device)
    b0, b1, b2, a1, a2 = (float(np.float32(c)) for c in coefs)
    lib = _build.library()
    _build.check(scan._launch_chained(x2, rows, n, 1, lambda *lb: (
        lib.cutesdr_biquad(
            x2.data_ptr(), a1, a2, b0, b1, b2, states[0].data_ptr(),
            states[1].data_ptr(), n, rows, scan._aligned(x2, y),
            y.data_ptr(), w_out.data_ptr(), *lb, _build.stream(x2)))),
        "biquad")
    LAUNCHES["biquad"] += 1
    return y.reshape(x.shape), w_out[0].reshape(lead), w_out[1].reshape(lead)
