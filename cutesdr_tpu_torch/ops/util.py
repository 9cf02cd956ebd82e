"""Shared helpers for the ops layer (port of ``cutesdr_tpu/ops/util.py``).

The JAX package solves its linear and max-affine recurrences with
``lax.associative_scan``; here they are a plain log-depth Hillis-Steele
prefix written in torch ops.  These are the plain versions behind the
scan kernels (``cutesdr_tpu_torch/kernels/scan.py``) and the path every
call below the kernels' size gate takes, on either device.
"""

from __future__ import annotations

import torch


def strided_corr(z: torch.Tensor, taps: torch.Tensor, stride: int = 1,
                 offset: int = 0) -> torch.Tensor:
    """y[..., n] = sum_j taps[j] * z[..., n*stride + offset + j] (VALID).

    Real dtypes only.  A ``conv1d`` (cross-correlation, no flip) pinned to
    full float32: cuDNN runs float32 convolutions in TF32 by default,
    which keeps ~3 decimal digits — the JAX side asks for HIGHEST."""
    if offset:
        z = z[..., offset:]
    batch = z.shape[:-1]
    zb = z.reshape(-1, 1, z.shape[-1])
    k = taps.to(z.dtype).reshape(1, 1, -1)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = torch.nn.functional.conv1d(zb, k, stride=stride)
    return y.reshape(batch + (y.shape[-1],))


def complex_strided_corr(z: torch.Tensor, taps: torch.Tensor,
                         stride: int = 1, offset: int = 0) -> torch.Tensor:
    """``strided_corr`` of complex ``z`` with real taps: both planes in
    one batched real convolution."""
    y = strided_corr(torch.stack([z.real, z.imag]), taps, stride, offset)
    return torch.complex(y[0], y[1])


def affine_prefix(a: torch.Tensor, b: torch.Tensor):
    """Inclusive prefix of the affine maps x -> a[n]*x + b[n] along the
    last axis: returns (A, B) with x[n] = A[n]*x[-1] + B[n].

    Maps compose as (l then r) = (l.a*r.a, r.a*l.b + r.b): each step folds
    the prefix ending ``s`` samples earlier into every element."""
    n = a.shape[-1]
    s = 1
    while s < n:
        b = torch.cat([b[..., :s], a[..., s:] * b[..., :-s] + b[..., s:]], -1)
        a = torch.cat([a[..., :s], a[..., s:] * a[..., :-s]], -1)
        s *= 2
    return a, b


def _initial(s0, u: torch.Tensor) -> torch.Tensor:
    """An initial state (a scalar, or one per row of ``u``) as a column
    that broadcasts against ``u``'s last axis."""
    return torch.as_tensor(s0, device=u.device).unsqueeze(-1)


def first_order_recurrence(alpha, u: torch.Tensor, s0) -> torch.Tensor:
    """Log-depth solve of s[n] = alpha*s[n-1] + u[n], s[-1] = s0, along the
    last axis.  ``alpha`` is a scalar or a per-sample tensor; ``s0`` a
    scalar or one value per row."""
    a = torch.as_tensor(alpha, dtype=u.dtype, device=u.device)
    A, B = affine_prefix(a.expand(u.shape), u)
    return A * _initial(s0, u) + B


def ema(alpha, x: torch.Tensor, init) -> torch.Tensor:
    """Exponential moving average y[n] = (1-a)*y[n-1] + a*x[n]."""
    return first_order_recurrence(1.0 - alpha, x * alpha, init)


def max_affine_recurrence(c, u: torch.Tensor, v, s0) -> torch.Tensor:
    """Log-depth solve of s[n] = max(c[n]*s[n-1] + u[n], v[n]), s[-1] = s0.

    Maps x -> max(c*x + u, v) with c >= 0 compose as
    (l then r) = (l.c*r.c, r.c*l.u + r.u, max(r.c*l.v + r.u, r.v))."""
    c = torch.as_tensor(c, dtype=u.dtype, device=u.device).expand(u.shape)
    v = torch.as_tensor(v, dtype=u.dtype, device=u.device).expand(u.shape)
    n = u.shape[-1]
    s = 1
    while s < n:
        cs = c[..., s:]
        v = torch.cat([v[..., :s],
                       torch.maximum(cs * v[..., :-s] + u[..., s:],
                                     v[..., s:])], -1)
        u = torch.cat([u[..., :s], cs * u[..., :-s] + u[..., s:]], -1)
        c = torch.cat([c[..., :s], cs * c[..., :-s]], -1)
        s *= 2
    return torch.maximum(c * _initial(s0, u) + u, v)


def distance_since_last_true(flags: torch.Tensor,
                             init_distance) -> torch.Tensor:
    """For each n, the samples since ``flags`` was last True (0 at a True
    sample); positions before any True count on from ``init_distance``
    (the carry of the previous block; a scalar or one per row).  int32."""
    n = flags.shape[-1]
    idx = torch.arange(1, n + 1, dtype=torch.int32, device=flags.device)
    # a virtual last True before the block, at index -init_distance
    start = -_initial(init_distance, flags).to(torch.int32)
    last = torch.cummax(torch.where(flags, idx, start), -1).values
    return idx - last


def sliding_window_max(x: torch.Tensor, window: int,
                       init_tail: torch.Tensor):
    """Max over the trailing ``window`` samples (current one included) for
    every position of ``x``; ``init_tail`` is the window-1 history.
    Returns (per-sample maxima, new tail).

    Van Herk / Gil-Werman: a block-wise prefix and suffix ``cummax`` give
    every sliding maximum in O(1) work per sample whatever the window."""
    w = int(window)
    z = torch.cat([init_tail, x], -1)                # n + w - 1 samples
    new_tail = z[..., z.shape[-1] - (w - 1):].clone() if w > 1 \
        else z[..., :0]
    if w == 1:
        return x, new_tail
    n = x.shape[-1]
    pad = (-z.shape[-1]) % w
    zp = torch.cat([z, z.new_full(z.shape[:-1] + (pad,), -torch.inf)], -1)
    blocks = zp.reshape(zp.shape[:-1] + (-1, w))
    pre = torch.cummax(blocks, -1).values.reshape(zp.shape)
    suf = torch.cummax(blocks.flip(-1), -1).values.flip(-1).reshape(zp.shape)
    # window [i, i+w-1] spans at most two blocks: a suffix, then a prefix
    y = torch.maximum(suf[..., :n], pre[..., w - 1:w - 1 + n])
    return y, new_tail


def moving_sum(x: torch.Tensor, window: int, init_tail: torch.Tensor):
    """Sum over the trailing ``window`` samples (current one included) for
    every position of ``x``, by cumulative-sum difference; ``init_tail``
    is the window-1 history.  Returns (per-sample sums, new tail)."""
    z = torch.cat([init_tail, x], -1)
    c = torch.cumsum(z, -1)
    c = torch.cat([c.new_zeros(z.shape[:-1] + (1,)), c], -1)
    n, w = x.shape[-1], int(window)
    return c[..., w:w + n] - c[..., :n], z[..., z.shape[-1] - (w - 1):].clone()
