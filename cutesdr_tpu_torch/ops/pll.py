"""Parallel solves of the second-order type-II PLL loops of the FM and SAM
demodulators (port of ``cutesdr_tpu/ops/pll.py``).

Both loops run the per-sample recurrence

    err   = +-wrap(theta -+ phase)
    freq += beta * err           (clamped to +-limit)
    phase += freq + alpha * err  (wrapped)

While the wrap and the clamp are inactive (the locked condition) it is
exactly linear in x = [e, f]: x[n+1] = A x[n] + [s*psi[n+1], 0] with
A = [[1-a-b, -1], [b, 1]] and psi the wrapped input phase increments, so a
block is a causal FIR of psi with the truncated impulse response A^d
(``solve_locked``).  Where it is not, ``chunked_scan`` evaluates the exact
recurrence as concurrent chunk scans and checks itself bitwise; the
caller falls back to the sequential loop (``kernels/seqloop``) when
neither holds.
"""

from __future__ import annotations

import numpy as np
import torch

from cutesdr_tpu_torch.types import K_2PI

WRAP_MARGIN = 0.98          # |e| < WRAP_MARGIN*pi counts as wrap-free

# float32 2*pi and its reciprocal.  The wrap multiplies by the reciprocal
# rather than dividing: torch on CUDA turns a division by a Python scalar
# into that product anyway, so this form rounds the same on both devices
# and in the CUDA kernels of kernels/seqloop.
TWO_PI = float(np.float32(K_2PI))
INV_2PI = float(np.float32(1.0) / np.float32(K_2PI))


def wrap_pi(e: torch.Tensor) -> torch.Tensor:
    """Wrap radians into [-pi, pi]: e - 2pi*round(e/2pi), round half even
    (the demods' ``_wrap_pi``)."""
    return e - TWO_PI * torch.round(e * INV_2PI)


def locked_loop_kernel(alpha: float, beta: float, tol: float = 1e-12,
                       max_taps: int = 4096) -> np.ndarray:
    """Powers A^d (d = 0..D-1) of the locked-loop state matrix, truncated
    where the spectral decay reaches ``tol``.  float64 host-side constant."""
    A = np.array([[1.0 - alpha - beta, -1.0], [beta, 1.0]], np.float64)
    rho = float(np.max(np.abs(np.linalg.eigvals(A))))
    if rho >= 0.9999:        # loop at/over the stability edge: no truncation
        d = max_taps
    else:
        d = int(np.ceil(np.log(tol) / np.log(rho))) + 2
        d = min(max(d, 8), max_taps)
    K = np.empty((d, 2, 2), np.float64)
    K[0] = np.eye(2)
    for i in range(1, d):
        K[i] = A @ K[i - 1]
    return K


def _conv_causal(u: torch.Tensor, k: torch.Tensor, n: int) -> torch.Tensor:
    """First n samples of the full convolution of u with each row of k
    ([..., d]), in the FFT form the JAX package chose, in float32."""
    d = k.shape[-1]
    L = 1 << int(np.ceil(np.log2(n + d - 1)))
    out = torch.fft.irfft(torch.fft.rfft(u, L) * torch.fft.rfft(k, L), L)
    return out[..., :n].to(u.dtype)


def chunked_scan(step, init, guess, xs: torch.Tensor, chunk: int, halo: int):
    """Guess-verify evaluation of a self-synchronizing scan along the last
    axis of ``xs`` (leading axes are independent streams: a bank).

    ``step(state, x) -> (state', y)`` with ``state`` and ``y`` flat tuples
    of tensors, applied elementwise over a [..., K] batch of chunks.  Pass
    1 runs every chunk from ``guess`` through a ``halo``-sample warmup (the
    tail of the previous chunk) and its own samples; chunk 0 starts from
    the true ``init`` with its warmup frozen.  Pass 2 re-runs every chunk
    from the pass-1 end state of its left neighbour.  The result is exact
    iff every pass-2 end state equals, bitwise, the pass-1 end state the
    right neighbour consumed (induction from chunk 0).  Returns
    (valid, ys, end): ``valid`` a bool tensor per stream, ``ys`` the
    per-sample outputs in time order, ``end`` the final state."""
    n = xs.shape[-1]
    if n % chunk or halo > chunk:
        raise ValueError(f"chunked_scan: n={n} chunk={chunk} halo={halo}")
    K = n // chunk
    lead = xs.shape[:-1]
    main = xs.reshape(lead + (K, chunk))
    halos = torch.cat([xs.new_zeros(lead + (1, halo)),
                       main[..., :-1, chunk - halo:]], -2)
    xs1 = torch.cat([halos, main], -1)                  # [..., K, halo+chunk]
    frozen = torch.zeros(K, dtype=torch.bool, device=xs.device)
    frozen[0] = True

    state = tuple(torch.cat([i.unsqueeze(-1),
                             g.unsqueeze(-1).expand(lead + (K - 1,))], -1)
                  for i, g in zip(init, guess))
    for t in range(halo + chunk):
        new, _ = step(state, xs1[..., t])
        state = tuple(torch.where(frozen, o, s) for o, s in zip(state, new)) \
            if t < halo else new
    e1 = state

    state = tuple(torch.cat([i.unsqueeze(-1), e[..., :-1]], -1)
                  for i, e in zip(init, e1))
    ys = []
    for t in range(chunk):
        state, y = step(state, main[..., t])
        ys.append(y)
    valid = torch.stack([(a[..., :-1] == b[..., :-1]).all(-1)
                         for a, b in zip(e1, state)]).all(0)
    ys = tuple(torch.stack(series, -1).reshape(lead + (n,))
               for series in zip(*ys))
    return valid, ys, tuple(s[..., -1] for s in state)


def solve_locked(kernel: torch.Tensor, beta, limit, e0: torch.Tensor,
                 f0: torch.Tensor, u: torch.Tensor):
    """Solve e[n], f[n] for x[n+1] = A x[n] + [u[n+1], 0], x[0] = [e0, f0],
    along the last axis of ``u`` (leading axes: a bank, with one e0 and f0
    per stream).

    ``u[..., 0] == 0`` by construction (the first sample's error is e0).
    Returns (e, f_next, valid): the error sequence, the post-update
    frequencies f[n+1] = f[n] + beta*e[n], and the exactness flag (a bool
    tensor per stream)."""
    n = u.shape[-1]
    out = _conv_causal(u.unsqueeze(-2), kernel[:, :, 0].T, n)   # [..., 2, n]
    e, f = out[..., 0, :], out[..., 1, :]
    d = min(kernel.shape[0], n)
    e0, f0 = e0.unsqueeze(-1), f0.unsqueeze(-1)
    e = torch.cat([e[..., :d] + (kernel[:d, 0, 0] * e0 + kernel[:d, 0, 1] * f0),
                   e[..., d:]], -1)
    f = torch.cat([f[..., :d] + (kernel[:d, 1, 0] * e0 + kernel[:d, 1, 1] * f0),
                   f[..., d:]], -1)
    f_next = f + float(beta) * e
    valid = ((e.abs().amax(-1) < float(np.float32(WRAP_MARGIN * np.pi)))
             & (f_next.abs().amax(-1) <= float(limit)))
    return e, f_next, valid
