"""Arbitrary-ratio fractional resampler, windowed-sinc interpolation (port
of ``cutesdr_tpu/ops/resampler.py``).

Two paths, chosen as the JAX package chooses them:

* ``_rational_process``: when the ratio equals an exact small fraction p/q
  (62500/48000 = 125/96 on the flagship), every output phase lies on the
  /q grid, the taps are static, and a block is one stride-p ``conv1d``
  with q output channels.
* ``_banded_process``: any ratio; 64 consecutive outputs share one input
  window and every tap weight is evaluated in closed form (``_sinc_band``).

Output timestamps t_k = t0 + k*dt use the exact two-level split of
``_times``: a single float32 product k*dt loses the fractional phase at
262k-sample blocks (46 dB instead of 130 dB).  The output count per block
is data-dependent; the block yields a fixed ``max_out`` with a validity
count, as in the JAX package.  The banded path also takes a channel bank
([C, n] input, a [C] time offset and tail rows; one count per channel).
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch

from cutesdr_tpu.types import K_PI
from cutesdr_tpu_torch.types import RDTYPE

SINC_PERIOD_PTS = 10000
SINC_PERIODS = 28            # reference-exact default (fractresampler.cpp:50)

_DT_SPLIT = 4096.0           # dt_hi quantum 2^-12
_K_SPLIT = 2048.0            # two-level split of k (see _times)
_CHUNK = 64                  # outputs per banded chunk

# Blackman-Harris 4-term coefficients (design/windows.py)
_BH_COEFS = (0.35875, 0.48829, 0.14128, 0.01168)


class ResamplerParams(NamedTuple):
    dt_hi: np.float32        # rate split: dt = in/out = dt_hi + dt_lo
    dt_lo: np.float32


class ResamplerCarry(NamedTuple):
    tail: torch.Tensor       # [periods] input history
    t0: torch.Tensor         # float32 0-dim fractional time offset


def split_rate(rate: float) -> tuple[np.float32, np.float32]:
    hi = np.round(rate * _DT_SPLIT) / _DT_SPLIT
    return np.float32(hi), np.float32(rate - hi)


def init(rate: float, device, complex_input: bool = False,
         periods: int = SINC_PERIODS) -> tuple[ResamplerParams,
                                               ResamplerCarry]:
    hi, lo = split_rate(rate)
    dtype = torch.complex64 if complex_input else RDTYPE
    return (ResamplerParams(dt_hi=hi, dt_lo=lo),
            ResamplerCarry(tail=torch.zeros(periods, dtype=dtype,
                                            device=device),
                           t0=torch.zeros((), dtype=RDTYPE, device=device)))


def set_rate(params: ResamplerParams, rate: float) -> ResamplerParams:
    hi, lo = split_rate(rate)
    return ResamplerParams(dt_hi=hi, dt_lo=lo)


def max_out_for(block_len: int, nominal_rate: float) -> int:
    """Per-block output capacity with margin for the rate lock's +-0.2%."""
    return int(np.ceil(block_len / (nominal_rate * 0.996))) + 4


def rational_for(in_rate: float, out_rate: float, max_den: int = 512,
                 max_num: int = 2048) -> tuple[int, int] | None:
    """(p, q) with in_rate/out_rate == p/q exactly (reduced, q >= 2)."""
    if out_rate <= 0 or in_rate <= 0:
        return None
    fr = Fraction(in_rate / out_rate).limit_denominator(max_den)
    if fr.numerator <= 0 or fr.numerator > max_num or fr.denominator < 2:
        return None
    if abs(float(fr) - in_rate / out_rate) > 1e-12 * float(fr):
        return None
    return int(fr.numerator), int(fr.denominator)


def _sinc_np(v: np.ndarray, periods: int) -> np.ndarray:
    """float64 windowed-sinc weight f(v) (the reference table entry at
    index v*10000), vectorized for the static rational weights."""
    v = np.asarray(v, np.float64)
    inside = (v > 0) & (v <= periods)
    w = np.zeros_like(v)
    for kk, a in enumerate(_BH_COEFS):
        w = w + ((-1.0) ** kk) * a * np.cos((2.0 * np.pi * kk / periods) * v)
    fi = np.pi * (v - periods / 2)
    with np.errstate(invalid="ignore", divide="ignore"):
        s = np.where(np.abs(fi) < 1e-9, 1.0, np.sin(fi) / fi)
    return np.where(inside, w * s, 0.0)


@functools.lru_cache(maxsize=16)
def _rational_weights(p: int, q: int, periods: int, interp: bool):
    """Static polyphase tap bank for dt = p/q: conv-stream output
    u = q*k + p' sits at t = p*k + b(p') + nu/q with b = (p*p')//q,
    nu = (p*p') mod q, and reads input offsets b+1 .. b+periods of the
    window starting at p*k.  interp=False applies the reference's
    truncating 10,000-point grid to the exact position first."""
    pp = np.arange(q)
    b = (p * pp) // q
    nu = (p * pp) % q
    W = int(b.max()) + periods + 1
    rhs = np.zeros((q, W), np.float64)
    j = np.arange(1, periods + 1)
    for c in range(q):
        v = j - nu[c] / q
        if not interp:
            v = np.floor(v * SINC_PERIOD_PTS) / SINC_PERIOD_PTS
        rhs[c, b[c] + 1:b[c] + periods + 1] = _sinc_np(v, periods)
    return rhs, W


def _rational_process(p: int, q: int, params: ResamplerParams,
                      carry: ResamplerCarry, x: torch.Tensor, max_out: int,
                      interp: bool):
    """Exact-rational resample: one static-weight stride-p convolution.

    Output o sits at position numerator N(o) = num0 + p*o (num0 =
    round(t0*q)); it maps to conv-stream index u = o + u0 with the input
    shifted sigma samples, u0 = num0*inv(p mod q) mod q and
    sigma = (p*u0 - num0)/q.  All offsets stay on the device (gathers), so
    nothing here waits for the device."""
    n = x.shape[-1]
    periods = carry.tail.shape[-1]
    dev = x.device
    rhs_np, W = _rational_weights(p, q, periods, interp)
    inv = pow(p % q, -1, q)

    num0 = torch.round(carry.t0 * q).to(torch.int64)         # [0, p]
    u0 = (num0 * inv) % q
    sigma = torch.div(p * u0 - num0, q, rounding_mode="floor")

    K = -(-((q - 1) + max_out) // q) + 1                     # conv groups
    Lc = p * (K - 1) + W
    pad_right = max(0, Lc - n) + p
    rhs = torch.tensor(rhs_np, dtype=RDTYPE, device=dev)[:, None, :]
    lhs_idx = torch.arange(Lc, device=dev) + (p - sigma)
    out_idx = torch.arange(max_out, device=dev) + u0

    def conv1(vec: torch.Tensor) -> torch.Tensor:
        zfull = torch.cat([vec.new_zeros(p), vec, vec.new_zeros(pad_right)])
        lhs = zfull[lhs_idx]                                 # z[i - sigma]
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            out = torch.nn.functional.conv1d(lhs[None, None, :], rhs,
                                             stride=p)       # [1, q, K]
        return out[0].T.reshape(-1)[out_idx]                 # time order

    z = torch.cat([carry.tail, x], -1)
    if z.is_complex():
        y = torch.complex(conv1(z.real), conv1(z.imag))
    else:
        y = conv1(z)

    o = torch.arange(max_out, device=dev)
    valid = torch.div(num0 + p * o, q, rounding_mode="floor") < n
    y = torch.where(valid, y, torch.zeros((), dtype=y.dtype, device=dev))
    n_valid = valid.sum().to(torch.int32)
    num_new = num0 + p * n_valid - q * n                     # [0, p)
    t0_new = num_new.to(RDTYPE) / q
    return (ResamplerCarry(tail=z[z.shape[-1] - periods:].clone(),
                           t0=t0_new), y, n_valid)


def _sinc_band(Ti: torch.Tensor, tf: torch.Tensor, m: np.ndarray,
               periods: int) -> torch.Tensor:
    """Windowed-sinc weights over a band, sv[..., m] = f(m - T[...]) with
    T = Ti + tf, evaluated separably: the Blackman-Harris terms split into
    static per-m factors times per-output cos/sin, and the sinc numerator
    is one well-reduced sine per output times a parity sign.  The position
    arrives exactly decomposed (int Ti, fractional tf) and is never
    reassembled into one float."""
    dev = tf.device
    mf = m.astype(np.float64)
    TP = (Ti % periods).to(RDTYPE) + tf                 # T mod P, exact
    w = torch.full(tf.shape + (len(m),), _BH_COEFS[0], dtype=RDTYPE,
                   device=dev)
    for kk in (1, 2, 3):
        a = ((-1.0) ** kk) * _BH_COEFS[kk]
        ang_m = 2.0 * np.pi * kk * mf / periods
        cm = torch.tensor((a * np.cos(ang_m)).astype(np.float32), device=dev)
        sm = torch.tensor((a * np.sin(ang_m)).astype(np.float32), device=dev)
        ang_T = TP * np.float32(2.0 * np.pi * kk / periods)
        w = w + (torch.cos(ang_T)[..., None] * cm
                 + torch.sin(ang_T)[..., None] * sm)

    im = torch.tensor(m - periods // 2, dtype=torch.int32,
                      device=dev) - Ti[..., None]
    vc = im.to(RDTYPE) - tf[..., None]
    fi = vc * np.float32(K_PI)
    inside = (vc > -(periods / 2)) & (vc <= periods / 2)

    rf = torch.round(tf)
    r = tf - rf                                          # [-0.5, 0.5], exact
    sin_r = torch.sin(r * np.float32(K_PI))
    n_round = Ti + rf.to(torch.int32)
    par_T = (1 - 2 * (n_round % 2)).to(RDTYPE)           # (-1)^round(T)
    sign_m = torch.tensor(np.where((m + periods // 2) % 2 == 0, -1.0, 1.0),
                          dtype=RDTYPE, device=dev)
    numer = (par_T * sin_r)[..., None] * sign_m

    small = fi.abs() < 1e-4                              # sin(fi)/fi -> 1
    s = torch.where(small, w, w * numer / torch.where(small, 1.0, fi))
    return torch.where(inside, s, torch.zeros((), dtype=RDTYPE, device=dev))


def _times(params: ResamplerParams, t0: torch.Tensor, k: torch.Tensor):
    """(t_int, t_frac) of t_k = t0 + k*dt, exact to ~1e-7 of a sample.

    dt_hi is a multiple of 2^-12, so k*dt_hi is exact only for k < 2^11:
    split k = k_hi*2048 + k_lo and take the two exact products apart
    (a1 = k_hi*(2048*dt_hi), a2 = k_lo*dt_hi), their fractions exactly,
    and b = t0 + k*dt_lo (|dt_lo| <= 2^-13) in plain float32."""
    k_hi = torch.floor(k / _K_SPLIT)
    a1 = k_hi * np.float32(_K_SPLIT * params.dt_hi)
    a2 = (k - k_hi * _K_SPLIT) * params.dt_hi
    b = t0 + k * params.dt_lo
    i1 = torch.floor(a1)
    i2 = torch.floor(a2)
    ftot = (a1 - i1) + (a2 - i2) + b
    f_int = torch.floor(ftot)
    return (i1 + i2 + f_int).to(torch.int32), ftot - f_int


def _banded_process(params: ResamplerParams, carry: ResamplerCarry,
                    x: torch.Tensor, max_out: int, interp: bool = False):
    """Arbitrary-ratio banded evaluator.  Returns (carry', y[..., max_out],
    n_valid); y[k] for k >= n_valid is zero.  C consecutive outputs share
    one M-sample window (chunk bases rounded down to 128 samples, as in
    the JAX package, so the two compute the same sums).  A leading axis
    of x is a bank of independent streams."""
    if x.dim() == 1:
        c, y, n_valid = _banded_process(
            params, ResamplerCarry(carry.tail[None], carry.t0[None]),
            x[None], max_out, interp)
        return ResamplerCarry(c.tail[0], c.t0[0]), y[0], n_valid[0]
    n = x.shape[-1]
    B = x.shape[0]
    periods = carry.tail.shape[-1]
    if periods % 2:
        raise NotImplementedError("odd sinc lengths are not ported yet")
    dev = x.device
    C = _CHUNK
    max_out_p = -(-max_out // C) * C
    n_chunks = max_out_p // C
    dt_max = 1.0062 * n / max(1.0, max_out - 5.0)
    M = int(np.ceil(C * dt_max)) + periods + 4 + 128
    M = -(-M // 128) * 128

    k = torch.arange(max_out_p, dtype=RDTYPE, device=dev)
    t_int, t_frac = _times(params, carry.t0[:, None], k)      # [B, max_out_p]
    valid = t_int[:, :max_out] < n

    z = torch.cat([carry.tail, x], -1)                   # z[m] = x[m-P]
    nrows = -(-z.shape[-1] // 128)
    zpad = torch.cat([z, z[:, -1:].expand(B, nrows * 128 - z.shape[-1])], -1)
    first = t_int[:, ::C].clamp(min=0)                   # [B, n_chunks]
    b0 = torch.div(first, 128, rounding_mode="floor") * 128
    rows = (b0[..., None] // 128 + torch.arange(M // 128, device=dev)).clamp(
        max=nrows - 1)                                   # whole-row gather
    zc = zpad.reshape(B, nrows, 128)[
        torch.arange(B, device=dev)[:, None, None], rows].reshape(
            B, n_chunks, M)

    idx_local = t_int.reshape(B, n_chunks, C) - b0[..., None]
    tf = t_frac.reshape(B, n_chunks, C)
    if not interp:
        # truncating-table semantics, decided at the chunk-local offset
        offs = (t_int.reshape(B, n_chunks, C) - first[..., None]).to(RDTYPE)
        qg = torch.ceil((offs + tf) * SINC_PERIOD_PTS)
        tf = (qg - offs * SINC_PERIOD_PTS) / SINC_PERIOD_PTS
    sv = _sinc_band(idx_local, tf, np.arange(M), periods)  # [B, nc, C, M]

    if z.is_complex():
        y = torch.complex((sv * zc.real[..., None, :]).sum(-1),
                          (sv * zc.imag[..., None, :]).sum(-1))
    else:
        y = (sv * zc[..., None, :]).sum(-1)
    y = y.reshape(B, max_out_p)[:, :max_out]
    y = torch.where(valid, y, torch.zeros((), dtype=y.dtype, device=dev))
    n_valid = valid.sum(-1).to(torch.int32)

    # t0' = t0 + n_valid*dt - n through the same exact split as _times
    cnt = n_valid.to(RDTYPE)
    c_hi = torch.floor(cnt / _K_SPLIT)
    a1 = c_hi * np.float32(_K_SPLIT * params.dt_hi)
    a2 = (cnt - c_hi * _K_SPLIT) * params.dt_hi
    i1 = torch.floor(a1)
    i2 = torch.floor(a2)
    t0_new = (((i1 + i2) - n) + ((a1 - i1) + (a2 - i2))
              + (carry.t0 + cnt * params.dt_lo))
    return (ResamplerCarry(tail=z[:, z.shape[-1] - periods:].clone(),
                           t0=t0_new), y, n_valid)


def process(params: ResamplerParams, carry: ResamplerCarry, x: torch.Tensor,
            max_out: int, interp: bool = False,
            rational: tuple[int, int] | None = None):
    """Resample one block.  ``rational`` is the nominal (p, q) or None; the
    static-polyphase path runs when the ratio equals it exactly (the
    rate-lock correction is zero), the banded evaluator otherwise.  The
    int32 phase numerators p*o and q*n must not overflow.  A bank ([C, n])
    takes the banded evaluator, as the JAX package's does."""
    if rational is not None and carry.tail.shape[-1] % 2 == 0 \
            and rational[0] * (max_out + 1) < 2**31 \
            and rational[1] * (x.shape[-1] + 1) < 2**31:
        p, q = rational
        if (params.dt_hi, params.dt_lo) == split_rate(p / q):
            return _rational_process(p, q, params, carry, x, max_out, interp)
    return _banded_process(params, carry, x, max_out, interp)
