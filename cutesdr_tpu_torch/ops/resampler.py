"""Arbitrary-ratio fractional resampler, windowed-sinc interpolation (port
of ``cutesdr_tpu/ops/resampler.py``).

Two paths, chosen as the JAX package chooses them:

* ``_rational_process``: when the ratio equals an exact small fraction p/q
  (62500/48000 = 125/96 on the flagship), every output phase lies on the
  /q grid, the taps are static, and a block is one stride-p ``conv1d``
  with q output channels.
* ``_banded_process``: any ratio; every tap weight is evaluated in closed
  form, and the weighted sum is the resamp kernel
  (``kernels/resamp.resample_band``, its plain version on the CPU).

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

from cutesdr_tpu_torch.kernels import resamp
from cutesdr_tpu_torch.kernels.resamp import SINC_PERIOD_PTS  # noqa: F401
from cutesdr_tpu_torch.types import RDTYPE

SINC_PERIODS = 28            # reference-exact default (fractresampler.cpp:50)
MAX_SOUNDCARDVAL = 32767.0   # int16 full scale of the sound card's samples

_DT_SPLIT = 4096.0           # dt_hi quantum 2^-12
_K_SPLIT = 2048.0            # two-level split of k (see _times)
_CHUNK = resamp.CHUNK        # outputs per banded chunk
_BH_COEFS = resamp.BH_COEFS  # Blackman-Harris 4-term coefficients


class ResamplerParams(NamedTuple):
    dt_hi: np.float32        # rate split: dt = in/out = dt_hi + dt_lo
    dt_lo: np.float32        # (a graphed receiver holds both as 0-dim
                             # float32 device tensors, filled in place)


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
def _rational_rhs(p: int, q: int, periods: int, interp: bool,
                  device: str) -> torch.Tensor:
    """``_rational_weights`` on ``device`` as the [q, 1, W] conv weights,
    made once (no host copy inside the step)."""
    rhs, _ = _rational_weights(p, q, periods, interp)
    return torch.tensor(rhs, dtype=RDTYPE, device=device)[:, None, :]


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
    _, W = _rational_weights(p, q, periods, interp)
    inv = pow(p % q, -1, q)

    num0 = torch.round(carry.t0 * q).to(torch.int64)         # [0, p]
    u0 = (num0 * inv) % q
    sigma = torch.div(p * u0 - num0, q, rounding_mode="floor")

    K = -(-((q - 1) + max_out) // q) + 1                     # conv groups
    Lc = p * (K - 1) + W
    pad_right = max(0, Lc - n) + p
    rhs = _rational_rhs(p, q, periods, interp, str(dev))
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


def _times(params: ResamplerParams, t0: torch.Tensor, k: torch.Tensor):
    """(t_int, t_frac) of t_k = t0 + k*dt, exact to ~1e-7 of a sample.

    dt_hi is a multiple of 2^-12, so k*dt_hi is exact only for k < 2^11:
    split k = k_hi*2048 + k_lo and take the two exact products apart
    (a1 = k_hi*(2048*dt_hi), a2 = k_lo*dt_hi), their fractions exactly,
    and b = t0 + k*dt_lo (|dt_lo| <= 2^-13) in plain float32."""
    k_hi = torch.floor(k / _K_SPLIT)
    a1 = k_hi * (params.dt_hi * np.float32(_K_SPLIT))
    a2 = (k - k_hi * _K_SPLIT) * params.dt_hi
    b = t0 + k * params.dt_lo
    i1 = torch.floor(a1)
    i2 = torch.floor(a2)
    ftot = (a1 - i1) + (a2 - i2) + b
    f_int = torch.floor(ftot)
    return (i1 + i2 + f_int).to(torch.int32), ftot - f_int


def band_size(n: int, max_out: int, periods: int) -> tuple[int, int]:
    """(outputs rounded up to whole chunks, window M) of a banded block of
    n inputs and max_out outputs: M covers a chunk's span at the ratio
    implied by (n, max_out) plus the rate lock's swing, the taps and the
    128-sample alignment slack."""
    C = _CHUNK
    dt_max = 1.0062 * n / max(1.0, max_out - 5.0)
    M = int(np.ceil(C * dt_max)) + periods + 4 + 128
    return -(-max_out // C) * C, -(-M // 128) * 128


def _banded_process(params: ResamplerParams, carry: ResamplerCarry,
                    x: torch.Tensor, max_out: int, interp: bool = False):
    """Arbitrary-ratio banded evaluator.  Returns (carry', y[..., max_out],
    n_valid); y[k] for k >= n_valid is zero.  C consecutive outputs share
    one M-sample window (chunk bases rounded down to 128 samples, as in
    the JAX package, so the two compute the same sums); the weighted sum
    is ``kernels/resamp.resample_band``.  A leading axis of x is a bank of
    independent streams."""
    if x.dim() == 1:
        c, y, n_valid = _banded_process(
            params, ResamplerCarry(carry.tail[None], carry.t0[None]),
            x[None], max_out, interp)
        return ResamplerCarry(c.tail[0], c.t0[0]), y[0], n_valid[0]
    n = x.shape[-1]
    B = x.shape[0]
    periods = carry.tail.shape[-1]
    dev = x.device
    max_out_p, M = band_size(n, max_out, periods)

    k = torch.arange(max_out_p, dtype=RDTYPE, device=dev)
    t_int, t_frac = _times(params, carry.t0[:, None], k)      # [B, max_out_p]
    valid = t_int[:, :max_out] < n

    z = torch.cat([carry.tail, x], -1)                   # z[m] = x[m-P]
    y = resamp.resample_band(z, t_int, t_frac, M, periods,
                             interp)[:, :max_out]
    y = torch.where(valid, y, torch.zeros((), dtype=y.dtype, device=dev))
    n_valid = valid.sum(-1).to(torch.int32)

    # t0' = t0 + n_valid*dt - n through the same exact split as _times
    cnt = n_valid.to(RDTYPE)
    c_hi = torch.floor(cnt / _K_SPLIT)
    a1 = c_hi * (params.dt_hi * np.float32(_K_SPLIT))
    a2 = (cnt - c_hi * _K_SPLIT) * params.dt_hi
    i1 = torch.floor(a1)
    i2 = torch.floor(a2)
    t0_new = (((i1 + i2) - n) + ((a1 - i1) + (a2 - i2))
              + (carry.t0 + cnt * params.dt_lo))
    return (ResamplerCarry(tail=z[:, z.shape[-1] - periods:].clone(),
                           t0=t0_new), y, n_valid)


def rational_route(params: ResamplerParams, rational, n: int, max_out: int,
                   periods: int) -> bool:
    """Whether a block of ``n`` inputs takes the static-polyphase path:
    ``rational`` (the nominal (p, q), or None) is given and the ratio
    equals it exactly (the rate-lock correction is zero), with an even
    sinc length and int32 phase numerators p*o and q*n that do not
    overflow.  A ratio held on the device (a graphed receiver's, set off
    nominal) takes the banded evaluator."""
    if rational is None or periods % 2 or isinstance(params.dt_hi,
                                                     torch.Tensor):
        return False
    p, q = rational
    return (p * (max_out + 1) < 2**31 and q * (n + 1) < 2**31
            and (params.dt_hi, params.dt_lo) == split_rate(p / q))


def process(params: ResamplerParams, carry: ResamplerCarry, x: torch.Tensor,
            max_out: int, interp: bool = False,
            rational: tuple[int, int] | None = None):
    """Resample one block: the static-polyphase path where
    ``rational_route`` holds, the banded evaluator otherwise.  A bank
    ([C, n]) takes the banded evaluator, as the JAX package's does."""
    if rational_route(params, rational, x.shape[-1], max_out,
                      carry.tail.shape[-1]):
        return _rational_process(*rational, params, carry, x, max_out,
                                 interp)
    return _banded_process(params, carry, x, max_out, interp)


def to_int16(y: torch.Tensor, gain, stereo: bool = False) -> torch.Tensor:
    """Gain + clip + int16 quantize (the sound card's format).  Complex
    input maps re -> left, im -> right ([..., 2]); real input gives mono.
    ``stereo`` is the JAX package's signature; the dtype decides."""
    if y.is_complex():
        g = torch.view_as_real(y) * gain
    else:
        g = y * gain
    g = torch.clamp(g, -MAX_SOUNDCARDVAL, MAX_SOUNDCARDVAL)
    return g.to(torch.int16)
