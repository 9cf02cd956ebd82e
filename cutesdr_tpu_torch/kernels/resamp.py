"""Banded windowed-sinc resampler kernel (port of
``cutesdr_tpu/kernels/resamp1.py``, ``resample_band``).

The weighted sum of ``ops/resampler._banded_process``: for output times
t_k = t_int[k] + t_frac[k] into z = [tail | block], y[k] = sum over the P
taps m = t_int[k]+1 .. t_int[k]+P of w(m - t_k) z[m], w the P-period
Blackman-Harris windowed sinc in the separable closed form of
``sinc_band``.  The times, the validity mask, the output count and the
time-offset update stay in ``ops/resampler``, as they do around the JAX
kernel.

The plain version evaluates, for each chunk of 64 consecutive outputs, the
weights over one M-sample window starting at the chunk's 128-aligned base
b0 (M weights per output, of which P are non-zero).  CUDA tensors launch
``csrc/resamp.cu``, which uses the same chunks and bases, so each weight is
the same number, but evaluates only the taps that can be non-zero.  A
leading axis of z and of the times is a bank of independent streams (one
launch for the bank); complex z is two planes under one set of weights.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cutesdr_tpu_torch.kernels import LAUNCHES, _build
from cutesdr_tpu_torch.types import CDTYPE, K_PI, RDTYPE

SINC_PERIOD_PTS = 10000      # the reference table's points per period
CHUNK = 64                   # outputs per chunk
# Blackman-Harris 4-term coefficients (design/windows.py)
BH_COEFS = (0.35875, 0.48829, 0.14128, 0.01168)


@functools.lru_cache(maxsize=16)
def band_tables(M: int, periods: int) -> np.ndarray:
    """[6, M] float32 per-m window factors a_k cos(2 pi k m / P) and
    a_k sin(2 pi k m / P), k = 1..3 (rows cm_1, sm_1, cm_2, ...), computed
    in float64 and rounded once."""
    mf = np.arange(M).astype(np.float64)
    rows = []
    for kk in (1, 2, 3):
        a = ((-1.0) ** kk) * BH_COEFS[kk]
        ang_m = 2.0 * np.pi * kk * mf / periods
        rows += [(a * np.cos(ang_m)).astype(np.float32),
                 (a * np.sin(ang_m)).astype(np.float32)]
    return np.stack(rows)


@functools.lru_cache(maxsize=16)
def _tables_on(M: int, periods: int, device: str) -> torch.Tensor:
    return torch.from_numpy(band_tables(M, periods)).to(device)


def sinc_band(Ti: torch.Tensor, tf: torch.Tensor, M: int,
              periods: int) -> torch.Tensor:
    """Windowed-sinc weights over a band, sv[..., m] = f(m - T[...]) for
    m < M with T = Ti + tf, evaluated separably: the Blackman-Harris terms
    split into the static per-m factors of ``band_tables`` times per-output
    cos/sin, and the sinc numerator is one well-reduced sine per output
    times a parity sign.  The position arrives exactly decomposed (int Ti,
    fractional tf) and is never reassembled into one float."""
    dev = tf.device
    m = np.arange(M)
    tables = _tables_on(M, periods, str(dev))
    TP = (Ti % periods).to(RDTYPE) + tf                 # T mod P, exact
    w = torch.full(tf.shape + (M,), BH_COEFS[0], dtype=RDTYPE, device=dev)
    for kk in (1, 2, 3):
        cm, sm = tables[2 * kk - 2], tables[2 * kk - 1]
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


def resample_band_plain(z: torch.Tensor, t_int: torch.Tensor,
                        t_frac: torch.Tensor, M: int, periods: int,
                        interp: bool) -> torch.Tensor:
    """The plain version: z [B, nz] (float32 or complex64), t_int int32
    and t_frac float32 [B, K] with K a multiple of CHUNK; returns y [B, K].
    Outputs whose taps run past z read edge values and are the caller's
    to mask."""
    B, K = t_int.shape
    dev = z.device
    n_chunks = K // CHUNK
    nrows = -(-z.shape[-1] // 128)
    zpad = torch.cat([z, z[:, -1:].expand(B, nrows * 128 - z.shape[-1])], -1)
    first = t_int[:, ::CHUNK].clamp(min=0)               # [B, n_chunks]
    b0 = torch.div(first, 128, rounding_mode="floor") * 128
    rows = (b0[..., None] // 128 + torch.arange(M // 128, device=dev)).clamp(
        max=nrows - 1)                                   # whole-row gather
    zc = zpad.reshape(B, nrows, 128)[
        torch.arange(B, device=dev)[:, None, None], rows].reshape(
            B, n_chunks, M)

    idx_local = t_int.reshape(B, n_chunks, CHUNK) - b0[..., None]
    tf = t_frac.reshape(B, n_chunks, CHUNK)
    if not interp:
        # truncating-table semantics, decided at the chunk-local offset
        offs = (t_int.reshape(B, n_chunks, CHUNK)
                - first[..., None]).to(RDTYPE)
        qg = torch.ceil((offs + tf) * SINC_PERIOD_PTS)
        tf = (qg - offs * SINC_PERIOD_PTS) / SINC_PERIOD_PTS
    sv = sinc_band(idx_local, tf, M, periods)            # [B, nc, C, M]
    if z.is_complex():
        y = torch.complex((sv * zc.real[..., None, :]).sum(-1),
                          (sv * zc.imag[..., None, :]).sum(-1))
    else:
        y = (sv * zc[..., None, :]).sum(-1)
    return y.reshape(B, K)


def span_cap(M: int, periods: int) -> int:
    """Samples of z a 256-output block of the kernel stages: its four
    chunks' bases lie within 3 x 64 x dt + 127 of the first, and M was
    sized for 64 x dt + P + 132 (``ops/resampler._banded_process``).  Taps
    beyond it (a ratio far off the one M was sized for) read global
    memory."""
    return 3 * max(M - periods - 132, 64) + 128 + M + 64


def resample_band(z: torch.Tensor, t_int: torch.Tensor,
                  t_frac: torch.Tensor, M: int, periods: int,
                  interp: bool) -> torch.Tensor:
    """y [B, K] of ``resample_band_plain``: the plain version for CPU
    tensors, one launch of the kernel over the B streams for CUDA ones."""
    if _build.on_cpu(z, t_int, t_frac):
        return resample_band_plain(z, t_int, t_frac, M, periods, interp)
    B, K = t_int.shape
    nz = z.shape[-1]
    if K % CHUNK or periods % 2 or M % 128:
        raise ValueError(f"resamp kernel: needs K % {CHUNK} == 0, even "
                         f"periods and M % 128 == 0 (K={K}, P={periods}, "
                         f"M={M})")
    cplx = z.is_complex()
    _build.require(z, "z", CDTYPE if cplx else RDTYPE, nz, rows=B)
    _build.require(t_int, "t_int", torch.int32, K, rows=B)
    _build.require(t_frac, "t_frac", RDTYPE, K, rows=B)
    y = torch.empty((B, K), dtype=z.dtype, device=z.device)
    zf = torch.view_as_real(z) if cplx else z
    yf = torch.view_as_real(y) if cplx else y
    es = 2 if cplx else 1
    tables = _tables_on(M, periods, str(z.device))
    _build.check(_build.library().cutesdr_resamp(
        zf.data_ptr(), zf.data_ptr() + 4 if cplx else None, es * nz, es, nz,
        t_int.data_ptr(), t_frac.data_ptr(), K, K, tables.data_ptr(), M,
        periods, int(bool(interp)), span_cap(M, periods), B, yf.data_ptr(),
        yf.data_ptr() + 4 if cplx else None, es * K, es,
        _build.stream(z)), "resamp")
    LAUNCHES["resamp"] += 1
    return y
