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
b0 (M weights per output, of which P are non-zero): in the separable form
of ``sinc_band`` for even P, in the JAX package's direct form
(``sinc_value``) for odd P.  CUDA tensors launch ``csrc/resamp.cu``, which
uses the same chunks and bases and the separable form for every P, but
evaluates only the taps that can be non-zero, two or eight lanes to an
output (``launch_plan``).  A leading axis of z and of the times is a bank of
independent streams (one launch for the bank); complex z is two planes
under one set of weights.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from cutesdr_tpu_torch.kernels import LAUNCHES, _build
from cutesdr_tpu_torch.types import CDTYPE, K_PI, RDTYPE

SINC_PERIOD_PTS = 10000      # the reference table's points per period
CHUNK = 64                   # outputs per chunk
THREADS = 256                # kernel threads per block (RS_THREADS)
# taps per lane the kernel unrolls fully, by lanes per output
UNROLLED = {8: (4, 8), 2: (16, 32)}
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


@functools.lru_cache(maxsize=16)
def _kernel_tables_on(M: int, periods: int, device: str) -> torch.Tensor:
    """``band_tables`` as the kernel reads them: [3, M] pairs (cm_k,
    sm_k)."""
    t = band_tables(M, periods).reshape(3, 2, M).transpose(0, 2, 1)
    return torch.from_numpy(np.ascontiguousarray(t)).to(device)


def sinc_band(Ti: torch.Tensor, tf: torch.Tensor, M: int,
              periods: int) -> torch.Tensor:
    """Windowed-sinc weights over a band, sv[..., m] = f(m - T[...]) for
    m < M with T = Ti + tf, evaluated separably: the Blackman-Harris terms
    split into the static per-m factors of ``band_tables`` times per-output
    cos/sin, and the sinc numerator is one well-reduced sine per output
    times a parity sign.  The position arrives exactly decomposed (int Ti,
    fractional tf) and is never reassembled into one float.  Any P: for
    odd P the parity term is taken about the half-integer P/2."""
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

    if periods % 2 == 0:
        im = torch.tensor(m - periods // 2, dtype=torch.int32,
                          device=dev) - Ti[..., None]
        vc = im.to(RDTYPE) - tf[..., None]
        rf = torch.round(tf)
        r = tf - rf                                      # [-0.5, 0.5], exact
        n_round = Ti + rf.to(torch.int32)
    else:
        # P/2 is a half-integer: the sine's argument pi*(m - T - P/2) is
        # reduced about T + 1/2 instead of round(T) (the kernel's odd-P
        # form; the plain version takes ``sinc_value`` for odd P)
        im = torch.tensor(m - periods // 2 - 1, dtype=torch.int32,
                          device=dev) - Ti[..., None]
        r = tf - np.float32(0.5)
        vc = im.to(RDTYPE) - r[..., None]
        n_round = Ti + 1
    fi = vc * np.float32(K_PI)
    inside = (vc > -(periods / 2)) & (vc <= periods / 2)
    sin_r = torch.sin(r * np.float32(K_PI))
    par_T = (1 - 2 * (n_round % 2)).to(RDTYPE)           # (-1)^round(T)
    sign_m = torch.tensor(np.where((m + periods // 2) % 2 == 0, -1.0, 1.0),
                          dtype=RDTYPE, device=dev)
    numer = (par_T * sin_r)[..., None] * sign_m

    small = fi.abs() < 1e-4                              # sin(fi)/fi -> 1
    s = torch.where(small, w, w * numer / torch.where(small, 1.0, fi))
    return torch.where(inside, s, torch.zeros((), dtype=RDTYPE, device=dev))


def sinc_value(v: torch.Tensor, periods: int, interp: bool) -> torch.Tensor:
    """The windowed-sinc weight at position ``v`` (support (0, periods]) in
    the direct closed form of the reference's table entry at v*10000 (the
    JAX package's ``ops/resampler._sinc_value``); ``interp=False`` first
    quantizes v to the table's 10,000-point grid."""
    if not interp:
        v = torch.floor(v * SINC_PERIOD_PTS) / SINC_PERIOD_PTS
    inside = (v > 0) & (v <= periods)
    vs = torch.where(inside, v, torch.full((), periods / 2, dtype=v.dtype,
                                           device=v.device))
    w = torch.zeros_like(vs)
    for kk, a in enumerate(BH_COEFS):
        w = w + np.float32(((-1.0) ** kk) * a) * torch.cos(
            np.float32(2.0 * np.pi * kk / periods) * vs)
    fi = np.float32(K_PI) * (vs - periods / 2)
    s = torch.where(fi.abs() < 1e-5, 1.0, torch.sin(fi) / fi)
    return torch.where(inside, w * s, torch.zeros((), dtype=v.dtype,
                                                  device=v.device))


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
    if periods % 2 == 0:
        sv = sinc_band(idx_local, tf, M, periods)        # [B, nc, C, M]
    else:
        v = (torch.arange(M, dtype=torch.int32, device=dev)
             - idx_local[..., None]).to(RDTYPE) - tf[..., None]
        sv = sinc_value(v, periods, True)
    if z.is_complex():
        y = torch.complex((sv * zc.real[..., None, :]).sum(-1),
                          (sv * zc.imag[..., None, :]).sum(-1))
    else:
        y = (sv * zc[..., None, :]).sum(-1)
    return y.reshape(B, K)


def span_cap(M: int, periods: int, outputs_per_block: int) -> int:
    """Samples of z a kernel block stages: the bases of its chunks lie
    within (chunks - 1) x 64 x dt + 127 of the first, and M was sized for
    64 x dt + P + 132 (``ops/resampler._banded_process``).  Taps beyond it
    (a ratio far off the one M was sized for) read global memory."""
    chunks = max(outputs_per_block // CHUNK, 1)
    return (chunks - 1) * max(M - periods - 132, 64) + 128 + M + 64


class ResampPlan(NamedTuple):
    lanes: int               # lanes per output
    outputs_per_block: int   # consecutive outputs a block walks
    taps_per_lane: int       # unrolled tap slots of a lane
    span: int                # z samples a block stages
    blocks: int              # blocks per stream


def launch_plan(K: int, n_streams: int, M: int, periods: int,
                n_sm: int) -> ResampPlan:
    """The kernel's work split.  G lanes per output, lane l taking the taps
    t_int + 1 + l + G i (i < taps_per_lane: the P + 1 candidates, the
    slots past them masked): G = 8 spreads a small call over the card and
    cuts each thread's chain (the session's block), G = 2 where two
    lanes per output already fill the card's resident threads (the
    rate-locked tail), since every lane repeats its output's setup.  A
    block of 256 threads evaluates 256 / G outputs at once and walks
    ``outputs_per_block`` of them, doubled up to 256 while the call still
    gives each SM four blocks, so that large calls stage the tables once
    per 256 outputs."""
    lanes = 2 if n_streams * K * 2 >= n_sm * 2048 else 8
    opb = THREADS // lanes
    while opb < 256 and n_streams * -(-K // (2 * opb)) >= 4 * n_sm:
        opb *= 2
    need = -(-(periods + 1) // lanes)
    tpl = next((t for t in UNROLLED[lanes] if t >= need), need)
    return ResampPlan(lanes, opb, tpl, span_cap(M, periods, opb),
                      -(-K // opb))


def resample_band(z: torch.Tensor, t_int: torch.Tensor,
                  t_frac: torch.Tensor, M: int, periods: int,
                  interp: bool) -> torch.Tensor:
    """y [B, K] of ``resample_band_plain``: the plain version for CPU
    tensors, one launch of the kernel over the B streams for CUDA ones."""
    if _build.on_cpu(z, t_int, t_frac):
        return resample_band_plain(z, t_int, t_frac, M, periods, interp)
    B, K = t_int.shape
    nz = z.shape[-1]
    if K % CHUNK or M % 128:
        raise ValueError(f"resamp kernel: needs K % {CHUNK} == 0 and "
                         f"M % 128 == 0 (K={K}, M={M})")
    cplx = z.is_complex()
    _build.require(z, "z", CDTYPE if cplx else RDTYPE, nz, rows=B)
    _build.require(t_int, "t_int", torch.int32, K, rows=B)
    _build.require(t_frac, "t_frac", RDTYPE, K, rows=B)
    plan = launch_plan(K, B, M, periods, _build.sm_count(z.device))
    y = torch.empty((B, K), dtype=z.dtype, device=z.device)
    zf = torch.view_as_real(z) if cplx else z
    yf = torch.view_as_real(y) if cplx else y
    es = 2 if cplx else 1
    tables = _kernel_tables_on(M, periods, str(z.device))
    _build.check(_build.library().cutesdr_resamp(
        zf.data_ptr(), zf.data_ptr() + 4 if cplx else None, es * nz, es, nz,
        t_int.data_ptr(), t_frac.data_ptr(), K, K, tables.data_ptr(), M,
        periods, int(bool(interp)), plan.lanes, plan.outputs_per_block,
        plan.taps_per_lane, plan.span, B, yf.data_ptr(),
        yf.data_ptr() + 4 if cplx else None, es * K, es,
        _build.stream(z)), "resamp")
    LAUNCHES["resamp"] += 1
    return y
