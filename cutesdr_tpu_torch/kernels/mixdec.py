"""Fused DC cal + NCO mix + polyphase decimation (port of
``cutesdr_tpu/kernels/mixdec.py``, ``MixDecimate.process_planes``).

The carry is one layout on both devices: the RAW input tail (taken before
the DC cal) and the uint32 DDS phase at the block start, held as int64.
The tail holds as much history as the JAX package's Pallas tail
(``raw_tail_length``: L-1-d samples rounded up to whole 8-row groups of
lanes), so a switch to a plan with a longer tail carries real samples;
the kernel and the plain version read only its trailing L-1-d samples.
Tail samples take back-dated phases acc_0 - k*inc through unsigned
wraparound, so the history is mixed with exactly the phases it would have
had.  CUDA tensors run ``csrc/mixdec.cu``; CPU tensors the plain
version, which rebuilds the mixed history and calls
``ops.decimator.fused_process``.  ``launch_plan`` chooses each call's tile
(outputs per CUDA block) and block size from the output count, D, the
taps, the card's SM count and shared memory.

A channel bank adds a leading channel axis to the carry, the DC cal and
the increments (a [C] int64 tensor of uint32 values); the composed taps
are shared.  Its input is one block for every channel (shared) or one row
per channel (stacked), and one launch serves the whole bank.

The planes are float32 or int16 (the radio's wire values, in the same
+-32767 convention, so a cast is exact).  The kernel reads int16 planes
as they are, at half the bytes (``LAUNCHES["mixdec_int16"]``), and gives
the same bits as on the planes cast to float32; the plain version and the
carry's raw tail cast them.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from cutesdr_tpu_torch.design.decimation_plan import DecimationPlan
from cutesdr_tpu_torch.kernels import LAUNCHES, _build
from cutesdr_tpu_torch.ops import decimator, nco
from cutesdr_tpu_torch.types import CDTYPE, RDTYPE


class MixDecParams(NamedTuple):
    h_eq: torch.Tensor   # composed decimation taps, float32 [L]
    phase_inc: int | torch.Tensor   # uint32 DDS increment (round(-f/fs *
                                    # 2^32) mod 2^32); a bank: [C] int64;
                                    # a graphed receiver: 0-dim int64
    taps: torch.Tensor   # h_eq flipped to correlation order, contiguous
                         # (the kernel's taps, made once at init)


class MixDecCarry(NamedTuple):
    raw_tail: torch.Tensor   # [raw_tail_length] complex64, raw (pre-DC-cal)
                             # input
    phase: torch.Tensor      # int64 0-dim, DDS accumulator at block start


def _column(v):
    """A per-channel [C] tensor as a [C, 1] column; host ints as they are."""
    return v.unsqueeze(-1) if isinstance(v, torch.Tensor) else v


LANE = 128              # the JAX kernel's lane width


def raw_tail_length(plan: DecimationPlan) -> int:
    """The raw history the carry holds: the JAX package's Pallas tail
    (``cutesdr_tpu/kernels/mixdec.py``, ``MixDecimate.halo``), the L-1-d
    samples the sum reads rounded up to whole lane rows, then to whole
    groups of 8 rows.  Its lanes are 128, or D where D is a multiple of
    128 whose composed taps are too long for a 128-column band."""
    D = plan.decimation
    need = decimator.tail_length(plan)
    L = len(plan.composed_taps())
    lane = LANE
    if D > LANE and -(-(-(-need // LANE) * LANE - need + L) // LANE) > LANE:
        lane = D
    rows = -(-need // lane)
    return -(-rows // 8) * 8 * lane


def init(plan: DecimationPlan, tune_freq: float,
         device) -> tuple[MixDecParams, MixDecCarry]:
    fp, _ = decimator.fused_init(plan, device)
    np_, nc = nco.init(tune_freq, plan.in_rate, device)
    tail = torch.zeros(raw_tail_length(plan), dtype=CDTYPE, device=device)
    return (MixDecParams(h_eq=fp.h_eq, phase_inc=np_.phase_inc,
                         taps=fp.h_eq.flip(-1).contiguous()),
            MixDecCarry(raw_tail=tail, phase=nc.phase_acc))


def read_tail(plan: DecimationPlan, params: MixDecParams,
              carry: MixDecCarry) -> torch.Tensor:
    """The trailing L-1-d samples of the carried tail that the sum reads,
    as a view."""
    t = carry.raw_tail.shape[-1]
    need = params.h_eq.shape[-1] - 1 - decimator.total_offset(plan)
    if t < need:
        raise ValueError(f"mixdec tail {t} shorter than the plan's {need}")
    return carry.raw_tail[..., t - need:]


# the kernel's work split (csrc/mixdec.cu)
R = 8                   # outputs a thread keeps in registers (MIX_R)
SMEM_MAX = 232_448      # shared memory a block may use (227 KB)
SMEM_SOFT = 113 * 1024  # up to here two blocks fit on one SM
HALO_WEIGHT = 0.4       # a window sample's staging (copy, sincos, mix)
                        # against one output's share of the sum, per D


class LaunchPlan(NamedTuple):
    tile_out: int     # outputs of one channel per CUDA block
    threads: int      # threads per block
    smem_bytes: int   # dynamic shared memory per block
    n_tiles: int      # blocks per channel


def lanes(dec: int) -> int:
    """P: the lanes that share one group of R outputs, one phase each."""
    return min(dec, 32)


def smem_bytes(tile_out: int, dec: int, ntaps: int) -> int:
    """Shared memory of a block, as csrc/mixdec.cu lays it out: one chunk
    of P phases of the mixed window (tile_out + K rows in groups of R
    rows, each group padded by P samples where P < 32), then the chunk's
    taps, K * P."""
    k, p = -(-ntaps // dec), lanes(dec)
    row = R * p + (p if p < 32 else 0)
    return (((tile_out + k) // R + 1) * row + -(-k * p // 2)) * 8


@functools.lru_cache(maxsize=64)
def launch_plan(n_out: int, n_ch: int, dec: int, ntaps: int,
                n_sm: int) -> LaunchPlan:
    """The tile and block size of one call: the most threads (512, 256,
    128) whose one pass over the warps' output groups (R outputs per group
    of P lanes) still leaves a block for every SM, then

    D > 32 (D/32 chunks of phases): a warp owns one group of R outputs
    through the chunks, so tile_out = R * warps;

    D <= 32 (one chunk): a block of T outputs does T + HALO_WEIGHT *
    (L - D) / D outputs' worth of work (its window overlaps the next by
    L - D samples); T runs over multiples of one pass while two blocks
    still fit on an SM, and the T whose blocks, spread evenly over the
    SMs, give the least work per SM wins (the larger on ties).  The
    flagship gets 256 outputs and 512 threads (a 13% overlap); the
    session's one-frame block 32 blocks of 32 outputs."""
    if dec <= 0 or dec & (dec - 1):
        raise ValueError(f"mixdec kernel needs a power-of-2 decimation, "
                         f"got {dec}")
    groups_per_warp = 32 // lanes(dec)
    for threads in (512, 256, 128):     # 512: MIX_MAX_THREADS
        unit = R * threads // 32 * groups_per_warp
        if -(-n_out // unit) * n_ch >= n_sm:
            break
    t = unit
    if dec <= 32:
        halo = HALO_WEIGHT * max(ntaps - dec, 0) / dec
        best = (math.inf, unit)
        while t <= max(unit, n_out + unit - 1) and (
                t == unit or smem_bytes(t, dec, ntaps) <= SMEM_SOFT):
            cost = -(-(-(-n_out // t) * n_ch) // n_sm) * (t + halo)
            if cost <= best[0]:
                best = (cost, t)
            t += unit
        t = best[1]
    smem = smem_bytes(t, dec, ntaps)
    if smem > SMEM_MAX:
        raise ValueError(f"mixdec: {ntaps} taps at D={dec} do not fit in "
                         "shared memory")
    return LaunchPlan(t, threads, smem, -(-n_out // t))


def _complex(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """The complex64 samples of two float32 or int16 planes (int16 ones
    stacked, then cast: exact)."""
    if re.dtype == RDTYPE:
        return torch.complex(re, im)
    return torch.view_as_complex(torch.stack([re, im], -1).to(RDTYPE))


def _new_carry(params: MixDecParams, carry: MixDecCarry, re: torch.Tensor,
               im: torch.Tensor) -> MixDecCarry:
    n, t = re.shape[-1], carry.raw_tail.shape[-1]
    rows = carry.raw_tail.shape[:-1]
    if n >= t:
        tail = _complex(re[..., n - t:], im[..., n - t:])
        tail = tail.expand(rows + (t,)).contiguous()
    else:
        x = _complex(re, im).expand(rows + (n,))
        tail = torch.cat([carry.raw_tail, x], -1)[..., n:]
    return MixDecCarry(raw_tail=tail,
                       phase=nco.advance(carry.phase, params.phase_inc, n))


def process_planes_plain(plan: DecimationPlan, params: MixDecParams,
                         carry: MixDecCarry, re: torch.Tensor,
                         im: torch.Tensor, dc: torch.Tensor
                         ) -> tuple[MixDecCarry, torch.Tensor]:
    """The plain version: (z - dc) * e^{j phase} over z = [raw tail | x]
    with the tail's phases back-dated, then the composed decimator."""
    tail = read_tail(plan, params, carry)
    t = tail.shape[-1]
    x = _complex(re, im).expand(tail.shape[:-1] + re.shape[-1:])
    z = torch.cat([tail, x], -1) - _column(dc.to(CDTYPE))
    k = torch.arange(-t, re.shape[-1], dtype=torch.int64, device=re.device)
    mixed = z * nco.oscillator(nco.accumulator(
        _column(carry.phase), _column(params.phase_inc), k))
    _, y = decimator.fused_process(
        plan, decimator.FusedParams(params.h_eq),
        decimator.FusedCarry(mixed[..., :t]), mixed[..., t:])
    return _new_carry(params, carry, re, im), y


def process_planes(plan: DecimationPlan, params: MixDecParams,
                   carry: MixDecCarry, re: torch.Tensor, im: torch.Tensor,
                   dc: torch.Tensor) -> tuple[MixDecCarry, torch.Tensor]:
    """One block given as float32 re/im planes (strided views of a
    complex tensor are fine) or int16 planes, plus the complex NCO-spur DC
    offset.  Returns the new carry and the len(re)/D decimated complex
    samples.  For a bank (a [C, t] carry) the planes are [n] (shared) or
    [C, n] and the result is [C, n/D]."""
    if _build.on_cpu(re, im, carry.raw_tail):
        return process_planes_plain(plan, params, carry, re, im, dc)
    n = re.shape[-1]
    D = plan.decimation
    if n % D:
        raise ValueError(f"mixdec block {n} not a multiple of {D}")
    L = params.h_eq.shape[-1]
    tail = read_tail(plan, params, carry)
    t = tail.shape[-1]
    bank = carry.raw_tail.dim() == 2
    C = carry.raw_tail.shape[0] if bank else 1
    rows = C if bank else None
    wire = re.dtype == torch.int16
    for name, a in (("re", re), ("im", im)):
        _build.require(a, name, torch.int16 if wire else RDTYPE, n,
                       contiguous=False, rows=rows if a.dim() == 2 else None)
    _build.require(carry.raw_tail, "raw_tail", CDTYPE, rows=rows)
    _build.require(params.h_eq, "h_eq", RDTYPE, L)
    _build.require(carry.phase.reshape(-1), "phase", torch.int64, C)
    dc = dc.to(CDTYPE).reshape(-1)
    _build.require(dc, "dc", CDTYPE, C)
    if isinstance(params.phase_inc, torch.Tensor):   # read on the card
        incs = params.phase_inc
        _build.require(incs.reshape(-1), "phase_inc", torch.int64, C)
        incs_ptr, inc0 = incs.data_ptr(), 0
    else:
        incs_ptr, inc0 = None, params.phase_inc
    _build.require(params.taps, "taps", RDTYPE, L)
    y = torch.empty((C, n // D) if bank else (n // D,), dtype=CDTYPE,
                    device=re.device)
    plan_ = launch_plan(n // D, C, D, L, _build.sm_count(re.device))
    cstride = lambda a: a.stride(0) if a.dim() == 2 else 0
    lib = _build.library()
    name = "mixdec_int16" if wire else "mixdec"
    call = lib.cutesdr_mixdec_i16 if wire else lib.cutesdr_mixdec
    _build.check(call(
        re.data_ptr(), im.data_ptr(), cstride(re), cstride(im),
        re.stride(-1), im.stride(-1), tail.data_ptr(), t, cstride(tail),
        params.taps.data_ptr(), L, dc.data_ptr(), carry.phase.data_ptr(), incs_ptr,
        inc0, nco.PHASE_SCALE, D, n // D, C, plan_.tile_out, plan_.threads,
        y.data_ptr(), _build.stream(re)), name)
    LAUNCHES[name] += 1
    return _new_carry(params, carry, re, im), y
