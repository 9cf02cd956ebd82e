"""Fused DC cal + NCO mix + polyphase decimation (port of
``cutesdr_tpu/kernels/mixdec.py``, ``MixDecimate.process_planes``).

The carry is one layout on both devices: the RAW input tail (taken before
the DC cal) of L-1-d samples and the uint32 DDS phase at the block start,
held as int64.  Tail samples take back-dated phases acc_0 - k*inc through
unsigned wraparound, so the history is mixed with exactly the phases it
would have had.  CUDA tensors run ``csrc/mixdec.cu``; CPU tensors the plain
version, which rebuilds the mixed history and calls
``ops.decimator.fused_process``.

A channel bank adds a leading channel axis to the carry, the DC cal and
the increments (a [C] int64 tensor of uint32 values); the composed taps
are shared.  Its input is one block for every channel (shared) or one row
per channel (stacked), and one launch serves the whole bank.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cutesdr_tpu_torch.design.decimation_plan import DecimationPlan
from cutesdr_tpu_torch.kernels import LAUNCHES, _build
from cutesdr_tpu_torch.ops import decimator, nco
from cutesdr_tpu_torch.types import CDTYPE, RDTYPE


class MixDecParams(NamedTuple):
    h_eq: torch.Tensor   # composed decimation taps, float32 [L]
    phase_inc: int | torch.Tensor   # uint32 DDS increment (round(-f/fs *
                                    # 2^32) mod 2^32); a bank: [C] int64


class MixDecCarry(NamedTuple):
    raw_tail: torch.Tensor   # [L-1-d] complex64, raw (pre-DC-cal) input
    phase: torch.Tensor      # int64 0-dim, DDS accumulator at block start


def _column(v):
    """A per-channel [C] tensor as a [C, 1] column; host ints as they are."""
    return v.unsqueeze(-1) if isinstance(v, torch.Tensor) else v


def init(plan: DecimationPlan, tune_freq: float,
         device) -> tuple[MixDecParams, MixDecCarry]:
    fp, fc = decimator.fused_init(plan, device)
    np_, nc = nco.init(tune_freq, plan.in_rate, device)
    return (MixDecParams(h_eq=fp.h_eq, phase_inc=np_.phase_inc),
            MixDecCarry(raw_tail=fc.tail, phase=nc.phase_acc))


def _new_carry(params: MixDecParams, carry: MixDecCarry, re: torch.Tensor,
               im: torch.Tensor) -> MixDecCarry:
    n, t = re.shape[-1], carry.raw_tail.shape[-1]
    rows = carry.raw_tail.shape[:-1]
    if n >= t:
        tail = torch.complex(re[..., n - t:], im[..., n - t:])
        tail = tail.expand(rows + (t,)).contiguous()
    else:
        x = torch.complex(re, im).expand(rows + (n,))
        tail = torch.cat([carry.raw_tail, x], -1)[..., n:]
    return MixDecCarry(raw_tail=tail,
                       phase=nco.advance(carry.phase, params.phase_inc, n))


def process_planes_plain(plan: DecimationPlan, params: MixDecParams,
                         carry: MixDecCarry, re: torch.Tensor,
                         im: torch.Tensor, dc: torch.Tensor
                         ) -> tuple[MixDecCarry, torch.Tensor]:
    """The plain version: (z - dc) * e^{j phase} over z = [raw tail | x]
    with the tail's phases back-dated, then the composed decimator."""
    t = carry.raw_tail.shape[-1]
    x = torch.complex(re, im).expand(carry.raw_tail.shape[:-1]
                                     + re.shape[-1:])
    z = torch.cat([carry.raw_tail, x], -1) - _column(dc.to(CDTYPE))
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
    """One block given as f32 re/im planes (strided views of a complex
    tensor are fine) plus the complex NCO-spur DC offset.  Returns the
    new carry and the len(re)/D decimated complex samples.  For a bank
    (a [C, t] carry) the planes are [n] (shared) or [C, n] and the result
    is [C, n/D]."""
    if _build.on_cpu(re, im, carry.raw_tail):
        return process_planes_plain(plan, params, carry, re, im, dc)
    n = re.shape[-1]
    D = plan.decimation
    if n % D:
        raise ValueError(f"mixdec block {n} not a multiple of {D}")
    L = params.h_eq.shape[-1]
    t = carry.raw_tail.shape[-1]
    if t != L - 1 - decimator.total_offset(plan):
        raise ValueError(f"mixdec tail {t} does not fit the plan (L={L})")
    bank = carry.raw_tail.dim() == 2
    C = carry.raw_tail.shape[0] if bank else 1
    rows = C if bank else None
    for name, a in (("re", re), ("im", im)):
        _build.require(a, name, RDTYPE, n, contiguous=False,
                       rows=rows if a.dim() == 2 else None)
    _build.require(carry.raw_tail, "raw_tail", CDTYPE, t, rows=rows)
    _build.require(params.h_eq, "h_eq", RDTYPE, L)
    _build.require(carry.phase.reshape(-1), "phase", torch.int64, C)
    dc = dc.to(CDTYPE).reshape(-1)
    _build.require(dc, "dc", CDTYPE, C)
    if bank:
        incs = params.phase_inc
        _build.require(incs, "phase_inc", torch.int64, C)
        incs_ptr, inc0 = incs.data_ptr(), 0
    else:
        incs_ptr, inc0 = None, params.phase_inc
    taps = params.h_eq.flip(-1).contiguous()
    y = torch.empty((C, n // D) if bank else (n // D,), dtype=CDTYPE,
                    device=re.device)
    cstride = lambda a: a.stride(0) if a.dim() == 2 else 0
    lib = _build.library()
    _build.check(lib.cutesdr_mixdec(
        re.data_ptr(), im.data_ptr(), cstride(re), cstride(im),
        re.stride(-1), im.stride(-1), carry.raw_tail.data_ptr(), t,
        taps.data_ptr(), L, dc.data_ptr(), carry.phase.data_ptr(), incs_ptr,
        inc0, nco.PHASE_SCALE, D, n // D, C, y.data_ptr(),
        _build.stream(re)), "mixdec")
    LAUNCHES["mixdec"] += 1
    return _new_carry(params, carry, re, im), y
