"""The impulse blanker over the radio's int16 planes in one launch (kernel
K10, ``csrc/blanker.cu``).

The magnitudes of int16 planes are integers, so the route sums them in
integers (exact) and compares ``mag * ratio > sum`` in float64, as the
float64 reference does; the blanked planes are zero or the delayed input,
so they come back as int16 planes.  The carried tails are those of
``ops/noiseblanker.BlankerCarry`` (float32 magnitudes and triggers, a
complex64 delay line), which hold integers on this route.

``int16_gate_plain`` is the same integer math in torch operations, the
form every CPU tensor takes (it also returns the blanked mask, which the
kernel does not write); CUDA tensors launch the kernel.  Planes are [n]
or [C, n] rows, each with its own tails.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cutesdr_tpu_torch.kernels import LAUNCHES, _build
from cutesdr_tpu_torch.types import CDTYPE, RDTYPE

TILE = 4096               # outputs a thread block


def int16_gate_plain(re: torch.Tensor, im: torch.Tensor,
                     mag_tail: torch.Tensor, trig_tail: torch.Tensor,
                     sig_tail: torch.Tensor, mag_samples: int, width: int,
                     ratio: float):
    """(blank, out_re, out_im, mag_tail', trig_tail', sig_tail') of one
    block of int16 planes: a sample triggers where its magnitude times
    ``ratio`` exceeds the integer sum of the last ``mag_samples`` + 1
    magnitudes; a sample is blanked where a trigger lies among the last
    ``width``; the output is the input delayed by ``sig_tail``'s length,
    zero where blanked."""
    n = re.shape[-1]
    mag = torch.maximum(re.to(torch.int64).abs(), im.to(torch.int64).abs())
    z = torch.cat([torch.round(mag_tail).to(torch.int64), mag], -1)
    c = F.pad(torch.cumsum(z, -1), (1, 0))
    sums = c[..., mag_samples + 1:] - c[..., :n]
    trig = mag.double() * ratio > sums.double()
    tz = torch.cat([trig_tail > 0.5, trig], -1).to(torch.int64)
    cc = F.pad(torch.cumsum(tz, -1), (1, 0))
    blank = cc[..., width:] > cc[..., :n]
    zr = torch.cat([torch.round(sig_tail.real).to(torch.int16), re], -1)
    zi = torch.cat([torch.round(sig_tail.imag).to(torch.int16), im], -1)
    zero = zr.new_zeros(())
    return (blank, torch.where(blank, zero, zr[..., :n]),
            torch.where(blank, zero, zi[..., :n]), z[..., n:].to(RDTYPE),
            tz[..., n:].to(RDTYPE),
            torch.complex(zr[..., n:].to(RDTYPE), zi[..., n:].to(RDTYPE)))


def blank_int16(re: torch.Tensor, im: torch.Tensor, mag_tail: torch.Tensor,
                trig_tail: torch.Tensor, sig_tail: torch.Tensor,
                mag_samples: int, width: int, ratio: float):
    """(out_re, out_im, mag_tail', trig_tail', sig_tail'): ``int16_gate_
    plain`` for CPU tensors, one launch of K10 for CUDA ones."""
    if _build.on_cpu(re, im, mag_tail, sig_tail):
        return int16_gate_plain(re, im, mag_tail, trig_tail, sig_tail,
                                mag_samples, width, ratio)[1:]
    n = re.shape[-1]
    rows = re.shape[0] if re.dim() == 2 else None
    C = rows or 1
    re, im = re.contiguous(), im.contiguous()
    for name, a in (("re", re), ("im", im)):
        _build.require(a, name, torch.int16, n, rows=rows)
    tails = [t.contiguous() for t in (mag_tail, trig_tail, sig_tail)]
    d1 = sig_tail.shape[-1]
    for name, t, k, dt in (("mag_tail", tails[0], mag_samples, RDTYPE),
                           ("trig_tail", tails[1], width - 1, RDTYPE),
                           ("sig_tail", tails[2], d1, CDTYPE)):
        _build.require(t, name, dt, k, rows=rows)
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    new = [torch.empty_like(t) for t in tails]
    lib = _build.library()
    _build.check(lib.cutesdr_blanker(
        re.data_ptr(), im.data_ptr(), n if rows else 0, tails[0].data_ptr(),
        tails[1].data_ptr(), tails[2].data_ptr(), n, C, mag_samples, width,
        d1, float(ratio), TILE, out_re.data_ptr(), out_im.data_ptr(),
        new[0].data_ptr(), new[1].data_ptr(), new[2].data_ptr(),
        _build.stream(re)), "blanker")
    LAUNCHES["blanker_int16"] += 1
    return out_re, out_im, *new
