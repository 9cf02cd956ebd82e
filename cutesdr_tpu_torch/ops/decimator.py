"""Composed polyphase decimator (port of the ``fused`` form of
``cutesdr_tpu/ops/decimator.py``).

The whole half-band / CIC3 cascade of a decimation plan is one equivalent
FIR at the input rate, H_eq(z) = prod_k H_k(z^(2^k)), run as a single
stride-D correlation: y[n] = (H_eq * x)[D*n + d] with d = ``total_offset``.
This is the plain version behind the mixdec kernel
(``cutesdr_tpu_torch/kernels/mixdec.py``), which carries the raw input
history and mixes it itself; the stage-by-stage ``cascade`` form is not
ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cutesdr_tpu_torch.design.decimation_plan import DecimationPlan
from cutesdr_tpu_torch.ops.util import complex_strided_corr
from cutesdr_tpu_torch.types import CDTYPE, RDTYPE


class FusedParams(NamedTuple):
    h_eq: torch.Tensor   # composed taps, float32


class FusedCarry(NamedTuple):
    tail: torch.Tensor   # (len(H_eq) - 1 - d)-sample complex input tail


def stage_offset(name: str) -> int:
    return 1 if name == "cic3" else 0


def total_offset(plan: DecimationPlan) -> int:
    return sum(stage_offset(name) << i for i, name in enumerate(plan.stages))


def tail_length(plan: DecimationPlan) -> int:
    return len(plan.composed_taps()) - 1 - total_offset(plan)


def fused_init(plan: DecimationPlan, device) -> tuple[FusedParams, FusedCarry]:
    h = np.asarray(plan.composed_taps())
    return (FusedParams(h_eq=torch.tensor(h, dtype=RDTYPE, device=device)),
            FusedCarry(tail=torch.zeros(tail_length(plan), dtype=CDTYPE,
                                        device=device)))


def fused_process(plan: DecimationPlan, params: FusedParams,
                  carry: FusedCarry,
                  x: torch.Tensor) -> tuple[FusedCarry, torch.Tensor]:
    """y[n] = sum_j H[j] x[D*n + d - j] for n = 0 .. len(x)/D - 1.

    With z = [tail | x] and the tail holding the last L-1-d samples,
    output n reads z[D*n : D*n + L] under the flipped-tap correlation."""
    z = torch.cat([carry.tail, x], -1)
    y = complex_strided_corr(z, params.h_eq.flip(-1), stride=plan.decimation)
    tail_len = carry.tail.shape[-1]
    return FusedCarry(tail=z[..., z.shape[-1] - tail_len:].clone()), y
