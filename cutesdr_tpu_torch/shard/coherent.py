"""Phase-coherent combining of two or more receive channels (port of
``cutesdr_tpu/shard/coherent.py``): diversity reception and simple
beamforming.

Reference analogue: none executed.  The reference defines the dual-RX
channel modes (CI_RX_CHAN_SETUP, interface/protocoldefs.h:143-152) and its
radios deliver interleaved two-channel packets, but CuteSDR demodulates
channel 1 only; this module combines the coherent streams before the
demodulator.

Maximal-ratio combining (MRC): with ch0 = s + n0 and ch1 = g*s + n1 for a
slowly varying complex channel gain g, the combiner estimates g from the
block cross-correlation of the two streams, smoothed across blocks by an
EMA (the carried state), and outputs

    y = (x0 + conj(g)*x1) / sqrt(1 + |g|^2),

up to +3 dB of SNR for equal-SNR branches.  A fixed steering gain can
take the estimate's place (manual steering).  ``array_process`` is the
same combine over M branches, each estimated against branch 0.

As in the JAX package these are plain tensor ops (XLA ops there, no
Pallas kernel): two reductions and one elementwise combine per block.
The EMA gain stays on the device, so no block reads the host; only
``DiversityReceiver.last_gain`` / ``last_gains`` do.  The steering switch
(``manual``) is a host bool of the params, so choosing it reads nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from cutesdr_tpu_torch.pipeline import receiver as rx
from cutesdr_tpu_torch.types import CDTYPE, RDTYPE, resolve_device


class CombinerParams(NamedTuple):
    alpha: float                  # EMA weight of the per-block estimate
                                  # (float32-rounded)
    manual: bool                  # use fixed_gain instead of the estimate
    fixed_gain: torch.Tensor      # complex64 0-dim steering gain


class CombinerCarry(NamedTuple):
    gain: torch.Tensor            # complex64 0-dim smoothed gain estimate


class ArrayCombinerCarry(NamedTuple):
    gains: torch.Tensor           # complex64 [M] smoothed gains (gains[0]=1)


def _alpha(smoothing_blocks: float) -> float:
    return float(np.float32(1.0 / max(1.0, smoothing_blocks)))


def _complex(v: complex, device) -> torch.Tensor:
    return torch.tensor(complex(np.complex64(v)), dtype=CDTYPE,
                        device=device)


def init(smoothing_blocks: float = 8.0, device="cuda", manual: bool = False,
         fixed_gain: complex = 1.0 + 0.0j
         ) -> tuple[CombinerParams, CombinerCarry]:
    """The two-branch combiner's (params, carry) on ``device`` (the card
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    params = CombinerParams(alpha=_alpha(smoothing_blocks),
                            manual=bool(manual),
                            fixed_gain=_complex(fixed_gain, device))
    return params, CombinerCarry(gain=_complex(1.0, device))


def _power(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(x) ** 2)


def process(params: CombinerParams, carry: CombinerCarry,
            x: torch.Tensor) -> tuple[CombinerCarry, torch.Tensor]:
    """x: [2, N] coherent complex64 streams -> combined [N]."""
    x0, x1 = x[0], x[1]
    if params.manual:
        g = params.fixed_gain
    else:
        g_block = torch.sum(x1 * torch.conj(x0)) / (_power(x0) + 1e-12)
        a = params.alpha
        g = float(np.float32(1.0) - np.float32(a)) * carry.gain + a * g_block
    norm = torch.sqrt(1.0 + torch.abs(g) ** 2)
    y = (x0 + torch.conj(g) * x1) / norm
    return CombinerCarry(gain=g), y


def array_init(n_branches: int, smoothing_blocks: float = 8.0,
               device="cuda") -> tuple[CombinerParams, ArrayCombinerCarry]:
    """M-branch MRC (antenna arrays, StackedReceiver-style streams): branch
    i's gain g_i is estimated against branch 0 and the combine is
    y = sum_i conj(g_i)*x_i / sqrt(sum_i |g_i|^2), the two-branch
    ``process`` generalized (the same math at M=2), on ``device``."""
    device = resolve_device(device)
    params = CombinerParams(alpha=_alpha(smoothing_blocks), manual=False,
                            fixed_gain=_complex(1.0, device))
    gains = torch.ones(n_branches, dtype=CDTYPE, device=device)
    return params, ArrayCombinerCarry(gains=gains)


def array_process(params: CombinerParams, carry: ArrayCombinerCarry,
                  x: torch.Tensor) -> tuple[ArrayCombinerCarry, torch.Tensor]:
    """x: [M, N] coherent complex64 streams -> MRC-combined [N]."""
    x0 = x[0]
    g_block = torch.sum(x * torch.conj(x0)[None, :], dim=-1) / (
        _power(x0) + 1e-12)
    a = params.alpha
    g = float(np.float32(1.0) - np.float32(a)) * carry.gains + a * g_block
    g = torch.cat([torch.ones(1, dtype=CDTYPE, device=g.device), g[1:]])
    norm = torch.sqrt(torch.sum(torch.abs(g) ** 2))
    y = torch.sum(torch.conj(g)[:, None] * x, dim=0) / norm
    return ArrayCombinerCarry(gains=g), y


@dataclass
class DiversityReceiver:
    """N coherent IQ streams -> MRC combine -> one receiver chain, on the
    card unless ``device`` says otherwise.

    ``process(iq_stack [n_branches, block_size])`` returns the receiver's
    StepOutput; ``last_gain`` / ``last_gains`` read the current gain
    estimate.  n_branches=2 is the dual-RX radio (CHAN_SETUP_DUAL_*);
    more serve antenna arrays."""
    cfg: Any                      # ReceiverConfig
    smoothing_blocks: float = 8.0
    n_branches: int = 2
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params, self.state = rx.init(self.cfg, self.device)
        if self.n_branches == 2:
            self.comb_params, self.comb_state = init(self.smoothing_blocks,
                                                     self.device)
            self._combine = process
        else:
            self.comb_params, self.comb_state = array_init(
                self.n_branches, self.smoothing_blocks, self.device)
            self._combine = array_process

    def _step(self, x: torch.Tensor) -> rx.StepOutput:
        want = (self.n_branches, self.cfg.block_size)
        if tuple(x.shape) != want:
            raise ValueError(f"diversity input: expected {want}, got "
                             f"{tuple(x.shape)}")
        self.comb_state, y = self._combine(self.comb_params, self.comb_state,
                                           x)
        self.state, out = rx.receiver_step(self.cfg, self.params, self.state,
                                           y)
        return out

    def process(self, iq_stack) -> rx.StepOutput:
        """A [n_branches, block_size] complex64 stack (host numpy is moved
        to the receiver's device)."""
        return self._step(torch.as_tensor(iq_stack).to(self.device, CDTYPE))

    def process_planes(self, re, im) -> rx.StepOutput:
        """The stack as [n_branches, block_size] float32 or int16 planes
        (the radio's 16-bit wire format, cast on the device)."""
        re, im = (torch.as_tensor(p).to(self.device, RDTYPE)
                  for p in (re, im))
        return self._step(torch.complex(re, im))

    # --- live controls (the receiver's param-update functions) ---
    def set_tune_freq(self, freq_hz: float) -> None:
        self.params = rx.tune_params(self.cfg, self.params, freq_hz)

    def set_filter(self, low_cut: float, hi_cut: float) -> None:
        self.params = rx.filter_params(self.cfg, self.params, low_cut,
                                       hi_cut)

    def set_volume(self, vol_0_99: int) -> None:
        self.params = rx.volume_params(self.params, vol_0_99)

    def set_resample_ratio(self, ratio: float) -> None:
        self.params = rx.ratio_params(self.params, ratio)

    def set_dc_offset(self, i_off: float, q_off: float) -> None:
        self.params = self.params._replace(dc_offset=_complex(
            complex(np.float32(i_off), np.float32(q_off)), self.device))

    @property
    def last_gain(self) -> complex:
        """The branch-1 gain estimate (a host read)."""
        if self.n_branches != 2:
            return self.last_gains[1]
        return complex(self.comb_state.gain.item())

    @property
    def last_gains(self) -> list:
        """Every branch's gain estimate (gains[0] = 1; a host read)."""
        if self.n_branches == 2:
            return [1.0 + 0.0j, self.last_gain]
        return [complex(v) for v in self.comb_state.gains.cpu().numpy()]

    def set_steering(self, gain: complex | None) -> None:
        """Fix the combining gain (None returns to automatic MRC).  Pairwise
        (n_branches=2) only: array mode always tracks."""
        if self.n_branches != 2:
            raise ValueError("manual steering is pairwise-only")
        if gain is None:
            self.comb_params = self.comb_params._replace(manual=False)
        else:
            self.comb_params = self.comb_params._replace(
                manual=True, fixed_gain=_complex(gain, self.device))
