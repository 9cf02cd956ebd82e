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
(``manual``, a host bool of the params or a 0-dim bool device tensor)
selects between the fixed and the tracked gain on the device
(``torch.where``, the JAX package's ``jnp.where``): one path for both
forms, the same bits.

``DiversityReceiver`` runs the combine and the receiver step as one step,
as the JAX package jits them as one function: on a CUDA device it
replays that step as one CUDA graph over a static [n_branches,
block_size] block (``pipeline.receiver.GraphedStepper``), so a block
makes no host read and no kernel launch of its own.  The tune, filter,
DC cal, volume and ratio reach the graph in place, as the single
receiver's do; the steering switch and gain are device tensors the
receiver holds and writes in place (``set_steering``), so steering
captures nothing.  On the CPU the same step runs eagerly.
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
    manual: Any                   # use fixed_gain instead of the estimate:
                                  # a host bool or a 0-dim bool tensor
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
    g_block = torch.sum(x1 * torch.conj(x0)) / (_power(x0) + 1e-12)
    a = params.alpha
    g = float(np.float32(1.0) - np.float32(a)) * carry.gain + a * g_block
    g = torch.where(torch.as_tensor(params.manual, device=g.device),
                    params.fixed_gain, g)
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


def _write(dst: torch.Tensor, v) -> None:
    """A device param written in place (a tensor copied, a value filled)."""
    if isinstance(v, torch.Tensor):
        dst.copy_(v)
    else:
        dst.fill_(v)


@dataclass(eq=False)
class DiversityReceiver(rx.GraphedStepper):
    """N coherent IQ streams -> MRC combine -> one receiver chain, on the
    card unless ``device`` says otherwise; on the card one CUDA graph a
    block (module notes).

    ``process(iq_stack [n_branches, block_size])`` returns the receiver's
    StepOutput; ``last_gain`` / ``last_gains`` read the current gain
    estimate.  n_branches=2 is the dual-RX radio (CHAN_SETUP_DUAL_*);
    more serve antenna arrays.  ``state`` is the receiver's carry and
    ``comb_state`` the combiner's (copies of the graph's buffers where a
    graph holds them; assigning either loads it)."""
    cfg: Any                      # ReceiverConfig
    smoothing_blocks: float = 8.0
    n_branches: int = 2
    device: Any = "cuda"

    _planes = False

    def __post_init__(self):
        self.device = resolve_device(self.device)
        params, state = rx.init(self.cfg, self.device)
        if self.n_branches == 2:
            comb_p, comb_c = init(self.smoothing_blocks, self.device)
            # the steering switch as a device flag, written in place
            comb_p = comb_p._replace(manual=torch.zeros(
                (), dtype=torch.bool, device=self.device))
            self._combine = process
        else:
            comb_p, comb_c = array_init(self.n_branches,
                                        self.smoothing_blocks, self.device)
            self._combine = array_process
        self._comb = comb_p
        self._start(params, (state, comb_c))

    @property
    def graphed(self) -> bool:
        """Whether a block replays a CUDA graph (on any CUDA device)."""
        return rx.graph_rule(self.cfg, self.device)

    @property
    def _block(self) -> tuple:
        return (self.n_branches, self.cfg.block_size)

    def _graph_key(self, params: rx.ReceiverParams) -> tuple:
        return super()._graph_key(params) + (self._comb.alpha,)

    def _step(self, cfg, params, carry, x: torch.Tensor):
        """The combine, then the receiver step on the combined block."""
        want = self._block
        if tuple(x.shape) != want:
            raise ValueError(f"diversity input: expected {want}, got "
                             f"{tuple(x.shape)}")
        state, comb = carry
        comb, y = self._combine(self._comb, comb, x)
        state, out = rx.receiver_step(cfg, params, state, y)
        return (state, comb), out

    def _input(self, iq_stack) -> torch.Tensor:
        """A [n_branches, block_size] complex64 stack for ``process``
        (host numpy is moved to the receiver's device; a complex64 tensor
        in pinned host memory goes straight into a graph's static input,
        ``non_blocking``).  ``process_planes`` takes the stack as
        [n_branches, block_size] float32 or int16 planes."""
        if (self.graphed and isinstance(iq_stack, torch.Tensor)
                and iq_stack.dtype == CDTYPE and iq_stack.is_pinned()):
            return iq_stack
        return self._to_device(iq_stack, CDTYPE)

    @property
    def state(self) -> rx.ReceiverState:
        return self.carry[0]

    @state.setter
    def state(self, value: rx.ReceiverState) -> None:
        self.carry = (value, self._live_carry()[1])

    @property
    def comb_state(self):
        return self.carry[1]

    @comb_state.setter
    def comb_state(self, value) -> None:
        self.carry = (self._live_carry()[0], value)

    @property
    def comb_params(self) -> CombinerParams:
        """The combiner's params; assigning them writes the steering flag
        and gain in place (a new ``alpha`` captures anew)."""
        return self._comb

    @comb_params.setter
    def comb_params(self, value: CombinerParams) -> None:
        if self.n_branches == 2:
            _write(self._comb.manual, value.manual)
        _write(self._comb.fixed_gain, value.fixed_gain)
        if value.alpha != self._comb.alpha:
            self._comb = self._comb._replace(alpha=value.alpha)
            self._key = None

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
        """The branch-1 gain estimate (a host read of the carry)."""
        if self.n_branches != 2:
            return self.last_gains[1]
        return complex(self._live_carry()[1].gain.item())

    @property
    def last_gains(self) -> list:
        """Every branch's gain estimate (gains[0] = 1; a host read)."""
        if self.n_branches == 2:
            return [1.0 + 0.0j, self.last_gain]
        return [complex(v) for v in
                self._live_carry()[1].gains.cpu().numpy()]

    def set_steering(self, gain: complex | None) -> None:
        """Fix the combining gain (None returns to automatic MRC), written
        in place into the device flag and gain the step reads.  Pairwise
        (n_branches=2) only: array mode always tracks."""
        if self.n_branches != 2:
            raise ValueError("manual steering is pairwise-only")
        self._comb.manual.fill_(gain is not None)
        if gain is not None:
            self._comb.fixed_gain.fill_(complex(np.complex64(gain)))
