"""Synchronous AM demodulator, carrier-tracking PLL (port of
``cutesdr_tpu/demod/sam.py``).

The PLL (loop BW 100 Hz, zeta 0.707, NCO clamped to +-1 kHz) takes one of
two tiers per block, numbered as in the JAX package:

* 0, linear: the parallel locked-loop solve (``ops/pll.solve_locked``),
  taken when its own validity flag says the linearization was exact;
* 2, scan: the exact sequential loop (``kernels/seqloop.sam_pll_scan``,
  the K8 kernel on CUDA), during acquisition or on carrier-less noise.

There is no chunked tier 1: the 100 Hz loop's memory (~2600 samples) is
as long as any useful chunk (see the JAX module).  The JAX package picks
the tier on the device with ``lax.cond``, and so does the card here: K8
takes the linear tier's validity flag and returns at once where it
holds, else writes the exact loop's outputs over the linear tier's
(``_exact_over``); the tier is a 0-dim int32 device tensor, counted in
``STATS`` on the device, so the step reads nothing on the host.  On the
CPU the same function branches on its bool.  ``process_probed`` returns
the tier as a host int.  Every function takes a channel bank as well
([C, n] input, a leading channel axis on the carry, shared params), with
the tier voted bank-wide as in the JAX package's ``_pll_batch``: a
locked channel takes the scan tier when another channel of the bank is
not.  The baseband is
rotated by the pre-update phase sequence either way, as the reference
does; stereo splits the DC-removed I/Q into LSB (left) and USB (right)
through a 0-10 kHz Hilbert bandpass pair.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cutesdr_tpu_torch.demod.am import dc_block
from cutesdr_tpu_torch.design.fir_kaiser import (design_lowpass,
                                                 hilbert_bandpass)
from cutesdr_tpu_torch.kernels import DeviceCounts, _build, seqloop
from cutesdr_tpu_torch.ops import fir, pll
from cutesdr_tpu_torch.ops.pll import TWO_PI, wrap_pi
from cutesdr_tpu_torch.types import K_2PI, real_scalar

PLL_BW = 100.0
PLL_ZETA = 0.707
PLL_LIMIT = 1000.0

TIER_LINEAR, TIER_SCAN = 0, 2
TIER_NAMES = {TIER_LINEAR: "linear", TIER_SCAN: "scan"}
# blocks per tier taken, counted on the device
STATS = DeviceCounts(TIER_NAMES[TIER_LINEAR], TIER_NAMES[TIER_SCAN])


class SamParams(NamedTuple):
    pll_alpha: np.float32
    pll_beta: np.float32
    nco_limit: np.float32         # +- rad/sample clamp
    pll_kernel: torch.Tensor      # [D,2,2] locked-loop impulse response
    hilbert: fir.FirParams        # 0..10 kHz Hilbert bandpass pair (stereo)


class SamCarry(NamedTuple):
    nco_phase: torch.Tensor       # float32 0-dim
    nco_freq: torch.Tensor
    z1: torch.Tensor              # DC state, I plane
    y1: torch.Tensor              # DC state, Q plane (stereo)
    hilbert: fir.FirCarry


def init(sample_rate: float, device) -> tuple[SamParams, SamCarry]:
    norm = K_2PI / sample_rate
    alpha = 2.0 * PLL_ZETA * PLL_BW * norm
    beta = (alpha * alpha) / (4.0 * PLL_ZETA * PLL_ZETA)
    lp = design_lowpass(1.0, 40.0, 4500.0, 5500.0, sample_rate)
    hi, hq = hilbert_bandpass(lp, 5000.0, sample_rate)
    fp, fc = fir.init(hi, device, taps_q=hq, complex_input=True)
    kernel = pll.locked_loop_kernel(float(alpha), float(beta))
    zero = lambda: real_scalar(0.0, device)
    return (SamParams(pll_alpha=np.float32(alpha), pll_beta=np.float32(beta),
                      nco_limit=np.float32(PLL_LIMIT * norm),
                      pll_kernel=torch.tensor(kernel.astype(np.float32),
                                              device=device),
                      hilbert=fp),
            SamCarry(nco_phase=zero(), nco_freq=zero(), z1=zero(), y1=zero(),
                     hilbert=fc))


def _exact_over(params: SamParams, carry: SamCarry, theta: torch.Tensor,
                linear, ok: torch.Tensor):
    """The exact loop's (phase', freq', pre-update phase sequence) over the
    linear tier's ``linear`` where ``ok`` (the linear tier is exact for
    every stream) does not hold: on the card one K8 launch that reads
    ``ok`` itself (no host read); on the CPU a branch on the bool, and no
    loop where it holds."""
    args = (params.pll_alpha, params.pll_beta, params.nco_limit,
            carry.nco_phase, carry.nco_freq, theta)
    if not _build.on_cpu(ok):
        return seqloop.sam_pll_scan(*args, ok, linear)
    return linear if bool(ok) else seqloop.sam_pll_scan(*args)


def _pll_linear(params: SamParams, carry: SamCarry, theta: torch.Tensor):
    """Parallel locked-loop solve; pre-update phases come back as
    theta - e (equal to the scan's mod 2pi, which the rotation absorbs)."""
    e0 = wrap_pi(theta[..., 0] - carry.nco_phase)
    psi = wrap_pi(theta[..., 1:] - theta[..., :-1])
    u = torch.cat([theta.new_zeros(theta.shape[:-1] + (1,)), psi], -1)
    e, f_next, valid = pll.solve_locked(params.pll_kernel, params.pll_beta,
                                        params.nco_limit, e0,
                                        carry.nco_freq, u)
    prev = theta - e
    e_last, f_last = e[..., -1], f_next[..., -1]
    phase = torch.remainder(theta[..., -1] - e_last + f_last
                            + float(params.pll_alpha) * e_last, TWO_PI)
    return valid, (phase, f_last, prev)


def _pll(params: SamParams, carry: SamCarry, x: torch.Tensor):
    """Tiered PLL; returns (tier, phase', freq', baseband, phase error),
    the tier a 0-dim int32 tensor, counted in ``STATS``."""
    theta = torch.atan2(x.imag, x.real)
    valid, linear = _pll_linear(params, carry, theta)
    ok = valid.all()
    phase, freq, prev = _exact_over(params, carry, theta, linear, ok)
    slot = (~ok).int()                     # STATS slot: 0 linear, 1 scan
    STATS.add(slot)
    tier = slot * TIER_SCAN
    base = x * torch.complex(torch.cos(prev), -torch.sin(prev))
    return tier, phase, freq, base, wrap_pi(theta - prev)


def _post_mono(carry: SamCarry, phase, freq, base):
    z1, y = dc_block(carry.z1, base.real)
    return carry._replace(nco_phase=phase, nco_freq=freq, z1=z1), y


def _post_stereo(params: SamParams, carry: SamCarry, phase, freq, base):
    z1, yi = dc_block(carry.z1, base.real)
    y1, yq = dc_block(carry.y1, base.imag)
    fc, f = fir.process_complex(params.hilbert, carry.hilbert,
                                torch.complex(yi, yq))
    left = f.real + f.imag       # lower sideband
    right = f.real - f.imag      # upper sideband
    return (carry._replace(nco_phase=phase, nco_freq=freq, z1=z1, y1=y1,
                           hilbert=fc),
            torch.complex(left, right))


def process(params: SamParams, carry: SamCarry,
            x: torch.Tensor) -> tuple[SamCarry, torch.Tensor]:
    _tier, phase, freq, base, _ = _pll(params, carry, x)
    return _post_mono(carry, phase, freq, base)


def probed(params: SamParams, carry: SamCarry, x: torch.Tensor):
    """process() + the PLL phase-error series x100 (the reference's
    PROFILE_6 tap, dsp/samdemod.cpp:92) and the tier taken, a 0-dim int32
    device tensor.  Returns (carry', audio, p6, tier)."""
    tier, phase, freq, base, err = _pll(params, carry, x)
    c, y = _post_mono(carry, phase, freq, base)
    return c, y, err * 100.0, tier


def process_probed(params: SamParams, carry: SamCarry, x: torch.Tensor):
    """``probed`` with the tier read to a host int."""
    c, y, p6, tier = probed(params, carry, x)
    return c, y, p6, int(tier)


def process_stereo(params: SamParams, carry: SamCarry,
                   x: torch.Tensor) -> tuple[SamCarry, torch.Tensor]:
    _tier, phase, freq, base, _ = _pll(params, carry, x)
    return _post_stereo(params, carry, phase, freq, base)


# The JAX package's channel-bank entry points: the functions above take a
# bank as they are, with the tier voted bank-wide.
process_batch = process
process_batch_stereo = process_stereo
