"""Digital AGC, non-hang mode (port of ``cutesdr_tpu/ops/agc.py``).

1. a 15 ms signal delay line so the gain leads the signal;
2. log magnitude log10(max(|I|,|Q|) + K_MIN) - log10(32767), in decades;
3. an 18 ms sliding-window peak (van Herk cummax);
4. attack and decay two-rate averagers, solved in parallel by guess-verify
   over the rise/fall branch pattern, with an exact sequential fallback;
5. the gain law: fixed gain below the knee, 10^(mag*(slope-1)) above.

The guess-verify loop is a Python loop that reads each round's mismatch
count on the host (one device sync per round, at most GUESS_ITERS rounds
per averager), and the fallback is a Python branch.  Hang mode is not
ported yet (ROADMAP Queue 1, "hang-mode AGC").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from cutesdr_tpu_torch.kernels import scan
from cutesdr_tpu_torch.ops.util import (first_order_recurrence,
                                        sliding_window_max)
from cutesdr_tpu_torch.types import MAX_AMPLITUDE, RDTYPE, real_scalar

DELAY_TIMECONST = 0.015
WINDOW_TIMECONST = 0.018
ATTACK_RISE_TIMECONST = 0.002
ATTACK_FALL_TIMECONST = 0.005
DECAY_RISEFALL_RATIO = 0.3
RELEASE_TIMECONST = 0.05
AGC_OUTSCALE = 0.7
MIN_CONSTANT = 3.2767e-4      # log10(0 + K) - log10(32767) == -8 (-160 dB)
MAX_DELAY_SAMPLES = 2047
GUESS_ITERS = 24              # cap on guess-verify rounds per averager

# how often the exact sequential fallback ran (it should not, in steady
# state); read by tests and chip_smoke.py
STATS = {"scan_fallbacks": 0}


@dataclass(frozen=True)
class AgcConfig:
    agc_on: bool
    use_hang: bool
    sample_rate: float

    @property
    def delay_samples(self) -> int:
        return min(int(self.sample_rate * DELAY_TIMECONST), MAX_DELAY_SAMPLES)

    @property
    def window_samples(self) -> int:
        return int(self.sample_rate * WINDOW_TIMECONST)


class AgcParams(NamedTuple):
    knee: np.float32             # thresh_dB / 20 (decades)
    gain_slope: np.float32       # slope / 100
    fixed_gain: np.float32
    manual_gain: np.float32
    attack_rise_alpha: np.float32
    attack_fall_alpha: np.float32
    decay_rise_alpha: np.float32
    decay_fall_alpha: np.float32
    hang_time: int               # samples


class AgcCarry(NamedTuple):
    sig_delay: torch.Tensor      # [delay_samples] complex input history
    mag_tail: torch.Tensor       # [window_samples-1] magnitude history
    attack_ave: torch.Tensor     # float32 0-dim
    decay_ave: torch.Tensor
    hang_timer: torch.Tensor     # int32 0-dim (hang mode only)


def _no_hang(cfg: AgcConfig) -> None:
    if cfg.use_hang:
        raise NotImplementedError(
            "agc_hang is not ported yet (ROADMAP Queue 1: hang-mode AGC)")


def make_params(cfg: AgcConfig, threshold_db: float, manual_gain_db: float,
                slope_factor: float, decay_ms: float) -> AgcParams:
    _no_hang(cfg)
    fs = cfg.sample_rate
    knee = threshold_db / 20.0
    gain_slope = slope_factor / 100.0
    fixed_gain = AGC_OUTSCALE * 10.0 ** (knee * (gain_slope - 1.0))
    manual = MAX_AMPLITUDE * 10.0 ** (-(100.0 - manual_gain_db) / 20.0)
    a_rise = 1.0 - np.exp(-1.0 / (fs * ATTACK_RISE_TIMECONST))
    a_fall = 1.0 - np.exp(-1.0 / (fs * ATTACK_FALL_TIMECONST))
    d_rise = 1.0 - np.exp(-1.0 / (fs * decay_ms * 1e-3 * DECAY_RISEFALL_RATIO))
    d_fall = 1.0 - np.exp(-1.0 / (fs * decay_ms * 1e-3))
    f = np.float32
    return AgcParams(knee=f(knee), gain_slope=f(gain_slope),
                     fixed_gain=f(fixed_gain), manual_gain=f(manual),
                     attack_rise_alpha=f(a_rise), attack_fall_alpha=f(a_fall),
                     decay_rise_alpha=f(d_rise), decay_fall_alpha=f(d_fall),
                     hang_time=int(fs * decay_ms * 1e-3))


def init_carry(cfg: AgcConfig, device) -> AgcCarry:
    _no_hang(cfg)
    return AgcCarry(
        sig_delay=torch.zeros(cfg.delay_samples, dtype=torch.complex64,
                              device=device),
        mag_tail=torch.full((cfg.window_samples - 1,), -16.0, dtype=RDTYPE,
                            device=device),
        attack_ave=real_scalar(-5.0, device),
        decay_ave=real_scalar(-5.0, device),
        hang_timer=torch.zeros((), dtype=torch.int32, device=device))


def _solve(A: torch.Tensor, B: torch.Tensor, x0) -> torch.Tensor:
    """x[n] = A[n]*x[n-1] + B[n]: the scan kernel from 65,536 samples up
    (the JAX package's gate), the log-depth torch solve below."""
    if scan.supported(B.shape[-1]):
        return scan.first_order_scan(A, B, x0)
    return first_order_recurrence(A, B, x0)


def _two_rate_parallel(rise_alpha, fall_alpha, x0, peak: torch.Tensor,
                       n_iters: int):
    """Guess-verify solve of the two-rate averager
        x[n] = (1-a[n])*x[n-1] + a[n]*pk[n],
        a[n] = rise if pk[n] > x[n-1] else fall.
    Every fixed-pattern trajectory lower-bounds the true one, so the
    iteration rises monotonically to the exact solution.  Returns
    (trajectory, converged)."""
    # warm start: one solve at the geometric-mean rate as a proxy state
    ag = np.sqrt(rise_alpha * fall_alpha)
    xg = _solve((np.float32(1.0) - ag) * torch.ones_like(peak),
                peak * ag, x0)
    pattern = peak > scan.shift1(xg, x0)
    one_round = scan.guess_round if scan.supported(peak.shape[-1]) \
        else scan.guess_round_plain
    x, pattern, count = one_round(peak, pattern, x0, rise_alpha, fall_alpha)
    rounds = 1
    converged = int(count) == 0                          # host sync
    while not converged and rounds < n_iters:
        x, pattern, count = one_round(peak, pattern, x0, rise_alpha,
                                      fall_alpha)
        rounds += 1
        converged = int(count) == 0                      # host sync
    return x, converged


def _averager_scan(p: AgcParams, carry: AgcCarry, peak: torch.Tensor):
    """The exact sequential recurrence of both averagers, one sample at a
    time on the tensors' device; taken only when guess-verify does not
    converge."""
    rise = torch.tensor([p.attack_rise_alpha, p.decay_rise_alpha],
                        dtype=RDTYPE, device=peak.device)
    fall = torch.tensor([p.attack_fall_alpha, p.decay_fall_alpha],
                        dtype=RDTYPE, device=peak.device)
    s = torch.stack([carry.attack_ave, carry.decay_ave])
    states = torch.empty(peak.shape[-1], 2, dtype=RDTYPE, device=peak.device)
    for i in range(peak.shape[-1]):
        pk = peak[i]
        alpha = torch.where(pk > s, rise, fall)
        s = (1.0 - alpha) * s + alpha * pk
        states[i] = s
    return s[0], s[1], states.amax(-1)


def _averager(p: AgcParams, carry: AgcCarry, peak: torch.Tensor):
    """(attack_last, decay_last, max(attack, decay) series)."""
    a, a_ok = _two_rate_parallel(p.attack_rise_alpha, p.attack_fall_alpha,
                                 carry.attack_ave, peak, GUESS_ITERS)
    d, d_ok = _two_rate_parallel(p.decay_rise_alpha, p.decay_fall_alpha,
                                 carry.decay_ave, peak, GUESS_ITERS)
    if a_ok and d_ok:
        return a[-1], d[-1], torch.maximum(a, d)
    STATS["scan_fallbacks"] += 1
    return _averager_scan(p, carry, peak)


def _prefix(cfg: AgcConfig, carry: AgcCarry, x: torch.Tensor):
    """Delay line, log magnitude, window peak — the fully parallel part."""
    n = x.shape[-1]
    zd = torch.cat([carry.sig_delay, x], -1)
    delayed = zd[:n]
    new_sig_delay = zd[n:].clone()
    inst = torch.maximum(x.real.abs(), x.imag.abs())
    mag = torch.log10(inst + MIN_CONSTANT) - np.float32(np.log10(MAX_AMPLITUDE))
    peak, mag_tail = sliding_window_max(mag, cfg.window_samples,
                                        carry.mag_tail)
    return delayed, new_sig_delay, peak, mag_tail


def _apply_gain(params: AgcParams, magsel: torch.Tensor,
                delayed: torch.Tensor) -> torch.Tensor:
    gain = torch.where(magsel <= params.knee,
                       torch.as_tensor(params.fixed_gain, device=magsel.device),
                       AGC_OUTSCALE * 10.0 ** (magsel * (params.gain_slope
                                                         - np.float32(1.0))))
    return delayed * gain


def process(cfg: AgcConfig, params: AgcParams, carry: AgcCarry,
            x: torch.Tensor) -> tuple[AgcCarry, torch.Tensor]:
    if not cfg.agc_on:
        return carry, x * params.manual_gain
    _no_hang(cfg)
    delayed, new_sig_delay, peak, mag_tail = _prefix(cfg, carry, x)
    a, d, magsel = _averager(params, carry, peak)
    y = _apply_gain(params, magsel, delayed)
    return AgcCarry(sig_delay=new_sig_delay, mag_tail=mag_tail,
                    attack_ave=a, decay_ave=d,
                    hang_timer=carry.hang_timer), y
