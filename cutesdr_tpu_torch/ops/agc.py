"""Digital AGC (port of ``cutesdr_tpu/ops/agc.py``).

1. a 15 ms signal delay line so the gain leads the signal;
2. log magnitude log10(max(|I|,|Q|) + K_MIN) - log10(32767), in decades;
3. an 18 ms sliding-window peak (van Herk cummax);
4. attack and decay averagers, solved in parallel by guess-verify over
   the branch pattern, with an exact sequential fallback (on the card
   one launch of kernel N1, ``kernels/agcseq``).  The decay
   averager is two-rate, or in hang mode rises fast, holds for hang_time
   samples and then releases;
5. the gain law: fixed gain below the knee, 10^(mag*(slope-1)) above.

``process`` takes the single stream and a channel bank alike ([C, n]
with per-channel carries, as the JAX package's vmapped form;
``process_batch`` is the same function).
Each averager's guess-verify solve is one launch on the card, warm start
and every round on the device, a row frozen once it validates: the
two-rate averagers' (K4, ``kernels/scan.guess_verify_solve``) and hang
mode's decay averager's (N3h, ``kernels/scan.hang_solve``).  The choice
between the parallel result and the sequential fallback is made on the
device, as JAX's ``lax.cond`` makes it: N1 takes the convergence flag of
both averagers over every row (a bank votes bank-wide, as JAX's
``process_batch`` does), returns at once where it holds and otherwise
writes the exact result over the parallel one (``_fallback``), so the
step reads nothing on the host and can be replayed as a CUDA graph.  On
the CPU the plain versions run their rounds from Python (one host read a
round) and the fallback branches on their flag.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from cutesdr_tpu_torch.kernels import DeviceCounts, agcseq, scan
from cutesdr_tpu_torch.ops.util import sliding_window_max
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
# state), counted where it runs (N1 on the card), and the two-rate
# averagers' guess-verify solves and the rounds they ran, counted by K4
# (``solve_rounds`` / ``solves``: the rounds a solve); read by tests, the
# benchmark and chip_smoke.py, the only host reads of them
STATS = DeviceCounts("scan_fallbacks", "solve_rounds", "solves")


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
    """A bank adds a leading channel axis to every field."""
    sig_delay: torch.Tensor      # [delay_samples] complex input history
    mag_tail: torch.Tensor       # [window_samples-1] magnitude history
    attack_ave: torch.Tensor     # float32 0-dim
    decay_ave: torch.Tensor
    hang_timer: torch.Tensor     # int32 0-dim (hang mode only)


def make_params(cfg: AgcConfig, threshold_db: float, manual_gain_db: float,
                slope_factor: float, decay_ms: float) -> AgcParams:
    fs = cfg.sample_rate
    knee = threshold_db / 20.0
    gain_slope = slope_factor / 100.0
    fixed_gain = AGC_OUTSCALE * 10.0 ** (knee * (gain_slope - 1.0))
    manual = MAX_AMPLITUDE * 10.0 ** (-(100.0 - manual_gain_db) / 20.0)
    a_rise = 1.0 - np.exp(-1.0 / (fs * ATTACK_RISE_TIMECONST))
    a_fall = 1.0 - np.exp(-1.0 / (fs * ATTACK_FALL_TIMECONST))
    d_rise = 1.0 - np.exp(-1.0 / (fs * decay_ms * 1e-3 * DECAY_RISEFALL_RATIO))
    if cfg.use_hang:
        d_fall = 1.0 - np.exp(-1.0 / (fs * RELEASE_TIMECONST))
    else:
        d_fall = 1.0 - np.exp(-1.0 / (fs * decay_ms * 1e-3))
    f = np.float32
    return AgcParams(knee=f(knee), gain_slope=f(gain_slope),
                     fixed_gain=f(fixed_gain), manual_gain=f(manual),
                     attack_rise_alpha=f(a_rise), attack_fall_alpha=f(a_fall),
                     decay_rise_alpha=f(d_rise), decay_fall_alpha=f(d_fall),
                     hang_time=int(fs * decay_ms * 1e-3))


def init_carry(cfg: AgcConfig, device) -> AgcCarry:
    return AgcCarry(
        sig_delay=torch.zeros(cfg.delay_samples, dtype=torch.complex64,
                              device=device),
        mag_tail=torch.full((cfg.window_samples - 1,), -16.0, dtype=RDTYPE,
                            device=device),
        attack_ave=real_scalar(-5.0, device),
        decay_ave=real_scalar(-5.0, device),
        hang_timer=torch.zeros((), dtype=torch.int32, device=device))


def _two_rate_parallel(rise_alpha, fall_alpha, x0, peak: torch.Tensor,
                       n_iters: int):
    """Guess-verify solve of the two-rate averager
        x[n] = (1-a[n])*x[n-1] + a[n]*pk[n],
        a[n] = rise if pk[n] > x[n-1] else fall.
    Every fixed-pattern trajectory lower-bounds the true one, so the
    iteration rises monotonically to the exact solution.  The solve
    kernel on the card at every size and row count (one launch, no host
    read; the JAX package's TPU gate of 65,536 samples does not apply),
    the plain loop on the CPU (``kernels/scan.guess_verify_solve``).
    Returns (trajectory, every row converged: a 0-dim device bool, or
    True where the plain loop has read it)."""
    x, ok, _ = scan.guess_verify_solve(peak, x0, rise_alpha, fall_alpha,
                                       n_iters,
                                       tally=STATS.slots(peak.device)[1:])
    return x, ok


def _hang_decay_parallel(p: AgcParams, d0, timer0, peak: torch.Tensor,
                         n_iters: int):
    """Guess-verify solve of the hang-mode decay averager: rise while
    pk > d, HOLD for hang_time samples, then release: N3h on the card
    (one launch), the plain rounds on the CPU (``kernels/scan.hang_solve``).
    Returns (trajectory, timer, all rows converged, as
    ``_two_rate_parallel``)."""
    return scan.hang_solve(peak, d0, timer0, p.decay_rise_alpha,
                           p.decay_fall_alpha, p.hang_time, n_iters)


def _averager_parallel(cfg: AgcConfig, p: AgcParams, carry: AgcCarry,
                       peak: torch.Tensor):
    """Both averagers in parallel: ((attack_last, decay_last, timer,
    max(attack, decay) series), every row of both converged: True, or a
    0-dim device bool)."""
    a, a_ok = _two_rate_parallel(p.attack_rise_alpha, p.attack_fall_alpha,
                                 carry.attack_ave, peak, GUESS_ITERS)
    if cfg.use_hang:
        d, timer, d_ok = _hang_decay_parallel(p, carry.decay_ave,
                                              carry.hang_timer, peak,
                                              GUESS_ITERS)
    else:
        d, d_ok = _two_rate_parallel(p.decay_rise_alpha, p.decay_fall_alpha,
                                     carry.decay_ave, peak, GUESS_ITERS)
        timer = carry.hang_timer
    # a bank's last values as contiguous [C] (N1 writes over them)
    return ((a[..., -1].contiguous(), d[..., -1].contiguous(), timer,
             torch.maximum(a, d)), a_ok & d_ok)


def _averager_scan(cfg: AgcConfig, p: AgcParams, carry: AgcCarry,
                   peak: torch.Tensor, out=None, skip=None, count=None):
    """The exact sequential recurrence of both averagers, every row at
    once (``kernels/agcseq``: one launch on the card, the per-sample torch
    loop on the CPU).  Returns the tuple of ``_averager_parallel``; with
    ``skip`` and ``out``, ``out`` where the flag holds (module notes of
    ``kernels/agcseq``)."""
    return agcseq.averager_scan(
        peak, carry.attack_ave, carry.decay_ave, carry.hang_timer,
        (p.attack_rise_alpha, p.attack_fall_alpha),
        (p.decay_rise_alpha, p.decay_fall_alpha),
        p.hang_time if cfg.use_hang else None, out, skip, count)


def _fallback(cfg: AgcConfig, p: AgcParams, carry: AgcCarry,
              peak: torch.Tensor, levels, ok):
    """The parallel ``levels`` (the tuple of ``_averager_parallel``) where
    ``ok`` (every row of both averagers converged) holds, else the exact
    recurrence (``_averager_scan``) over every row, counted in ``STATS``
    where it runs.  On the card the 0-dim flag is read by N1, which then
    writes the exact result over ``levels`` (no host read).  On the CPU
    the flag (True where the plain loop read it, else its 0-dim flag) is
    branched on here."""
    count = STATS.counter(peak.device, "scan_fallbacks")
    if isinstance(ok, torch.Tensor) and ok.device.type == "cuda":
        return _averager_scan(cfg, p, carry, peak, levels, ok, count)
    if bool(ok):
        return levels
    return _averager_scan(cfg, p, carry, peak, count=count)


def _prefix(cfg: AgcConfig, carry: AgcCarry, x: torch.Tensor):
    """Delay line, log magnitude, window peak — the fully parallel part."""
    n = x.shape[-1]
    zd = torch.cat([carry.sig_delay, x], -1)
    delayed = zd[..., :n]
    new_sig_delay = zd[..., n:].clone()
    inst = torch.maximum(x.real.abs(), x.imag.abs())
    mag = torch.log10(inst + MIN_CONSTANT) - np.float32(np.log10(MAX_AMPLITUDE))
    peak, mag_tail = sliding_window_max(mag, cfg.window_samples,
                                        carry.mag_tail)
    return delayed, new_sig_delay, peak, mag_tail


def _apply_gain(params: AgcParams, magsel: torch.Tensor,
                delayed: torch.Tensor) -> torch.Tensor:
    gain = torch.where(magsel <= params.knee, float(params.fixed_gain),
                       AGC_OUTSCALE * 10.0 ** (magsel * (params.gain_slope
                                                         - np.float32(1.0))))
    return delayed * gain


def process(cfg: AgcConfig, params: AgcParams, carry: AgcCarry,
            x: torch.Tensor) -> tuple[AgcCarry, torch.Tensor]:
    """One stream ``x`` [n], or a channel bank: ``x`` [C, n] with a leading
    channel axis on the carry and shared params.  Each solve is one launch
    over the bank's rows (converged channels frozen), and the fallback is
    voted bank-wide: N1 runs every channel where any channel did not
    converge, as JAX's ``lax.cond(jnp.all(valid), ...)``."""
    if not cfg.agc_on:
        return carry, x * params.manual_gain
    delayed, new_sig_delay, peak, mag_tail = _prefix(cfg, carry, x)
    levels, ok = _averager_parallel(cfg, params, carry, peak)
    a, d, timer, magsel = _fallback(cfg, params, carry, peak, levels, ok)
    y = _apply_gain(params, magsel, delayed)
    return AgcCarry(sig_delay=new_sig_delay, mag_tail=mag_tail,
                    attack_ave=a, decay_ave=d, hang_timer=timer), y


process_batch = process
