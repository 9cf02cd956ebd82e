"""NBFM demodulator with PLL frequency tracker and noise squelch (port of
``cutesdr_tpu/demod/fm.py``).

The PLL (BW 6 kHz, zeta 0.707, +-6 kHz range) has an NCO-frequency term
that is the FM audio once its slow DC (a one-pole tracked offset) is
removed.  It takes one of three tiers per block, numbered as in the JAX
package:

* 0, linear: the parallel locked-loop solve (``ops/pll.solve_locked``);
* 1, chunked: the exact recurrence as concurrent chunk scans with a
  bitwise boundary check, for blocks of at least four 128-sample chunks
  (``_chunkable``) where every boundary held;
* 2, scan: the exact sequential loop.

Tiers 1 and 2 are one call of ``kernels/seqloop.fm_pll_chunked`` (one
launch of the K7 kernel on the card, its plain version on the CPU): the
chunked tier's schedule with its failed chunks repaired in the same
call, so its outputs are the sequential loop's, and its first check's
flag labels the block tier 1 (chunkable and every boundary held) or 2.
``_pll_chunked`` (``ops/pll.chunked_scan``, JAX's chunked tier) is no
tier here: the tests and the smoke hold K7's flag to it.

The JAX package picks the tier on the device with ``lax.cond``, and so
does the card here: K7 takes the linear tier's validity flag and returns
at once where it holds, else writes the exact loop's outputs over the
linear tier's (``_exact_over``), and the tier is a 0-dim int32 device
tensor, counted in ``STATS`` on the device: no host read, so the step can
be replayed as a CUDA graph.  On the CPU the same function branches on
its bool and runs no loop where the linear tier held.  ``process_probed``
and ``last_tier`` return the tier as a host int (a read outside the
step).  Every function takes a channel bank as well ([C, n] input,
a leading channel axis on the carry, shared params): the tier is then
voted bank-wide, as in the JAX package's ``process_batch``, so a locked
channel takes the scan tier when another channel of the bank is not.
Every tier runs the DC tracker afterwards, vectorized in the offset
frame (``_dc_track``).  The noise squelch (HP FIR, rectified EMA,
+-100 hysteresis against a 0..5000 threshold) and the optional one-pole
de-emphasis are parallel and stay on the device.  The three one-pole
EMAs (DC tracker, squelch, de-emphasis) are each one launch of the affine
scan on the card (``kernels/scan.ema``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cutesdr_tpu_torch.design.fir_kaiser import design_highpass
from cutesdr_tpu_torch.design.iir_biquad import biquad_lowpass
from cutesdr_tpu_torch.kernels import DeviceCounts, _build, scan, seqloop
from cutesdr_tpu_torch.ops import fir, iir, pll
from cutesdr_tpu_torch.ops.pll import TWO_PI, wrap_pi
from cutesdr_tpu_torch.types import K_2PI, real_scalar

FMPLL_RANGE = 6000.0
VOICE_BANDWIDTH = 3000.0
FMPLL_BW = VOICE_BANDWIDTH * 2.0
FMPLL_ZETA = 0.707
FMDC_ALPHA = 0.01
MAX_FMOUT = 25000.0
SQUELCH_MAX = 5000.0
SQUELCHAVE_TIMECONST = 0.02
SQUELCH_HYSTERESIS = 100.0

PLL_CHUNK = 128
PLL_HALO = 128

TIER_LINEAR, TIER_CHUNKED, TIER_SCAN = 0, 1, 2
TIER_NAMES = {TIER_LINEAR: "linear", TIER_CHUNKED: "chunked",
              TIER_SCAN: "scan"}
# blocks per tier taken, counted on the device
STATS = DeviceCounts(*(TIER_NAMES[t] for t in sorted(TIER_NAMES)))


class FmParams(NamedTuple):
    pll_alpha: np.float32
    pll_beta: np.float32
    nco_limit: np.float32
    out_gain: np.float32
    dc_alpha: np.float32
    squelch_alpha: np.float32
    squelch_threshold: np.float32
    pll_kernel: torch.Tensor      # [D,2,2] powers A^d of the locked loop
    hp_fir: fir.FirParams         # noise HP above the voice band
    lp_iir: iir.IirParams         # 3 kHz audio lowpass when squelch open
    deemph_alpha: np.float32      # one-pole de-emphasis; 1.0 = off (y = x)


class FmCarry(NamedTuple):
    nco_phase: torch.Tensor       # float32 0-dim
    nco_freq: torch.Tensor
    freq_error_dc: torch.Tensor
    squelch_ave: torch.Tensor
    squelch_on: torch.Tensor      # bool 0-dim
    hp_fir: fir.FirCarry
    lp_iir: iir.IirCarry
    deemph: torch.Tensor          # de-emphasis filter state


def squelch_threshold_from_ui(value: int) -> float:
    """UI 0..99 -> threshold (99 forces permanent squelch)."""
    return SQUELCH_MAX - (SQUELCH_MAX * value) / 99.0


def deemphasis_alpha(sample_rate: float, tau_us: float) -> float:
    """One-pole de-emphasis coefficient for a time constant in
    microseconds; 0 (off) maps to alpha = 1 (identity)."""
    if tau_us <= 0.0:
        return 1.0
    return float(1.0 - np.exp(-1.0 / (sample_rate * tau_us * 1e-6)))


def _one_pole(sample_rate: float, timeconst: float) -> np.float32:
    return np.float32(1.0 - np.exp(-1.0 / (sample_rate * timeconst)))


def _hp_taps(fm_bw: float, sample_rate: float):
    return design_highpass(1.0, 50.0, fm_bw, fm_bw * 0.6, sample_rate)


def init(sample_rate: float, device, squelch_ui_value: int = 0,
         fm_bw: float = VOICE_BANDWIDTH,
         deemphasis_us: float = 0.0) -> tuple[FmParams, FmCarry]:
    norm = K_2PI / sample_rate
    alpha = 2.0 * FMPLL_ZETA * FMPLL_BW * norm
    beta = (alpha * alpha) / (4.0 * FMPLL_ZETA * FMPLL_ZETA)
    limit = FMPLL_RANGE * norm
    kernel = pll.locked_loop_kernel(float(alpha), float(beta))
    fp, fc = fir.init(_hp_taps(fm_bw, sample_rate), device)
    ip, ic = iir.init(biquad_lowpass(VOICE_BANDWIDTH, 1.0, sample_rate),
                      device)
    f = np.float32
    params = FmParams(
        pll_alpha=f(alpha), pll_beta=f(beta), nco_limit=f(limit),
        out_gain=f(MAX_FMOUT / limit),
        dc_alpha=_one_pole(sample_rate, FMDC_ALPHA),
        squelch_alpha=_one_pole(sample_rate, SQUELCHAVE_TIMECONST),
        squelch_threshold=f(squelch_threshold_from_ui(squelch_ui_value)),
        pll_kernel=torch.tensor(kernel.astype(np.float32), device=device),
        hp_fir=fp, lp_iir=ip,
        deemph_alpha=f(deemphasis_alpha(sample_rate, deemphasis_us)))
    zero = lambda: real_scalar(0.0, device)
    carry = FmCarry(
        nco_phase=zero(), nco_freq=zero(), freq_error_dc=zero(),
        squelch_ave=zero(),
        squelch_on=torch.tensor(True, device=device),
        hp_fir=fc, lp_iir=ic, deemph=zero())
    return params, carry


def set_squelch(params: FmParams, ui_value: int) -> FmParams:
    return params._replace(
        squelch_threshold=np.float32(squelch_threshold_from_ui(ui_value)))


def set_deemphasis(params: FmParams, tau_us: float,
                   sample_rate: float) -> FmParams:
    """Live de-emphasis change; off (tau 0) by default, as the reference's
    CFmDemod has none.  Typical NBFM values: 75 us, 50 us."""
    return params._replace(
        deemph_alpha=np.float32(deemphasis_alpha(sample_rate, tau_us)))


def set_bandwidth(params: FmParams, fm_bw: float,
                  sample_rate: float) -> FmParams:
    """Re-derive the squelch HP filter when the channel filter BW changes."""
    fp, _ = fir.init(_hp_taps(fm_bw, sample_rate),
                     params.hp_fir.taps_i.device)
    return params._replace(hp_fir=fp)


def _dc_track(params: FmParams, freqs: torch.Tensor, dc0: torch.Tensor):
    """DC-tracker EMA about the block's first frequency sample as origin
    (an exact identity that keeps the float32 state near zero: the
    absolute-frame EMA was the FM chain's noise floor).  Returns
    (audio series, dc_last)."""
    off = freqs[..., 0]
    f_off = freqs - off.unsqueeze(-1)
    dcs_off = scan.ema(params.dc_alpha, f_off, dc0 - off)
    audio = (f_off - dcs_off) * float(params.out_gain)
    return audio, off + dcs_off[..., -1]


def _chunkable(n: int) -> bool:
    """Static gate of the chunked tier."""
    return n % PLL_CHUNK == 0 and n // PLL_CHUNK >= 4


def _pll_chunked(params: FmParams, carry: FmCarry, theta: torch.Tensor,
                 halo: int = PLL_HALO):
    """The exact recurrence as chunk scans (``ops/pll.chunked_scan``), with
    a ``halo`` of warm-up (the checks force repairs with a short one): JAX's
    chunked tier, the reference for K7's flag (no tier of ``_pll``)."""
    a, b, lim = (float(v) for v in (params.pll_alpha, params.pll_beta,
                                    params.nco_limit))

    def step(state, th):
        phase, freq = state
        err = -wrap_pi(th + phase)
        freq = torch.clamp(freq + b * err, -lim, lim)
        phase = wrap_pi(phase + freq + a * err)
        return (phase, freq), (freq, err)

    init = (carry.nco_phase, carry.nco_freq)
    valid, (freqs, errs), (phase, freq) = pll.chunked_scan(
        step, init, init, theta, PLL_CHUNK, halo)
    audio, dc_last = _dc_track(params, freqs, carry.freq_error_dc)
    return valid, (torch.remainder(phase, TWO_PI), freq, dc_last, audio,
                   errs)


def _linear_solve(params: FmParams, carry: FmCarry, theta: torch.Tensor):
    """Parallel solve of the locked loop: its exactness flag and (phase',
    freq', freqs, err), the outputs of K7's form."""
    e0 = -wrap_pi(theta[..., 0] + carry.nco_phase)
    psi = wrap_pi(theta[..., 1:] - theta[..., :-1])
    u = torch.cat([theta.new_zeros(theta.shape[:-1] + (1,)), -psi], -1)
    e, f_next, valid = pll.solve_locked(params.pll_kernel, params.pll_beta,
                                        params.nco_limit, e0,
                                        carry.nco_freq, u)
    e_last, f_last = e[..., -1], f_next[..., -1]
    phase = torch.remainder(-theta[..., -1] - e_last + f_last
                            + float(params.pll_alpha) * e_last, TWO_PI)
    return valid, (phase, f_last, f_next, e)


def _tracked(params: FmParams, carry: FmCarry, loop):
    """(phase', freq', dc_last, audio, err) of a loop's (phase', freq',
    freqs, err): the DC tracker, run after either tier."""
    phase, freq, freqs, err = loop
    audio, dc_last = _dc_track(params, freqs, carry.freq_error_dc)
    return phase, freq, dc_last, audio, err


def _pll_linear(params: FmParams, carry: FmCarry, theta: torch.Tensor):
    """Parallel solve of the locked loop plus its exactness flag."""
    valid, loop = _linear_solve(params, carry, theta)
    return valid, _tracked(params, carry, loop)


def _exact_over(params: FmParams, carry: FmCarry, theta: torch.Tensor,
                linear, ok: torch.Tensor):
    """The exact loop's (phase', freq', freqs, err) over the linear tier's
    ``linear`` where ``ok`` (the linear tier is exact for every stream)
    does not hold, and K7's chunked-tier flag (False where ``ok`` holds):
    on the card one K7 launch that reads ``ok`` itself (no host read);
    on the CPU a branch on the bool, and no loop where it holds."""
    args = (params.pll_alpha, params.pll_beta, params.nco_limit,
            carry.nco_phase, carry.nco_freq, theta)
    if _build.on_cpu(ok):
        if bool(ok):
            return torch.zeros(theta.shape[:-1], dtype=torch.bool), linear
        valid, *loop = seqloop.fm_pll_chunked(*args)
    else:
        valid, *loop = seqloop.fm_pll_chunked(*args, seqloop.HALO, 0, ok,
                                              linear)
    return valid, tuple(loop)


def _tier(ok: torch.Tensor, chunked: torch.Tensor, n: int) -> torch.Tensor:
    """The tier taken, a 0-dim int32 tensor on the flags' device: linear
    where ``ok``, else chunked where the block is chunkable and every
    stream's K7 flag (``chunked``) held, else scan."""
    held = (chunked.all() if _chunkable(n) else torch.zeros_like(ok)).int()
    return torch.where(ok, TIER_LINEAR, TIER_SCAN - held)


def _pll(params: FmParams, carry: FmCarry, x: torch.Tensor):
    """Tiered PLL solve.  Returns (tier, pll_out) with the tier taken (a
    0-dim int32 tensor, counted in ``STATS``); a bank takes a tier only
    where it is exact for every channel."""
    theta = torch.atan2(x.imag, x.real)
    valid, linear = _linear_solve(params, carry, theta)
    ok = valid.all()
    chunked, loop = _exact_over(params, carry, theta, linear, ok)
    tier = _tier(ok, chunked, theta.shape[-1])
    STATS.add(tier)
    return tier, _tracked(params, carry, loop)


def _noise_squelch(params: FmParams, carry: FmCarry, audio: torch.Tensor):
    fc, noise = fir.process_real(params.hp_fir, carry.hp_fir, audio)
    ave = scan.ema(params.squelch_alpha, noise.abs(),
                   carry.squelch_ave)[..., -1]

    thresh = params.squelch_threshold
    if thresh == 0.0:
        squelched = torch.ones_like(ave, dtype=torch.bool)
    else:
        squelched = torch.where(carry.squelch_on,
                                ave >= float(thresh - SQUELCH_HYSTERESIS),
                                ave >= float(thresh + SQUELCH_HYSTERESIS))

    ic, lp_audio = iir.process(params.lp_iir, carry.lp_iir, audio)
    # freeze the LP state and zero the audio while squelched
    ic = iir.IirCarry(*(torch.where(squelched, old, new)
                        for new, old in zip(ic, carry.lp_iir)))
    y = torch.where(squelched.unsqueeze(-1), torch.zeros_like(lp_audio),
                    lp_audio)
    return fc, ic, ave, squelched, y


def _post(params: FmParams, carry: FmCarry, pll_out):
    """Squelch + de-emphasis + carry assembly after the PLL."""
    phase, freq, dc, audio, _err = pll_out
    fc, ic, ave, squelched, y = _noise_squelch(params, carry, audio)
    y = scan.ema(params.deemph_alpha, y, carry.deemph)
    return FmCarry(nco_phase=phase, nco_freq=freq, freq_error_dc=dc,
                   squelch_ave=ave, squelch_on=squelched,
                   hp_fir=fc, lp_iir=ic, deemph=y[..., -1]), y


def process(params: FmParams, carry: FmCarry,
            x: torch.Tensor) -> tuple[FmCarry, torch.Tensor]:
    _tier, pll_out = _pll(params, carry, x)
    return _post(params, carry, pll_out)


def probed(params: FmParams, carry: FmCarry, x: torch.Tensor):
    """process() + the per-sample phase error x100 (the reference's
    PROFILE_6 tap, dsp/fmdemod.cpp:120) and the tier taken, a 0-dim int32
    device tensor.  Returns (carry', audio, p6, tier)."""
    tier, pll_out = _pll(params, carry, x)
    c, y = _post(params, carry, pll_out)
    return c, y, pll_out[4] * 100.0, tier


def process_probed(params: FmParams, carry: FmCarry, x: torch.Tensor):
    """``probed`` with the tier read to a host int."""
    c, y, p6, tier = probed(params, carry, x)
    return c, y, p6, int(tier)


def process_stereo(params: FmParams, carry: FmCarry,
                   x: torch.Tensor) -> tuple[FmCarry, torch.Tensor]:
    carry, y = process(params, carry, x)
    return carry, torch.complex(y, y)


# The JAX package's channel-bank entry points: the functions above take a
# bank as they are, with the tier voted bank-wide.
process_batch = process
process_batch_stereo = process_stereo


def last_tier(params: FmParams, carry: FmCarry, x: torch.Tensor) -> int:
    """The tier a block would take (0/1/2), alone, as a host int."""
    tier, _ = _pll(params, carry, x)
    return int(tier)
