"""The PyTorch port's AM, SAM and FM demodulators and the ops under them
(FIR, IIR, PLL solves, the sequential PLL loops) against the JAX package
on the CPU.  Inputs are made with numpy from a seed and fed to both.

Where the two are not bitwise equal it is for one of three reasons, each
bounded below: XLA:CPU contracts the PLL updates ``freq + beta*err`` and
``phase + freq + alpha*err`` into FMAs while the port (and its CUDA
kernels) round every product (up to 9.6e-7 rad in the FM phase-error
series, 7.2e-7 rad in the SAM phases); the two FFT libraries and prefix
trees associate differently (relative 1e-6 class); and the JAX CPU scan
tier runs FM's DC tracker inside the loop in the absolute frame, where the
port runs it after the loop in the offset frame, as the JAX package does
behind its TPU kernel (relative 1e-5, the bound of tests/test_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesdr_tpu.demod import am as j_am
from cutesdr_tpu.demod import fm as j_fm
from cutesdr_tpu.demod import sam as j_sam
from cutesdr_tpu.design.fir_kaiser import design_lowpass, hilbert_bandpass
from cutesdr_tpu.design.iir_biquad import biquad_lowpass
from cutesdr_tpu.ops import fir as j_fir
from cutesdr_tpu.ops import iir as j_iir
from cutesdr_tpu.ops import pll as j_pll
from cutesdr_tpu_torch.demod import am as t_am
from cutesdr_tpu_torch.demod import fm as t_fm
from cutesdr_tpu_torch.demod import sam as t_sam
from cutesdr_tpu_torch.kernels import seqloop as t_seq
from cutesdr_tpu_torch.ops import fir as t_fir
from cutesdr_tpu_torch.ops import iir as t_iir
from cutesdr_tpu_torch.ops import pll as t_pll

torch.set_num_threads(1)

FS = 62_500.0


def _cplx(rng, n, scale=1.0):
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * scale).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-30)


def _ang(got, want):
    """Largest wrapped angle difference."""
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return float(np.abs((d + np.pi) % (2 * np.pi) - np.pi).max())


def _theta(x):
    return np.arctan2(x.imag, x.real).astype(np.float32)


def _dc_err(got, want, x):
    """Largest error of AM/SAM audio relative to the DC block's integrator
    scale: y = z0[n] - z0[n-1] cancels two values near |x|/(1-0.99), so
    the float32 roundoff of that state, not of y, sets the floor."""
    scale = float(np.abs(x).max()) / (1.0 - t_am.DC_ALPHA)
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale


# ------------------------------------------------------------- FIR / IIR --

@pytest.mark.parametrize("complex_input", [False, True])
def test_fir_across_carry(complex_input):
    """Real post-filter taps, and the SAM stereo Hilbert pair on complex
    input: within 1e-6 of the output scale over three chained blocks
    (float32 convolutions summed in another order); tails equal."""
    rng = np.random.default_rng(20)
    lp = design_lowpass(1.0, 40.0, 4500.0, 5500.0, 31_250.0)
    if complex_input:
        hi, hq = hilbert_bandpass(lp, 5000.0, 31_250.0)
        jp, jc = j_fir.init(hi, hq, complex_input=True)
        tp, tc = t_fir.init(hi, "cpu", taps_q=hq, complex_input=True)
        jf, tf = j_fir.process_complex, t_fir.process_complex
    else:
        jp, jc = j_fir.init(lp)
        tp, tc = t_fir.init(lp, "cpu")
        jf, tf = j_fir.process_real, t_fir.process_real
    for n in (1000, 37, 4096):
        x = _cplx(rng, n, 100.0)
        if not complex_input:
            x = x.real.copy()
        jc, jy = jf(jp, jc, jnp.asarray(x))
        tc, ty = tf(tp, tc, _t(x))
        assert _rel(ty.numpy(), jy) < 1e-6
        np.testing.assert_array_equal(tc.tail.numpy(), np.asarray(jc.tail))


@pytest.mark.parametrize("complex_input", [False, True])
def test_iir_across_carry(complex_input):
    """The 3 kHz squelch lowpass biquad: within 1e-5 of the output scale
    over two chained blocks (the two log-depth prefixes associate
    differently), states within 1e-5 relative."""
    rng = np.random.default_rng(21)
    coefs = biquad_lowpass(3000.0, 1.0, FS)
    jp, jc = j_iir.init(coefs, complex_input=complex_input)
    tp, tc = t_iir.init(coefs, "cpu", complex_input=complex_input)
    j_process = jax.jit(j_iir.process)
    for n in (4096, 777):
        x = _cplx(rng, n, 1000.0)
        if not complex_input:
            x = x.real.copy()
        jc, jy = j_process(jp, jc, jnp.asarray(x))
        tc, ty = t_iir.process(tp, tc, _t(x))
        assert ty.dtype == (torch.complex64 if complex_input
                            else torch.float32)
        assert _rel(ty.numpy(), jy) < 1e-5
        for a, b in zip(tc, jc):
            b = complex(b)
            assert abs(complex(a) - b) < 1e-5 * max(abs(b), 1000.0)


# -------------------------------------------------------------------- PLL --

@pytest.mark.parametrize("mode", ["fm", "sam"])
def test_solve_locked_matches_jax(mode):
    """The locked-loop impulse response equals the JAX one in float64, and
    the FFT solve agrees within 1e-5 of its scale (float32 FFTs) with the
    same validity flag, on a locked tone's phase increments."""
    jm, tm = (j_fm, t_fm) if mode == "fm" else (j_sam, t_sam)
    jp, _ = jm.init(FS)
    tp, _ = tm.init(FS, "cpu")
    a, b = float(tp.pll_alpha), float(tp.pll_beta)
    np.testing.assert_array_equal(t_pll.locked_loop_kernel(a, b),
                                  j_pll.locked_loop_kernel(a, b))
    rng = np.random.default_rng(22)
    n = 4096
    u = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    u[0] = 0.0
    e0, f0 = np.float32(0.4), np.float32(0.01)
    je, jf, jv = j_pll.solve_locked(jp.pll_kernel, jp.pll_beta, jp.nco_limit,
                                    jnp.asarray(e0), jnp.asarray(f0),
                                    jnp.asarray(u))
    te, tf, tv = t_pll.solve_locked(tp.pll_kernel, tp.pll_beta, tp.nco_limit,
                                    torch.tensor(e0), torch.tensor(f0), _t(u))
    assert bool(tv) == bool(jv)
    assert _rel(te.numpy(), je) < 1e-5 and _rel(tf.numpy(), jf) < 1e-5


def _fm_step(tp):
    a, b, lim = (float(v) for v in (tp.pll_alpha, tp.pll_beta, tp.nco_limit))

    def step(state, th):
        phase, freq = state
        err = -t_pll.wrap_pi(th + phase)
        freq = torch.clamp(freq + b * err, -lim, lim)
        phase = t_pll.wrap_pi(phase + freq + a * err)
        return (phase, freq), (freq, err)
    return step


def test_chunked_scan_is_the_sequential_loop_on_noise():
    """On noise the chunked tier validates, and its outputs and end state
    are bitwise the sequential loop's (same torch ops, any width); against
    the JAX chunked tier the bounds of tests/test_pll_chunked.py hold up to
    the FMA rounding described above."""
    rng = np.random.default_rng(23)
    tp, tc = t_fm.init(FS, "cpu")
    jp, jc = j_fm.init(FS)
    th = _theta(_cplx(rng, 1024))
    init = (tc.nco_phase, tc.nco_freq)
    valid, (freqs, errs), (phase, freq) = t_pll.chunked_scan(
        _fm_step(tp), init, init, _t(th), 128, 128)
    assert bool(valid)
    ph, fr, freqs_s, errs_s = t_seq.fm_pll_scan_plain(
        tp.pll_alpha, tp.pll_beta, tp.nco_limit, tc.nco_phase, tc.nco_freq,
        _t(th))
    assert torch.equal(freqs, freqs_s) and torch.equal(errs, errs_s)
    assert float(torch.remainder(phase, t_pll.TWO_PI)) == float(ph)
    assert float(freq) == float(fr)
    jvalid, (jph, jfr, _, _, jerr) = jax.jit(j_fm._pll_chunked)(
        jp, jc, jnp.asarray(th))
    assert bool(jvalid)
    assert float(np.abs(errs.numpy() - np.asarray(jerr)).max()) < 2e-6
    assert _ang(float(ph), float(jph)) < 1e-5
    assert abs(float(fr) - float(jfr)) < 1e-6


def test_chunked_scan_soundness_under_failed_sync():
    """A map that never forgets its state (a pure integrator) from a wrong
    guess comes back invalid; from true guesses it is exact."""
    xs = _t(np.random.default_rng(1).standard_normal(1024).astype(np.float32))

    def integrate(state, x):
        s = state[0] + x
        return (s,), (s,)

    zero = (torch.tensor(0.0),)
    valid, _, _ = t_pll.chunked_scan(integrate, zero, (torch.tensor(123.0),),
                                     xs, 128, 128)
    assert not bool(valid)

    def decay(state, x):
        s = 0.5 * state[0] + x
        return (s,), (s,)

    valid, (ys,), (end,) = t_pll.chunked_scan(decay, zero, zero, xs, 128, 128)
    assert bool(valid)
    s, want = torch.tensor(0.0), []
    for x in xs:
        s = 0.5 * s + x
        want.append(s)
    assert torch.equal(ys, torch.stack(want)) and float(end) == float(s)
    with pytest.raises(ValueError):
        t_pll.chunked_scan(decay, zero, zero, xs[:1000], 128, 128)


# ----------------------------------------------------------------- demods --

def _tone(n, f_hz, start=0, amp=3000.0, fs=FS):
    t = (np.arange(n) + start) / fs
    return (amp * np.exp(1j * (2 * np.pi * f_hz * t + 0.3))).astype(
        np.complex64)


def _am_tone(n, start=0, fs=FS):
    t = (np.arange(n) + start) / fs
    env = 1.0 + 0.5 * np.cos(2 * np.pi * 400.0 * t)
    return (2000.0 * env * np.exp(1j * 0.3)).astype(np.complex64)


TIER_CASES = [
    # mode, stimulus, block length, tier of the last of two blocks
    ("fm", "tone", 2048, 0),
    ("fm", "noise", 2048, 1),
    ("fm", "noise", 1000, 2),       # not chunkable: 1000 % 128 != 0
    ("sam", "tone", 2048, 0),
    ("sam", "noise", 2048, 2),
]


@pytest.mark.parametrize("mode,stim,n,tier", TIER_CASES)
def test_demod_tier_parity(mode, stim, n, tier):
    """``process_probed`` of the port against the JAX demod over two
    chained blocks: the same tier each block, the FM audio within 1e-5 of
    its scale, the SAM audio within 1e-6 of the DC block's state scale
    (``_dc_err``), the phase-error probe within 2e-4 (x100 scale, FMA
    rounding), and the PLL state within 1e-5 rad and 1e-6 rad/sample."""
    rng = np.random.default_rng(30 + n)
    jm, tm = (j_fm, t_fm) if mode == "fm" else (j_sam, t_sam)
    jp, jc = jm.init(FS)
    tp, tc = tm.init(FS, "cpu")
    j_probed = jax.jit(jm.process_probed)
    for b in range(2):
        if stim == "noise":
            x = _cplx(rng, n, 3000.0)
        elif mode == "fm":
            x = _tone(n, 150.0, start=b * n)
        else:
            x = _am_tone(n, start=b * n)
        alone = t_fm.last_tier(tp, tc, _t(x)) if mode == "fm" else None
        jc, jy, jp6, jtier = j_probed(jp, jc, jnp.asarray(x))
        tc, ty, tp6, ttier = tm.process_probed(tp, tc, _t(x))
        assert ttier == int(jtier), (b, ttier, int(jtier))
        assert alone in (None, ttier)
        if mode == "sam":
            assert _dc_err(ty.numpy(), jy, x) < 1e-6
        elif np.abs(np.asarray(jy)).max() > 0:
            assert _rel(ty.numpy(), jy) < 1e-5
        else:
            assert not ty.any()                       # squelched
        assert float(np.abs(tp6.numpy() - np.asarray(jp6)).max()) < 2e-4
        assert _ang(float(tc.nco_phase), float(jc.nco_phase)) < 1e-5
        assert abs(float(tc.nco_freq) - float(jc.nco_freq)) < 1e-6
    assert ttier == tier


def test_fm_squelch_and_deemphasis_carry():
    """The FM post chain across blocks: squelch state machine (closed on
    noise, open on a tone), the frozen LP state (checked through the next
    block's audio), the de-emphasis EMA, and the live setters."""
    rng = np.random.default_rng(31)
    jp, jc = j_fm.init(FS, squelch_ui_value=10, deemphasis_us=75.0)
    tp, tc = t_fm.init(FS, "cpu", squelch_ui_value=10, deemphasis_us=75.0)
    for f in ("pll_alpha", "pll_beta", "nco_limit", "out_gain",
              "squelch_threshold", "deemph_alpha"):
        assert getattr(tp, f) == np.float32(getattr(jp, f)), f
    for f in ("dc_alpha", "squelch_alpha"):
        assert abs(getattr(tp, f) / np.float32(getattr(jp, f)) - 1) < 1e-6
    j_process = jax.jit(j_fm.process)
    scale, squelched = 1.0, []
    blocks = [_tone(2048, 150.0), _tone(2048, 150.0, 2048),
              _cplx(rng, 2048, 3000.0), _tone(2048, 150.0, 6144)]
    for i, x in enumerate(blocks):
        if i == 3:
            jp = j_fm.set_deemphasis(j_fm.set_squelch(jp, 5), 50.0, FS)
            tp = t_fm.set_deemphasis(t_fm.set_squelch(tp, 5), 50.0, FS)
            jp = j_fm.set_bandwidth(jp, 5000.0, FS)
            tp = t_fm.set_bandwidth(tp, 5000.0, FS)
        jc, jy = j_process(jp, jc, jnp.asarray(x))
        tc, ty = t_fm.process(tp, tc, _t(x))
        assert bool(tc.squelch_on) == bool(jc.squelch_on), i
        squelched.append(bool(tc.squelch_on))
        assert abs(float(tc.squelch_ave) / float(jc.squelch_ave) - 1) < 1e-4
        # within 3e-5 of the largest audio so far (squelched blocks carry
        # only the de-emphasis decay).  After the noise block the DC
        # tracker holds the two prefix trees' roundoff at the noise's
        # frequency scale (+-limit): 1.7e-6 rad/sample, which the audio
        # gain of 41,446 makes 1.3e-5 of the next tone's audio.
        scale = max(scale, float(np.abs(np.asarray(jy)).max()))
        assert float(np.abs(ty.numpy() - np.asarray(jy)).max()) < 3e-5 * scale
        assert abs(float(tc.deemph) - float(jc.deemph)) < 3e-5 * scale
    assert squelched == [False, False, True, False]


@pytest.mark.parametrize("mode", ["am", "sam"])
def test_stereo_and_am(mode):
    """AM mono and stereo, and SAM stereo (Hilbert sideband split, DC
    states of both planes), over two chained blocks: within 1e-6 of the DC
    block's state scale (``_dc_err``)."""
    jm, tm = (j_am, t_am) if mode == "am" else (j_sam, t_sam)
    if mode == "am":
        jp, jc = jm.init(5000.0, 31_250.0)
        tp, tc = tm.init(5000.0, 31_250.0, "cpu")
    else:
        jp, jc = jm.init(31_250.0)
        tp, tc = tm.init(31_250.0, "cpu")
    jc2, tc2 = jc, tc
    j_stereo, j_mono = jax.jit(jm.process_stereo), jax.jit(jm.process)
    for b in range(2):
        x = _am_tone(2048, start=b * 2048, fs=31_250.0)
        jc, jy = j_stereo(jp, jc, jnp.asarray(x))
        tc, ty = tm.process_stereo(tp, tc, _t(x))
        assert ty.dtype == torch.complex64
        assert _dc_err(ty.numpy(), jy, x) < 1e-6
        jc2, jy2 = j_mono(jp, jc2, jnp.asarray(x))
        tc2, ty2 = tm.process(tp, tc2, _t(x))
        assert _dc_err(ty2.numpy(), jy2, x) < 1e-6
    if mode == "am":
        jp = j_am.set_bandwidth(jp, 3000.0, 31_250.0)
        tp = t_am.set_bandwidth(tp, 3000.0, 31_250.0)
        np.testing.assert_array_equal(tp.post_fir.taps_i.numpy(),
                                      np.asarray(jp.post_fir.taps_i))
