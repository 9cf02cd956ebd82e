"""Sizes the port's kernels do not take, against the JAX package on the
CPU: channel filters whose nfft the fastfir kernel refuses (a latency-sized
16384/8193, nfft = 2000), which route to the plain FFT overlap-save on
either device as JAX routes them to its XLA FFT; and odd sinc lengths of
the resampler, which the plain version evaluates in JAX's direct closed
form (the kernel takes the separable form for any length, bounded here
against the direct one).

The same seeded numpy inputs go through the JAX function and its port;
tolerances are stated per test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesdr_tpu.ops import fastfir as j_ff
from cutesdr_tpu.ops import resampler as j_rs
from cutesdr_tpu_torch import kernels
from cutesdr_tpu_torch.kernels import fastfir, resamp
from cutesdr_tpu_torch.ops import fastfir as t_ff
from cutesdr_tpu_torch.ops import resampler as t_rs

torch.set_num_threads(1)


def _cplx(rng, n, scale=1.0):
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * scale).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("nfft,ntaps,taken", [
    (2048, 1025, True),        # the default channel filter
    (8192, 4097, True),        # the kernel's largest size
    (16384, 8193, False),      # design/latency's grown filter
    (2000, 1025, False),       # not a power of 2 (test_config_fuzz.py)
    (4, 1, True),              # the smallest transform
    (2048, 2049, False),       # no valid output
])
def test_fastfir_kernel_supported(nfft, ntaps, taken):
    """The kernel's own size rule, decided from the shape alone."""
    assert fastfir.kernel_supported(nfft, ntaps) is taken


@pytest.mark.parametrize("nfft,ntaps", [(16384, 8193), (2000, 1025)])
def test_fastfir_unsupported_sizes_take_the_plain_route(nfft, ntaps):
    """Streamed through ``kernels/fastfir.process`` (the receiver's call)
    and ``filter_frames``: no launch, and within the port filter test's bar
    of JAX's ops/fastfir (5e-5 x the output's peak) over three blocks,
    the carried tails equal."""
    rng = np.random.default_rng(21)
    fs = 62_500.0
    jp, jc = j_ff.init(100.0, 2800.0, 0.0, fs, jnp.complex64, nfft=nfft,
                       ntaps=ntaps)
    tp, tc = t_ff.init(100.0, 2800.0, 0.0, fs, "cpu", nfft=nfft, ntaps=ntaps)
    n = 2 * (nfft - ntaps + 1)
    kernels.reset_launches()
    for _ in range(3):
        x = _cplx(rng, n, 100.0)
        jc, jy = j_ff.process(jp, jc, jnp.asarray(x))
        tc, ty = fastfir.process(tp, tc, _t(x))
        want = np.asarray(jy)
        assert np.abs(ty.numpy() - want).max() <= 5e-5 * np.abs(want).max()
        np.testing.assert_array_equal(tc.tail.numpy(), np.asarray(jc.tail))
    z = _t(_cplx(rng, ntaps - 1 + n, 100.0))
    assert torch.equal(fastfir.filter_frames(tp.h_freq, z, ntaps),
                       t_ff.filter_frames(tp.h_freq, z, ntaps))
    assert not any(kernels.LAUNCHES.values())


def _audio_band_sinad(y, fs, f0, guard_hz=8.0, band=(20.0, 20000.0)):
    """Tone power against in-band noise and distortion on a detrended,
    Kaiser-windowed PSD (the measure of tests/test_ops.py)."""
    y = np.asarray(y, np.float64)
    y = y - np.polyval(np.polyfit(np.arange(len(y)), y, 1), np.arange(len(y)))
    ps = np.abs(np.fft.rfft(y * np.kaiser(len(y), 38.0))) ** 2
    f = np.fft.rfftfreq(len(y), 1.0 / fs)
    tone_bins = np.abs(f - f0) <= guard_hz
    inband = (f >= band[0]) & (f <= band[1]) & ~tone_bins
    return 10 * np.log10(ps[tone_bins].sum() / ps[inband].sum())


def test_odd_periods_resample():
    """tests/test_ops.py's odd-P case in the port: 29 taps, complex input,
    a 4,096-sample block at 62.5/48 kHz resamples (more than 3,000 valid
    outputs), with no launch."""
    p, c = t_rs.init(62500 / 48000, "cpu", complex_input=True, periods=29)
    x = (1000 * np.exp(2j * np.pi * 1000 * np.arange(4096) / 62500)
         ).astype(np.complex64)
    kernels.reset_launches()
    _, y, nv = t_rs.process(p, c, _t(x), t_rs.max_out_for(4096, 62500 / 48000))
    assert int(nv) > 3000
    assert torch.isfinite(y).all()
    assert kernels.LAUNCHES["resamp"] == 0


def test_resampler_long_sinc_snr():
    """tests/test_ops.py's streaming case in the port: 48 taps (the tap
    count from the carry's shape), 64 blocks of 1,024 at 15.625 -> 48 kHz
    in the exact-position mode, above 110 dB."""
    fs_in, fs_out, f0, block = 15625.0, 48000.0, 1000.0, 1024
    rate = fs_in / fs_out
    p, c = t_rs.init(rate, "cpu", periods=48)
    assert c.tail.shape[-1] == 48
    max_out = t_rs.max_out_for(block, rate)
    ys = []
    for b in range(64):
        x = np.cos(2 * np.pi * f0 / fs_in
                   * (np.arange(block) + b * block)).astype(np.float32) * 0.3
        c, y, nv = t_rs.process(p, c, _t(x), max_out, interp=True)
        ys.append(y.numpy()[:int(nv)])
    y = np.concatenate(ys)[1000:-1000]
    assert _audio_band_sinad(y, fs_out, f0) > 110.0


@pytest.mark.parametrize("interp", [True, False])
def test_banded_process_odd_periods_matches_jax(interp):
    """``_banded_process`` at P = 29 against JAX's (its direct-form
    fallback) from the same inputs, two chained blocks 0.13% off the
    rational grid: the same output counts, outputs within 1e-5 of their
    peak (the banded resampler test's bar), t0 within 1e-6, equal
    tails."""
    rng = np.random.default_rng(8)
    rate = 62_500.0 / 48_000.0 * 1.0013
    n = 8192
    cap = t_rs.max_out_for(n, rate)
    jp, jc = j_rs.init(rate, periods=29)
    tp, tc = t_rs.init(rate, "cpu", periods=29)
    for _ in range(2):
        x = (rng.standard_normal(n) * 1000).astype(np.float32)
        jc, jy, jn = j_rs._banded_process(jp, jc, jnp.asarray(x), cap, interp)
        tc, ty, tn = t_rs._banded_process(tp, tc, _t(x), cap, interp)
        want = np.asarray(jy)
        assert int(tn) == int(jn)
        assert np.abs(ty.numpy() - want).max() <= 1e-5 * np.abs(want).max()
        assert abs(float(tc.t0) - float(jc.t0)) < 1e-6
        np.testing.assert_array_equal(tc.tail.numpy(), np.asarray(jc.tail))


@pytest.mark.parametrize("periods", [29, 31, 47])
def test_sinc_band_odd_periods_matches_direct_form(periods):
    """The separable form the kernel evaluates for odd P (the sine reduced
    about the half-integer P/2) against the direct closed form of the plain
    version and of JAX's ``_sinc_value``: within 2e-6 of the weights'
    unit scale (the direct form rounds its sine's large arguments; JAX's
    test bounds the even-P forms at 2e-4)."""
    rng = np.random.default_rng(periods)
    M = 128
    Ti = rng.integers(0, 60, 256).astype(np.int32)
    tf = rng.random(256).astype(np.float32)
    tf[:4] = (0.0, 0.5, 0.25, 1.0)
    sb = resamp.sinc_band(_t(Ti), _t(tf), M, periods).numpy()
    v = (np.arange(M, dtype=np.int32) - Ti[:, None]).astype(np.float32) \
        - tf[:, None]
    direct = resamp.sinc_value(_t(v), periods, True).numpy()
    want = np.asarray(j_rs._sinc_value(jnp.asarray(v), periods, True))
    assert np.abs(direct - want).max() < 1e-6
    assert np.abs(sb - direct).max() < 2e-6
