"""Parity of the PyTorch port's ops (CPU) with the JAX package's.

The same seeded numpy inputs, cast to float32 / complex64, go through the
JAX function and its port; tolerances are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesdr_tpu.design.decimation_plan import plan_decimation
from cutesdr_tpu.ops import agc as j_agc
from cutesdr_tpu.ops import decimator as j_dec
from cutesdr_tpu.ops import fastfir as j_ff
from cutesdr_tpu.ops import nco as j_nco
from cutesdr_tpu.ops import resampler as j_rs
from cutesdr_tpu.ops import smeter as j_sm
from cutesdr_tpu.ops import util as j_util
from cutesdr_tpu_torch.ops import agc as t_agc
from cutesdr_tpu_torch.ops import decimator as t_dec
from cutesdr_tpu_torch.ops import fastfir as t_ff
from cutesdr_tpu_torch.ops import nco as t_nco
from cutesdr_tpu_torch.ops import resampler as t_rs
from cutesdr_tpu_torch.ops import smeter as t_sm
from cutesdr_tpu_torch.ops import util as t_util

torch.set_num_threads(1)


def _cplx(rng, n, scale=1.0):
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * scale).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, rel * scale)


def test_nco_near_phase_wrap():
    """The int64 + mask DDS equals the uint32 one across the 2^32 wrap:
    the carried phase exactly, the mixed samples to float32 roundoff."""
    rng = np.random.default_rng(0)
    fs, f = 2_000_000.0, 123_456.7
    jp, jc = j_nco.init(f, fs)
    jc = jc._replace(phase_acc=jnp.uint32(2**32 - 1000))
    tp, tc = t_nco.init(f, fs, "cpu")
    tc = tc._replace(phase_acc=torch.tensor(2**32 - 1000))
    assert tp.phase_inc == int(jp.phase_inc)
    for _ in range(2):
        x = _cplx(rng, 4096, 1000.0)
        jc, jy = j_nco.process(jp, jc, jnp.asarray(x))
        tc, ty = t_nco.process(tp, tc, _t(x))
        assert int(tc.phase_acc) == int(jc.phase_acc)
        _close(ty.numpy(), np.asarray(jy), 1e-6, "nco")


def test_decimator_fused_process():
    rng = np.random.default_rng(1)
    plan = plan_decimation(2_000_000.0, 20_000.0)
    jp, jc = j_dec.fused_init(plan, jnp.complex64, jnp.float32)
    tp, tc = t_dec.fused_init(plan, "cpu")
    assert tc.tail.shape[-1] == jc.tail.shape[-1] == t_dec.tail_length(plan)
    for _ in range(2):
        x = _cplx(rng, 32 * 256, 1000.0)
        jc, jy = j_dec.fused_process(plan, jp, jc, jnp.asarray(x))
        tc, ty = t_dec.fused_process(plan, tp, tc, _t(x))
        _close(ty.numpy(), np.asarray(jy), 1e-5, "fused_process")
        np.testing.assert_array_equal(tc.tail.numpy(), np.asarray(jc.tail))


def test_fastfir_process_and_retune():
    rng = np.random.default_rng(2)
    fs = 62_500.0
    jp, jc = j_ff.init(100.0, 2800.0, 0.0, fs, jnp.complex64)
    tp, tc = t_ff.init(100.0, 2800.0, 0.0, fs, "cpu")
    for i in range(3):
        if i == 2:
            jp = j_ff.retune(jp, 300.0, 3000.0, 0.0, fs)
            tp = t_ff.retune(tp, 300.0, 3000.0, 0.0, fs)
        x = _cplx(rng, 4096, 100.0)
        jc, jy = j_ff.process(jp, jc, jnp.asarray(x))
        tc, ty = t_ff.process(tp, tc, _t(x))
        _close(ty.numpy(), np.asarray(jy), 5e-5, "fastfir")
        np.testing.assert_array_equal(tc.tail.numpy(), np.asarray(jc.tail))


@pytest.mark.parametrize("n,fast", [(8192, False), (65536, True)])
def test_smeter_series_and_last_value(n, fast):
    """A small block and a whole-32768-sample block (``fast``: the JAX
    package's final-values-only kernel gate; the port's S-meter takes the
    same dispatch at every size, its plain version on the CPU) against the
    JAX series form, within 1e-3 dB, over two chained blocks."""
    from cutesdr_tpu_torch.kernels import scan as t_scan
    assert t_scan.smeter_supported(n) == fast
    rng = np.random.default_rng(3)
    jp, jc = j_sm.init(62_500.0, jnp.float32)
    tp, tc = t_sm.init(62_500.0, "cpu")
    j_process = jax.jit(j_sm.process)
    for b in range(2):
        x = _cplx(rng, n, 300.0 * (1 + 5 * b))
        jc, jm = j_process(jp, jc, jnp.asarray(x))
        tc, tm = t_sm.process(tp, tc, _t(x))
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-4)
        for f in ("attack_ave", "decay_ave", "average_mag", "peak_mag"):
            assert abs(float(getattr(tc, f)) - float(getattr(jc, f))) < 1e-3
    jc, jpk = j_sm.get_peak(jc)
    tc, tpk = t_sm.get_peak(tc)
    assert abs(float(tpk) - float(jpk)) < 1e-3
    assert float(tc.peak_mag) == 0.0
    assert abs(float(t_sm.get_ave(tc)) - float(j_sm.get_ave(jc))) < 1e-3


def test_util_scans():
    rng = np.random.default_rng(4)
    n = 5000
    a = (0.99 + 0.005 * rng.random(n)).astype(np.float32)
    u = (rng.standard_normal(n) * 0.01).astype(np.float32)
    want = jax.jit(j_util.first_order_recurrence)(
        jnp.asarray(a), jnp.asarray(u), np.float32(-3.0))
    got = t_util.first_order_recurrence(_t(a), _t(u), np.float32(-3.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    m = (rng.standard_normal(n) * 10 - 60).astype(np.float32)
    aa = np.float32(1 / 625.0)
    ja = jax.jit(j_util.ema)(aa, jnp.asarray(m), np.float32(-120.0))
    ta = t_util.ema(aa, _t(m), np.float32(-120.0))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5 * 120)
    ad = np.float32(1 / 31250.0)
    jd = jax.jit(j_util.max_affine_recurrence)(
        np.float32(1) - ad, ad * jnp.asarray(m), ja, np.float32(-120.0))
    td = t_util.max_affine_recurrence(np.float32(1) - ad, _t(m) * ad, ta,
                                      np.float32(-120.0))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5 * 120)

    tail = (rng.standard_normal(1124) - 3).astype(np.float32)
    for w in (1, 7, 1125):
        jy, jt = j_util.sliding_window_max(jnp.asarray(m), w,
                                           jnp.asarray(tail[:w - 1]))
        ty, tt = t_util.sliding_window_max(_t(m), w, _t(tail[:w - 1]))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_util_and_smeter_bank_rows():
    """The channel-bank forms: distance_since_last_true (hang mode) with
    one carried distance per row equals JAX's vmapped form; the scans and
    the S-meter on [C, n] with per-row initial states equal the port's
    own rows one at a time, bitwise, and JAX's vmapped S-meter within
    1e-3 dB."""
    rng = np.random.default_rng(8)
    flags = rng.random((3, 700)) < np.array([[0.0], [0.01], [0.3]])
    d0 = np.array([0, 17, 5000], np.int32)
    want = jax.jit(jax.vmap(j_util.distance_since_last_true))(
        jnp.asarray(flags), jnp.asarray(d0))
    got = t_util.distance_since_last_true(_t(flags), _t(d0))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    u = _t((rng.standard_normal((3, 700)) * 0.01).astype(np.float32))
    s0 = _t(np.array([-3.0, 0.5, 2.0], np.float32))
    rows = t_util.first_order_recurrence(np.float32(0.99), u, s0)
    caps = t_util.max_affine_recurrence(np.float32(0.9), u, rows, s0)
    for c in range(3):
        r = t_util.first_order_recurrence(np.float32(0.99), u[c], s0[c])
        assert torch.equal(rows[c], r)
        assert torch.equal(
            caps[c], t_util.max_affine_recurrence(np.float32(0.9), u[c], r,
                                                  s0[c]))

    x = np.stack([_cplx(rng, 4096, 300.0 * (c + 1)) for c in range(3)])
    jp, jc = j_sm.init(62_500.0, jnp.float32)
    tp, tc = t_sm.init(62_500.0, "cpu")
    jcb = jax.tree_util.tree_map(lambda a: jnp.stack([a] * 3), jc)
    jcb, jm = jax.jit(jax.vmap(lambda c, xx: j_sm.process(jp, c, xx)))(
        jcb, jnp.asarray(x))
    tcb, tm = t_sm.process(tp, type(tc)(*(torch.stack([a] * 3) for a in tc)),
                           _t(x))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-4)
    for f in ("attack_ave", "decay_ave", "peak_mag"):
        np.testing.assert_allclose(getattr(tcb, f).numpy(),
                                   np.asarray(getattr(jcb, f)), atol=1e-3)
    for c in range(3):
        one, _ = t_sm.process(tp, tc, _t(x[c]))
        assert all(torch.equal(a[c], b) for a, b in zip(tcb, one))


def _envelope_blocks(rng, n, n_blocks):
    """Complex test signal with a stepping envelope (AGC attack/decay)."""
    out = []
    for b in range(n_blocks):
        env = np.repeat(10.0 ** rng.uniform(1, 4, n // 512), 512)
        out.append((_cplx(rng, n) * env).astype(np.complex64))
    return out


@pytest.mark.parametrize("force_fallback", [False, True])
def test_agc_three_blocks(monkeypatch, force_fallback):
    """AGC over 3 chained blocks against the JAX AGC; with one
    guess-verify round allowed, both take the exact sequential fallback."""
    rng = np.random.default_rng(5)
    fs = 15_625.0
    if force_fallback:
        monkeypatch.setattr(j_agc, "GUESS_ITERS", 1)
        monkeypatch.setattr(t_agc, "GUESS_ITERS", 1)
    jcfg = j_agc.AgcConfig(True, False, fs)
    tcfg = t_agc.AgcConfig(True, False, fs)
    jp = j_agc.make_params(jcfg, -100.0, 30.0, 0.0, 200.0)
    tp = t_agc.make_params(tcfg, -100.0, 30.0, 0.0, 200.0)
    for f in tp._fields:
        assert np.float32(getattr(tp, f)) == np.asarray(getattr(jp, f)), f
    jc = j_agc.init_carry(jcfg, True)
    tc = t_agc.init_carry(tcfg, "cpu")
    before = t_agc.STATS["scan_fallbacks"]
    # a fresh function per test, so the trace reads this test's GUESS_ITERS
    j_process = jax.jit(lambda p, c, x: j_agc.process(jcfg, p, c, x))
    for x in _envelope_blocks(rng, 4096, 3):
        jc, jy = j_process(jp, jc, jnp.asarray(x))
        tc, ty = t_agc.process(tcfg, tp, tc, _t(x))
        _close(ty.numpy(), np.asarray(jy), 1e-4, "agc")
        assert abs(float(tc.attack_ave) - float(jc.attack_ave)) < 1e-5
        assert abs(float(tc.decay_ave) - float(jc.decay_ave)) < 1e-5
        np.testing.assert_array_equal(tc.sig_delay.numpy(),
                                      np.asarray(jc.sig_delay))
        np.testing.assert_allclose(tc.mag_tail.numpy(),
                                   np.asarray(jc.mag_tail), atol=1e-6)
    fell_back = t_agc.STATS["scan_fallbacks"] > before
    assert fell_back == force_fallback


def test_agc_guess_verify_rounds_match_jax(monkeypatch):
    """On a window-peak plateau (a steady tone at 65,536 samples: the
    attack average sits within ulps of the peak), the port's plain
    guess-verify converges in as many rounds as JAX's, and to the same
    trajectory within 1e-5 decades.  Its tie forgiveness rounds each
    branch once, as XLA:CPU's FMA contraction does; rounded twice, the
    rounds crept a few samples at a time (10 here, against JAX's 2)."""
    from cutesdr_tpu_torch.kernels import scan as t_scan
    fs, n = 62_500.0, 65536
    rng = np.random.default_rng(9)
    k = np.arange(n)
    x = (1036.0 * np.exp(2j * np.pi * 1000.0 * k / fs)
         + _cplx(rng, n)).astype(np.complex64)
    cfg = t_agc.AgcConfig(True, False, fs)
    p = t_agc.make_params(cfg, -100.0, 30.0, 0.0, 200.0)
    c = t_agc.init_carry(cfg, "cpu")
    c = c._replace(attack_ave=torch.tensor(np.float32(-1.5)),
                   mag_tail=torch.full_like(c.mag_tail, -1.5))
    peak = t_agc._prefix(cfg, c, _t(x))[2]
    rounds = []
    real = t_scan.guess_round_plain
    monkeypatch.setattr(t_scan, "guess_round_plain",
                        lambda *a: rounds.append(1) or real(*a))
    tx, ok = t_agc._two_rate_parallel(p.attack_rise_alpha,
                                      p.attack_fall_alpha, c.attack_ave,
                                      peak, t_agc.GUESS_ITERS, fast=False)
    solve = jax.jit(lambda it: j_agc._two_rate_parallel(
        jnp.float32(p.attack_rise_alpha), jnp.float32(p.attack_fall_alpha),
        jnp.float32(-1.5), jnp.asarray(peak.numpy()), it))
    j_rounds = next(it for it in range(1, 25) if bool(solve(it)[1]))
    assert ok and len(rounds) == j_rounds, (len(rounds), j_rounds)
    np.testing.assert_allclose(tx.numpy(), np.asarray(solve(j_rounds)[0]),
                               atol=1e-5)


def test_agc_manual_gain():
    x = _cplx(np.random.default_rng(6), 1024, 100.0)
    jcfg = j_agc.AgcConfig(False, False, 62_500.0)
    tcfg = t_agc.AgcConfig(False, False, 62_500.0)
    jp = j_agc.make_params(jcfg, -100.0, 40.0, 0.0, 200.0)
    tp = t_agc.make_params(tcfg, -100.0, 40.0, 0.0, 200.0)
    _, jy = j_agc.process(jcfg, jp, j_agc.init_carry(jcfg, True),
                          jnp.asarray(x))
    _, ty = t_agc.process(tcfg, tp, t_agc.init_carry(tcfg, "cpu"), _t(x))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    # a bank of two channels: one shared manual gain
    xb = np.stack([x, x[::-1]])
    jpb = jax.tree_util.tree_map(lambda a: jnp.stack([a, a]), jp)
    jcb = jax.tree_util.tree_map(lambda a: jnp.stack([a, a]),
                                 j_agc.init_carry(jcfg, True))
    _, jy = j_agc.process_batch(jcfg, jpb, jcb, jnp.asarray(xb))
    tc = t_agc.init_carry(tcfg, "cpu")
    _, ty = t_agc.process_batch(tcfg, tp, type(tc)(*(torch.stack([a, a])
                                                     for a in tc)), _t(xb))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("interp", [True, False])
def test_rational_weights_bit_equal(interp):
    jw, jW = j_rs._rational_weights(125, 96, 28, interp)
    tw, tW = t_rs._rational_weights(125, 96, 28, interp)
    assert jW == tW
    np.testing.assert_array_equal(tw, jw)
    assert t_rs.rational_for(62_500.0, 48_000.0) == \
        j_rs.rational_for(62_500.0, 48_000.0) == (125, 96)
    assert t_rs.split_rate(62_500 / 48_000) == j_rs.split_rate(62_500 / 48_000)


def _resample_blocks(jfn, tfn, rate, n, interp, n_blocks=2):
    rng = np.random.default_rng(7)
    cap = j_rs.max_out_for(n, rate)
    assert cap == t_rs.max_out_for(n, rate)
    jp, jc = j_rs.init(rate)
    tp, tc = t_rs.init(rate, "cpu")
    for _ in range(n_blocks):
        x = (rng.standard_normal(n) * 1000).astype(np.float32)
        jc, jy, jn = jfn(jp, jc, jnp.asarray(x), cap, interp)
        tc, ty, tn = tfn(tp, tc, _t(x), cap, interp)
        assert int(tn) == int(jn)
        _close(ty.numpy(), np.asarray(jy), 1e-5, "resampler")
        assert abs(float(tc.t0) - float(jc.t0)) < 1e-6
        np.testing.assert_array_equal(tc.tail.numpy(), np.asarray(jc.tail))


@pytest.mark.parametrize("interp", [True, False])
def test_rational_resampler(interp):
    _resample_blocks(
        lambda p, c, x, cap, i: j_rs._rational_process(125, 96, p, c, x, cap,
                                                       i),
        lambda p, c, x, cap, i: t_rs._rational_process(125, 96, p, c, x, cap,
                                                       i),
        62_500.0 / 48_000.0, 16384, interp)


@pytest.mark.parametrize("interp", [True, False])
def test_banded_resampler(interp):
    rate = 62_500.0 / 48_000.0 * 1.0013           # off the rational grid
    _resample_blocks(
        lambda p, c, x, cap, i: j_rs.process(p, c, x, cap, interp=i,
                                             rational=(125, 96)),
        lambda p, c, x, cap, i: t_rs.process(p, c, x, cap, interp=i,
                                             rational=(125, 96)),
        rate, 8192, interp)


def test_resampler_times_two_level_split():
    """t_k = t0 + k*dt for k up to 262,144: the integer parts exactly, the
    fractional parts to float32 roundoff (a one-product k*dt is ~2^-7 off
    at the far end)."""
    jp, _ = j_rs.init(62_500.0 / 48_000.0)
    tp, _ = t_rs.init(62_500.0 / 48_000.0, "cpu")
    k = np.arange(262_145, dtype=np.float32)
    t0 = np.float32(0.3125)
    ji, jf = j_rs._times(jp, jnp.asarray(t0), jnp.asarray(k))
    ti, tf = t_rs._times(tp, torch.tensor(t0), _t(k))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-6)
    exact = 0.3125 + k.astype(np.float64) * (62_500.0 / 48_000.0)
    got = ti.numpy().astype(np.float64) + tf.numpy()
    assert np.abs(got - exact).max() < 1e-4
