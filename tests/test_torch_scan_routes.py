"""The routes of the port's recurrences through the scan kernels: the
dispatch functions (``kernels/scan.first_order_scan``, ``ema``,
``smeter_last``; ``kernels/agcseq.averager_scan``) on CPU tensors give
exactly their plain versions, every switched call site goes through them,
and the AGC's sequential fallback (kernel N1's plain form) matches the JAX
package's ``_averager_scan``.  The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesdr_tpu.ops import agc as j_agc
from cutesdr_tpu_torch import kernels
from cutesdr_tpu_torch.demod import am as t_am
from cutesdr_tpu_torch.demod import fm as t_fm
from cutesdr_tpu_torch.demod import sam as t_sam
from cutesdr_tpu_torch.kernels import agcseq, scan
from cutesdr_tpu_torch.ops import agc as t_agc
from cutesdr_tpu_torch.ops import smeter as t_sm
from cutesdr_tpu_torch.ops import util

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cplx(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


# ------------------------------------------------- (a) dispatch == plain --

@pytest.mark.parametrize("n", [1, 7, 1024, 2049])
@pytest.mark.parametrize("rows", [0, 3])
@pytest.mark.parametrize("kind", ["scan scalar a", "scan per-sample a",
                                  "ema", "smeter"])
def test_dispatch_is_plain_on_cpu(kind, rows, n):
    """On CPU tensors each dispatch function is bitwise its plain version,
    for [n] and [C, n] with per-row initial states, and launches nothing."""
    rng = np.random.default_rng(100 + n + rows)
    shape = (rows, n) if rows else (n,)
    u = _t((rng.standard_normal(shape) * 10 - 60).astype(np.float32))
    x0 = torch.tensor(rng.standard_normal(shape[:-1]) - 100,
                      dtype=torch.float32)
    kernels.reset_launches()
    if kind == "scan scalar a":
        got = scan.first_order_scan(np.float32(0.99), u, x0)
        want = util.first_order_recurrence(np.float32(0.99), u, x0)
    elif kind == "scan per-sample a":
        a = _t((0.99 + 0.005 * rng.random(shape)).astype(np.float32))
        got = scan.first_order_scan(a, u, x0)
        want = util.first_order_recurrence(a, u, x0)
    elif kind == "ema":
        got = scan.ema(np.float32(1 / 625.0), u, x0)
        want = util.ema(np.float32(1 / 625.0), u, x0)
    else:
        aa, ad = np.float32(1 / 625.0), np.float32(1 / 31250.0)
        got = scan.smeter_last(u, aa, ad, x0, x0 + 1)
        a_series = util.ema(aa, u, x0)
        want = (a_series[..., -1], util.max_affine_recurrence(
            np.float32(1.0) - ad, u * ad, a_series, x0 + 1)[..., -1])
        assert got[0].shape == shape[:-1]
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        got, want = got[1], want[1]
    assert torch.equal(got, want)
    assert not any(kernels.LAUNCHES.values())


# ------------------------------------------ (b) the call sites' routes --

def _count(monkeypatch, name):
    """Count the calls of ``kernels.scan.<name>``, passing them on."""
    calls = []
    real = getattr(scan, name)
    monkeypatch.setattr(scan, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("site", ["smeter", "smeter bank", "fm", "am", "sam",
                                  "sam stereo", "agc hang bank"])
def test_call_sites_take_the_dispatch(monkeypatch, site):
    """Every switched call site reaches its recurrence through the
    dispatch functions of ``kernels/scan`` (kernel K3 or K5 on the card):
    the S-meter (one stream and a bank), FM's DC tracker, squelch and
    de-emphasis EMAs, the AM and SAM DC block, and hang mode's decay
    rounds in a bank; a small size on the CPU."""
    rng = np.random.default_rng(7)
    fs = 15_625.0
    counts = {k: _count(monkeypatch, k)
              for k in ("first_order_scan", "ema", "smeter_last")}
    want = {}
    if site.startswith("smeter"):
        rows = 3 if site == "smeter bank" else 0
        p, c = t_sm.init(fs, "cpu")
        if rows:
            c = type(c)(*(torch.stack([v] * rows) for v in c))
        x = _t(_cplx(rng, (rows, 512) if rows else (512,), 300.0))
        c, _ = t_sm.process(p, c, x)
        assert c.decay_ave.shape == x.shape[:-1]
        want = {"smeter_last": 1}
    elif site == "fm":
        p, c = t_fm.init(fs, "cpu", squelch_ui_value=50, deemphasis_us=75.0)
        k = np.arange(512)
        x = _t((1000 * np.exp(2j * np.pi * (0.01 * k + 0.5 * np.sin(
            2 * np.pi * k / 60)))).astype(np.complex64))
        tracks = []
        real = t_fm._dc_track
        monkeypatch.setattr(t_fm, "_dc_track",
                            lambda *a: tracks.append(1) or real(*a))
        t_fm.process(p, c, x)
        # the DC tracker once per PLL tier tried, the squelch, de-emphasis
        want = {"ema": len(tracks) + 2}
    elif site == "am":
        p, c = t_am.init(5000.0, fs, "cpu")
        t_am.process(p, c, _t(_cplx(rng, 512, 100.0)))
        want = {"first_order_scan": 1}
    elif site.startswith("sam"):
        p, c = t_sam.init(fs, "cpu")
        k = np.arange(512)
        x = _t((1000 * np.exp(2j * np.pi * 0.001 * k)).astype(np.complex64))
        if site == "sam":
            t_sam.process(p, c, x)
            want = {"first_order_scan": 1}
        else:
            t_sam.process_stereo(p, c, x)
            want = {"first_order_scan": 2}
    else:
        cfg = t_agc.AgcConfig(True, True, fs)
        p = t_agc.make_params(cfg, -100.0, 30.0, 0.0, 200.0)
        c = t_agc.init_carry(cfg, "cpu")
        c = type(c)(*(torch.stack([v] * 2) for v in c))
        t_agc.process_batch(cfg, p, c, _t(_cplx(rng, (2, 1024), 300.0)))
        # one solve per guess-verify round
        want = {"first_order_scan": max(len(counts["first_order_scan"]), 1)}
    got = {k: len(v) for k, v in counts.items() if v}
    assert got == want, (site, got)


# --------------------------------------------- (c), (d) the AGC fallback --

def _agc_case(hang, rows, n, seed):
    """(cfg, params, carry, peak) of a port AGC at 15,625 Hz: the window
    peak of a stepping envelope, carries with a leading axis of ``rows``
    (0: one stream) that differ per row."""
    rng = np.random.default_rng(seed)
    cfg = t_agc.AgcConfig(True, hang, 15_625.0)
    p = t_agc.make_params(cfg, -100.0, 30.0, 0.0, 200.0)
    c = t_agc.init_carry(cfg, "cpu")
    shape = (rows, n) if rows else (n,)
    env = np.repeat(10.0 ** rng.uniform(1, 4, shape[:-1] + (n // 256,)),
                    256, -1)
    x = _t((_cplx(rng, shape) * env).astype(np.complex64))
    if rows:
        c = type(c)(*(torch.stack([v] * rows) for v in c))
        c = c._replace(attack_ave=c.attack_ave - torch.arange(rows) * 0.5,
                       hang_timer=torch.arange(rows, dtype=torch.int32) * 90)
    peak = t_agc._prefix(cfg, c, x)[2]
    return cfg, p, c, peak


@pytest.mark.parametrize("rows", [0, 3])
@pytest.mark.parametrize("hang", [False, True])
def test_fallback_wrapper_is_plain_loop_and_matches_jax(hang, rows):
    """The N1 wrapper on CPU tensors is the per-sample plain loop itself
    (bitwise, no launch), through ``ops/agc._averager_scan``, in both
    modes and with rows; and it agrees with JAX's ``_averager_scan``
    (vmapped over rows) within 1e-5 decades (XLA:CPU contracts the
    updates into FMAs, the port rounds each product), timers equal."""
    cfg, p, c, peak = _agc_case(hang, rows, 1024, 31 + rows)
    hang_time = p.hang_time if hang else None
    args = (peak, c.attack_ave, c.decay_ave, c.hang_timer,
            (p.attack_rise_alpha, p.attack_fall_alpha),
            (p.decay_rise_alpha, p.decay_fall_alpha), hang_time)
    kernels.reset_launches()
    got = t_agc._averager_scan(cfg, p, c, peak)
    want = agcseq.averager_scan_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(agcseq.averager_scan(*args),
                                                  want))
    assert not any(kernels.LAUNCHES.values())
    jcfg = j_agc.AgcConfig(True, hang, 15_625.0)
    jp = j_agc.make_params(jcfg, -100.0, 30.0, 0.0, 200.0)
    jc = j_agc.init_carry(jcfg, True)._replace(
        attack_ave=jnp.asarray(c.attack_ave.numpy()),
        decay_ave=jnp.asarray(c.decay_ave.numpy()),
        hang_timer=jnp.asarray(c.hang_timer.numpy()))
    fn = lambda cc, pk: j_agc._averager_scan(jcfg, jp, cc, pk)
    if rows:
        fn = jax.vmap(fn, in_axes=(j_agc.AgcCarry(None, None, 0, 0, 0), 0))
    ja, jd, jt, jm = jax.jit(fn)(jc, jnp.asarray(peak.numpy()))
    for g, w in ((got[0], ja), (got[1], jd), (got[3], jm)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jt))


@pytest.mark.parametrize("hang,bank", [(True, False), (True, True),
                                       (False, True)])
def test_forced_fallback_block_matches_jax(monkeypatch, hang, bank):
    """With one guess-verify round allowed, the port's ``agc.process`` (a
    stream) or ``process_batch`` (two channels) takes the sequential
    fallback through the N1 wrapper where that round does not validate,
    as JAX's takes its scan; over two chained blocks within 1e-4 of JAX's
    output scale and 1e-5 decades on the carries, timers equal."""
    monkeypatch.setattr(j_agc, "GUESS_ITERS", 1)
    monkeypatch.setattr(t_agc, "GUESS_ITERS", 1)
    calls = []
    real = agcseq.averager_scan
    monkeypatch.setattr(agcseq, "averager_scan",
                        lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(61)
    fs = 15_625.0
    jcfg, tcfg = j_agc.AgcConfig(True, hang, fs), t_agc.AgcConfig(True, hang,
                                                                  fs)
    jp = j_agc.make_params(jcfg, -100.0, 30.0, 0.0, 200.0)
    tp = t_agc.make_params(tcfg, -100.0, 30.0, 0.0, 200.0)
    jc, tc = j_agc.init_carry(jcfg, True), t_agc.init_carry(tcfg, "cpu")
    rows = 2 if bank else 0
    if bank:
        jc = jax.tree_util.tree_map(lambda a: jnp.stack([a] * 2), jc)
        jp_b = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(jnp.asarray(a), (2,) + jnp.shape(a)),
            jp)
        tc = type(tc)(*(torch.stack([v] * 2) for v in tc))
        j_step = jax.jit(lambda c, x: j_agc.process_batch(jcfg, jp_b, c, x))
        t_step = t_agc.process_batch
    else:
        j_step = jax.jit(lambda c, x: j_agc.process(jcfg, jp, c, x))
        t_step = t_agc.process
    before = t_agc.STATS["scan_fallbacks"]
    for _ in range(2):
        shape = (rows, 2048) if rows else (2048,)
        env = np.repeat(10.0 ** rng.uniform(1, 4, shape[:-1] + (8,)), 256, -1)
        x = (_cplx(rng, shape) * env).astype(np.complex64)
        jc, jy = j_step(jc, jnp.asarray(x))
        tc, ty = t_step(tcfg, tp, tc, _t(x))
        want = np.asarray(jy)
        np.testing.assert_allclose(ty.numpy(), want,
                                   atol=1e-4 * np.abs(want).max())
        for f in ("attack_ave", "decay_ave"):
            np.testing.assert_allclose(getattr(tc, f).numpy(),
                                       np.asarray(getattr(jc, f)), atol=1e-5)
        np.testing.assert_array_equal(tc.hang_timer.numpy(),
                                      np.asarray(jc.hang_timer))
    fell_back = t_agc.STATS["scan_fallbacks"] - before
    assert fell_back >= 1 and len(calls) == fell_back
