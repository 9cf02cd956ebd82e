"""The port's front end and display on the CPU against the JAX package: the
noise blanker (and the receiver and banks with it on), the spectrum
display, the reference-exact banded resampler, ``migrate_state`` /
``Receiver.reconfigure``, and ``convert.from_jax`` with a blanker carry.
The same seeded numpy inputs go through both packages; each test states
its tolerance."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesdr_tpu.ops import noiseblanker as j_nb
from cutesdr_tpu.ops import util as j_util
from cutesdr_tpu.pipeline import receiver as jrx
from cutesdr_tpu.pipeline import spectrum as j_sp
from cutesdr_tpu.shard import channels as j_ch
from cutesdr_tpu_torch import convert, kernels
from cutesdr_tpu_torch.demod import fm as t_fm
from cutesdr_tpu_torch.ops import noiseblanker as t_nb
from cutesdr_tpu_torch.ops import resampler as t_rs
from cutesdr_tpu_torch.ops import util as t_util
from cutesdr_tpu_torch.pipeline import receiver as trx
from cutesdr_tpu_torch.pipeline import spectrum as t_sp
from cutesdr_tpu_torch.shard import channels as t_ch

torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _snr_db(want, got):
    err = np.abs(np.asarray(got) - np.asarray(want))
    return 10 * np.log10(np.mean(np.abs(np.asarray(want)) ** 2)
                         / max(np.mean(err ** 2), 1e-30))


def _impulsive(rng, n, fs, tone_hz, period_s=0.004, power_db=-30.0):
    """A tone at ``tone_hz`` plus -80 dBFS noise and a 3-sample impulse
    near full scale every ``period_s``."""
    t = np.arange(n) / fs
    x = 32767.0 * 10 ** (power_db / 20) * np.exp(2j * np.pi * tone_hz * t)
    x += 3.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    period = int(period_s * fs)
    for s in range(period // 3, n - 3, period):
        x[s:s + 3] = 25000.0 - 20000.0j
    return x.astype(np.complex64)


def test_moving_sum_matches_jax():
    """The cumsum-difference moving sum with its carried tail over chained
    blocks: within 1e-6 of the window sum's scale (float32 cumulative
    sums, summed in another order)."""
    rng = np.random.default_rng(60)
    w = 33
    jt, tt = jnp.zeros(w - 1, jnp.float32), torch.zeros(w - 1)
    for n in (100, 7, 513):
        x = (rng.random(n) * 1000).astype(np.float32)
        js, jt = j_util.moving_sum(jnp.asarray(x), w, jt)
        ts, tt = t_util.moving_sum(torch.from_numpy(x), w, tt)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js),
                                   atol=1e-6 * 1000 * w)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_blanker_matches_jax_chunked():
    """The blanker over blocks of uneven sizes: identical blanked sets and
    identical outputs (a blanked sample is zero, the others the delayed
    input), the carries equal."""
    rng = np.random.default_rng(61)
    fs = 250_000.0
    x = _impulsive(rng, 30_000, fs, 7_000.0)
    jcfg = j_nb.BlankerConfig(True, 40.0, 20.0, fs)
    tcfg = t_nb.BlankerConfig(True, 40.0, 20.0, fs)
    jc = j_nb.init_carry(jcfg, jnp.complex64, jnp.float32)
    tc = t_nb.init_carry(tcfg, "cpu")
    jy, ty, pos = [], [], 0
    for n in (4096, 1000, 10_000, 14_904):
        jc, a = j_nb.process(jcfg, jc, jnp.asarray(x[pos:pos + n]))
        tc, b = t_nb.process(tcfg, tc, torch.from_numpy(x[pos:pos + n]))
        jy.append(np.asarray(a))
        ty.append(b.numpy())
        pos += n
    jy, ty = np.concatenate(jy), np.concatenate(ty)
    assert (ty == 0).sum() > 20
    np.testing.assert_array_equal(ty == 0, jy == 0)
    np.testing.assert_array_equal(ty, jy)
    for f in t_nb.BlankerCarry._fields:
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)), rtol=1e-6)
    assert t_nb.history_len(tcfg) == j_nb.history_len(jcfg)


def test_blanker_matches_reference_binary():
    """refgold_blanker through the port: identical blanked-sample sets and
    >= 140 dB on the passed-through samples (the JAX test's bars)."""
    d = np.load(os.path.join(FIXDIR, "refgold_blanker.npz"))
    meta = json.loads(str(d["meta"]))
    x = (d["iq_re"].astype(np.float32)
         + 1j * d["iq_im"].astype(np.float32)).astype(np.complex64)
    ref = d["out_re"] + 1j * d["out_im"]
    cfg = t_nb.BlankerConfig(True, meta["threshold"], meta["width_us"],
                             meta["fs"])
    carry = t_nb.init_carry(cfg, "cpu")
    got = []
    for pos in range(0, len(x), meta["chunk"]):
        carry, y = t_nb.process(cfg, carry,
                                torch.from_numpy(x[pos:pos + meta["chunk"]]))
        got.append(y.numpy())
    got, skip = np.concatenate(got), meta["skip"]
    np.testing.assert_array_equal(np.abs(got[skip:]) == 0,
                                  np.abs(ref[skip:]) == 0)
    assert _snr_db(ref[skip:], got[skip:]) > 140.0


def _frames(rng, n_frames, n):
    t = np.arange(n_frames * n) / 1e6
    x = 3000.0 * np.exp(2j * np.pi * 123_456.0 * t)
    x += 30.0 * (rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t)))
    return x.astype(np.complex64).reshape(n_frames, n)


def test_spectrum_matches_jax():
    """accumulate over the moving-average fill and into the sum-replace
    recurrence (ave_size 4, seven frames, one call with two frames),
    db_spectrum within 1e-3 dB (the two float32 FFTs round apart, by up to
    5e-6 of a noise bin 40 dB under the tone), the count equal, and
    screen_map in both its branches within 1 pixel."""
    rng = np.random.default_rng(62)
    cfg_kw = dict(fft_size=1024, ave_size=4, sample_rate=1e6)
    jcfg, tcfg = j_sp.SpectrumConfig(**cfg_kw), t_sp.SpectrumConfig(**cfg_kw)
    js, ts = j_sp.init(jcfg), t_sp.init(tcfg, "cpu")
    x = _frames(rng, 7, 1024)
    for fr in (x[0], x[1], x[2:4], x[4], x[5], x[6]):
        js, jov = j_sp.accumulate(jcfg, js, jnp.asarray(fr))
        ts, tov = t_sp.accumulate(tcfg, ts, torch.from_numpy(fr))
        assert bool(tov) == bool(jov)
        assert int(ts.count) == int(js.count)
    jdb, tdb = j_sp.db_spectrum(jcfg, js), t_sp.db_spectrum(tcfg, ts)
    np.testing.assert_allclose(tdb.numpy(), np.asarray(jdb), atol=1e-4)
    for geo in ((200, 300, 0.0, -120.0, -5e5, 5e5),
                (200, 400, 0.0, -120.0, 120e3, 127e3)):
        jp = np.asarray(j_sp.screen_map(jcfg, jdb, *geo))
        tp = t_sp.screen_map(tcfg, tdb, *geo).numpy()
        assert tp.shape == jp.shape
        assert np.abs(tp.astype(int) - jp).max() <= 1
    ts = t_sp.reset(tcfg, ts)
    assert int(ts.count) == 0 and not ts.pwr_ave.any()


def test_display_matches_reference_binary():
    """refgold_fftdisp through the port's display path: the reference
    binary's pixel map within 1 pixel at every column (the JAX test's bar,
    with its +6.02 dB calibration quirk re-applied)."""
    d = np.load(os.path.join(FIXDIR, "refgold_fftdisp.npz"))
    meta = json.loads(str(d["meta"]))
    x = (d["iq_re"].astype(np.float64) + 1j * d["iq_im"].astype(np.float64))
    N = meta["fft_size"]
    cfg = t_sp.SpectrumConfig(fft_size=N, ave_size=meta["ave_size"],
                              sample_rate=meta["sample_rate"],
                              db_compensation=20 * np.log10(2.0))
    st = t_sp.init(cfg, "cpu")
    for fr in range(meta["frames"]):
        st, _ = t_sp.accumulate(cfg, st, torch.from_numpy(
            x[fr * N:(fr + 1) * N].astype(np.complex64)))
    pix = t_sp.screen_map(cfg, t_sp.db_spectrum(cfg, st), meta["height"],
                          meta["width"], meta["max_db"], meta["min_db"],
                          -meta["sample_rate"] / 2,
                          meta["sample_rate"] / 2).numpy()
    ref = d["pix"].astype(int)
    m = min(len(ref), len(pix))
    assert np.abs(ref[:m] - pix[:m].astype(int)).max() <= 1
    assert pix[:m].min() < meta["height"] // 4


@pytest.mark.parametrize("method", ["feed", "feed_planes"])
def test_analyzer_matches_jax(method):
    """SpectrumAnalyzer.feed (complex) and feed_planes (int16 planes) with
    a display throttle of 3 frames, fed in uneven pieces: the same frames
    reach the average as in the JAX analyzer (spectrum within 1e-3 dB, as
    test_spectrum_matches_jax)."""
    rng = np.random.default_rng(63)
    cfg_kw = dict(fft_size=512, ave_size=2, sample_rate=512 * 30.0)
    ja = j_sp.SpectrumAnalyzer(j_sp.SpectrumConfig(**cfg_kw),
                               max_display_rate=10.0)
    ta = t_sp.SpectrumAnalyzer(t_sp.SpectrumConfig(**cfg_kw),
                               max_display_rate=10.0, device="cpu")
    x = _frames(rng, 14, 512).reshape(-1)
    qr, qi = (np.round(p).astype(np.int16) for p in (x.real, x.imag))
    readies, pos = [], 0
    for n in (700, 1500, 300, 2000, len(x) - 4500):
        sl = slice(pos, pos + n)
        if method == "feed":
            xi = (qr[sl] + 1j * qi[sl]).astype(np.complex64)
            readies.append((ja.feed(xi), ta.feed(xi)))
        else:
            readies.append((ja.feed_planes(qr[sl], qi[sl]),
                            ta.feed_planes(qr[sl], qi[sl])))
        pos += n
    assert all(a == b for a, b in readies)
    np.testing.assert_allclose(ta.spectrum_db(), ja.spectrum_db(), atol=1e-3)
    assert ta.overload == ja.overload


@pytest.mark.parametrize("skip", [1, 4, 7])
def test_analyzer_feed_keeps_the_throttled_frames(skip):
    """SpectrumAnalyzer.feed slices out only the frames its throttle
    keeps: fed in pieces shorter than a frame, spanning many frames and
    ending mid-frame, it accumulates the frames (and flags the pieces)
    that a frame-by-frame count does, bitwise."""
    rng = np.random.default_rng(65 + skip)
    cfg = t_sp.SpectrumConfig(fft_size=512, ave_size=2,
                              sample_rate=512 * 10.0 * skip)
    a = t_sp.SpectrumAnalyzer(cfg, max_display_rate=10.0, device="cpu")
    b = t_sp.SpectrumAnalyzer(cfg, max_display_rate=10.0, device="cpu")
    assert a._skip == skip
    x = _frames(rng, 40, 512).reshape(-1)
    pending, count, pos = np.zeros(0, np.complex64), 0, 0
    for n in (200, 200, 57, 4000, 1, 511, 6600, 512, 6000, len(x) - 18081):
        piece = x[pos:pos + n]
        pos += n
        buf, ready = np.concatenate([pending, piece]), False
        while len(buf) >= 512:
            frame, buf = buf[:512], buf[512:]
            count += 1
            if count == skip:
                count, ready = 0, True
                b._acc(frame.real, frame.imag)
        pending = buf
        assert a.feed(piece) == ready
        assert np.array_equal(a._pending, pending)
    for f in t_sp.SpectrumState._fields:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f))


def test_analyzer_feed_equals_feed_planes():
    """Without a throttle (one display frame per FFT frame) feed and
    feed_planes accumulate the same frames: equal states."""
    rng = np.random.default_rng(64)
    cfg = t_sp.SpectrumConfig(fft_size=512, ave_size=3, sample_rate=512.0)
    a = t_sp.SpectrumAnalyzer(cfg, max_display_rate=10.0, device="cpu")
    b = t_sp.SpectrumAnalyzer(cfg, max_display_rate=10.0, device="cpu")
    x = _frames(rng, 6, 512).reshape(-1)
    qr, qi = (np.round(p).astype(np.int16) for p in (x.real, x.imag))
    for sl in (slice(0, 900), slice(900, 2100), slice(2100, None)):
        assert a.feed((qr[sl] + 1j * qi[sl]).astype(np.complex64)) == \
            b.feed_planes(qr[sl], qi[sl])
    for f in t_sp.SpectrumState._fields:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f))


def test_resampler_matches_reference_binary():
    """refgold_resampler through the port's banded path in reference-exact
    mode (interp=False, the resamp kernel's plain version on the CPU):
    identical output counts and >= 110 dB (the JAX test's bars)."""
    d = np.load(os.path.join(FIXDIR, "refgold_resampler.npz"))
    meta = json.loads(str(d["meta"]))
    x = (d["iq_re"].astype(np.float32)
         + 1j * d["iq_im"].astype(np.float32)).astype(np.complex64)
    ref = d["out_re"] + 1j * d["out_im"]
    chunk = meta["chunk"]
    p, c = t_rs.init(meta["rate"], "cpu", complex_input=True)
    kernels.reset_launches()
    got = []
    for pos in range(0, len(x), chunk):
        cap = t_rs.max_out_for(chunk, meta["rate"])
        c, y, nv = t_rs.process(p, c, torch.from_numpy(x[pos:pos + chunk]),
                                cap, interp=False)
        got.append(y[:int(nv)].numpy())
    got = np.concatenate(got)
    assert len(got) == len(ref)
    skip = meta["skip"]
    assert _snr_db(ref[skip:], got[skip:]) > 110.0
    assert kernels.LAUNCHES["resamp"] == 0            # CPU: plain version


def _match(jout, tout, min_snr=90.0, skip=0):
    n = int(jout.n_audio)
    assert int(tout.n_audio) == n
    want = np.asarray(jout.audio)[:n].astype(np.float64)
    got = tout.audio[:n].double().numpy()
    assert _snr_db(want[skip:], got[skip:]) >= min_snr
    assert abs(float(tout.smeter_ave_db) - float(jout.smeter_ave_db)) < 0.01


def test_receiver_with_blanker_matches_jax():
    """nb_on through the USB receiver, three blocks of an impulsive tone:
    >= 90 dB against the JAX Receiver, and the blanker carry equal."""
    kw = dict(input_rate=250_000.0, mode="usb", tune_freq=60_000.0,
              frames_per_block=2, nb_on=True, nb_threshold=40.0,
              nb_width_us=20.0)
    jr = jrx.Receiver(jrx.ReceiverConfig(**kw))
    tr = trx.Receiver(trx.ReceiverConfig(**kw), "cpu")
    rng = np.random.default_rng(65)
    x = _impulsive(rng, 3 * tr.cfg.block_size, 250e3, 61_000.0)
    for blk in x.reshape(3, -1):
        _match(jr.process(jnp.asarray(blk)), tr.process(blk))
    np.testing.assert_array_equal(tr.state.blanker.sig_tail.numpy(),
                                  np.asarray(jr.state.blanker.sig_tail))


@pytest.mark.parametrize("kind", ["bank", "stacked"])
def test_bank_with_blanker_matches_jax(kind):
    """nb_on in a ChannelBank (the blanker once over the shared block, its
    carry with the channel axis) and a StackedReceiver (one blanker per
    stream): >= 90 dB per channel against the JAX banks after the first
    block."""
    kw = dict(input_rate=250_000.0, mode="usb", frames_per_block=2,
              nb_on=True, nb_threshold=40.0, nb_width_us=20.0)
    freqs = [40e3, -60e3]
    rng = np.random.default_rng(66)
    tcls, jcls = ((t_ch.ChannelBank, j_ch.ChannelBank) if kind == "bank"
                  else (t_ch.StackedReceiver, j_ch.StackedReceiver))
    tb = tcls(trx.ReceiverConfig(**kw), freqs, "cpu")
    jb = jcls(jrx.ReceiverConfig(**kw), freqs)
    bs = tb.cfg.block_size
    rows = 1 if kind == "bank" else 2
    x = sum(_impulsive(rng, 3 * bs * rows, 250e3, f + 1000.0, power_db=-40.0)
            for f in freqs).reshape(rows, 3, bs)
    assert tb.state.blanker.mag_tail.shape[0] == 2
    want, got = [], []
    for b in range(3):
        blk = x[0, b] if kind == "bank" else x[:, b]
        jo, to = jb.process(jnp.asarray(blk)), tb.process(blk)
        n = np.asarray(jo.n_audio)
        np.testing.assert_array_equal(to.n_audio.numpy(), n)
        if b:
            want.append(np.asarray(jo.audio))
            got.append(to.audio.numpy())
    for c in range(2):
        assert _snr_db(np.concatenate([w[c] for w in want]),
                       np.concatenate([g[c] for g in got])) >= 90.0


def test_from_jax_with_blanker_mid_stream():
    """A JAX stream with the blanker on, converted after two blocks
    (``convert.from_jax`` maps the blanker carry), continues on the port
    for two more at >= 90 dB."""
    kw = dict(input_rate=250_000.0, mode="usb", tune_freq=60_000.0,
              frames_per_block=2, nb_on=True, nb_threshold=40.0,
              nb_width_us=20.0)
    jr = jrx.Receiver(jrx.ReceiverConfig(**kw))
    tcfg = trx.ReceiverConfig(**kw)
    rng = np.random.default_rng(67)
    x = _impulsive(rng, 4 * tcfg.block_size, 250e3, 61_000.0).reshape(4, -1)
    for blk in x[:2]:
        jr.process(jnp.asarray(blk))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    params, state = convert.from_jax(tcfg, to_np(jr.params), to_np(jr.state),
                                     "cpu")
    assert state.blanker.sig_tail.dtype == torch.complex64
    for blk in x[2:]:
        jout = jr.process(jnp.asarray(blk))
        state, tout = trx.receiver_step(tcfg, params, state,
                                        torch.from_numpy(blk))
        _match(jout, tout)


WALK = [dict(mode="usb"), dict(mode="am"), dict(mode="fm"), dict(mode="usb"),
        dict(mode="usb", fastfir_nfft=4096, fastfir_ntaps=2049)]


# FM's three blocks after the am -> fm switch: the PLL's acquisition head
# (measured 14.1, 48.8 and 77.1 dB on this walk; each bar is 1 dB below)
FM_WALK_SNR = (13.1, 47.8, 76.1)


def _segment_slope_db(want, got, seg=128):
    """SNR of each ``seg``-sample segment of a block, fitted by a line:
    its rise in dB per 512 samples."""
    snrs = [_snr_db(want[i:i + seg], got[i:i + seg])
            for i in range(0, len(want) - seg + 1, seg)]
    return np.polyfit(np.arange(len(snrs)), snrs, 1)[0] * 512 / seg


def _fm_block(jr, tr, x):
    """One block through both packages: (JAX output, port output, the
    tiers the port's FM demod took, JAX's ``pll_tier`` probe)."""
    before = dict(t_fm.STATS)
    jout, tout = jr.process(jnp.asarray(x)), tr.process(x)
    taken = [k for k, v in t_fm.STATS.items() if v != before[k]]
    return jout, tout, taken, t_fm.TIER_NAMES[int(jout.probes["pll_tier"])]


def test_reconfigure_matches_jax():
    """A live walk usb -> am -> fm -> usb, then a filter-size change
    (2048/1025 -> 4096/2049), three blocks in each configuration, through
    ``Receiver.reconfigure`` on both packages (JAX with its Pallas mixdec,
    interpreted: its carry is the raw input tail like the port's, at the
    same row-padded length), the blanker on.  The level trackers carried
    across each switch equal JAX's (S-meter within 0.01 dB, the resampler
    time within 1e-6).  Every block of every configuration is compared:
    the S-meter within 0.01 dB, and the audio at >= 90 dB, first blocks
    included (each reads 100.3-129.6 dB).

    FM's blocks are the exception, at ``FM_WALK_SNR``: the PLL acquires on
    the channel filter's near-silent head after the switch, where the FMA
    rounding of JAX's loop against the port's flips a phase wrap, and the
    difference then decays through the DC tracker and the de-emphasis, as
    in tests/test_torch_receiver.py.  Three checks show that this is that
    transient and not the migration: each FM block takes the same PLL
    tier as JAX's (its ``pll_tier`` probe; chunked, then linear), the SNR
    rises block over block and within the last block at ~9 dB per 512
    samples, and freshly built FM receivers fed the same samples show the
    same head (10.0, 38.9, 66.9 dB), rising at the same rate."""
    base = dict(input_rate=250_000.0, tune_freq=60_000.0, frames_per_block=2,
                nb_on=True, nb_threshold=40.0, nb_width_us=20.0)
    jx = dict(decimator_impl="pallas", pallas_interpret=True)
    jcfg = lambda step: jrx.ReceiverConfig(**base, **step, **jx,
                                           probes=step["mode"] == "fm")
    jr = jrx.Receiver(jcfg(WALK[0]))
    tr = trx.Receiver(trx.ReceiverConfig(**base, **WALK[0]), "cpu")
    jr.set_volume(70)
    tr.set_volume(70)
    rng = np.random.default_rng(68)
    amp = 32767.0 * 10 ** (-30 / 20)
    pos = 0
    fm_x, fm_snr = [], []
    for k, step in enumerate(WALK):
        if k:
            jr.reconfigure(jcfg(step))
            tr.reconfigure(trx.ReceiverConfig(**base, **step))
            assert float(tr.state.resamp.t0) == pytest.approx(
                float(jr.state.resamp.t0), abs=1e-6)
            assert float(tr.state.smeter.attack_ave) == pytest.approx(
                float(jr.state.smeter.attack_ave), abs=0.01)
            assert tr.params.audio_gain == pytest.approx(
                float(jr.params.audio_gain))
        for b in range(3):
            n = tr.cfg.block_size
            t = (np.arange(n) + pos) / 250e3
            env = 1 + 0.5 * np.cos(2 * np.pi * 400 * t)
            x = amp * env * np.exp(1j * (2 * np.pi * 61_000.0 * t
                                         + 2.0 * np.sin(2 * np.pi * 700 * t)))
            x += 3.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            x = x.astype(np.complex64)
            pos += n
            if step["mode"] != "fm":
                _match(jr.process(jnp.asarray(x)), tr.process(x))
                continue
            jout, tout, taken, tier = _fm_block(jr, tr, x)
            assert taken == [tier]
            _match(jout, tout, min_snr=FM_WALK_SNR[b])
            want = np.asarray(jout.audio)[:int(jout.n_audio)]
            got = tout.audio[:int(tout.n_audio)].double().numpy()
            fm_x.append(x)
            fm_snr.append(_snr_db(want, got))
            if b == 2:
                fm_slope = _segment_slope_db(want, got)

    jf = jrx.Receiver(jcfg(dict(mode="fm")))
    tf = trx.Receiver(trx.ReceiverConfig(**base, mode="fm"), "cpu")
    jf.set_volume(70)
    tf.set_volume(70)
    fresh = []
    for x in fm_x:
        jout, tout, taken, tier = _fm_block(jf, tf, x)
        assert taken == [tier]
        want = np.asarray(jout.audio)[:int(jout.n_audio)]
        got = tout.audio[:int(tout.n_audio)].double().numpy()
        fresh.append(_snr_db(want, got))
    fresh_slope = _segment_slope_db(want, got)
    for snrs, slope in ((fm_snr, fm_slope), (fresh, fresh_slope)):
        assert snrs[0] < snrs[1] < snrs[2]
        assert 7.0 < slope < 11.0
    assert abs(fm_slope - fresh_slope) < 1.0


def test_migrate_state_rules():
    """migrate_state's rules on the port's state, against JAX's on the same
    switch: a mode change at the same rates keeps the decimator carry
    (raw tail, phase), the channel filter and AGC windows, and restarts
    the demodulator; a new input rate restarts the decimator carry and
    keeps the level trackers; the blanker carries only while on."""
    kw = dict(input_rate=250_000.0, tune_freq=60_000.0, frames_per_block=2,
              nb_on=True)
    old_cfg = trx.ReceiverConfig(mode="am", **kw)
    tr = trx.Receiver(old_cfg, "cpu")
    rng = np.random.default_rng(69)
    x = (1000 * (rng.standard_normal(tr.cfg.block_size)
                 + 1j * rng.standard_normal(tr.cfg.block_size))
         ).astype(np.complex64)
    tr.process(x)
    old = tr.state

    same_rate = trx.ReceiverConfig(mode="sam", **kw)
    _, fresh = trx.init(same_rate, "cpu")
    st = trx.migrate_state(old_cfg, old, same_rate, fresh)
    assert torch.equal(st.dec.raw_tail, old.dec.raw_tail)
    assert int(st.dec.phase) == int(old.dec.phase)
    assert torch.equal(st.chan_filter.tail, old.chan_filter.tail)
    assert torch.equal(st.agc.sig_delay, old.agc.sig_delay)
    assert torch.equal(st.blanker.sig_tail, old.blanker.sig_tail)
    assert type(st.demod) is type(fresh.demod)
    assert torch.equal(st.demod.nco_phase, fresh.demod.nco_phase)

    new_rate = trx.ReceiverConfig(mode="am", **dict(kw, input_rate=500e3,
                                                    nb_on=False))
    _, fresh = trx.init(new_rate, "cpu")
    st = trx.migrate_state(old_cfg, old, new_rate, fresh)
    assert st.blanker is None
    assert int(st.dec.phase) == int(fresh.dec.phase)
    assert not st.dec.raw_tail.any()
    assert torch.equal(st.agc.attack_ave, old.agc.attack_ave)
    assert torch.equal(st.smeter.attack_ave, old.smeter.attack_ave)
    assert torch.equal(st.resamp.t0, old.resamp.t0)

    # the same rules as the JAX package's on its own state
    jo = jrx.ReceiverConfig(mode="am", **kw, decimator_impl="pallas",
                            pallas_interpret=True)
    jn = jrx.ReceiverConfig(mode="sam", **kw, decimator_impl="pallas",
                            pallas_interpret=True)
    _, jold = jrx.init(jo)
    _, jfresh = jrx.init(jn)
    jst = jrx.migrate_state(jo, jold, jn, jfresh)
    assert np.asarray(jst.demod.nco_phase) == np.asarray(
        jfresh.demod.nco_phase)
    assert jst.blanker is not None and st.blanker is None
