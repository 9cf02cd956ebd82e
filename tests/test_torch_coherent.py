"""The port's diversity combiner (``shard/coherent``), DiversityReceiver
and DiversitySession on the CPU: against the JAX package's on the same
inputs (made with numpy from a seed), the cases of tests/test_coherent.py
on the port, and a stream carried from JAX's receiver into the port's
(``convert.from_jax`` + ``convert.from_jax_combiner``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesdr_tpu import session as js
from cutesdr_tpu.pipeline import receiver as jrx
from cutesdr_tpu.shard import coherent as jc
from cutesdr_tpu_torch import convert
from cutesdr_tpu_torch import session as ts
from cutesdr_tpu_torch.pipeline import receiver as trx
from cutesdr_tpu_torch.shard import coherent as tc

torch.set_num_threads(1)

to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


def _two_branch(n, g, snr_db, f=0.02, seed=0, amp=1.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    s = amp * np.exp(2j * np.pi * f * t)
    npow = amp * 10 ** (-snr_db / 20.0)
    n0 = npow * (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2)
    n1 = npow * (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2)
    return np.stack([s + n0, g * s + n1]).astype(np.complex64), s


def _tone_snr(y, f):
    n = len(y)
    w = np.hanning(n)
    spec = np.abs(np.fft.fft(y * w)) ** 2
    k = int(round(f * n)) % n
    sig = spec[max(0, k - 2):k + 3].sum()
    return 10 * np.log10(sig / (spec.sum() - sig))


def _snr_db(want, got):
    want = np.asarray(want, np.complex128)
    err = np.asarray(got, np.complex128) - want
    return 10 * np.log10(np.sum(np.abs(want) ** 2)
                         / max(np.sum(np.abs(err) ** 2), 1e-30))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _blocks(x, size):
    return [x[:, i:i + size] for i in range(0, x.shape[1], size)]


# ----------------------------------------------- the combiner against JAX --
@pytest.mark.parametrize("manual", [False, True])
def test_process_matches_jax(manual):
    """Two-branch MRC over eight chained blocks (tracking, or manual
    steering): the gain within 1e-5 relative, the combined stream >= 110
    dB SNR against JAX's on every block."""
    x, _ = _two_branch(8 * 4096, 0.8 * np.exp(1j * 0.7), snr_db=15.0,
                       seed=3, amp=3000.0)
    jp, jcar = jc.init(4.0, manual=manual, fixed_gain=0.6 - 0.3j)
    tp, tcar = tc.init(4.0, "cpu", manual=manual, fixed_gain=0.6 - 0.3j)
    step = jax.jit(jc.process)
    for blk in _blocks(x, 4096):
        jcar, jy = step(jp, jcar, jnp.asarray(blk))
        tcar, ty = tc.process(tp, tcar, torch.from_numpy(blk))
        g = complex(np.asarray(jcar.gain))
        assert abs(tcar.gain.item() - g) <= 1e-5 * abs(g)
        assert _snr_db(jy, ty.numpy()) >= 110.0


def test_array_process_matches_jax():
    """Four-branch MRC over six chained blocks: gains[0] pinned to 1, every
    gain within 1e-5 relative, the combined stream >= 110 dB SNR against
    JAX's."""
    rng = np.random.default_rng(4)
    gains = np.array([1.0, 0.9 * np.exp(1j * 0.5), 0.6 * np.exp(-1j * 1.0),
                      0.3 * np.exp(1j * 2.0)])
    n = 6 * 4096
    s = 2000.0 * np.exp(2j * np.pi * 0.013 * np.arange(n))
    x = (gains[:, None] * s + 200.0 * (rng.standard_normal((4, n))
                                       + 1j * rng.standard_normal((4, n))))
    x = x.astype(np.complex64)
    jp, jcar = jc.array_init(4, smoothing_blocks=2.0)
    tp, tcar = tc.array_init(4, smoothing_blocks=2.0, device="cpu")
    step = jax.jit(jc.array_process)
    for blk in _blocks(x, 4096):
        jcar, jy = step(jp, jcar, jnp.asarray(blk))
        tcar, ty = tc.array_process(tp, tcar, torch.from_numpy(blk))
        assert tcar.gains[0].item() == 1.0
        assert _rel(tcar.gains.numpy(), np.asarray(jcar.gains)) <= 1e-5
        assert _snr_db(jy, ty.numpy()) >= 110.0
    np.testing.assert_allclose(np.abs(tcar.gains.numpy()), np.abs(gains),
                               atol=0.05)


def test_combined_stream_within_float64_combine():
    """At a long block (262,144 samples) the float32 reductions sum in
    another order than XLA's: the combined stream stays within 1e-5
    relative of a float64 combine of the same input with the port's own
    gain."""
    x, _ = _two_branch(262_144, 0.8 * np.exp(1j * 0.7), snr_db=10.0,
                       seed=5, amp=5000.0)
    tp, tcar = tc.init(8.0, "cpu")
    tcar, ty = tc.process(tp, tcar, torch.from_numpy(x))
    x64 = x.astype(np.complex128)
    p0 = np.sum(np.abs(x64[0]) ** 2)
    g = (1 - 1 / 8) * 1.0 + (1 / 8) * np.sum(x64[1] * np.conj(x64[0])) / p0
    y64 = (x64[0] + np.conj(g) * x64[1]) / np.sqrt(1 + abs(g) ** 2)
    assert abs(tcar.gain.item() - g) <= 1e-5 * abs(g)
    assert _rel(ty.numpy(), y64) <= 1e-5


# ------------------------------------- tests/test_coherent.py on the port --
def test_gain_estimate_converges():
    g_true = 0.8 * np.exp(1j * 2.1)
    x, _ = _two_branch(65536, g_true, snr_db=20.0)
    p, c = tc.init(smoothing_blocks=4.0, device="cpu")
    for blk in x.reshape(2, 16, 4096).transpose(1, 0, 2):
        c, _ = tc.process(p, c, torch.from_numpy(np.ascontiguousarray(blk)))
    assert abs(c.gain.item() - g_true) < 0.05


def test_mrc_improves_snr():
    """Equal-SNR branches: MRC beats the best single branch by > 2 dB."""
    x, _ = _two_branch(32768, np.exp(1j * 1.0), snr_db=15.0)
    p, c = tc.init(smoothing_blocks=2.0, device="cpu")
    outs = []
    for blk in x.reshape(2, 8, 4096).transpose(1, 0, 2):
        c, y = tc.process(p, c, torch.from_numpy(np.ascontiguousarray(blk)))
        outs.append(y.numpy())
    y = np.concatenate(outs[2:])
    snr0 = _tone_snr(x[0][2 * 4096:], 0.02)
    snr1 = _tone_snr(x[1][2 * 4096:], 0.02)
    assert _tone_snr(y, 0.02) > max(snr0, snr1) + 2.0


def test_manual_steering_override():
    x, _ = _two_branch(4096, 1.0j, snr_db=30.0)
    p, c = tc.init(manual=True, fixed_gain=1.0j, device="cpu")
    c, y = tc.process(p, c, torch.from_numpy(x))
    assert abs(np.abs(y.numpy()).mean() - np.sqrt(2.0)) < 0.05
    assert c.gain.item() == 1.0j


def test_diversity_receiver_end_to_end():
    cfg = trx.ReceiverConfig(input_rate=2e6, mode="usb", tune_freq=100e3,
                             agc_on=False)
    rx = tc.DiversityReceiver(cfg, smoothing_blocks=2.0, device="cpu")
    n, n_blocks = cfg.block_size, 8
    t = np.arange(n_blocks * n) / 2e6
    s = 8000.0 * np.exp(2j * np.pi * 102e3 * t)     # 2 kHz audio in USB
    g = 0.9 * np.exp(-1j * 0.7)
    stack = np.stack([s, g * s]).astype(np.complex64)
    audio = []
    for blk in _blocks(stack, n):
        out = rx.process(blk)
        audio.append(out.audio[:int(out.n_audio)].numpy())
    a = np.concatenate(audio[4:])
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    f = np.fft.rfftfreq(len(a), 1 / 48000.0)
    assert abs(f[np.argmax(spec)] - 2000.0) < 30
    assert abs(rx.last_gain - g) < 0.05


def test_diversity_receiver_planes_match_complex_path():
    """process_planes (float32 re/im planes) gives the same audio and gain
    as process() (complex64)."""
    cfg = trx.ReceiverConfig(input_rate=2e6, mode="usb", tune_freq=100e3,
                             agc_on=False)
    rx_c = tc.DiversityReceiver(cfg, smoothing_blocks=2.0, device="cpu")
    rx_p = tc.DiversityReceiver(cfg, smoothing_blocks=2.0, device="cpu")
    n = cfg.block_size
    t = np.arange(3 * n) / 2e6
    s = 8000.0 * np.exp(2j * np.pi * 102e3 * t)
    stack = np.stack([s, 0.8 * np.exp(1j * 0.3) * s]).astype(np.complex64)
    for blk in _blocks(stack, n):
        out_c = rx_c.process(blk)
        out_p = rx_p.process_planes(np.ascontiguousarray(blk.real),
                                    np.ascontiguousarray(blk.imag))
        np.testing.assert_allclose(out_p.audio.numpy(), out_c.audio.numpy(),
                                   rtol=0, atol=1e-4)
    assert abs(rx_p.last_gain - rx_c.last_gain) < 1e-6


def test_array_combiner_generalizes_mrc():
    """M-branch MRC: gains converge to the branch mismatches, the combine
    beats the best branch, M=2 reproduces the pairwise combiner."""
    rng = np.random.default_rng(9)
    n = 4096
    s = np.exp(2j * np.pi * 0.01 * np.arange(n)) * 1000.0
    gains = np.array([1.0, 0.8 * np.exp(1j * 0.7), 0.5 * np.exp(-1j * 1.1)])
    noise = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
             ) * 100.0
    x = torch.from_numpy((gains[:, None] * s[None, :] + noise)
                         .astype(np.complex64))
    p, c = tc.array_init(3, smoothing_blocks=1.0, device="cpu")
    for _ in range(6):
        c, y = tc.array_process(p, c, x)
    g = c.gains.numpy()
    np.testing.assert_allclose(np.abs(g), np.abs(gains), atol=0.05)
    np.testing.assert_allclose(np.angle(g[1:]), np.angle(gains[1:]),
                               atol=0.05)

    def snr(sig):
        a = (sig @ np.conj(s)) / (s @ np.conj(s))
        resid = sig - a * s
        return 10 * np.log10(np.abs(a) ** 2 * np.mean(np.abs(s) ** 2)
                             / np.mean(np.abs(resid) ** 2))

    xn = x.numpy()
    assert snr(y.numpy()) > max(snr(xn[i]) for i in range(3)) + 1.0
    p2, c2 = tc.array_init(2, smoothing_blocks=1.0, device="cpu")
    pp, cp = tc.init(smoothing_blocks=1.0, device="cpu")
    _, y2 = tc.array_process(p2, c2, x[:2])
    _, yp = tc.process(pp, cp, x[:2])
    np.testing.assert_allclose(y2.numpy(), yp.numpy(), atol=1e-2)


def test_diversity_receiver_n_branches():
    cfg = trx.ReceiverConfig(input_rate=250_000.0, mode="usb",
                             tune_freq=60_000.0, audio_rate=None,
                             agc_on=False)
    drx = tc.DiversityReceiver(cfg, smoothing_blocks=1.0, n_branches=4,
                               device="cpu")
    gains = np.array([1.0, 0.9 * np.exp(1j * 0.5), 0.6 * np.exp(-1j * 1.0),
                      0.3 * np.exp(1j * 2.0)])
    n = cfg.block_size * 3
    x0 = 32767 * 0.1 * np.exp(2j * np.pi * 61_000.0 * np.arange(n)
                              / cfg.input_rate)
    audio = []
    for b in np.split(x0, 3):
        out = drx.process((gains[:, None] * b[None, :]).astype(np.complex64))
        audio.append(out.audio.numpy())
    np.testing.assert_allclose(np.abs(np.asarray(drx.last_gains)),
                               np.abs(gains), atol=0.05)
    with pytest.raises(ValueError, match="pairwise"):
        drx.set_steering(1.0)
    a = np.concatenate(audio)[2048:]
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    f_pk = np.fft.rfftfreq(len(a), 1 / cfg.output_rate)[int(np.argmax(spec))]
    assert abs(f_pk - 1000.0) < 80.0


# ------------------------------------ receiver and session against JAX ----
KW = dict(input_rate=250_000.0, mode="usb", tune_freq=60_000.0,
          frames_per_block=2)


def _stack(n, seed, start=0):
    """Branch 1 = 0.8 at 40 degrees x branch 0's -30 dBFS tone 1 kHz above
    the tune, independent -70 dBFS noise on each."""
    rng = np.random.default_rng(seed)
    t = (start + np.arange(n)) / 250e3
    s = 32767 * 10 ** (-30 / 20) * np.exp(2j * np.pi * 61_000.0 * t)
    g = 0.8 * np.exp(1j * np.deg2rad(40.0))
    noise = 10.0 * (rng.standard_normal((2, n))
                    + 1j * rng.standard_normal((2, n)))
    return (np.stack([s, g * s]) + noise).astype(np.complex64)


def _match(jout, tout, min_snr=90.0):
    """tests/test_torch_receiver.py's bar: equal n_audio, S-meter within
    0.01 dB, audio >= 90 dB SNR."""
    n = int(jout.n_audio)
    assert int(tout.n_audio) == n
    assert _snr_db(np.asarray(jout.audio)[:n], tout.audio[:n].numpy()) >= \
        min_snr
    assert abs(float(tout.smeter_ave_db) - float(jout.smeter_ave_db)) < 0.01
    assert abs(float(tout.smeter_peak_db)
               - float(jout.smeter_peak_db)) < 0.01


def test_diversity_receiver_from_jax_matches_jax():
    """The JAX DiversityReceiver runs two blocks; its receiver state and
    combiner carry go to a port DiversityReceiver (``from_jax`` +
    ``from_jax_combiner``); both run four more blocks: the _match bar on
    each, and the gain within 1e-5 relative."""
    jd = jc.DiversityReceiver(jrx.ReceiverConfig(**KW), smoothing_blocks=4.0)
    td = tc.DiversityReceiver(trx.ReceiverConfig(**KW), smoothing_blocks=4.0,
                              device="cpu")
    n = td.cfg.block_size
    x = _stack(6 * n, seed=1)
    for blk in _blocks(x[:, :2 * n], n):
        jd.process(jnp.asarray(blk))
    td.params, td.state = convert.from_jax(td.cfg, to_np(jd.params),
                                           to_np(jd.state), "cpu")
    td.comb_params, td.comb_state = convert.from_jax_combiner(
        to_np(jd.comb_params), to_np(jd.comb_state), "cpu")
    assert td.last_gain == jd.last_gain
    for blk in _blocks(x[:, 2 * n:], n):
        _match(jd.process(jnp.asarray(blk)), td.process(blk))
        assert abs(td.last_gain - jd.last_gain) <= 1e-5 * abs(jd.last_gain)


def test_from_jax_combiner_array_and_manual():
    """An M-branch carry and a manual-steering params convert field by
    field."""
    jp, jcar = jc.array_init(3, smoothing_blocks=2.0)
    jcar = jcar._replace(gains=jnp.asarray([1.0, 0.5j, -0.25],
                                           jnp.complex64))
    tp, tcar = convert.from_jax_combiner(to_np(jp), to_np(jcar), "cpu")
    assert isinstance(tcar, tc.ArrayCombinerCarry)
    np.testing.assert_array_equal(tcar.gains.numpy(), np.asarray(jcar.gains))
    jp2, jc2 = jc.init(3.0, manual=True, fixed_gain=0.5 + 0.25j)
    tp2, tc2 = convert.from_jax_combiner(to_np(jp2), to_np(jc2), "cpu")
    assert tp2.manual is True and tp2.alpha == float(np.float32(1 / 3))
    assert tp2.fixed_gain.item() == 0.5 + 0.25j
    assert isinstance(tc2, tc.CombinerCarry) and tc2.gain.item() == 1.0


def test_diversity_session_matches_jax():
    """The same [2, n] stacks pumped into both sessions in uneven pieces,
    four blocks: after flush() the same blocks run, the queued int16
    audio >= 90 dB SNR against JAX's (one step is staged in flight, and
    delivered by flush), the last block's S-meters within 0.01 dB, the
    gain within 1e-5 relative, the controls and the status line as
    JAX's."""
    j = js.DiversitySession(jrx.ReceiverConfig(**KW))
    t = ts.DiversitySession(trx.ReceiverConfig(**KW), device="cpu")
    n = t.cfg.block_size
    x = _stack(4 * n, seed=2)
    for s in (j, t):
        s.start()
        for piece in np.array_split(x, 5, axis=1):
            s.pump(piece)
    assert len(t._inflight) == 1
    assert t.flush() == 1 and j.flush() == 0
    assert t.metrics.blocks == j.metrics.blocks == 4
    assert t.metrics.audio_samples_out == j.metrics.audio_samples_out

    def queued(q):
        idx = (q._tail + np.arange(q.level)) & (q.size - 1)
        return q._buf[idx].astype(np.float64)

    want, got = queued(j.audio_queue), queued(t.audio_queue)
    assert len(got) == len(want) > 0
    assert _snr_db(want, got) >= 90.0
    assert abs(t.metrics.smeter_ave_db - j.metrics.smeter_ave_db) < 0.01
    assert abs(t.metrics.smeter_peak_db - j.metrics.smeter_peak_db) < 0.01
    assert abs(t.gain - j.gain) <= 1e-5 * abs(j.gain)
    assert t.tune_clicked(61_049.0) == j.tune_clicked(61_049.0)
    assert t.set_filter(-50.0, 30_000.0) == j.set_filter(-50.0, 30_000.0)
    t.set_volume(40)
    assert t.settings.volume == 40
    assert "rx2 gain" in t.status_line()
    assert t.status_line().split("|")[-1] == j.status_line().split("|")[-1]
