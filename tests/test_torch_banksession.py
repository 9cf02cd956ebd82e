"""The port's BankSession on the CPU against the JAX package's on the same
pumped input (per-channel S-meters, the monitor channel's audio, the
mini-spectra, the controls, the probe scope on the monitor channel), and
a channel bank's probe taps against the JAX bank's.  Inputs are made with
numpy from a seed and fed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesdr_tpu import bank as jb
from cutesdr_tpu.pipeline import receiver as jrx
from cutesdr_tpu.shard import channels as j_ch
from cutesdr_tpu_torch import bank as tb
from cutesdr_tpu_torch.pipeline import receiver as trx
from cutesdr_tpu_torch.shard import channels as t_ch

torch.set_num_threads(1)

FS = 250_000.0
BASE = dict(input_rate=FS, tune_freq=60_000.0, frames_per_block=2)
FREQS = [30_000.0, 61_000.0, -50_000.0]


def _signal(n, seed, start=0):
    """Tones 2 kHz above channel 0 (-20 dBFS) and 1 kHz above channel 1
    (-30 dBFS), nothing in channel 2, -80 dBFS noise."""
    rng = np.random.default_rng(seed)
    t = (start + np.arange(n)) / FS
    x = (32767 * 10 ** (-20 / 20) * np.exp(2j * np.pi * 32_000.0 * t)
         + 32767 * 10 ** (-30 / 20) * np.exp(2j * np.pi * 62_000.0 * t))
    x += 3.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def _snr_db(want, got):
    want = np.asarray(want, np.complex128)
    err = np.asarray(got, np.complex128) - want
    return 10 * np.log10(np.sum(np.abs(want) ** 2)
                         / max(np.sum(np.abs(err) ** 2), 1e-30))


def _queued(q):
    """The audio a RateLockedQueue holds, oldest first."""
    idx = (q._tail + np.arange(q.level)) & (q.size - 1)
    return q._buf[idx].astype(np.float64)


def _pair(**kw):
    cfg = dict(BASE, mode="usb", **kw)
    j = jb.BankSession(jrx.ReceiverConfig(**cfg), FREQS, monitor=1)
    t = tb.BankSession(trx.ReceiverConfig(**cfg), FREQS, monitor=1,
                       device="cpu")
    for s in (j, t):
        s.start()
    return j, t


def _pump(sessions, x, pieces=3):
    for s in sessions:
        for piece in np.array_split(x, pieces):
            s.pump(piece)
        s.flush()


def test_bank_session_matches_jax():
    """Six blocks in uneven pieces: the same blocks run, per-channel
    S-meters within 0.01 dB, the monitor channel's queued audio >= 90 dB
    SNR (int16 both), the mini-spectra within 0.1 dB wherever JAX's is
    above -100 dB, the metrics counts equal, the channel table the same
    (its meters rounded to 0.1 dB); the toned channels' meters > 30 dB
    above the empty one's."""
    j, t = _pair()
    n = t.cfg.block_size
    x = _signal(6 * n, seed=1)
    _pump((j, t), x, pieces=7)
    assert t.metrics.blocks == j.metrics.blocks == 6
    assert t.metrics.samples_in == j.metrics.samples_in
    assert t.metrics.audio_samples_out == j.metrics.audio_samples_out
    np.testing.assert_allclose(t.smeter_db, np.asarray(j.smeter_db),
                               atol=0.01)
    np.testing.assert_allclose(t.smeter_peak_db,
                               np.asarray(j.smeter_peak_db), atol=0.01)
    assert min(t.smeter_db[:2]) > t.smeter_db[2] + 30.0
    want, got = _queued(j.audio_queue), _queued(t.audio_queue)
    assert len(got) == len(want) > 0
    assert _snr_db(want, got) >= 90.0
    live = j.channel_spectra > -100.0
    assert live.any()
    assert np.abs(t.channel_spectra - j.channel_spectra)[live].max() < 0.1
    for a, b in zip(t.channel_info(), j.channel_info()):
        assert list(a) == list(b)
        assert (a["id"], a["tune_hz"], a["monitor"]) == (
            b["id"], b["tune_hz"], b["monitor"])
        assert abs(a["smeter_db"] - b["smeter_db"]) <= 0.1 + 1e-9


def test_bank_session_controls_match_jax():
    """select, tune_channel, tune_clicked, set_volume, channel_info and
    the status line: the same values and structure as JAX's."""
    j, t = _pair()
    for s in (j, t):
        assert s.select(2) == 2
        assert s.select(4) == 1                  # modulo the channel count
        assert s.tune_channel(0, 35_000.0) == 35_000.0
    assert t.tune_clicked(61_049.0) == j.tune_clicked(61_049.0)
    assert t.tune_freqs == j.tune_freqs
    ti, ji = t.channel_info(), j.channel_info()
    assert [{k: v for k, v in d.items() if k != "spec"} for d in ti] == [
        {k: v for k, v in d.items() if k != "spec"} for d in ji]
    assert [len(d["spec"]) for d in ti] == [tb.SPECTRA_BINS] * 3
    t.set_volume(40)
    assert t.settings.volume == 40
    assert t.status_line().startswith("3 ch | monitor 1 | ")
    assert t.n_channels == j.n_channels == 3


def test_bank_probe_scope_monitor_channel():
    """tests/test_bank.py's probe-scope check on the port, against the
    JAX session: the monitor channel's p2 spectrum peaks at its +1 kHz
    audio line and is within 0.1 dB of JAX's above -100 dB (the float
    floor outside the passband is noise), the frame reports the monitor
    channel; a scope view records; off rebuilds without probes; p6 and a
    bad trigger mode are ValueErrors."""
    j, t = _pair()
    n = t.cfg.block_size
    x = _signal(8 * n, seed=2)
    for s in (j, t):
        assert s.set_probe("p2") == "p2_fastfir"
    _pump((j, t), x[:4 * n])
    fj, ft = j.probe_frame(), t.probe_frame()
    assert list(ft) == list(fj)
    assert ft["channel"] == fj["channel"] == 1 and ft["view"] == "spectrum"
    db, want = t._probe_inst.spectrum_db(), j._probe_inst.spectrum_db()
    live = want > -100.0            # the passband, not the float floor
    assert live.sum() > 20
    assert np.abs(db - want)[live].max() < 0.1
    pk = (np.argmax(db) - len(db) // 2) * ft["sample_rate"] / len(db)
    assert abs(pk - 1000.0) < 100.0, pk
    for s in (j, t):
        assert s.set_probe("p4", view="scope") == "p4_demod"
    _pump((j, t), x[4 * n:6 * n])
    ft = t.probe_frame()
    assert ft["view"] == "scope" and len(ft["record"]) == 1024
    for s in (j, t):
        with pytest.raises(ValueError, match="unknown probe tap"):
            s.set_probe("p6")
        with pytest.raises(ValueError, match="trigger mode"):
            s.set_probe("p2", view="scope", trigger_mode="bogus")
        assert s.set_probe(None) is None
        assert not s.cfg.probes
    _pump((j, t), x[6 * n:])
    assert t.probe_frame() is None
    assert t.metrics.blocks == j.metrics.blocks == 8


def test_bank_taps_match_jax():
    """A 2-channel ChannelBank with the noise blanker and probes on, over
    two blocks with impulses: p1-p5 and p7 with a leading channel axis
    and no p6, as JAX's bank, each channel >= 90 dB SNR against JAX's."""
    kw = dict(BASE, mode="usb", nb_on=True, probes=True)
    jbank = j_ch.ChannelBank(jrx.ReceiverConfig(**kw), FREQS[:2])
    tbank = t_ch.ChannelBank(trx.ReceiverConfig(**kw), FREQS[:2], "cpu")
    n = tbank.cfg.block_size
    for b in range(2):
        x = _signal(n, seed=20 + b, start=b * n)
        x[(b * n + np.arange(n)) % 2500 == 0] += 20000.0
        want = {k: np.asarray(v)
                for k, v in jbank.process(jnp.asarray(x)).probes.items()}
        got = {k: v.numpy() for k, v in tbank.process(x).probes.items()}
        assert sorted(got) == sorted(want) == [
            "p1_downconvert", "p2_fastfir", "p3_agc", "p4_demod",
            "p5_resampled", "p7_blanker"]
        for k, w in want.items():
            assert got[k].shape == w.shape and w.shape[0] == 2, k
            assert got[k].dtype == w.dtype, k
            for c in range(2):
                assert _snr_db(w[c], got[k][c]) >= 90.0, (k, c)
