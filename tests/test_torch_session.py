"""The port's live session on the CPU: ``ReceiverSession`` against the JAX
package's on the same pumped input (the queued audio and the metrics
counts) through a mode walk with the noise blanker on, the int16 plane
path, the program cache, the rate-lock loop, the settings documents and
the checkpoint, and the entry points' device rule."""

import dataclasses

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before any session)
import numpy as np
import pytest
import torch

from cutesdr_tpu import session as js
from cutesdr_tpu import settings as jset
from cutesdr_tpu.pipeline import receiver as jrx
from cutesdr_tpu_torch import session as ts
from cutesdr_tpu_torch import settings as tset
from cutesdr_tpu_torch.pipeline import receiver as trx
from cutesdr_tpu_torch.pipeline import spectrum as t_sp
from cutesdr_tpu_torch.shard import channels as t_ch

torch.set_num_threads(1)

KW = dict(input_rate=250_000.0, mode="usb", tune_freq=60_000.0,
          frames_per_block=2, nb_on=True)


def _signal(n, seed=3):
    """A -30 dBFS tone 1 kHz above the tune, -80 dBFS noise, a near full
    scale impulse every 20 ms."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 250e3
    x = 32767 * 10 ** (-30 / 20) * np.exp(2j * np.pi * 61_000.0 * t)
    x += 3.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x[::5000] += 20000.0
    return x.astype(np.complex64)


def _queued(q):
    """The audio a RateLockedQueue holds, oldest first."""
    idx = (q._tail + np.arange(q.level)) & (q.size - 1)
    return q._buf[idx].astype(int)


def _walk(sess, x, piece, planes, mode):
    """Pump ``x`` in pieces of ``piece`` samples (complex, or int16 planes)
    with the mode walk usb -> ``mode`` (piece 4) -> usb (piece 8)."""
    blocks = []
    for i, pos in enumerate(range(0, len(x), piece)):
        if i in (4, 8):
            sess.set_mode(mode if i == 4 else "usb")
        chunk = x[pos:pos + piece]
        if planes:
            blocks.append(sess.pump_planes(
                np.round(chunk.real).astype(np.int16),
                np.round(chunk.imag).astype(np.int16)))
        else:
            blocks.append(sess.pump(chunk))
    sess.flush()
    return blocks


@pytest.mark.parametrize("planes,mode", [(False, "am"), (True, "lsb")])
def test_session_matches_jax(planes, mode):
    """The same input through both sessions (pump of complex samples, or
    pump_planes of int16 wire planes through the ingest thread) with a
    mode walk usb -> ``mode`` -> usb and the blanker on: the same blocks
    run and the metrics counts are equal.  The JAX session runs its
    Pallas mixdec interpreted, whose carry is the raw input tail like the
    port's.

    The queued int16 audio within 1 LSB, where the float32 audio of the
    two packages rounds apart: through LSB (same rates, every carry kept)
    and through AM (a new decimation plan with a longer decimator tail,
    which both packages fill from the same raw history: the port's tail
    holds as many samples as JAX's row-padded one)."""
    x = _signal(120_000)
    if planes:
        x = (np.round(x.real) + 1j * np.round(x.imag)).astype(np.complex64)
    jsess = js.ReceiverSession(jrx.ReceiverConfig(
        **KW, decimator_impl="pallas", pallas_interpret=True))
    tsess = ts.ReceiverSession(trx.ReceiverConfig(**KW), device="cpu")
    for s in (jsess, tsess):
        s.start()
    assert _walk(jsess, x, 10_000, planes, mode) == _walk(
        tsess, x, 10_000, planes, mode)
    for k in ("samples_in", "blocks", "audio_samples_out", "audio_overflows",
              "audio_underflows"):
        assert getattr(tsess.metrics, k) == getattr(jsess.metrics, k), k
    # every sample fed ran, but a partial block that waits
    pending = len(tsess._pending) + len(tsess._pending_re)
    assert tsess.metrics.samples_in + pending == len(x)
    assert pending < tsess.cfg.block_size
    a, b = _queued(jsess.audio_queue), _queued(tsess.audio_queue)
    assert len(a) == len(b) > 10_000
    assert np.abs(a - b).max() <= 1
    assert tsess.cfg.mode == "usb" and tsess.settings.demod_mode == "usb"
    tsess.stop()


def test_pump_planes_int16_equals_pump():
    """int16 planes through the ingest thread give the same queued audio
    and metrics as the same values pumped as complex samples, bitwise; the
    display path gets the same frames where the throttle is off."""
    x = _signal(60_000, seed=4)
    qr, qi = np.round(x.real).astype(np.int16), np.round(x.imag).astype(
        np.int16)
    xq = (qr.astype(np.float32) + 1j * qi.astype(np.float32)).astype(
        np.complex64)
    cfg = trx.ReceiverConfig(**KW)
    spec = t_sp.SpectrumConfig(fft_size=512, sample_rate=512.0)
    a = ts.ReceiverSession(cfg, spectrum_cfg=spec, device="cpu")
    b = ts.ReceiverSession(cfg, spectrum_cfg=spec, device="cpu")
    a.start()
    b.start()
    for pos in range(0, 60_000, 7_000):
        a.pump(xq[pos:pos + 7_000])
        b.pump_planes(qr[pos:pos + 7_000], qi[pos:pos + 7_000])
    a.flush()
    b.flush()
    np.testing.assert_array_equal(_queued(a.audio_queue),
                                  _queued(b.audio_queue))
    assert a.metrics.as_dict()["audio_samples_out"] == \
        b.metrics.as_dict()["audio_samples_out"]
    assert a.metrics.samples_in == b.metrics.samples_in == 57_344
    for f in t_sp.SpectrumState._fields:
        assert torch.equal(getattr(a.analyzer.state, f),
                           getattr(b.analyzer.state, f))
    b.stop()
    assert b._ingest is None


def test_mode_walk_drops_no_sample():
    """Uneven pieces through pump_planes while the mode walks usb -> am ->
    fm -> usb and the input rate changes: every whole block of the new
    block size runs, the partial block waits, and flush delivers every
    step."""
    cfg = trx.ReceiverConfig(**dict(KW, nb_on=False))
    sess = ts.ReceiverSession(cfg, device="cpu")
    sess.start()
    x = _signal(200_000, seed=5)
    qr, qi = (np.round(p).astype(np.int16) for p in (x.real, x.imag))
    fed, pos = 0, 0
    for i, piece in enumerate((9_000, 13_000, 5_500, 17_000, 30_000,
                               12_345, 20_000)):
        if i in (2, 3, 4):
            sess.set_mode(("am", "fm", "usb")[i - 2])
        if i == 5:
            sess.set_input_rate(500_000.0)
        sess.pump_planes(qr[pos:pos + piece], qi[pos:pos + piece])
        pos += piece
        fed += piece
    sess.flush()
    pending = len(sess._pending_re)
    assert sess.metrics.samples_in + pending == fed
    assert pending < sess.cfg.block_size
    assert sess.metrics.audio_samples_out > 0
    assert not sess._inflight
    sess.stop()


def test_program_cache_lru_eviction():
    """max_cached_programs bounds the cached receivers as in the JAX
    session: the least recently used go first, never the active one nor
    the one just touched; the same walk leaves the same modes cached."""
    kw = dict(KW, nb_on=False)
    t = ts.ReceiverSession(trx.ReceiverConfig(**kw), device="cpu",
                           max_cached_programs=2)
    j = js.ReceiverSession(jrx.ReceiverConfig(**kw), max_cached_programs=2)
    modes = lambda sess: [k[1] for k in sess._receivers]
    for s in (t, j):
        s.precompile(["am", "fm"])
    assert modes(t) == modes(j) == ["usb", "fm"]
    for mode, want in (("sam", ["usb", "sam"]), ("fm", ["sam", "fm"]),
                       ("usb", ["fm", "usb"])):
        t.set_mode(mode)
        j.set_mode(mode)
        assert modes(t) == modes(j) == want
    assert t.receiver is t._receivers[t._cfg_key(t.cfg)]


def test_rate_lock_loop_sets_the_ratio():
    """The consumer's rate correction reaches the receiver's resampler at
    the next pump: ratio = nominal * (1 + correction), as in the JAX
    session; a change of mode keeps the correction."""
    cfg = trx.ReceiverConfig(**dict(KW, nb_on=False))
    sess = ts.ReceiverSession(cfg, device="cpu")
    sess.start()
    sess.audio_queue._rate_correction = 2.5e-4
    sess.pump(_signal(cfg.block_size, seed=6))
    want = trx.ratio_params(trx.init(cfg, "cpu")[0], cfg.output_rate
                            / 48_000.0 * (1 + 2.5e-4)).resamp
    assert sess.receiver.params.resamp == want
    sess.set_mode("am")
    nominal = sess.cfg.output_rate / 48_000.0
    assert sess.receiver.params.resamp == trx.ratio_params(
        sess.receiver.params, nominal * (1 + 2.5e-4)).resamp


def test_controls_match_jax():
    """tune_clicked rounds to the mode's click resolution, set_filter
    clamps to the mode's limits and mirrors symmetric modes, as the JAX
    session does; status_line renders."""
    cfg = trx.ReceiverConfig(**dict(KW, nb_on=False))
    t = ts.ReceiverSession(cfg, device="cpu")
    j = js.ReceiverSession(jrx.ReceiverConfig(**dict(KW, nb_on=False)))
    for s in (t, j):
        s.set_mode("am")
    assert t.tune_clicked(60_049.0) == j.tune_clicked(60_049.0)
    assert t.current_tune == j.current_tune
    for lo, hi in ((-12_000.0, 3_000.0), (-100.0, 400.0)):
        assert t.set_filter(lo, hi) == j.set_filter(lo, hi)
    t.set_volume(55)
    assert t.settings.volume == 55
    assert "Msps" in t.status_line()


def test_entry_points_default_to_the_card(monkeypatch):
    """Receiver, ChannelBank, StackedReceiver, ReceiverSession, the
    SpectrumAnalyzer, DiversityReceiver, the combiners' init/array_init,
    DiversitySession, BankSession and ProbeSpectrum run on "cuda" unless
    told otherwise: with no CUDA device and no device asked for they
    raise, never falling back to the CPU."""
    from cutesdr_tpu_torch.bank import BankSession
    from cutesdr_tpu_torch.shard import coherent
    from cutesdr_tpu_torch.shard.coherent import DiversityReceiver
    from cutesdr_tpu_torch.testbench.probes import ProbeSpectrum

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = trx.ReceiverConfig(**KW)
    for make in (lambda: trx.Receiver(cfg),
                 lambda: t_ch.ChannelBank(cfg, [0.0]),
                 lambda: t_ch.StackedReceiver(cfg, [0.0]),
                 lambda: ts.ReceiverSession(cfg),
                 lambda: t_sp.SpectrumAnalyzer(t_sp.SpectrumConfig()),
                 lambda: DiversityReceiver(cfg),
                 lambda: coherent.init(),
                 lambda: coherent.array_init(4),
                 lambda: ts.DiversitySession(cfg),
                 lambda: BankSession(cfg, [0.0, 1000.0]),
                 lambda: ProbeSpectrum(48_000.0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert trx.Receiver(cfg, "cpu").device.type == "cpu"


def test_settings_round_trip(tmp_path):
    """SessionSettings save/load round trip, and receiver_config_from_
    settings builds the same configuration as the JAX package's."""
    s = tset.SessionSettings(volume=42, nb_on=True, demod_mode="cwu")
    s.demod["cwu"].offset = 700.0
    s.display.fft_size = 8192
    path = tmp_path / "settings.json"
    s.save(path)
    back = tset.SessionSettings.load(path)
    assert back == s
    assert tset.SessionSettings.load(tmp_path / "none.json") == \
        tset.SessionSettings()
    js_s = jset.SessionSettings.load(path)
    t_cfg = tset.receiver_config_from_settings(back, 2e6)
    j_cfg = jset.receiver_config_from_settings(js_s, 2e6)
    for f in dataclasses.fields(t_cfg):
        assert getattr(t_cfg, f.name) == getattr(j_cfg, f.name), f.name


def test_checkpoint_resume_is_deterministic(tmp_path):
    """A stream checkpointed after two blocks and resumed in a new receiver
    continues bitwise as the uninterrupted one; the stream offset comes
    back."""
    cfg = trx.ReceiverConfig(**dict(KW, mode="fm"))
    x = _signal(4 * cfg.block_size, seed=7).reshape(4, -1)
    a = trx.Receiver(cfg, "cpu")
    for blk in x[:2]:
        a.process(blk)
    path = tmp_path / "state.npz"
    tset.save_state(path, a.state, stream_offset=2 * cfg.block_size)
    b = trx.Receiver(cfg, "cpu")
    b.state, offset = tset.load_state(path, b.state)
    assert offset == 2 * cfg.block_size
    for blk in x[2:]:
        ya, yb = a.process(blk), b.process(blk)
        assert torch.equal(ya.audio, yb.audio)
    assert torch.equal(a.state.blanker.sig_tail, b.state.blanker.sig_tail)


def test_checkpoint_shape_mismatch_refused(tmp_path):
    path = tmp_path / "state.npz"
    tset.save_state(path, trx.Receiver(trx.ReceiverConfig(**KW), "cpu").state)
    other = trx.Receiver(trx.ReceiverConfig(**dict(KW, mode="am")), "cpu")
    with pytest.raises(ValueError, match="config mismatch"):
        tset.load_state(path, other.state)
