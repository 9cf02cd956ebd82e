"""The port's spectrum server over loopback driving the port's sessions
(the route, SSE, mode, probe-scope and bank cases of
tests/test_probes_serve.py and tests/test_bank.py, and the audio stream
of tests/test_serve_audio.py), ``to_int16`` against the JAX package's bit
for bit, and the latency model against the JAX package's over a grid of
configurations and against the port's receiver (tests/test_latency.py)."""

import http.client
import json
import struct
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesdr_tpu.design import latency as j_lat
from cutesdr_tpu.ops import resampler as j_rs
from cutesdr_tpu.pipeline import receiver as jrx
from cutesdr_tpu_torch.bank import BankSession
from cutesdr_tpu_torch.design import latency as t_lat
from cutesdr_tpu_torch.io.audio_sink import RateLockedQueue
from cutesdr_tpu_torch.ops import resampler as t_rs
from cutesdr_tpu_torch.pipeline.receiver import (MODE_LIMITS, Receiver,
                                                 ReceiverConfig)
from cutesdr_tpu_torch.serve import SpectrumServer
from cutesdr_tpu_torch.session import ReceiverSession

torch.set_num_threads(1)


def _tone(n, f, fs, power_db):
    t = np.arange(n) / fs
    return (32767 * 10 ** (power_db / 20)
            * np.exp(2j * np.pi * f * t)).astype(np.complex64)


def _post(srv, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _frame(srv):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/spectrum.json", timeout=5) as r:
        return json.loads(r.read())


def test_spectrum_server_roundtrip():
    tunes = []
    srv = SpectrumServer(port=0, sample_rate=1e6,
                         on_tune=lambda f: tunes.append(f)).start()
    try:
        srv.update(np.linspace(-120, -20, 1024), smeter_db=-42.0)
        d = _frame(srv)
        assert len(d["db"]) == 1024 and d["smeter_db"] == -42.0
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/",
                                    timeout=5) as r:
            assert b"canvas" in r.read()
        _post(srv, "/tune", {"fraction": 0.75})
        assert tunes and abs(tunes[0] - 0.25 * 1e6) < 1.0
    finally:
        srv.stop()


def test_spectrum_server_sse_push_and_filter_drag():
    """Frames arrive over /events without polling; /filter round-trips the
    clamped edges; /tune returns the applied (rounded) value."""
    srv = SpectrumServer(port=0, sample_rate=1e6,
                         on_tune=lambda f: round(f / 100) * 100,
                         on_filter=lambda lo, hi: (max(lo, -8000.0),
                                                   min(hi, 8000.0))).start()
    try:
        srv.set_view(tune_hz=0.0, low_hz=-5000.0, hi_hz=5000.0)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
        conn.request("GET", "/events")
        resp = conn.getresponse()
        assert resp.getheader("Content-Type") == "text/event-stream"

        def read_event():
            buf = b""
            while not buf.endswith(b"\n\n"):
                c = resp.read(1)
                if not c:
                    raise AssertionError("stream closed")
                buf += c
            return buf

        first = read_event()
        assert first.startswith(b"data: ")
        d = json.loads(first[6:])
        assert d["tune_hz"] == 0.0 and len(d["db"]) == 1024
        srv.update(np.full(512, -30.0), smeter_db=-21.0)
        ev = read_event()
        while not ev.startswith(b"data: "):
            ev = read_event()
        d = json.loads(ev[6:])
        assert d["smeter_db"] == -21.0 and len(d["db"]) == 512
        assert _post(srv, "/filter", {"low_hz": -20000.0, "hi_hz": 3000.0}
                     ) == (200, {"low_hz": -8000.0, "hi_hz": 3000.0})
        assert srv.view["low_hz"] == -8000.0
        assert _post(srv, "/tune", {"freq_hz": 12349.0}) == (
            200, {"tune_hz": 12300.0})
        assert srv.view["tune_hz"] == 12300.0
        conn.close()
    finally:
        srv.stop()


def test_freqctrl_digit_editor_served():
    srv = SpectrumServer(port=0, sample_rate=1e6).start()
    try:
        srv.set_view(tune_hz=12_345.0, rf_center=7_000_000.0)
        srv.update(np.full(1024, -100.0))
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/",
                                    timeout=5) as r:
            page = r.read().decode()
        for needle in ("freqctrl", "fcRender", "lead-zero", "fcClamp"):
            assert needle in page, needle
        d = _frame(srv)
        assert d["rf_center"] == 7_000_000.0 and d["tune_hz"] == 12_345.0
    finally:
        srv.stop()


def test_session_set_filter_clamps_and_mirrors():
    sess = ReceiverSession(ReceiverConfig(input_rate=500_000.0, mode="am"),
                           device="cpu")
    assert sess.set_filter(-3000.0, 7000.0) == (-7000.0, 7000.0)
    assert sess.set_filter(-99000.0, 99000.0) == (-10000.0, 10000.0)
    sess2 = ReceiverSession(ReceiverConfig(input_rate=500_000.0,
                                           mode="usb"), device="cpu")
    assert sess2.set_filter(-50.0, 30000.0) == (0.0, 20000.0)
    assert (sess2.current_low, sess2.current_hi) == (0.0, 20000.0)


def test_mode_switch_endpoint():
    """POST /mode drives the port session's set_mode; the frame carries
    the new mode and its edges; the stream goes on."""
    cfg = ReceiverConfig(input_rate=250_000.0, mode="usb",
                         tune_freq=10_000.0, audio_rate=None)
    sess = ReceiverSession(cfg, device="cpu")
    sess.start()

    def on_mode(mode):
        sess.set_mode(mode)
        c = sess.cfg
        srv.set_view(low_hz=c.low_cut, hi_hz=c.hi_cut,
                     symmetric=MODE_LIMITS[mode][4])
        return mode

    srv = SpectrumServer(port=0, sample_rate=cfg.input_rate,
                         on_mode=on_mode).start()
    srv.set_view(mode=cfg.mode, tune_hz=cfg.tune_freq, low_hz=cfg.low_cut,
                 hi_hz=cfg.hi_cut)
    try:
        assert _post(srv, "/mode", {"mode": "am"}) == (200, {"mode": "am"})
        assert sess.cfg.mode == "am"
        frame = _frame(srv)
        assert frame["mode"] == "am" and frame["symmetric"] is True
        sess.pump(np.zeros(2 * sess.cfg.block_size, np.complex64))
        assert sess.metrics.blocks >= 1
    finally:
        sess.stop()
        srv.stop()


def test_probe_tap_scope_over_http():
    """POST /probe selects a live tap of the port session; frames carry
    its spectrum (the p2 line at +1 kHz) or a free-run record; bad taps
    are 400s; off removes it and switches the receiver back."""
    cfg = ReceiverConfig(input_rate=250_000.0, mode="usb",
                         tune_freq=60_000.0, audio_rate=48000.0)
    sess = ReceiverSession(cfg, device="cpu")
    sess.start()
    srv = SpectrumServer(port=0, sample_rate=cfg.input_rate,
                         on_tune=sess.tune_clicked,
                         on_probe=sess.set_probe).start()
    sess.on_spectrum = lambda db: srv.update(
        db, smeter_db=sess.metrics.smeter_ave_db, probe=sess.probe_frame())
    sess.analyzer._skip = 1
    try:
        x = _tone(cfg.block_size * 6, 61_000.0, cfg.input_rate, -20.0)
        assert _post(srv, "/probe", {"tap": "p2", "view": "spectrum"}) == (
            200, {"tap": "p2_fastfir"})
        for b in np.split(x, 6):
            sess.pump(b)
        sess.flush()
        p = _frame(srv)["probe"]
        assert p["tap"] == "p2_fastfir" and p["view"] == "spectrum"
        db = np.asarray(p["db"])
        pk = (np.argmax(db) - len(db) // 2) * p["sample_rate"] / len(db)
        assert abs(pk - 1000.0) < 100.0, pk
        assert _post(srv, "/probe", {"tap": "p4", "view": "scope",
                                     "trigger_mode": "free"}) == (
            200, {"tap": "p4_demod"})
        for b in np.split(x, 6):
            sess.pump(b)
        sess.flush()
        p = _frame(srv)["probe"]
        assert p["view"] == "scope" and len(p["record"]) == 1024
        code, d = _post(srv, "/probe", {"tap": "p9"})
        assert code == 400 and "error" in d
        code, d = _post(srv, "/probe", {"tap": "p7"})
        assert code == 400
        assert _post(srv, "/probe", {"tap": "off"}) == (200, {"tap": None})
        sess.pump(x[:cfg.block_size])
        sess.flush()
        assert "probe" not in _frame(srv)
        assert not sess.cfg.probes
    finally:
        srv.stop()


def test_bank_serve_roundtrip():
    """tests/test_bank.py's web round trip on the port's BankSession: the
    channel table in the frame, POST /select moving the monitor."""
    cfg = ReceiverConfig(input_rate=250_000.0, mode="usb")
    sess = BankSession(cfg, [28_000.0, -52_000.0], device="cpu")
    sess.start()

    def on_select(i):
        m = sess.select(i)
        srv.set_view(tune_hz=sess.tune_freqs[m])
        return m

    srv = SpectrumServer(port=0, sample_rate=cfg.input_rate,
                         on_tune=sess.tune_clicked,
                         on_select=on_select).start()
    try:
        sess.on_spectrum = lambda db: srv.update(
            db, smeter_db=float(sess.smeter_db[sess.monitor]),
            channels=sess.channel_info())
        t = np.arange(cfg.block_size * 6) / cfg.input_rate
        iq = (8000.0 * (np.exp(2j * np.pi * 30_000.0 * t)
                        + np.exp(2j * np.pi * -50_000.0 * t))
              ).astype(np.complex64)
        sess.analyzer._skip = 1
        sess.pump(iq)
        sess.flush()
        sess.on_spectrum(sess.analyzer.spectrum_db())
        frame = _frame(srv)
        assert len(frame["channels"]) == 2
        assert frame["channels"][0]["monitor"]
        assert frame["channels"][1]["smeter_db"] > -40
        assert _post(srv, "/select", {"channel": 1}) == (200,
                                                         {"selected": 1})
        assert sess.monitor == 1
        assert _frame(srv)["tune_hz"] == sess.tune_freqs[1]
    finally:
        srv.stop()


def _read_exact(stream, n):
    buf = b""
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            break
        buf += chunk
    return buf


def test_audio_wav_streams_decodable_pcm():
    """tests/test_serve_audio.py on the port's server and queue: /audio.wav
    streams the rate-locked queue as paced PCM a WAV reader decodes (the
    1 kHz tone), two listeners each get the whole stream, and POST
    /volume reaches the callback."""
    q = RateLockedQueue()
    t = np.arange(48000) / 48000
    tone = (8000.0 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.int16)
    q.put_block(tone)                     # > half fill: startup gate opens
    got_volume = []
    srv = SpectrumServer(port=0, sample_rate=2e6, audio_queue=q,
                         on_volume=got_volume.append).start()
    stop = threading.Event()

    def feeder():
        while not stop.is_set():
            q.put_block(tone[:4800])
            time.sleep(0.05)

    try:
        threading.Thread(target=feeder, daemon=True).start()
        resp = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/audio.wav", timeout=10)
        assert resp.headers["Content-Type"] == "audio/wav"
        hdr = _read_exact(resp, 44)
        assert hdr[:4] == b"RIFF" and hdr[8:12] == b"WAVE"
        fmt = struct.unpack("<IHHIIHH", hdr[16:36])
        assert fmt[1] == 1 and fmt[2] == 1 and fmt[3] == 48000
        audio = np.frombuffer(_read_exact(resp, 48000), np.int16).astype(
            np.float64)
        resp.close()
        assert len(audio) == 24000
        spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
        pk = np.fft.rfftfreq(len(audio), 1 / 48000.0)[np.argmax(spec)]
        assert abs(pk - 1000.0) < 20.0, pk
        assert 20 * np.log10(spec.max()) - np.median(
            20 * np.log10(spec + 1e-9)) > 40.0

        outs = {}

        def read_one(tag):
            r2 = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/audio.wav", timeout=10)
            _read_exact(r2, 44)
            outs[tag] = _read_exact(r2, 24000)
            r2.close()

        readers = [threading.Thread(target=read_one, args=(k,))
                   for k in ("a", "b")]
        for r2 in readers:
            r2.start()
        for r2 in readers:
            r2.join(15)
            assert not r2.is_alive()
        for k, raw in outs.items():
            a2 = np.frombuffer(raw, np.int16).astype(np.float64)
            assert len(a2) == 12000, (k, len(a2))
            s2 = np.abs(np.fft.rfft(a2 * np.hanning(len(a2))))
            pk2 = np.fft.rfftfreq(len(a2), 1 / 48000.0)[np.argmax(s2)]
            assert abs(pk2 - 1000.0) < 30.0, (k, pk2)
        assert _post(srv, "/volume", {"volume": 42}) == (200,
                                                         {"volume": 42})
        assert got_volume == [42]
    finally:
        stop.set()
        srv.stop()


# ------------------------------------------------------------ to_int16 ----
@pytest.mark.parametrize("stereo", [False, True])
def test_to_int16_matches_jax(stereo):
    """Gain, clip and int16 quantize bit for bit against the JAX
    package's, mono (float32) and stereo (complex64 -> [n, 2]), over
    values past full scale both ways and halfway points."""
    rng = np.random.default_rng(7)
    n = 4096
    y = rng.standard_normal(n) * 30000.0
    y[:8] = [0.5, -0.5, 1.5, -1.5, 32767.4, -32767.6, 1e9, -1e9]
    if stereo:
        y = y + 1j * rng.standard_normal(n) * 30000.0
    y = y.astype(np.complex64 if stereo else np.float32)
    for gain in (1.0, 0.37, 3.0):
        want = np.asarray(j_rs.to_int16(jnp.asarray(y), gain, stereo))
        got = t_rs.to_int16(torch.from_numpy(y), gain, stereo).numpy()
        assert got.dtype == want.dtype == np.int16
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------- latency model --
GRID = [dict(), dict(mode="am", input_rate=250_000.0),
        dict(mode="fm", frames_per_block=4), dict(audio_rate=None),
        dict(mode="cwu", input_rate=2e6, resampler_periods=29),
        dict(mode="lsb", fastfir_nfft=4096, fastfir_ntaps=2049)]


@pytest.mark.parametrize("kw", GRID)
def test_latency_model_matches_jax(kw):
    """latency_report (with and without the queue) equal to JAX's, and
    choose_fastfir_sizes picking the same sizes or raising the same
    error at each target."""
    tcfg, jcfg = ReceiverConfig(**kw), jrx.ReceiverConfig(**kw)
    for queue in (False, True):
        assert t_lat.latency_report(tcfg, queue) == j_lat.latency_report(
            jcfg, queue)
    for target in (1e-4, 2e-3, 5e-3, 2e-2, 0.1, 1.0):
        try:
            want = j_lat.choose_fastfir_sizes(jcfg, target)
        except ValueError as e:
            with pytest.raises(ValueError, match="unreachable") as got:
                t_lat.choose_fastfir_sizes(tcfg, target)
            assert str(got.value) == str(e)
            continue
        got = t_lat.choose_fastfir_sizes(tcfg, target)
        assert (got.fastfir_nfft, got.fastfir_ntaps, got.frames_per_block
                ) == (want.fastfir_nfft, want.fastfir_ntaps,
                      want.frames_per_block)
        assert got.mode == tcfg.mode and got.input_rate == tcfg.input_rate


def test_impulse_delay_matches_group_delay_budget():
    """tests/test_latency.py on the port: an input impulse surfaces in the
    audio at the modeled decimator + channel-filter group delay (USB, AGC
    off, no resampler: a linear path)."""
    cfg = ReceiverConfig(input_rate=500_000.0, mode="usb", tune_freq=0.0,
                         audio_rate=None, agc_on=False,
                         agc_manual_gain_db=0.0)
    rep = t_lat.latency_report(cfg)
    gd_out = ((rep["decimator_group_delay"] + rep["fastfir_group_delay"])
              * cfg.output_rate)
    rx = Receiver(cfg, "cpu")
    x = np.zeros(cfg.block_size * 3, np.complex64)
    x[0] = 1000.0
    audio = np.concatenate([rx.process(b).audio.numpy()
                            for b in np.split(x, 3)])
    assert abs(int(np.argmax(np.abs(audio))) - gd_out) <= 2


def test_choose_fastfir_sizes_runs_end_to_end():
    """A 15 ms target shrinks the filter, and the port's receiver at the
    chosen sizes still recovers the tone."""
    cfg = ReceiverConfig(input_rate=500_000.0, mode="usb",
                         tune_freq=100_000.0, audio_rate=None, agc_on=False)
    tuned = t_lat.choose_fastfir_sizes(cfg, 15e-3)
    assert tuned.fastfir_nfft < 2048
    assert t_lat.latency_report(tuned)["total"] <= 15e-3
    rx = Receiver(tuned, "cpu")
    x = _tone(tuned.block_size * 6, 101_000.0, tuned.input_rate, -20.0)
    audio = np.concatenate([rx.process(b).audio.numpy()
                            for b in np.split(x, 6)])
    a = audio[len(audio) // 2:]
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    f_pk = np.argmax(spec) * tuned.output_rate / len(a)
    assert abs(f_pk - 1000.0) < 2 * tuned.output_rate / len(a)
