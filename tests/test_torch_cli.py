"""The port's command line on the CPU (``--device cpu``): the receiver
configurations it builds against the JAX CLI's over a grid of argv, its
``run`` against the JAX CLI's ``run`` on the same argv (the WAV's frames
and samples), the live sources (a fake NetSDR over loopback, the native
UDP ingest), ``serve`` with a loopback GET and its settings file,
``record``, ``spectrum``, ``latency`` and ``discover``, and the device
rule: without a card and without ``--device cpu`` a command raises."""

import argparse
import asyncio
import json
import socket
import struct
import threading
import time
import urllib.request
import wave

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before any CLI)
import numpy as np
import pytest
import torch

from cutesdr_tpu import cli as j_cli
from cutesdr_tpu.pipeline.receiver import ReceiverConfig as JConfig
from cutesdr_tpu_torch import cli as t_cli
from cutesdr_tpu_torch.design.latency import latency_report
from cutesdr_tpu_torch.io import discover as t_discover
from cutesdr_tpu_torch.pipeline.receiver import ReceiverConfig as TConfig

torch.set_num_threads(1)

FS = 250_000.0
CPU = ["--device", "cpu"]


@pytest.fixture
def jax_cli(monkeypatch):
    """The JAX CLI with its readback floor 0 (no device probe) and no
    persistent compile cache."""
    from cutesdr_tpu.design import latency as j_lat
    monkeypatch.setattr(j_lat, "measure_readback_floor", lambda *a: 0.0)
    monkeypatch.setattr(j_cli, "_enable_compile_cache", lambda: None)
    return j_cli


def _wav(path):
    with wave.open(str(path)) as w:
        return (w.getnchannels(), w.getframerate(),
                np.frombuffer(w.readframes(w.getnframes()), np.int16))


def _tone_peak(audio, rate=48000.0):
    """(peak frequency, peak over median floor in dB) of the audio after
    its first half (the AGC's settling head)."""
    a = audio[len(audio) // 2:].astype(np.float64)
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    k = int(np.argmax(spec))
    return (np.fft.rfftfreq(len(a), 1 / rate)[k],
            20 * np.log10(spec[k] / np.median(spec)))


# --------------------------------------------------------- configuration --

def _args(mod, argv, default_latency_ms=-1.0):
    """``argv`` parsed by a CLI module's receiver arguments (run's and
    serve's latency default unless given)."""
    ap = argparse.ArgumentParser()
    mod._add_receiver_args(ap, default_latency_ms=default_latency_ms)
    return ap.parse_args(argv)


GRID = [[]]
for _mode in ("am", "sam", "fm", "usb", "lsb", "cwu", "cwl"):
    for _lat in ([], ["--target-latency-ms", "0"],
                 ["--target-latency-ms", "10"]):
        GRID.append(["--mode", _mode, *_lat])
GRID += [["--fs", "10e6", "--freq", "3e6"],
         ["--mode", "cwl", "--cw-offset", "600", "--target-latency-ms", "25"],
         ["--stereo", "--mode", "sam", "--squelch", "40", "--agc-off",
          "--nb-on", "--nb-threshold", "70", "--fm-deemphasis-us", "75",
          "--low-cut", "-4000", "--hi-cut", "4000"]]


@pytest.mark.parametrize("argv", GRID, ids=lambda a: " ".join(a) or "defaults")
def test_cfg_from_args_matches_jax(argv):
    """The same argv gives the same ReceiverConfig, field by field over
    the fields both packages have (JAX's readback floor 0)."""
    j = j_cli._cfg_from_args(_args(j_cli, argv), readback_floor_s=0.0)
    t = t_cli._cfg_from_args(_args(t_cli, argv))
    names = (set(TConfig.__dataclass_fields__)
             & set(JConfig.__dataclass_fields__))
    assert len(names) >= 25
    for name in sorted(names):
        assert getattr(t, name) == getattr(j, name), name
    assert t.block_size == j.block_size


@pytest.mark.parametrize("argv", [["--target-latency-ms", "0.5"],
                                  ["--mode", "cwu", "--target-latency-ms",
                                   "5"]])
def test_cfg_from_args_refuses_unreachable_target(argv):
    """An explicit latency target that cannot be met is an error in both."""
    with pytest.raises(SystemExit):
        j_cli._cfg_from_args(_args(j_cli, argv), readback_floor_s=0.0)
    with pytest.raises(SystemExit):
        t_cli._cfg_from_args(_args(t_cli, argv))


@pytest.mark.parametrize("mode", ["usb", "cwu"])
def test_cfg_from_args_unreachable_default_matches_jax(mode, monkeypatch):
    """Where the 10 ms default cannot be met (CW at 10 MSPS and up, whose
    composed decimators are too slow to design here, so the sizing is
    made to refuse), both CLIs take the smallest filter, one frame: the
    same config, field by field."""
    from cutesdr_tpu.design import latency as j_lat
    from cutesdr_tpu_torch.design import latency as t_lat

    def refuse(cfg, target):
        raise ValueError("target unreachable")
    monkeypatch.setattr(j_lat, "choose_fastfir_sizes", refuse)
    monkeypatch.setattr(t_lat, "choose_fastfir_sizes", refuse)
    argv = ["--mode", mode]
    j = j_cli._cfg_from_args(_args(j_cli, argv), readback_floor_s=0.0)
    t = t_cli._cfg_from_args(_args(t_cli, argv))
    assert (t.fastfir_nfft, t.fastfir_ntaps, t.frames_per_block) == (
        t_lat.MIN_NFFT, t_lat.MIN_NFFT // 2 + 1, 1)
    for name in set(TConfig.__dataclass_fields__) & set(
            JConfig.__dataclass_fields__):
        assert getattr(t, name) == getattr(j, name), name


@pytest.mark.parametrize("kw", [
    dict(freq=7_100_000.0, center=None, bw_index=1),
    dict(freq=7_101_000.0, center=7_100_000.0, bw_index=3),
    dict(freq=8_000_000.0, center=7_000_000.0, bw_index=1),
    dict(freq=1000.0, center=0.0, bw_index=0, radio_type="sdriq")])
def test_radio_center_algebra_matches_jax(kw):
    """radio: sources take the radio's rate table and split --freq into the
    RF center and the NCO's baseband tune, as JAX's CLI does (or both
    refuse a station outside the digitized band)."""
    def run(mod):
        a = argparse.Namespace(source="radio:h", fs=2e6,
                               **{"radio_type": "netsdr", **kw})
        try:
            mod._apply_radio_rate(a)
        except SystemExit as e:
            return str(e)
        return (a.fs, a.freq, a.center, mod._radio_db_cal(
            argparse.Namespace(**vars(a), rf_gain=-10)))
    assert run(t_cli) == run(j_cli)


# ------------------------------------------------------------------- run --

def _record_sigmf(tmp_path):
    base = str(tmp_path / "cap")
    assert t_cli.main(["record", "--source", "tone:61000", "--fs", str(FS),
                       "--freq", "60000", "--seconds", "0.4", "--fmt",
                       "cf32", "--out", base, *CPU]) == 0
    return f"file:{base}.sigmf-data"


@pytest.mark.parametrize("source", ["tone", "sigmf", "dual"])
def test_cli_run_matches_jax(source, tmp_path, jax_cli):
    """``run`` of the port and of the JAX CLI on the same argv (250 kSPS,
    USB, 0.4 s, the 10 ms default target): the same WAV frame count and
    format, the audio within 1 LSB, the tone at 1 kHz."""
    argv = ["run", "--fs", str(FS), "--mode", "usb", "--freq", "60000",
            "--seconds", "0.4"]
    if source == "tone":
        argv += ["--source", "tone:61000"]
    elif source == "sigmf":
        argv += ["--source", _record_sigmf(tmp_path)]
    else:
        argv += ["--dual", "--source", "dualtone:61000:40:0.8"]
    assert jax_cli.main(argv + ["--out", str(tmp_path / "j.wav")]) == 0
    assert t_cli.main(argv + ["--out", str(tmp_path / "t.wav"), *CPU]) == 0
    jc, jr, ja = _wav(tmp_path / "j.wav")
    tc, tr, ta = _wav(tmp_path / "t.wav")
    assert (tc, tr, len(ta)) == (jc, jr, len(ja))
    assert len(ta) > 10_000
    assert np.abs(ta.astype(int) - ja.astype(int)).max() <= 1
    f, snr = _tone_peak(ta)
    assert abs(f - 1000.0) < 50.0 and snr > 60.0, (f, snr)


def test_cli_run_raises_without_card(tmp_path, monkeypatch):
    """No CUDA device and no --device cpu: the command raises; it does not
    run on the CPU, and writes no WAV."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.wav"
    for argv in (["run", "--source", "tone:61000", "--fs", str(FS),
                  "--freq", "60000", "--seconds", "0.1", "--out", str(out)],
                 ["spectrum", "--source", "tone:1000", "--fs", str(FS)]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_cli.main(argv)
    assert not out.exists()


# ----------------------------------------------------------- live sources --

def test_cli_run_from_fake_netsdr(tmp_path):
    """``run --source radio:`` against the fake NetSDR of the integration
    tests (TCP control + UDP 16-bit packets) at bandwidth index 1
    (250 kSPS): the tone 1 kHz above the tune comes out of the WAV, and
    the source reports no lost packet or block."""
    from test_integration_radio import FakeNetSdr

    box, started = {}, threading.Event()

    def radio_thread():
        async def main():
            radio = FakeNetSdr(tone_hz=11_000.0, fs=FS, n_packets=2000)
            await radio.start()
            box["port"] = radio.port
            box["stop"] = stop = asyncio.Event()
            box["loop"] = asyncio.get_running_loop()
            started.set()
            await stop.wait()
            await radio.stop()
        asyncio.run(main())

    th = threading.Thread(target=radio_thread, daemon=True)
    th.start()
    assert started.wait(10.0)
    out = tmp_path / "radio.wav"
    try:
        rc = t_cli.main(["run", "--source", f"radio:127.0.0.1:{box['port']}",
                         "--bw-index", "1", "--mode", "usb", "--freq",
                         "10000", "--center", "0", "--seconds", "0.3",
                         "--out", str(out), *CPU])
    finally:
        box["loop"].call_soon_threadsafe(box["stop"].set)
        th.join(10.0)
    assert rc == 0 and not th.is_alive()
    f, snr = _tone_peak(_wav(out)[2])
    assert abs(f - 1000.0) < 50.0, f


def test_cli_run_from_native_udp(tmp_path, capsys):
    """``run --source udp:PORT`` through the port's native ingest (its
    plane reads into ``Receiver.process_planes``): a tone streamed as
    16-bit packets comes out of the WAV at 1 kHz; the run prints the
    ingest's packet counts."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    stop = threading.Event()

    def feeder():
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
            n, seq, t0 = 256, 1, time.perf_counter()
            while not stop.is_set():
                t = (seq - 1) * n + np.arange(n)
                iq = 3000.0 * np.exp(2j * np.pi * 61_000.0 / FS * t)
                data = np.empty(2 * n, "<i2")
                data[0::2], data[1::2] = np.round(iq.real), np.round(iq.imag)
                sock.sendto(struct.pack("<HH", 0x8204, seq & 0xFFFF)
                            + data.tobytes(), ("127.0.0.1", port))
                seq += 1
                # paced to ~1.3x the stream's rate
                lag = (seq - 1) * n / (1.3 * FS) - (time.perf_counter() - t0)
                if lag > 0:
                    time.sleep(lag)

    th = threading.Thread(target=feeder, daemon=True)
    out = tmp_path / "udp.wav"
    th.start()
    try:
        rc = t_cli.main(["run", "--source", f"udp:{port}", "--fs", str(FS),
                         "--mode", "usb", "--freq", "60000", "--seconds",
                         "0.3", "--out", str(out), *CPU])
    finally:
        stop.set()
        th.join(5.0)
    assert rc == 0
    f, snr = _tone_peak(_wav(out)[2])
    assert abs(f - 1000.0) < 50.0 and snr > 60.0, (f, snr)
    assert "packets=" in capsys.readouterr().err


# ----------------------------------------------------------------- serve --

def _free_tcp_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serve_loopback_and_settings(tmp_path, capsys):
    """``serve --seconds 1 --device cpu``: a loopback GET of
    /spectrum.json and a POST /tune while it runs; the settings file it
    saves at exit loads into a second serve, which saves it again."""
    port = _free_tcp_port()
    path = tmp_path / "settings.json"
    argv = ["serve", "--no-precompile", "--source", "tone:61000", "--fs",
            str(FS), "--mode", "usb", "--freq", "60000", "--seconds", "1",
            "--port", str(port), "--settings", str(path), *CPU]
    box = {}
    th = threading.Thread(target=lambda: box.setdefault(
        "rc", t_cli.main(argv)), daemon=True)
    th.start()
    got, tuned = None, None
    deadline = time.time() + 60
    while (got is None or tuned is None) and time.time() < deadline:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/spectrum.json", timeout=2) as r:
                got = json.loads(r.read())
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/tune",
                data=json.dumps({"freq_hz": 60_500}).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=2) as r:
                tuned = json.loads(r.read())
        except OSError:
            time.sleep(0.05)
    th.join(120)
    assert not th.is_alive() and box["rc"] == 0
    assert isinstance(got, dict) and tuned == {"tune_hz": 60_500.0}
    err = capsys.readouterr().err
    assert "x real time" in err and "settings saved" in err
    doc = json.loads(path.read_text())
    assert doc["demod_mode"] == "usb"
    assert doc["radio"]["demod_frequency"] == 60_500
    doc["volume"] = 42
    path.write_text(json.dumps(doc))
    argv[argv.index("--seconds") + 1] = "0.2"
    assert t_cli.main(argv) == 0
    assert json.loads(path.read_text())["volume"] == 42


# ------------------------------------------- spectrum, latency, discover --

def test_cli_spectrum_matches_jax(capsys, jax_cli):
    """``spectrum`` of the sweep generator (a tone in -90 dBFS noise): the
    same frames, peak bin and frequency as the JAX CLI's, the peak and the
    median noise floor within 0.01 dB."""
    argv = ["spectrum", "--source", "sweep", "--fs", str(FS),
            "--fft-size", "2048", "--ave", "2", "--frames", "3"]
    assert jax_cli.main(argv) == 0
    j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert t_cli.main(argv + CPU) == 0
    t = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("frames", "peak_bin", "peak_freq_hz"):
        assert t[k] == j[k], k
    assert abs(t["peak_freq_hz"] + 50_000.0) < 1000.0   # the sweep's start
    for k in ("peak_db", "noise_floor_db"):
        assert abs(t[k] - j[k]) < 0.01, k


@pytest.mark.parametrize("argv", [[], ["--mode", "fm", "--with-queue"],
                                  ["--target-latency-ms", "10", "--fs",
                                   "10e6"]])
def test_cli_latency_matches_jax(argv, capsys, jax_cli):
    """``latency`` prints the JAX CLI's JSON, and its numbers are
    ``latency_report`` of the configuration."""
    assert jax_cli.main(["latency", *argv]) == 0
    j = json.loads(capsys.readouterr().out)
    assert t_cli.main(["latency", *argv, *CPU]) == 0
    t = json.loads(capsys.readouterr().out)
    assert t == j
    cfg = t_cli._cfg_from_args(_args(
        t_cli, [a for a in argv if a != "--with-queue"], 0.0))
    rep = latency_report(cfg, include_queue="--with-queue" in argv)
    assert t["total"] == round(rep["total"] * 1e3, 3)


class _LoopbackSocket(socket.socket):
    """Sends the discovery broadcast to 127.0.0.1 instead: the test never
    puts a packet on a network."""

    def sendto(self, data, addr):
        return super().sendto(data, ("127.0.0.1", addr[1]))


@pytest.mark.parametrize("radio", [False, True])
def test_cli_discover(radio, monkeypatch, capsys):
    """``discover`` with its request sent to loopback: no responder gives
    rc 0 and "no devices found"; a fake NetSDR responder is listed."""
    monkeypatch.setattr(t_discover, "socket", argparse.Namespace(
        **{k: getattr(socket, k) for k in dir(socket) if k.isupper()},
        socket=_LoopbackSocket, timeout=socket.timeout))
    responder = None
    if radio:
        responder = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        responder.bind(("127.0.0.1", t_discover.DISCOVER_SERVER_PORT))

        def answer():
            req, addr = responder.recvfrom(2048)
            assert req == t_discover._build_request()
            name = b"NetSDR".ljust(16, b"\0")
            msg = struct.pack("<HBBB16s16s16sHB", 88, 0x5A, 0xA5, 1, name,
                              b"SN1".ljust(16, b"\0"),
                              bytes([1, 0, 0, 127]) + bytes(12), 50000, 0)
            responder.sendto(msg + bytes(88 - len(msg)), addr)
        threading.Thread(target=answer, daemon=True).start()
    try:
        assert t_cli.main(["discover", "--timeout", "0.2"]) == 0
    finally:
        if responder is not None:
            responder.close()
    cap = capsys.readouterr()
    if radio:
        dev = json.loads(cap.out)
        assert (dev["name"], dev["serial"], dev["ip"]) == (
            "NetSDR", "SN1", "127.0.0.1")
    else:
        assert cap.out == "" and "no devices found" in cap.err
