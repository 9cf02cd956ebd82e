"""The port's I/O copies against the JAX package's: each case runs the same
calls on the JAX module and on the port's counterpart and requires equal
results (bytes, values, arrays bitwise, files byte for byte), one
parametrised test per surface: ASCP, the AD6620 loader, discovery, the
UDP packet decode and sequence tracker, the file sources and sinks, the
SigMF recorder and ring, the signal generator, the radio rate tables and
the sound-card sink.  Then the port's native UDP ingest, built into
``build/native/``, over loopback."""

import json
import socket
import struct
import types

import numpy as np
import pytest
import torch

import cutesdr_tpu.io.ad6620 as j_ad6620
import cutesdr_tpu.io.ascp as j_ascp
import cutesdr_tpu.io.audio_device as j_audio_device
import cutesdr_tpu.io.audio_sink as j_audio_sink
import cutesdr_tpu.io.discover as j_discover
import cutesdr_tpu.io.filesource as j_filesource
import cutesdr_tpu.io.netsdr as j_netsdr
import cutesdr_tpu.io.recorder as j_recorder
import cutesdr_tpu.testbench.generators as j_generators
import cutesdr_tpu_torch.io.ad6620 as t_ad6620
import cutesdr_tpu_torch.io.ascp as t_ascp
import cutesdr_tpu_torch.io.audio_device as t_audio_device
import cutesdr_tpu_torch.io.audio_sink as t_audio_sink
import cutesdr_tpu_torch.io.discover as t_discover
import cutesdr_tpu_torch.io.filesource as t_filesource
import cutesdr_tpu_torch.io.netsdr as t_netsdr
import cutesdr_tpu_torch.io.recorder as t_recorder
import cutesdr_tpu_torch.testbench.generators as t_generators

torch.set_num_threads(1)

JAX = types.SimpleNamespace(
    ascp=j_ascp, ad6620=j_ad6620, audio_device=j_audio_device,
    audio_sink=j_audio_sink, discover=j_discover, filesource=j_filesource,
    netsdr=j_netsdr, recorder=j_recorder, generators=j_generators)
PORT = types.SimpleNamespace(
    ascp=t_ascp, ad6620=t_ad6620, audio_device=t_audio_device,
    audio_sink=t_audio_sink, discover=t_discover, filesource=t_filesource,
    netsdr=t_netsdr, recorder=t_recorder, generators=t_generators)


def _same(a, b) -> None:
    """Equal, recursively: arrays bitwise (dtype too), everything else by
    ==."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert a == b, (a, b)


def _both(case, *args) -> None:
    """Run ``case(modules, *args)`` on the JAX modules and on the port's
    and hold the results equal."""
    _same(case(JAX, *args), case(PORT, *args))


# ------------------------------------------------------------------ ascp --

def _ascp_set_item(m):
    return m.ascp.set_item(
        m.ascp.ci.RX_STATE, ("u8", m.ascp.ci.RX_STATE_DATACOMPLEX),
        ("u8", m.ascp.ci.RX_STATE_ON), ("u8", m.ascp.ci.MODE_CONTIGUOUS24),
        ("u8", 0))


def _ascp_req_item(m):
    return m.ascp.req_item(m.ascp.ci.GENERAL_STATUS_CODE)


def _ascp_roundtrip(m):
    msg = m.ascp.AscpMessage(m.ascp.TYPE_HOST_SET_CITEM)
    msg.add_citem(m.ascp.ci.RX_FREQUENCY).add_u8(0).add_u32(
        14_200_000).add_u8(0).add_u16(0xBEEF)
    raw = msg.to_bytes()
    p = m.ascp.AscpMessage.from_bytes(raw)
    item = p.citem()
    p.rewind()
    return raw, item, p.get_u8(), p.get_u32(), p.get_u8(), p.get_u16()


def _ascp_assembler(m):
    ci = m.ascp.ci
    stream = b"".join([m.ascp.req_item(ci.GENERAL_STATUS_CODE),
                       m.ascp.set_item(ci.RX_RF_GAIN, ("u8", 0),
                                       ("u8", 0xF6)),
                       m.ascp.req_item(ci.GENERAL_INTERFACE_NAME)])
    split, asm = [], m.ascp.StreamAssembler()
    for i in range(0, len(stream), 3):          # awkward chunk sizes
        split += asm.feed(stream[i:i + 3])
    coalesced = m.ascp.StreamAssembler().feed(stream + stream)
    return [(g.to_bytes(), g.msg_type, g.length) for g in split + coalesced]


def _ascp_8192(m):
    hdr = struct.pack("<H", m.ascp.TYPE_TARG_DATA_ITEM0 << 8)
    body = bytes(range(256)) * 32
    got = m.ascp.StreamAssembler().feed(hdr + body + hdr[:1])
    return [(g.length, g.msg_type, bytes(g.body)) for g in got]


@pytest.mark.parametrize("case", [_ascp_set_item, _ascp_req_item,
                                  _ascp_roundtrip, _ascp_assembler,
                                  _ascp_8192], ids=lambda c: c.__name__)
def test_ascp_matches_jax(case):
    """ASCP wire bytes, the parser and the stream assembler (split,
    coalesced, the 8192-byte data item)."""
    _both(case)


# ---------------------------------------------------------------- ad6620 --

def _ad6620_sequence(m, name):
    loader = m.ad6620.Ad6620Loader(name)
    msgs = []
    while (msg := loader.next_message()) is not None:
        msgs.append(msg)
    return msgs


def _ad6620_rcf(m, name):
    p = m.ad6620.PROFILES[name]
    return (m.ad6620.design_rcf_taps(p), p.total_decimation,
            m.ad6620.SDRIQ_BW_PROFILES)


@pytest.mark.parametrize("case", [_ad6620_sequence, _ad6620_rcf],
                         ids=lambda c: c.__name__)
@pytest.mark.parametrize("name", ["5k", "50k", "190k"])
def test_ad6620_matches_jax(case, name):
    """The AD6620 register-load sequence and the RCF taps of a profile."""
    _both(case, name)


# -------------------------------------------------------------- discover --

def _discover_response():
    name = b"NetSDR".ljust(16, b"\0")
    sn = b"XX123456".ljust(16, b"\0")
    ip = bytes([100, 0, 168, 192]) + bytes(12)
    msg = struct.pack("<HBBB16s16s16sHB", 88, 0x5A, 0xA5, 1, name, sn, ip,
                      50000, 0)
    return msg + bytes(88 - len(msg) - 1) + bytes([0x03])


@pytest.mark.parametrize("case", [
    lambda m: m.discover.parse_response(_discover_response()).__dict__,
    lambda m: m.discover.parse_response(bytes(56)),
    lambda m: m.discover._build_request(),
    lambda m: m.discover._build_request("NetSDR")], ids=["parse", "bad_key",
                                                          "request",
                                                          "request_name"])
def test_discover_matches_jax(case):
    """The discovery response parse, the bad-key refusal and the request
    bytes."""
    _both(case)


# ----------------------------------------------------------- udp decode ---

def _pkt16(seq):
    data = np.zeros(512, "<i2")
    data[0::2] = np.arange(256) * 97 - 12000
    data[1::2] = -np.arange(256) * 53
    return struct.pack("<HH", 0x8204, seq) + data.tobytes()


def _pkt24(seq):
    vals = [((i * 7919) - 900000) & 0xFFFFFF for i in range(480)]
    return struct.pack("<HH", 0x8404, seq) + b"".join(
        v.to_bytes(3, "little") for v in vals)


@pytest.mark.parametrize("case", [
    lambda m: m.netsdr.decode_iq_packet(_pkt16(3)),
    lambda m: m.netsdr.decode_iq_packet(_pkt24(7)),
    lambda m: m.netsdr.decode_iq_packet(bytes(100)),
    lambda m: m.netsdr.decode_iq_packet_dual(_pkt16(9)),
    lambda m: (m.netsdr.PKT_LENGTH_16, m.netsdr.PKT_LENGTH_24),
    lambda m: [(lambda t: [t.update(s) for s in seqs] and int(t.missed))(
        m.netsdr.SequenceTracker()) for seqs in
        ([0, 1, 2, 5, 6], [1, 2, 3], [32765, 32766, 1, 2],
         [0, 4, 0, 1], [10, 9, 8])]],
    ids=["16bit", "24bit", "bad_size", "dual", "lengths", "seq_tracker"])
def test_packet_decode_matches_jax(case):
    """16- and 24-bit packet decode, the dual split and the sequence
    tracker's gap count."""
    _both(case)


# ------------------------------------------------------------ filesource --

def _file_int16(m, tmp):
    path = str(tmp / f"{m.filesource.__name__}.raw")
    iq = (np.arange(100) - 50 + 1j * np.arange(100)).astype(np.complex64)
    w = m.filesource.RawIQWriter(path, "int16")
    w.write(iq)
    w.close()
    src = m.filesource.FileSource(path, "int16")
    return open(path, "rb").read(), src.next_block(60), src.next_block(60)


def _file_cf32_loop(m, tmp):
    path = str(tmp / f"{m.filesource.__name__}.cf32")
    iq = np.exp(1j * np.linspace(0, 3, 64)).astype(np.complex64)
    w = m.filesource.RawIQWriter(path, "cf32")
    w.write(iq)
    w.close()
    src = m.filesource.FileSource(path, "cf32", loop=True)
    return [src.next_block(48) for _ in range(4)]


def _file_npy(m, tmp):
    path = str(tmp / "cap.npy")
    np.save(path, np.exp(1j * np.linspace(0, 3, 64)).astype(np.complex64))
    src = m.filesource.FileSource(path, "npy", loop=True)
    return [src.next_block(40) for _ in range(3)]


def _file_legacy(m, tmp, fmt, header):
    path = str(tmp / f"cap.{fmt}")
    vals = np.array([1 << 8, -(1 << 8), 123456, -654321, 0, 255], np.int32)
    payload = b"".join(int(v & 0xFFFFFF).to_bytes(3, "little") for v in vals)
    with open(path, "wb") as f:
        f.write(b"\xab" * header + payload)
    src = m.filesource.FileSource(path, fmt, loop=True)
    return [src.next_block(2) for _ in range(4)]


def _wav(m, tmp, stereo):
    path = str(tmp / f"{m.filesource.__name__}.wav")
    a = np.linspace(-40000, 40000, 480)
    with m.filesource.WavSink(path, 48000, stereo) as w:
        w.write(a + 1j * a[::-1] if stereo else a)
        w.write(a[:100] * 0.3 + (1j * a[:100] if stereo else 0))
    return open(path, "rb").read()


@pytest.mark.parametrize("case,extra", [
    (_file_int16, ()), (_file_cf32_loop, ()), (_file_npy, ()),
    (_file_legacy, ("sv", 0x7E)), (_file_legacy, ("perseus", 0x7A)),
    (_wav, (False,)), (_wav, (True,))],
    ids=["int16", "cf32_loop", "npy", "sv", "perseus", "wav", "wav_stereo"])
def test_filesource_matches_jax(case, extra, tmp_path):
    """FileSource round trips and the legacy capture formats, WavSink (the
    file's bytes)."""
    _both(case, tmp_path, *extra)


# -------------------------------------------------------------- recorder --

def _tone(n, f=0.01, amp=10000.0):
    return (amp * np.exp(2j * np.pi * f * np.arange(n))).astype(np.complex64)


def _no_datetime(meta):
    meta = json.loads(json.dumps(meta))
    meta["global"].pop("core:datetime", None)
    for c in meta["captures"]:
        c.pop("core:datetime", None)
    return meta


def _sigmf(m, tmp, fmt, channels):
    base = str(tmp / f"{m.recorder.__name__}_{fmt}")
    iq = _tone(5000)
    if channels == 2:
        iq = np.stack([iq, (0.5j * iq).astype(np.complex64)])
    with m.recorder.SigMFWriter(base, fmt, sample_rate=2e6, center_freq=10e6,
                                num_channels=channels,
                                description="test") as w:
        w.write(iq[..., :3000])
        w.write(iq[..., 3000:])
        w.annotate(100, 50, label="burst")
    meta = json.load(open(base + ".sigmf-meta"))
    src, meta2 = m.recorder.open_sigmf(base + ".sigmf-meta")
    return (open(base + ".sigmf-data", "rb").read(), _no_datetime(meta),
            _no_datetime(meta2), src.next_block(4096), src.next_block(4096))


def _sigmf_metadata(m, tmp):
    return _no_datetime(m.recorder.sigmf_metadata(
        "cf32", 1e6, 7.1e6, extra_global={"core:author": "x"}))


class _ListWriter:
    def __init__(self):
        self.chunks, self.closed = [], False

    def write(self, iq):
        self.chunks.append(np.asarray(iq).copy())

    def close(self):
        self.closed = True


def _ring(m, tmp):
    ring = m.recorder.RingRecorder(capacity=1000)
    stream = np.arange(9000).astype(np.complex64)
    for i in range(0, 5000, 256):
        ring.push(stream[i:i + 256])
    w = _ListWriter()
    pre = ring.trigger(w, post=1500)
    states = []
    for i in range(5000, 9000, 256):
        ring.push(stream[i:i + 256])
        states.append(ring.recording)
    ring.close()
    return pre, ring.trigger_index, states, w.closed, np.concatenate(w.chunks)


@pytest.mark.parametrize("case,extra", [
    (_sigmf, ("int16", 1)), (_sigmf, ("cf32", 1)), (_sigmf, ("cf32", 2)),
    (_sigmf_metadata, ()), (_ring, ())],
    ids=["sigmf_int16", "sigmf_cf32", "sigmf_dual", "metadata", "ring"])
def test_recorder_matches_jax(case, extra, tmp_path):
    """SigMF data files byte for byte, the metadata (its datetime aside)
    and open_sigmf's playback; the ring recorder's pre-trigger history,
    post-trigger capture and close."""
    _both(case, tmp_path, *extra)


# ------------------------------------------------------------ generators --

def _gen_blocks(m, **kw):
    g = m.generators.SignalGenerator(m.generators.GenConfig(**kw))
    out = [g.next_block(1000), g.next_block(777, complex_out=False)]
    g.reset()
    return out + [g.next_block(500)]


@pytest.mark.parametrize("case", [
    lambda m: _gen_blocks(m, sample_rate=250e3, sweep_start_hz=10e3,
                          sweep_stop_hz=60e3, sweep_rate_hz_per_sec=20e3,
                          signal_power_db=-20.0, noise_power_db=-90.0),
    lambda m: _gen_blocks(m, sample_rate=2e6, sweep_start_hz=101e3,
                          sweep_stop_hz=101e3, signal_power_db=-20.0),
    lambda m: _gen_blocks(m, sample_rate=2e6, sweep_start_hz=5e3,
                          sweep_stop_hz=5e3, pulse_width_sec=1e-4,
                          pulse_period_sec=4e-4, noise_power_db=-60.0),
    lambda m: m.generators.tone(1000, 1234.5, 48e3, -6.0)],
    ids=["sweep", "tone", "pulsed_noise", "tone_fn"])
def test_generators_match_jax(case):
    """SignalGenerator blocks (sweep, fixed tone, pulses with noise,
    reset) and ``tone``, bitwise."""
    _both(case)


# ---------------------------------------------------- rate tables, sink ---

class _FakeStream:
    def __init__(self, **kw):
        self.kw = kw

    def start(self):
        pass

    def stop(self):
        pass

    def close(self):
        pass


class _FakeSd:
    OutputStream = _FakeStream

    @staticmethod
    def query_devices():
        return [{"name": "a", "max_output_channels": 2},
                {"name": "mic", "max_output_channels": 0}]


def _rates(m):
    rt = m.netsdr.RadioType
    return ({t.value: m.netsdr.RATE_TABLES[t] for t in rt},
            [(t.value, i, m.netsdr.gain_cal_offset(t, i))
             for t in rt for i in range(4)])


def _sound_card(m):
    q = m.audio_sink.RateLockedQueue()
    q.put_block(np.arange(-3000, 9000, 3, dtype=np.int16))
    sink = m.audio_device.SoundCardSink(q, 48000, _backend=_FakeSd)
    out = np.zeros((512, 1), np.float32)
    sink._callback(out, 512, None, None)
    return out, sink._stream.kw["samplerate"], sink._stream.kw["channels"]


@pytest.mark.parametrize("case", [_rates, _sound_card],
                         ids=lambda c: c.__name__)
def test_radio_tables_and_sink_match_jax(case):
    """RATE_TABLES and gain_cal_offset of every radio and bandwidth index;
    the sound-card sink's callback drain through a fake backend."""
    _both(case)


def test_list_devices_without_backend():
    """Without the optional sounddevice package the port lists no output
    devices, as the JAX package does."""
    assert t_audio_device.list_devices() == j_audio_device.list_devices()
    if not t_audio_device.available():
        assert t_audio_device.list_devices() == []


# ---------------------------------------------------------- native ingest --

def _free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_native_ingest_builds_into_build_dir():
    """The port's ingest library is compiled from native/ingest.cpp into
    build/native/<key>/ for this machine, and that is the file loaded."""
    import os

    from cutesdr_tpu_torch.io import native_ingest

    lib = native_ingest.build()
    assert lib.parent.parent == native_ingest.BUILD_ROOT
    assert lib.parent.name == native_ingest.build_key()
    assert str(native_ingest.BUILD_ROOT).startswith(
        str(native_ingest.ROOT / "build"))
    assert os.path.exists(lib)
    assert native_ingest._load()._name == str(lib)


@pytest.mark.parametrize("planes", [False, True])
def test_native_ingest_loopback(planes):
    """16-bit packets over loopback come out of ``read`` (complex64) or
    ``read_planes`` (float32 planes) with the packets' values; the stats
    count the packets; a drained ring times out."""
    from cutesdr_tpu_torch.io.native_ingest import NativeIngest

    port = _free_udp_port()
    with NativeIngest(port, ring_log2=16) as ing, \
            socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        for seq in range(1, 5):
            sock.sendto(_pkt16(seq), ("127.0.0.1", port))
        want = t_netsdr.decode_iq_packet(_pkt16(1))[1]
        if planes:
            re, im = ing.read_planes(4 * 256, timeout_ms=3000)
            assert re.dtype == im.dtype == np.float32
            got = (re + 1j * im).astype(np.complex64)
            assert ing.read_planes(256, timeout_ms=50) is None
        else:
            got = ing.read(4 * 256, timeout_ms=3000)
            assert got.dtype == np.complex64
            assert ing.read(256, timeout_ms=50) is None
        for row in got.reshape(4, 256):
            np.testing.assert_array_equal(row, want)
        stats = ing.stats()
        assert stats["packets"] == 4
        assert stats["missed_packets"] in (0, 1)   # sequence started at 1
        assert stats["dropped_samples"] == 0
