"""RFSPACE radio client: TCP control plane + UDP data plane.

Reference analogue: CSdrInterface + CNetIOBase (interface/sdrinterface.cpp,
interface/netiobase.cpp): the device personality layer (per-radio
sample-rate/bandwidth tables, ASCP response parsing, start/stop command
sequences, RF-gain dB calibration, frequency-range clamping, keepalive
watchdog, NCO-spur DC auto-cal) and the network transport (TCP reconnect
state machine, ASCP stream assembly, UDP int24/int16 datagram decoding with
sequence-gap accounting).

Redesigned as asyncio host code feeding blocks to the receiver; the hot
UDP decode is vectorized NumPy (or the native C++ ring-buffer ingest in
``io.native_ingest`` for multi-MSPS rates).

The port's own copy of ``cutesdr_tpu/io/netsdr.py`` (numpy and the
standard library); a test holds its code equal to the JAX package's.
"""

from __future__ import annotations

import asyncio
import contextlib
import enum
from dataclasses import dataclass
from typing import Callable

import numpy as np

from cutesdr_tpu_torch.io import ascp
from cutesdr_tpu_torch.io.ascp import AscpMessage, StreamAssembler, ci
from cutesdr_tpu_torch.io.ad6620 import SDRIQ_BW_PROFILES, Ad6620Loader

PKT_LENGTH_24 = 1444      # 240 cpx samples of 24-bit I/Q + 4-byte header
PKT_LENGTH_16 = 1028      # 342 cpx samples of 16-bit I/Q + 4-byte header
SPUR_CAL_MAXSAMPLES = 300000


class RadioType(enum.Enum):
    SDR14 = "SDR-14"
    SDRIQ = "SDR-IQ"
    SDRIP = "SDR-IP"
    NETSDR = "NetSDR"


class Status(enum.Enum):
    NOT_CONNECTED = 0
    CONNECTING = 1
    CONNECTED = 2
    RUNNING = 3
    ERROR = 4
    ADOVR = 5


# per-radio sample-rate and usable-bandwidth tables, indexed by the GUI
# bandwidth index 0..3 (interface/sdrinterface.cpp:51-114)
RATE_TABLES: dict[RadioType, tuple[tuple[float, int], ...]] = {
    RadioType.SDRIQ: tuple(
        (66666666.6667 / d, bw) for d, bw in
        ((1200, 50000), (600, 100000), (420, 150000), (340, 190000))),
    RadioType.SDR14: tuple(
        (66666666.6667 / d, bw) for d, bw in
        ((1200, 50000), (600, 100000), (420, 150000), (340, 190000))),
    RadioType.NETSDR: tuple(
        (80.0e6 / d, bw) for d, bw in
        ((1280, 50000), (320, 200000), (128, 500000), (40, 1600000))),
    RadioType.SDRIP: tuple(
        (80.0e6 / d, bw) for d, bw in
        ((1280, 50000), (320, 200000), (130, 500000), (40, 1800000))),
}

# RF-gain dB calibration offsets toward absolute dBm at the antenna
# (interface/sdrinterface.cpp:628-642)
GAIN_CAL = {RadioType.SDRIP: -10.0, RadioType.NETSDR: -12.0}
SDRIQ_6620FILTERGAIN = (0.0, 8.0, 11.0, 22.0)


def gain_cal_offset(radio_type: RadioType, bandwidth_index: int) -> float:
    """Per-radio display-dB calibration (~dBm at the antenna connector,
    interface/sdrinterface.cpp:627-646)."""
    if radio_type in (RadioType.SDR14, RadioType.SDRIQ):
        return -49.0 + SDRIQ_6620FILTERGAIN[bandwidth_index]
    return GAIN_CAL[radio_type]


def decode_iq_packet(data: bytes) -> tuple[int, np.ndarray] | None:
    """Decode one UDP data packet -> (sequence_number, complex64 samples).

    24-bit payload scaled to the ±32k range (/256, i.e. (raw<<8)/65536 like
    interface/netiobase.cpp:497-527); 16-bit used as-is.
    """
    size = len(data)
    seq = int.from_bytes(data[2:4], "little")
    if size == PKT_LENGTH_24:
        b = np.frombuffer(data, np.uint8, count=size - 4, offset=4)
        b = b.reshape(-1, 3).astype(np.int32)
        v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        v = np.where(v & 0x800000, v - (1 << 24), v).astype(np.float32) / 256.0
        iq = v[0::2] + 1j * v[1::2]
    elif size == PKT_LENGTH_16:
        v = np.frombuffer(data, "<i2", count=(size - 4) // 2, offset=4)
        v = v.astype(np.float32)
        iq = v[0::2] + 1j * v[1::2]
    else:
        return None
    return seq, iq.astype(np.complex64)


def decode_iq_packet_dual(data: bytes):
    """Decode a dual-channel data packet -> (seq, iq_ch1, iq_ch2).

    In the NetSDR dual-channel modes (CI_RX_CHAN_SETUP_DUAL_*) the payload
    interleaves the two receivers' complex samples: I1 Q1 I2 Q2 ...  (The
    reference defines the protocol constants but never demodulates the
    second channel; this framework runs twin chains — shard/channels.py
    StackedReceiver.)"""
    decoded = decode_iq_packet(data)
    if decoded is None:
        return None
    seq, iq = decoded
    return seq, iq[0::2], iq[1::2]


class SequenceTracker:
    """Missed-UDP-packet accounting (interface/netiobase.cpp:488-496)."""

    def __init__(self):
        self._last = 0
        self.missed = 0

    def update(self, seq: int) -> None:
        if seq == 0:
            self._last = 0
        if seq != self._last:
            self.missed += np.int16(seq) - np.int16(self._last)
            self._last = seq
        self._last = (self._last + 1) & 0xFFFF
        if self._last == 0:
            self._last = 1


class _UdpProtocol(asyncio.DatagramProtocol):
    def __init__(self, client: "SdrClient"):
        self.client = client

    def datagram_received(self, data, addr):
        self.client._on_udp(data)


@dataclass
class SdrClient:
    """Asyncio radio client.  Set ``on_iq`` to receive sample blocks."""
    host: str = "127.0.0.1"
    port: int = 50000
    on_iq: Callable[[np.ndarray], None] | None = None
    # dual-channel modes (CHAN_SETUP_DUAL_*): called with (iq_ch1, iq_ch2)
    # per packet instead of on_iq.  The reference defines these modes
    # (interface/protocoldefs.h:143-152) but never demodulates channel 2;
    # here both streams feed twin chains / MRC diversity (shard/coherent.py)
    on_iq_dual: Callable[[np.ndarray, np.ndarray], None] | None = None
    on_status: Callable[[Status], None] | None = None

    radio_type: RadioType = RadioType.NETSDR
    bandwidth_index: int = 3
    rf_gain: int = 0
    channel_mode: int = ci.CHAN_SETUP_SINGLE_1
    status: Status = Status.NOT_CONNECTED

    device_name: str = ""
    serial: str = ""
    boot_rev: float = 0.0
    app_rev: float = 0.0
    base_freq_min: int = 0
    base_freq_max: int = 30_000_000
    option_freq_min: int = 0
    option_freq_max: int = 30_000_000
    current_frequency: int = 0
    missed_packets: int = 0
    # latched on an unsolicited A/D-overload status; consumer clears it
    # (the reference shows a timed red status, gui/mainwindow.cpp:776-782)
    ad_overload: bool = False

    def __post_init__(self):
        self._assembler = StreamAssembler()
        self._seq = SequenceTracker()
        self._writer: asyncio.StreamWriter | None = None
        self._udp_transport = None
        self._keepalive_counter = 0
        self._ad6620: Ad6620Loader | None = None
        self._running = False
        self._want_running = False      # user intent; survives reconnects
        self._closed = False
        self._reconnect_delay = 2.0
        self._link_lost: asyncio.Event | None = None
        self.reconnects = 0             # completed recoveries (metrics)
        self._tasks: list[asyncio.Task] = []
        # NCO spur cal state (interface/sdrinterface.cpp:791-848)
        self._spur_i = 0.0
        self._spur_q = 0.0
        self._spur_count = 0
        self._spur_active = False

    # ------------------------------------------------------ connection ----
    async def connect(self, reconnect_delay: float = 2.0,
                      keepalive_period: float = 1.0) -> None:
        """Establish the link and start the supervisor.  Returns once the
        first connection is up; afterwards a dead link (TCP EOF, connect
        refusal, or 2 missed keepalive acks) tears the stream down and
        re-enters the reference's backoff connect loop, resuming the stream
        on reconnect (interface/netiobase.cpp:301-377,309-328)."""
        self._reconnect_delay = reconnect_delay
        self._keepalive_period = keepalive_period
        self._closed = False
        ready = asyncio.Event()
        self._tasks.append(asyncio.create_task(self._link_supervisor(ready)))
        await ready.wait()

    async def close(self) -> None:
        self._closed = True
        for t in self._tasks:
            t.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await t
        self._tasks.clear()
        await self._teardown_link()
        self._set_status(Status.NOT_CONNECTED)

    async def _teardown_link(self) -> None:
        if self._writer is not None:
            self._writer.close()
            with contextlib.suppress(Exception):
                await self._writer.wait_closed()
            self._writer = None
        if self._udp_transport is not None:
            self._udp_transport.close()
            self._udp_transport = None
        self._running = False

    async def _link_supervisor(self, ready: asyncio.Event) -> None:
        """Connect → monitor → teardown → backoff → reconnect, forever."""
        first = True
        while not self._closed:
            self._set_status(Status.CONNECTING)
            try:
                reader, self._writer = await asyncio.open_connection(
                    self.host, self.port)
            except OSError:
                await asyncio.sleep(self._reconnect_delay)
                continue
            loop = asyncio.get_running_loop()
            self._udp_transport, _ = await loop.create_datagram_endpoint(
                lambda: _UdpProtocol(self),
                local_addr=("0.0.0.0", self.port))
            self._assembler = StreamAssembler()
            self._keepalive_counter = 0
            self._link_lost = asyncio.Event()
            children = [asyncio.create_task(self._tcp_reader(reader)),
                        asyncio.create_task(self._keepalive_loop())]
            self._set_status(Status.CONNECTED)
            self.request_info()
            if not first and self._want_running:
                self.reconnects += 1
                self.start()           # resume the stream after recovery
            first = False
            ready.set()
            try:
                await self._link_lost.wait()
            finally:
                for t in children:
                    t.cancel()
                    with contextlib.suppress(asyncio.CancelledError):
                        await t
                await self._teardown_link()
            self._set_status(Status.ERROR)
            await asyncio.sleep(self._reconnect_delay)

    def _set_status(self, s: Status) -> None:
        self.status = s
        if self.on_status:
            self.on_status(s)

    def _send(self, raw: bytes) -> None:
        if self._writer is not None:
            self._writer.write(raw)

    def _mark_link_lost(self) -> None:
        if self._link_lost is not None:
            self._link_lost.set()

    async def _tcp_reader(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                data = await reader.read(4096)
                if not data:
                    break
                for msg in self._assembler.feed(data):
                    self._parse_message(msg)
        except OSError:
            pass
        self._mark_link_lost()

    async def _keepalive_loop(self) -> None:
        """1 Hz status request; after 2 missed acks the link is declared
        dead (interface/sdrinterface.cpp:692-703) and the supervisor tears
        the stream down and re-enters the connect loop."""
        while True:
            await asyncio.sleep(self._keepalive_period)
            self._send(ascp.req_item(ci.GENERAL_STATUS_CODE))
            self._keepalive_counter += 1
            if self._keepalive_counter > 2:
                self._mark_link_lost()
                return

    # ----------------------------------------------------- control plane --
    @property
    def sample_rate(self) -> float:
        return RATE_TABLES[self.radio_type][self.bandwidth_index][0]

    @property
    def max_bandwidth(self) -> int:
        return RATE_TABLES[self.radio_type][self.bandwidth_index][1]

    @property
    def gain_calibration_offset(self) -> float:
        return gain_cal_offset(self.radio_type, self.bandwidth_index)

    def request_info(self) -> None:
        """Handshake burst (interface/sdrinterface.cpp:440-467)."""
        self._send(ascp.req_item(ci.GENERAL_INTERFACE_NAME))
        self._send(ascp.req_item(ci.GENERAL_INTERFACE_SERIALNUM))
        self._send(ascp.req_item(ci.GENERAL_HARDFIRM_VERSION, ("u8", 0)))
        self._send(ascp.req_item(ci.GENERAL_HARDFIRM_VERSION, ("u8", 1)))
        if self.radio_type in (RadioType.SDRIP, RadioType.NETSDR):
            self._send(ascp.req_item_range(ci.RX_FREQUENCY,
                                           ("u8", ci.RX_CHAN_1)))

    def set_bandwidth_index(self, index: int) -> None:
        self.bandwidth_index = index
        if self.radio_type in (RadioType.SDR14, RadioType.SDRIQ):
            self._ad6620 = Ad6620Loader(SDRIQ_BW_PROFILES[index])
            nxt = self._ad6620.next_message()
            if nxt:
                self._send(nxt)

    def start(self) -> None:
        """Per-radio start sequence (interface/sdrinterface.cpp:510-597)."""
        chan = (ci.RX_CHAN_ALL if self.channel_mode in
                (ci.CHAN_SETUP_SINGLE_SUM, ci.CHAN_SETUP_SINGLE_DIF)
                else (ci.RX_CHAN_2 if self.channel_mode ==
                      ci.CHAN_SETUP_SINGLE_2 else ci.RX_CHAN_1))
        if self.radio_type in (RadioType.SDRIP, RadioType.NETSDR):
            self._send(ascp.set_item(ci.RX_CHAN_SETUP,
                                     ("u8", self.channel_mode)))
            self._send(ascp.set_item(ci.RX_RF_FILTER, ("u8", chan),
                                     ("u8", ci.RF_FILTER_AUTO)))
            self._send(ascp.set_item(ci.RX_AD_MODES, ("u8", chan),
                                     ("u8", ci.AD_MODES_DITHER | ci.AD_MODES_PGA)))
            self._send(ascp.set_item(ci.RX_SYNCIN_MODE_PARAMETERS,
                                     ("u8", 0), ("u8", ci.SYNCIN_MODE_OFF)))
            self._send(ascp.set_item(ci.RX_PULSEOUT_MODE,
                                     ("u8", 0), ("u8", ci.PULSEOUT_MODE_OFF)))
            self._send(ascp.set_item(ci.RX_OUT_SAMPLE_RATE, ("u8", 0),
                                     ("u32", int(self.sample_rate))))
            mode = (ci.MODE_CONTIGUOUS24 if self.sample_rate < 1_500_000.0
                    else ci.MODE_CONTIGUOUS16)
            self._send(ascp.set_item(ci.RX_STATE,
                                     ("u8", ci.RX_STATE_DATACOMPLEX),
                                     ("u8", ci.RX_STATE_ON),
                                     ("u8", mode), ("u8", 0)))
            self._spur_active = False
        else:   # SDR-IQ / SDR-14
            self._send(ascp.set_item(ci.RX_IF_GAIN, ("u8", 0), ("u32", 24)))
            self._send(ascp.set_item(ci.RX_STATE,
                                     ("u8", ci.RX_STATE_COMPLEX_HF),
                                     ("u8", ci.RX_STATE_ON),
                                     ("u8", ci.MODE_CONTIGUOUS16), ("u8", 0)))
            self._start_spur_cal()
        self.set_rf_gain(self.rf_gain)
        self._keepalive_counter = 0
        self._running = True
        self._want_running = True
        self._set_status(Status.RUNNING)

    def stop(self) -> None:
        self._running = False
        self._want_running = False
        self._send(ascp.set_item(ci.RX_STATE,
                                 ("u8", ci.RX_STATE_DATACOMPLEX),
                                 ("u8", ci.RX_STATE_IDLE),
                                 ("u8", 0), ("u8", 0)))

    def set_rx2_parameters(self, rx2_gain: float, rx2_phase_deg: float) -> None:
        """Dual-channel amplitude/phase balance: channel-1 A/D gain scaled
        by rx2_gain (16-bit fraction of 0x7FFF) and channel-2 NCO phase
        offset as a 32-bit fraction of 360 degrees
        (interface/sdrinterface.cpp:400-435)."""
        gain = int(rx2_gain * 32767.0) & 0xFFFF
        phase = int((rx2_phase_deg / 360.0) * 4294967295.0) & 0xFFFFFFFF
        self._send(ascp.set_item(ci.RX_ADCGAIN, ("u8", ci.RX_CHAN_2),
                                 ("u16", 0x7FFF)))
        self._send(ascp.set_item(ci.RX_ADCGAIN, ("u8", ci.RX_CHAN_1),
                                 ("u16", gain)))
        self._send(ascp.set_item(ci.RX_NCOPHASE, ("u8", ci.RX_CHAN_1),
                                 ("u32", 0)))
        self._send(ascp.set_item(ci.RX_NCOPHASE, ("u8", ci.RX_CHAN_2),
                                 ("u32", phase)))

    def set_rf_gain(self, gain_db: int) -> None:
        self.rf_gain = gain_db
        self._send(ascp.set_item(ci.RX_RF_GAIN, ("u8", ci.RX_CHAN_1),
                                 ("u8", gain_db)))

    def set_frequency(self, freq_hz: int) -> int:
        """Clamped to base/option (downconverter) ranges with the
        invalid-gap jump rule (interface/sdrinterface.cpp:652-687)."""
        freq = min(freq_hz, self.option_freq_max)
        if self.base_freq_max < freq < self.option_freq_min:
            freq = (self.option_freq_min if freq > self.current_frequency
                    else self.base_freq_max)
        self.current_frequency = freq
        self._send(ascp.set_item(ci.RX_FREQUENCY, ("u8", ci.RX_CHAN_1),
                                 ("u32", freq), ("u8", 0)))
        if self.radio_type == RadioType.SDRIP:
            self._send(ascp.set_item(ci.RX_FREQUENCY,
                                     ("u8", ci.RX_FREQUENCY_DISPLAY),
                                     ("u32", freq), ("u8", 0)))
        return freq

    # --------------------------------------------------- response parser --
    def _parse_message(self, msg: AscpMessage) -> None:
        t = msg.msg_type
        if t == ascp.TYPE_TARG_RESP_CITEM and len(msg.body) >= 2:
            item = msg.citem()
            msg.rewind()
            if item == ci.GENERAL_INTERFACE_NAME:
                self.device_name = msg.get_cstring()
                by_name = {r.value: r for r in RadioType}
                self.radio_type = by_name.get(self.device_name,
                                              self.radio_type)
            elif item == ci.GENERAL_INTERFACE_SERIALNUM:
                self.serial = msg.get_cstring()
            elif item == ci.GENERAL_HARDFIRM_VERSION:
                which = msg.get_u8()
                rev = msg.get_u16() / 100.0
                if which == 0:
                    self.boot_rev = rev
                else:
                    self.app_rev = rev
            elif item == ci.GENERAL_STATUS_CODE:
                self._keepalive_counter = 0
            elif item == ci.RX_STATE:
                msg.get_u8()
                if msg.get_u8() == ci.RX_STATE_ON:
                    self._running = True
                    self._set_status(Status.RUNNING)
                else:
                    self._running = False
                    self._set_status(Status.CONNECTED)
        elif t == ascp.TYPE_TARG_RESP_CITEM_RANGE and len(msg.body) >= 2:
            if msg.citem() == ci.RX_FREQUENCY:
                msg.rewind()
                msg.get_u8()
                self.base_freq_min = msg.get_u32()
                msg.get_u8()
                self.base_freq_max = msg.get_u32()
                msg.get_u8()
                self.option_freq_min = self.base_freq_min
                self.option_freq_max = self.base_freq_max
                if msg.length > 15:
                    self.option_freq_min = msg.get_u32()
                    msg.get_u8()
                    self.option_freq_max = msg.get_u32()
        elif t == ascp.TYPE_TARG_UNSOLICITED_CITEM and len(msg.body) >= 2:
            if msg.citem() == ci.GENERAL_STATUS_CODE:
                msg.rewind()
                if msg.get_u8() == ci.STATUS_ADOVERLOAD:
                    self.ad_overload = True
                    self._set_status(Status.ADOVR)
        elif t == ascp.TYPE_DATA_ITEM_ACK and len(msg.body) >= 1:
            which = msg.body[0]
            if which == 1 and self._ad6620 is not None:
                nxt = self._ad6620.next_message()
                if nxt:
                    self._send(nxt)
                else:
                    self._ad6620 = None

    # ------------------------------------------------------- data plane ---
    def _on_udp(self, data: bytes) -> None:
        if self.channel_mode in (ci.CHAN_SETUP_DUAL_AD1,
                                 ci.CHAN_SETUP_DUAL_AD2,
                                 ci.CHAN_SETUP_DUAL_AD12):
            decoded = decode_iq_packet_dual(data)
            if decoded is None or not self._running:
                return
            seq, iq1, iq2 = decoded
            self._seq.update(seq)
            self.missed_packets = int(self._seq.missed)
            if self.on_iq_dual is not None:
                self.on_iq_dual(iq1, iq2)
            return
        decoded = decode_iq_packet(data)
        if decoded is None or not self._running:
            return
        seq, iq = decoded
        self._seq.update(seq)
        self.missed_packets = int(self._seq.missed)
        if self._spur_active:
            self._spur_calibrate(iq)
        if self.on_iq is not None:
            self.on_iq(iq)

    # ---------------------------------------------------- NCO spur cal ----
    def _start_spur_cal(self) -> None:
        if abs(self._spur_i) > 10.0:
            self._spur_i = 0.0
        if abs(self._spur_q) > 10.0:
            self._spur_q = 0.0
        self._spur_count = 0
        self._spur_active = True

    def _spur_calibrate(self, iq: np.ndarray) -> None:
        """Exponential DC average over ~300k samples; the learned I/Q
        offsets feed Receiver.set_dc_offset (the pipeline subtracts them,
        interface/sdrinterface.cpp:826-848, 891-894)."""
        if self._spur_count < SPUR_CAL_MAXSAMPLES:
            a = 1.0 / 100000.0
            # block-exponential update equivalent to the per-sample loop
            w = (1.0 - a) ** np.arange(len(iq), 0, -1)
            self._spur_i = (self._spur_i * (1.0 - a) ** len(iq)
                            + a * float(np.sum(w * np.real(iq)) / (1.0 - a)))
            self._spur_q = (self._spur_q * (1.0 - a) ** len(iq)
                            + a * float(np.sum(w * np.imag(iq)) / (1.0 - a)))
            self._spur_count += len(iq) // 2
        else:
            self._spur_active = False

    @property
    def spur_offsets(self) -> tuple[float, float]:
        return self._spur_i, self._spur_q
