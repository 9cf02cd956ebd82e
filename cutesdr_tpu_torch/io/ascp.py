"""ASCP (Amateur Station Control Protocol) wire codec — byte-identical with
the RFSPACE control protocol.

Reference analogue: interface/ascpmsg.h (builder/parser over a byte union)
and interface/protocoldefs.h (control-item space).  Wire format: 16-bit
little-endian header = 13-bit total length | 3-bit type, then an optional
16-bit control-item code, then little-endian parameters.

The port's own copy of ``cutesdr_tpu/io/ascp.py`` (numpy and the standard
library); a test holds its code equal to the JAX package's.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

LENGTH_MASK = 0x1FFF

# message types (host->target)
TYPE_HOST_SET_CITEM = 0 << 5
TYPE_HOST_REQ_CITEM = 1 << 5
TYPE_HOST_REQ_CITEM_RANGE = 2 << 5
TYPE_HOST_DATA_ITEM0 = 4 << 5
TYPE_HOST_DATA_ITEM1 = 5 << 5
TYPE_HOST_DATA_ITEM2 = 6 << 5
TYPE_HOST_DATA_ITEM3 = 7 << 5
# message types (target->host)
TYPE_TARG_RESP_CITEM = 0 << 5
TYPE_TARG_UNSOLICITED_CITEM = 1 << 5
TYPE_TARG_RESP_CITEM_RANGE = 2 << 5
TYPE_TARG_DATA_ITEM0 = 4 << 5
TYPE_TARG_DATA_ITEM1 = 5 << 5
TYPE_TARG_DATA_ITEM2 = 6 << 5
TYPE_TARG_DATA_ITEM3 = 7 << 5
TYPE_DATA_ITEM_ACK = 3 << 5

MAX_MSG_LENGTH = 8192 + 2


class ci:
    """Control-item codes and their parameter constants."""
    GENERAL_INTERFACE_NAME = 0x0001
    GENERAL_INTERFACE_SERIALNUM = 0x0002
    GENERAL_INTERFACE_VERSION = 0x0003
    GENERAL_HARDFIRM_VERSION = 0x0004
    GENERAL_STATUS_CODE = 0x0005
    GENERAL_PRODUCT_ID = 0x0009
    GENERAL_OPTIONS = 0x000A
    GENERAL_SECURITY_CODE = 0x000B
    RX_STATE = 0x0018
    RX_CHAN_SETUP = 0x0019
    RX_FREQUENCY = 0x0020
    RX_NCOPHASE = 0x0022
    RX_ADCGAIN = 0x0023
    RX_RF_GAIN = 0x0038
    RX_IF_GAIN = 0x0040
    RX_RF_FILTER = 0x0044
    RX_AF_GAIN = 0x0048
    RX_AD_MODES = 0x008A
    RX_IN_SAMPLE_RATE = 0x00B0
    RX_SYNCIN_MODE_PARAMETERS = 0x00B4
    RX_PULSEOUT_MODE = 0x00B6
    RX_OUT_SAMPLE_RATE = 0x00B8
    RX_OUTPUT_PARAMS = 0x00C4
    RX_UDP_OUTPUT_PARAMS = 0x00C5
    RX_CALIBRATION_DATA = 0x00D0
    TX_DA_MODE = 0x012A
    TX_CW_MSG = 0x0150
    UPDATE_MODE_CONTROL = 0x0300
    UPDATE_MODE_PARAMS = 0x0302

    # status codes
    STATUS_IDLE = 0x0B
    STATUS_BUSY = 0x0C
    STATUS_ADOVERLOAD = 0x20
    STATUS_BOOTIDLE = 0x0E
    STATUS_BOOTBUSY = 0x0F
    STATUS_BOOTERROR = 0x80
    # RX_STATE parameters
    RX_STATE_DATACOMPLEX = 0x80
    RX_STATE_DATAREAL = 0x00
    RX_STATE_COMPLEX_HF = 0x81      # SDR-IQ/14
    RX_STATE_IDLE = 0x01
    RX_STATE_ON = 0x02
    MODE_CONTIGUOUS24 = 0x80
    MODE_CONTIGUOUS16 = 0x00
    MODE_CONTINUOUS24 = 0x81
    MODE_CONTINUOUS16 = 0x01
    MODE_HWSYNC24 = 0x83
    MODE_HWSYNC16 = 0x03
    # channels
    RX_CHAN_1 = 0
    RX_CHAN_2 = 2
    RX_CHAN_ALL = 0xFF
    # channel setup modes
    CHAN_SETUP_SINGLE_1 = 0
    CHAN_SETUP_SINGLE_2 = 1
    CHAN_SETUP_SINGLE_SUM = 2
    CHAN_SETUP_SINGLE_DIF = 3
    CHAN_SETUP_DUAL_AD1 = 4
    CHAN_SETUP_DUAL_AD2 = 5
    CHAN_SETUP_DUAL_AD12 = 6
    # RF filter select
    RF_FILTER_AUTO = 0
    RF_FILTER_BYPASS = 11
    RF_FILTER_NOPASS = 12
    # A/D modes
    AD_MODES_DITHER = 0x01
    AD_MODES_PGA = 0x02
    # sync-in / pulse-out
    SYNCIN_MODE_OFF = 0
    PULSEOUT_MODE_OFF = 0
    # frequency channel parameter
    RX_FREQUENCY_NCO = 0
    RX_FREQUENCY_DISPLAY = 1


@dataclass
class AscpMessage:
    """Builder/parser for one ASCP message."""
    msg_type: int = TYPE_HOST_SET_CITEM
    body: bytearray = field(default_factory=bytearray)
    _read_pos: int = 0

    # ---- building ----
    def add_citem(self, item: int) -> "AscpMessage":
        self.body += struct.pack("<H", item)
        return self

    def add_u8(self, v: int) -> "AscpMessage":
        self.body += struct.pack("<B", v & 0xFF)
        return self

    def add_u16(self, v: int) -> "AscpMessage":
        self.body += struct.pack("<H", v & 0xFFFF)
        return self

    def add_u32(self, v: int) -> "AscpMessage":
        self.body += struct.pack("<I", v & 0xFFFFFFFF)
        return self

    def add_u40(self, v: int) -> "AscpMessage":
        """5-byte little-endian value (frequency fields are 5 bytes)."""
        self.body += struct.pack("<IB", v & 0xFFFFFFFF, (v >> 32) & 0xFF)
        return self

    def to_bytes(self) -> bytes:
        total = 2 + len(self.body)
        if total > MAX_MSG_LENGTH:
            raise ValueError(f"message too long: {total}")
        hdr = (total & LENGTH_MASK) | (self.msg_type << 8)
        return struct.pack("<H", hdr) + bytes(self.body)

    # ---- parsing ----
    @classmethod
    def from_bytes(cls, raw: bytes) -> "AscpMessage":
        hdr, = struct.unpack_from("<H", raw, 0)
        return cls(msg_type=(hdr >> 8) & 0xE0, body=bytearray(raw[2:]))

    @property
    def length(self) -> int:
        return 2 + len(self.body)

    def citem(self) -> int:
        v, = struct.unpack_from("<H", self.body, 0)
        return v

    def rewind(self, after_citem: bool = True) -> "AscpMessage":
        self._read_pos = 2 if after_citem else 0
        return self

    def get_u8(self) -> int:
        v, = struct.unpack_from("<B", self.body, self._read_pos)
        self._read_pos += 1
        return v

    def get_u16(self) -> int:
        v, = struct.unpack_from("<H", self.body, self._read_pos)
        self._read_pos += 2
        return v

    def get_u32(self) -> int:
        v, = struct.unpack_from("<I", self.body, self._read_pos)
        self._read_pos += 4
        return v

    def get_cstring(self) -> str:
        end = self.body.index(0, self._read_pos)
        s = self.body[self._read_pos:end].decode("ascii", "replace")
        self._read_pos = end + 1
        return s


def set_item(item: int, *fields) -> bytes:
    """Convenience: build a SET control-item message.  fields are
    (kind, value) pairs with kind in {'u8','u16','u32'}."""
    m = AscpMessage(TYPE_HOST_SET_CITEM).add_citem(item)
    for kind, v in fields:
        getattr(m, f"add_{kind}")(v)
    return m.to_bytes()


def req_item(item: int, *fields) -> bytes:
    m = AscpMessage(TYPE_HOST_REQ_CITEM).add_citem(item)
    for kind, v in fields:
        getattr(m, f"add_{kind}")(v)
    return m.to_bytes()


def req_item_range(item: int, *fields) -> bytes:
    m = AscpMessage(TYPE_HOST_REQ_CITEM_RANGE).add_citem(item)
    for kind, v in fields:
        getattr(m, f"add_{kind}")(v)
    return m.to_bytes()


class StreamAssembler:
    """Reassemble ASCP messages from a TCP byte stream.

    Reference analogue: the 3-state assembler in CTcpThread::AssembleAscpMsg
    (interface/netiobase.cpp:386-425), including the length==0 → 8194-byte
    special case for full-size data messages.
    """

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes):
        """Yield complete AscpMessage objects."""
        self._buf += data
        out = []
        while len(self._buf) >= 2:
            hdr, = struct.unpack_from("<H", self._buf, 0)
            length = hdr & LENGTH_MASK
            if length == 0:
                length = 8192 + 2
            if length < 2:
                # malformed: resync by dropping one byte
                del self._buf[0]
                continue
            if len(self._buf) < length:
                break
            out.append(AscpMessage.from_bytes(bytes(self._buf[:length])))
            del self._buf[:length]
        return out
