"""UDP broadcast device discovery for RFSPACE radios.

Reference analogue: gui/sdrdiscoverdlg.{h,cpp}: a 0x5AA5-keyed request
broadcast to port 48321 (responses on 48322), with packed little-endian
response structs (common 56-byte header plus device-specific custom fields).
Wire format is byte-identical; this is a headless utility instead of a
dialog.

The port's own copy of ``cutesdr_tpu/io/discover.py`` (numpy and the
standard library); a test holds its code equal to the JAX package's.
"""

from __future__ import annotations

import socket
import struct
import time
from dataclasses import dataclass

DISCOVER_SERVER_PORT = 48321   # device listens here
DISCOVER_CLIENT_PORT = 48322   # responses arrive here
KEY0, KEY1 = 0x5A, 0xA5
OP_REQUEST = 0
OP_RESPONSE = 1
OP_SET = 2

# 56-byte fixed common header: length, key, op, name[16], sn[16],
# ipaddr[16], port, customfield
_COMMON = struct.Struct("<HBBB16s16s16sHB")
# note: the key is two bytes (0x5A, 0xA5); struct above splits length(2),
# key0, key1, op


@dataclass
class DiscoveredDevice:
    name: str
    serial: str
    ip: str
    port: int
    status_connected: bool = False
    status_running: bool = False
    raw: bytes = b""


def _build_request(name_filter: str = "") -> bytes:
    name = name_filter.encode("ascii")[:15].ljust(16, b"\0")
    msg = _COMMON.pack(56, KEY0, KEY1, OP_REQUEST, name, b"\0" * 16,
                       b"\0" * 16, 0, 0)
    return msg


def parse_response(data: bytes) -> DiscoveredDevice | None:
    if len(data) < 56:
        return None
    length, k0, k1, op, name, sn, ipaddr, port, custom = \
        _COMMON.unpack_from(data, 0)
    if (k0, k1) != (KEY0, KEY1) or op != OP_RESPONSE:
        return None
    # ipaddr: little-endian byte order, IPv4 in first 4 bytes
    ip = ".".join(str(b) for b in ipaddr[3::-1])
    dev = DiscoveredDevice(
        name=name.split(b"\0")[0].decode("ascii", "replace"),
        serial=sn.split(b"\0")[0].decode("ascii", "replace"),
        ip=ip, port=port, raw=data)
    # status byte position differs per device type; NetSDR keeps it at
    # offset 56+6+2+2+2+1+1+1+1+4+4+4+2+1 = 87
    if len(data) >= 88:
        status = data[87]
        dev.status_connected = bool(status & 1)
        dev.status_running = bool(status & 2)
    return dev


def discover(timeout: float = 0.5, name_filter: str = "",
             bind_ip: str = "") -> list[DiscoveredDevice]:
    """Broadcast a discovery request and collect responses."""
    req = _build_request(name_filter)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((bind_ip, DISCOVER_CLIENT_PORT))
        s.sendto(req, ("255.255.255.255", DISCOVER_SERVER_PORT))
        s.settimeout(timeout)
        found: dict[str, DiscoveredDevice] = {}
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            try:
                data, _ = s.recvfrom(2048)
            except socket.timeout:
                break
            dev = parse_response(data)
            if dev is not None:
                found[dev.serial or dev.ip] = dev
        return list(found.values())
