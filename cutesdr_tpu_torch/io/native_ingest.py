"""ctypes binding for the native C++ UDP ingest (``native/ingest.cpp``).

The port's counterpart of ``cutesdr_tpu/io/native_ingest.py``: the same
``NativeIngest`` class (a test holds its code equal to the JAX
package's), with its own build.  The library is compiled at first use,
never at import, from ``native/ingest.cpp`` with the flags of
``native/Makefile`` into ``<repo>/build/native/<key>/`` (``build/`` is
listed in ``.gitignore``), and only that file is loaded.  The key hashes
the source, the flags and the target that ``-march=native`` resolves to
on this machine, so a library that another machine built is never
loaded.  The native path matters at multi-MSPS rates where per-packet
Python work cannot keep up (BASELINE config 5: 20 MSPS).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "ingest.cpp"
BUILD_ROOT = ROOT / "build" / "native"
LIB_NAME = "libcutesdr_ingest.so"
CXX = "g++"
# native/Makefile's CXXFLAGS and link flags
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-Wextra", "-shared", "-pthread"]

_lock = threading.Lock()
_lib = None


def build_key() -> str:
    """Hash of the source, the flags and the compiler's resolved native
    target (``-Q --help=target``: the -march it picks and the ISA flags it
    turns on here)."""
    target = subprocess.run(
        [CXX, "-march=native", "-Q", "--help=target"], check=True,
        capture_output=True, text=True).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(target.encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library for this machine unless its key is built."""
    out_dir = BUILD_ROOT / build_key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True)
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.ingest_create.restype = ctypes.c_void_p
        lib.ingest_create.argtypes = [ctypes.c_uint16, ctypes.c_int]
        lib.ingest_read.restype = ctypes.c_int64
        lib.ingest_read.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_int64, ctypes.c_int]
        lib.ingest_read_planes.restype = ctypes.c_int64
        lib.ingest_read_planes.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_float),
                                           ctypes.POINTER(ctypes.c_float),
                                           ctypes.c_int64, ctypes.c_int]
        lib.ingest_available.restype = ctypes.c_int64
        lib.ingest_available.argtypes = [ctypes.c_void_p]
        lib.ingest_stats.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int64),
                                     ctypes.POINTER(ctypes.c_uint64),
                                     ctypes.POINTER(ctypes.c_uint64)]
        lib.ingest_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeIngest:
    """UDP IQ receiver backed by the C++ ring buffer."""

    def __init__(self, port: int, ring_log2: int = 22):
        lib = _load()
        self._lib = lib
        self._h = lib.ingest_create(port, ring_log2)
        if not self._h:
            raise RuntimeError(f"ingest_create failed on port {port}")

    def read(self, n: int, timeout_ms: int = 1000) -> np.ndarray | None:
        """Blocking read of exactly n complex64 samples (None on timeout)."""
        buf = np.empty(2 * n, np.float32)
        got = self._lib.ingest_read(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, timeout_ms)
        if got == 0:
            return None
        return buf.view(np.complex64)

    def read_planes(self, n: int, timeout_ms: int = 1000):
        """Blocking read of n samples as separate (re, im) float32 planes
        (None on timeout) — deinterleaved in the native copy-out; feeds
        ReceiverSession.pump_planes without a host conversion pass."""
        re = np.empty(n, np.float32)
        im = np.empty(n, np.float32)
        got = self._lib.ingest_read_planes(
            self._h, re.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            im.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, timeout_ms)
        if got == 0:
            return None
        return re, im

    @property
    def available(self) -> int:
        return int(self._lib.ingest_available(self._h))

    def stats(self) -> dict:
        missed = ctypes.c_int64()
        packets = ctypes.c_uint64()
        dropped = ctypes.c_uint64()
        self._lib.ingest_stats(self._h, ctypes.byref(missed),
                               ctypes.byref(packets), ctypes.byref(dropped))
        return {"missed_packets": missed.value, "packets": packets.value,
                "dropped_samples": dropped.value}

    def close(self) -> None:
        if self._h:
            self._lib.ingest_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
