"""File sources and sinks: raw IQ capture playback and WAV audio output.

Reference analogue: the file-playback kludges (interface/netiobase.cpp
CIQDataThread::FileTest and the testbench's SV/Perseus capture reader,
gui/testbench.cpp:367-395) — promoted here to first-class offline sources,
which is the standard way to run the framework without a radio.

The port's own copy of ``cutesdr_tpu/io/filesource.py`` (numpy and the
standard library); a test holds its code equal to the JAX package's.
"""

from __future__ import annotations

import wave
from dataclasses import dataclass

import numpy as np


@dataclass
class FileSource:
    """Streaming IQ source from a raw capture file.

    Formats:
      'int16'   — interleaved little-endian int16 I,Q
      'int24'   — interleaved little-endian int24 I,Q (scaled /65536 to the
                  ±32k range like the reference's UDP path)
      'cf32'    — interleaved float32 I,Q
      'npy'     — complex .npy array
      'sv'      — SpectraVue .dat capture: 0x7e-byte header then int24
                  interleaved I,Q (the reference testbench's USE_SVFILE
                  playback, gui/testbench.cpp:367-395: 3 bytes into the
                  high bytes of an int32, /65536 == int24/256)
      'perseus' — Perseus capture: identical payload, 0x7a-byte header
                  (USE_PERSEUSFILE, same site)

    ``channels=2`` reads channel-interleaved multichannel captures (the
    SigMF convention: per sample instant, one I/Q pair per channel) and
    yields [channels, n] stacks — dual-RX capture playback.
    """
    path: str
    fmt: str = "int16"
    loop: bool = False
    channels: int = 1

    _HEADER_BYTES = {"sv": 0x7E, "perseus": 0x7A}

    def __post_init__(self):
        if self.fmt == "npy":
            self._data = np.load(self.path).astype(np.complex64)
            self._pos = 0
        else:
            self._fh = open(self.path, "rb")
            self._header = self._HEADER_BYTES.get(self.fmt, 0)
            if self._header:
                self._fh.seek(self._header)

    def _bytes_per_sample(self) -> int:
        return {"int16": 4, "int24": 6, "cf32": 8,
                "sv": 6, "perseus": 6}[self.fmt]

    def next_block(self, n: int) -> np.ndarray | None:
        """Return exactly n complex64 samples ([channels, n] for
        multichannel captures), or None at end of stream (non-looping).
        Short final reads are zero-padded."""
        if self.channels > 1:
            flat = self._next_flat(n * self.channels)
            if flat is None:
                return None
            return flat.reshape(-1, self.channels).T.copy()
        return self._next_flat(n)

    def _next_flat(self, n: int) -> np.ndarray | None:
        if self.fmt == "npy":
            if self._pos >= len(self._data):
                if not self.loop:
                    return None
                self._pos = 0
            out = self._data[self._pos:self._pos + n]
            self._pos += len(out)
            if len(out) < n:
                out = np.pad(out, (0, n - len(out)))
            return out

        raw = self._fh.read(n * self._bytes_per_sample())
        if not raw:
            if not self.loop:
                return None
            self._fh.seek(self._header)   # reference re-seeks past header
            raw = self._fh.read(n * self._bytes_per_sample())
        if self.fmt == "int16":
            a = np.frombuffer(raw, "<i2")
            a = a.reshape(-1, 2).astype(np.float32)
            iq = a[:, 0] + 1j * a[:, 1]
        elif self.fmt == "cf32":
            a = np.frombuffer(raw, "<f4").reshape(-1, 2)
            iq = a[:, 0] + 1j * a[:, 1]
        else:  # int24 payload (raw, SV, Perseus)
            b = np.frombuffer(raw, np.uint8)
            b = b[:len(b) - len(b) % 6].reshape(-1, 6)
            def i24(lo, mid, hi):
                v = (lo.astype(np.int32) | (mid.astype(np.int32) << 8)
                     | (hi.astype(np.int32) << 16))
                return np.where(v & 0x800000, v - (1 << 24), v)
            i = i24(b[:, 0], b[:, 1], b[:, 2]).astype(np.float32)
            q = i24(b[:, 3], b[:, 4], b[:, 5]).astype(np.float32)
            # 24-bit scaled to the ±32k range: (raw24 << 8) / 65536 == /256
            iq = (i + 1j * q) / np.float32(256.0)
        iq = iq.astype(np.complex64)
        if len(iq) < n:
            iq = np.pad(iq, (0, n - len(iq)))
        return iq


class WavSink:
    """Stream demodulated audio to a 16-bit PCM WAV file."""

    def __init__(self, path: str, sample_rate: int = 48000,
                 stereo: bool = False):
        self._w = wave.open(path, "wb")
        self._w.setnchannels(2 if stereo else 1)
        self._w.setsampwidth(2)
        self._w.setframerate(int(sample_rate))
        self.stereo = stereo

    def write(self, audio: np.ndarray) -> None:
        """audio: float array (real, or complex for stereo L=re R=im),
        full-scale ±32767."""
        a = np.asarray(audio)
        if np.iscomplexobj(a):
            a = np.stack([a.real, a.imag], axis=-1)
        a = np.clip(a, -32767, 32767).astype("<i2")
        self._w.writeframes(a.tobytes())

    def close(self) -> None:
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RawIQWriter:
    """Record raw IQ to a file (int16 interleaved or npy)."""

    def __init__(self, path: str, fmt: str = "int16"):
        self.fmt = fmt
        self.path = path
        if fmt == "npy":
            self._chunks: list[np.ndarray] = []
        else:
            self._fh = open(path, "wb")

    def write(self, iq: np.ndarray) -> None:
        if self.fmt == "npy":
            self._chunks.append(np.asarray(iq, np.complex64))
        else:
            a = np.empty((len(iq), 2), "<i2")
            a[:, 0] = np.clip(np.real(iq), -32767, 32767)
            a[:, 1] = np.clip(np.imag(iq), -32767, 32767)
            self._fh.write(a.tobytes())

    def close(self) -> None:
        if self.fmt == "npy":
            np.save(self.path, np.concatenate(self._chunks)
                    if self._chunks else np.zeros(0, np.complex64))
        else:
            self._fh.close()
