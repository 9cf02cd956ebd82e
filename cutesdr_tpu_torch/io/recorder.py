"""IQ capture recording: SigMF metadata and a pre-trigger ring recorder.

Reference analogue: CuteSDR has no recorder — the closest is the testbench's
raw-capture file *playback* (gui/testbench.cpp:367-395) and the `#if 0`
FileTest reader (interface/netiobase.cpp:536-625).  Recording is the missing
half of that workflow, so the new framework provides it first-class:

* ``SigMFWriter`` — records to a SigMF recording pair
  (``<name>.sigmf-data`` + ``<name>.sigmf-meta``), the open standard for
  annotated IQ captures, so captures interoperate with other SDR tools.
* ``RingRecorder`` — a bounded pre-trigger ring: continuously remembers the
  last N seconds of IQ so that when an event fires (squelch opens, S-meter
  spike, operator key-press) the capture *includes the signal's onset*.

The port's own copy of ``cutesdr_tpu/io/recorder.py`` (numpy and the
standard library); a test holds its code equal to the JAX package's.
"""

from __future__ import annotations

import datetime
import json
from collections import deque

import numpy as np

# SigMF core:datatype strings for the formats RawIQWriter understands.
_SIGMF_DTYPE = {"int16": "ci16_le", "cf32": "cf32_le"}


def _utc_now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


def sigmf_metadata(fmt: str, sample_rate: float, center_freq: float = 0.0,
                   description: str = "", datetime_iso: str | None = None,
                   extra_global: dict | None = None) -> dict:
    """Build a SigMF v1 metadata dict for a single-capture recording."""
    meta = {
        "global": {
            "core:datatype": _SIGMF_DTYPE[fmt],
            "core:sample_rate": float(sample_rate),
            "core:version": "1.0.0",
            "core:recorder": "cutesdr-tpu",
            "core:description": description,
        },
        "captures": [{
            "core:sample_start": 0,
            "core:frequency": float(center_freq),
            "core:datetime": datetime_iso or _utc_now(),
        }],
        "annotations": [],
    }
    if extra_global:
        meta["global"].update(extra_global)
    return meta


class SigMFWriter:
    """Stream IQ to ``<base>.sigmf-data`` with a ``<base>.sigmf-meta``
    sidecar written on close.

    fmt 'int16' stores interleaved little-endian I,Q int16 (ci16_le) —
    byte-compatible with the reference's 16-bit UDP payload samples;
    'cf32' stores interleaved float32 (cf32_le).
    """

    def __init__(self, base_path: str, fmt: str = "int16",
                 sample_rate: float = 2e6, center_freq: float = 0.0,
                 description: str = "", num_channels: int = 1):
        if fmt not in _SIGMF_DTYPE:
            raise ValueError(f"unsupported SigMF format {fmt!r}")
        base = base_path
        for suffix in (".sigmf-data", ".sigmf-meta", ".sigmf"):
            if base.endswith(suffix):
                base = base[:-len(suffix)]
        self.base = base
        self.fmt = fmt
        self.sample_rate = sample_rate
        self.center_freq = center_freq
        self.description = description
        self.num_channels = int(num_channels)
        self.samples = 0
        self._annotations: list[dict] = []
        self._start_iso = _utc_now()
        self._fh = open(base + ".sigmf-data", "wb")

    @property
    def data_path(self) -> str:
        return self.base + ".sigmf-data"

    @property
    def meta_path(self) -> str:
        return self.base + ".sigmf-meta"

    def write(self, iq: np.ndarray) -> None:
        """Append samples: [n] complex, or [num_channels, n] stacks for
        multichannel captures (channel-interleaved per the SigMF
        convention)."""
        iq = np.asarray(iq)
        n_frames = iq.shape[-1]
        if iq.ndim == 2:
            if iq.shape[0] != self.num_channels:
                raise ValueError(f"stack has {iq.shape[0]} channels, "
                                 f"writer configured for {self.num_channels}")
            iq = iq.T.reshape(-1)          # s0ch0, s0ch1, s1ch0, ...
        if self.fmt == "int16":
            a = np.empty((len(iq), 2), "<i2")
            a[:, 0] = np.clip(np.real(iq), -32767, 32767)
            a[:, 1] = np.clip(np.imag(iq), -32767, 32767)
        else:
            a = np.empty((len(iq), 2), "<f4")
            a[:, 0], a[:, 1] = np.real(iq), np.imag(iq)
        self._fh.write(a.tobytes())
        self.samples += n_frames

    def annotate(self, sample_start: int, sample_count: int,
                 label: str = "", **fields) -> None:
        """Add a SigMF annotation (e.g. 'squelch open' span)."""
        ann = {"core:sample_start": int(sample_start),
               "core:sample_count": int(sample_count)}
        if label:
            ann["core:label"] = label
        ann.update(fields)
        self._annotations.append(ann)

    def close(self) -> None:
        self._fh.close()
        meta = sigmf_metadata(self.fmt, self.sample_rate, self.center_freq,
                              self.description, self._start_iso)
        if self.num_channels > 1:
            meta["global"]["core:num_channels"] = self.num_channels
        meta["annotations"] = list(self._annotations)
        with open(self.meta_path, "w") as f:
            json.dump(meta, f, indent=2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


SigMFWriter._annotations = []


class RingRecorder:
    """Pre-trigger capture ring.

    Continuously ``push()`` IQ blocks; the ring keeps the most recent
    ``capacity`` samples.  On ``trigger()`` the buffered history is flushed
    to a writer and subsequent pushes stream through until ``post`` more
    samples have been written, then the recording closes itself.

    This reproduces what a hardware spectrum analyzer's trigger capture
    does; the reference's testbench trigger (gui/testbench.cpp:819-898)
    only ever captured *display* data — here it is the raw stream.
    """

    def __init__(self, capacity: int, make_writer=None):
        """make_writer(trigger_index) -> object with write()/close();
        defaults must be supplied at trigger() time otherwise."""
        self.capacity = int(capacity)
        self._blocks: deque[np.ndarray] = deque()
        self._held = 0          # samples currently in the ring
        self.total = 0          # samples ever pushed (global stream index)
        self._writer = None
        self._post_remaining = 0
        self._make_writer = make_writer
        self.trigger_index: int | None = None

    @property
    def recording(self) -> bool:
        return self._writer is not None

    def push(self, iq: np.ndarray) -> None:
        iq = np.asarray(iq)
        self.total += len(iq)
        if self._writer is not None:
            n = min(len(iq), self._post_remaining)
            self._writer.write(iq[:n])
            self._post_remaining -= n
            if self._post_remaining <= 0:
                self._writer.close()
                self._writer = None
            return
        self._blocks.append(iq)
        self._held += len(iq)
        while self._blocks and self._held - len(self._blocks[0]) >= self.capacity:
            self._held -= len(self._blocks.popleft())

    def trigger(self, writer=None, post: int = 0) -> int:
        """Flush the pre-trigger history into ``writer`` and keep recording
        the next ``post`` samples.  Returns the number of pre-trigger
        samples written."""
        if self.recording:
            raise RuntimeError("already recording")
        if writer is None:
            writer = self._make_writer(self.total)
        pre = 0
        for blk in self._blocks:
            # only the last `capacity` samples count as history
            pre += len(blk)
        # trim the oldest partial block so history is exactly <= capacity
        skip = max(0, pre - self.capacity)
        first = True
        for blk in self._blocks:
            if first and skip:
                blk = blk[skip:]
                first = False
            writer.write(blk)
        pre -= skip
        self._blocks.clear()
        self._held = 0
        self.trigger_index = self.total
        if post > 0:
            self._writer = writer
            self._post_remaining = post
        else:
            writer.close()
        return pre

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def open_sigmf(path: str, loop: bool = False):
    """Open a SigMF recording for playback.  Accepts the base name or
    either file of the pair.  Returns (FileSource, metadata dict)."""
    from cutesdr_tpu_torch.io.filesource import FileSource

    base = path
    for suffix in (".sigmf-data", ".sigmf-meta", ".sigmf"):
        if base.endswith(suffix):
            base = base[:-len(suffix)]
    with open(base + ".sigmf-meta") as f:
        meta = json.load(f)
    dtype = meta["global"]["core:datatype"]
    fmt = {v: k for k, v in _SIGMF_DTYPE.items()}.get(dtype)
    if fmt is None:
        raise ValueError(f"unsupported SigMF datatype {dtype!r}")
    nch = int(meta["global"].get("core:num_channels", 1))
    return FileSource(base + ".sigmf-data", fmt, loop, channels=nch), meta
