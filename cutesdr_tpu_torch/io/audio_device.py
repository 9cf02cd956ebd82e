"""Sound-card consumer for the rate-locked audio queue.

Reference analogue: the QAudioOutput half of CSoundOut
(interface/soundout.cpp:86-133 start, 477-516 worker thread): the reference
pushes queue data into the OS audio device from its own thread, polling
``bytesFree`` to dodge Qt's pull-model jitter.  Here the device callback
*pulls* from ``RateLockedQueue.get`` — the queue already implements the
half-fill startup gate, under/overflow healing, and the P-controller rate
estimate, so the callback is a straight drain and the clock-tracking loop
closes exactly as in the reference (queue depth → ratio correction →
on-device resampler).

The backend is the optional ``sounddevice`` package (PortAudio).  It is not
part of the baked environment, so everything is import-gated: ``available()``
reports whether a device path exists, and construction raises a clear error
otherwise.  Tests inject a fake backend.

The port's own copy of ``cutesdr_tpu/io/audio_device.py`` (numpy and the
standard library); a test holds its code equal to the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from cutesdr_tpu_torch.io.audio_sink import RateLockedQueue


def _import_sounddevice():
    try:
        import sounddevice  # type: ignore
        return sounddevice
    except ImportError:
        return None


def available() -> bool:
    """True if the optional sounddevice backend can be imported."""
    return _import_sounddevice() is not None


def list_devices() -> list[str]:
    sd = _import_sounddevice()
    if sd is None:
        return []
    return [d["name"] for d in sd.query_devices()
            if d.get("max_output_channels", 0) > 0]


class SoundCardSink:
    """Drains a RateLockedQueue into the host sound card.

    The device callback runs on PortAudio's audio thread; ``queue.get`` is
    lock-protected and returns silence until the half-fill gate opens, so
    starting the stream before the pipeline produces audio is safe (the
    reference behaves the same way, interface/soundout.cpp:312-334).
    """

    def __init__(self, queue: RateLockedQueue, sample_rate: int = 48000,
                 device: Optional[str] = None, blocksize: int = 1024,
                 _backend=None):
        sd = _backend if _backend is not None else _import_sounddevice()
        if sd is None:
            raise RuntimeError(
                "sound-card output needs the optional 'sounddevice' package "
                "(pip install sounddevice); use the WAV sink otherwise")
        self.queue = queue
        self.channels = 2 if queue.stereo else 1
        self._stream = sd.OutputStream(
            samplerate=sample_rate, channels=self.channels, dtype="int16",
            blocksize=blocksize, device=device, callback=self._callback)
        self.frames_played = 0

    def _callback(self, outdata, frames, time_info, status) -> None:
        data = self.queue.get(frames)
        outdata[:] = data.reshape(frames, self.channels)
        self.frames_played += frames

    def start(self) -> "SoundCardSink":
        self._stream.start()
        return self

    def stop(self) -> None:
        self._stream.stop()
        self._stream.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
