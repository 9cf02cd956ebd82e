"""SSB and CW demodulation (dsp/ssbdemod.cpp:48-60): the audio is the
real part of the levelled rows, the channel filter having kept one
sideband (and, in CW, the mixer having put the tone at the
configuration's offset)."""

from __future__ import annotations

import torch

from sdrbench.reference.stage import Part as _Part

STAGE = "demod"
MODES = ("usb", "lsb", "cwu", "cwl")


def takes(rx: dict) -> bool:
    return rx.get("mode") in MODES and not rx.get("stereo", False)


class Part(_Part):

    def __call__(self, leveled: torch.Tensor) -> torch.Tensor:
        """The audio [C, n] of the levelled [C, 2, n] rows."""
        return leveled[:, 0]
