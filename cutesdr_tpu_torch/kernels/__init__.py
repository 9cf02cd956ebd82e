"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version (in the same module) for CPU tensors.  ``LAUNCHES`` counts
kernel launches per wrapper — incremented only where a kernel is launched
— so a run can show that the main path went through the kernels (K1's
launches over int16 planes count under ``mixdec_int16``, the others under
``mixdec``).  A replayed CUDA graph of the receiver's step adds the
launches it captured on every replay (``pipeline/stepgraph``).

``DeviceCounts`` keeps the counts that the step decides on the device
(the AGC's sequential fallbacks, the PLL tiers): no host read inside the
step, a read only when a count is asked for.
"""

from __future__ import annotations

import contextlib
from collections.abc import MutableMapping

import torch

LAUNCHES = {"mixdec": 0, "mixdec_int16": 0, "fastfir": 0, "fastfir_batch": 0,
            "scan_plain": 0, "scan_solve": 0, "smeter": 0, "seqloop_fm": 0,
            "seqloop_sam": 0, "resamp": 0, "agcseq": 0, "hang_solve": 0,
            "biquad": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _canon(device) -> torch.device:
    """``device`` with its index (a bare "cuda" is the current device), as
    a tensor's ``device`` reads."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class DeviceCounts(MutableMapping):
    """Named counts kept where they are counted: one int32 slot a name in
    a tensor on each device that counted (the CPU's too), which the
    kernels (a device pointer) or tensor ops inside the step add to, so
    counting costs the step no host read and a CUDA graph of the step
    counts on every replay.  Reading a count sums the devices' slots (a
    read of a CUDA device waits for it, and happens only here); assigning
    a count sets it and zeroes the slots."""

    def __init__(self, *names: str):
        self._names = names
        self._set = dict.fromkeys(names, 0)      # assigned values
        self._slots: dict = {}                   # device -> int32 [names]
        self._ids: dict = {}                     # device -> arange(names)

    def slots(self, device: torch.device) -> torch.Tensor:
        """The int32 [len(names)] counters on ``device`` (made at first
        use, zero)."""
        device = _canon(device)
        t = self._slots.get(device)
        if t is None:
            t = self._slots[device] = torch.zeros(
                len(self._names), dtype=torch.int32, device=device)
            self._ids[device] = torch.arange(len(self._names),
                                             dtype=torch.int32, device=device)
        return t

    def counter(self, device: torch.device, name: str) -> torch.Tensor:
        """The 0-dim slot of ``name`` on ``device`` (a view: a kernel adds
        to it through its pointer)."""
        return self.slots(device)[self._names.index(name)]

    def add(self, index: torch.Tensor) -> None:
        """One more at the slot a 0-dim integer tensor names (by position
        in ``names``), on its device, without a host read."""
        slots = self.slots(index.device)
        slots.add_(self._ids[_canon(index.device)] == index)

    def __getitem__(self, name: str) -> int:
        i = self._names.index(name)
        return self._set[name] + sum(int(t[i]) for t in self._slots.values())

    def __setitem__(self, name: str, value: int) -> None:
        i = self._names.index(name)
        self._set[name] = int(value)
        for t in self._slots.values():
            t[i] = 0

    def __delitem__(self, name: str) -> None:
        raise TypeError("counts cannot be removed")

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def __repr__(self) -> str:
        return repr(dict(self))


@contextlib.contextmanager
def uncounted(*counts: DeviceCounts):
    """Work that is set-up, not the stream's (a CUDA graph's warm-up):
    ``LAUNCHES`` and each of ``counts`` are put back as they were (the
    counts are read, a wait for the card, and assigned)."""
    launches = dict(LAUNCHES)
    saved = [dict(c) for c in counts]
    try:
        yield
    finally:
        LAUNCHES.update(launches)
        for c, was in zip(counts, saved):
            c.update(was)
