"""Device meshes (port of ``cutesdr_tpu/shard/mesh.py``).

A ``Mesh`` is a 2-D grid of ``torch.device`` with the axes ("t", "ch"):
"t" holds the time shards of one wideband stream (``shard.timeshard``),
"ch" independent channel banks (``shard.channels``).  Entries may repeat:
``make_mesh(time=4, devices=["cuda:0"] * 4)`` runs four shards on one
card, and ``["cpu"] * 8`` is the CPU's counterpart of eight devices.

A mesh that spans the ranks of a ``torch.distributed`` group
(``shard.multihost.global_time_mesh``) also holds each entry's rank;
a mesh without ranks lives in this process.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cutesdr_tpu_torch.types import resolve_device

AXES = ("t", "ch")


@dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray               # [time, channels] of torch.device
    ranks: np.ndarray | None = None   # the rank owning each entry, or None

    axis_names = AXES

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.devices.shape))

    @staticmethod
    def _line(grid: np.ndarray, axis: str) -> np.ndarray:
        """The entries along ``axis`` (the first entry of the other);
        raises ValueError on an axis that is not one of ``AXES``."""
        return grid[:, 0] if AXES.index(axis) == 0 else grid[0, :]

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` (the first entry of the other)."""
        return list(self._line(self.devices, axis))

    def axis_ranks(self, axis: str) -> list[int] | None:
        """The rank owning each entry along ``axis``; None without ranks."""
        line = self._line(self.devices if self.ranks is None else self.ranks,
                          axis)
        return None if self.ranks is None else [int(r) for r in line]


def cuda_devices() -> list[torch.device]:
    """Every CUDA device of this process; raises without one."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(time: int = 1, channels: int = 1, devices=None) -> Mesh:
    """A ("t", "ch") mesh of time x channels entries over ``devices``
    (default: every CUDA device; without one it raises, it never picks
    the CPU).  A mesh that needs more devices than it was given raises."""
    devices = (cuda_devices() if devices is None
               else [torch.device(d) for d in devices])
    need = time * channels
    if need > len(devices):
        raise ValueError(f"mesh {time}x{channels} needs {need} devices, "
                         f"have {len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(time, channels))
