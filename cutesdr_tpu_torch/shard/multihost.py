"""Time sharding across processes (port of
``cutesdr_tpu/shard/multihost.py``) over ``torch.distributed``.

* ``initialize`` joins the process group: NCCL on the card, gloo only
  where the caller asks for the CPU.
* ``global_time_mesh`` orders every rank's local devices into one "t"
  axis, each rank owning a contiguous run of shards.
* ``HostShardedStream`` cuts this rank's slice of a superblock into its
  shards, so no process ever holds the whole stream (a 20 MSPS stream
  split at the ingest, BASELINE config 5).
* ``DistributedExchange`` is the time-sharded front end's exchange across
  ranks: the halo across a rank boundary by ``batch_isend_irecv``, the
  last shard's tails broadcast from the last rank, the filtered stream
  by ``all_gather``; inside a rank, device copies.  Complex tensors go
  over the wire as ``view_as_real`` float32 pairs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cutesdr_tpu_torch.shard.mesh import Mesh, cuda_devices
from cutesdr_tpu_torch.shard.timeshard import LocalExchange
from cutesdr_tpu_torch.types import CDTYPE, RDTYPE, resolve_device


def initialize(coordinator: str, num_processes: int, process_id: int,
               device="cuda") -> None:
    """Join the process group at ``coordinator`` ("host:port" or a
    "tcp://" address): NCCL for the card, gloo for ``device="cpu"``."""
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def global_time_mesh(local_devices=None) -> Mesh:
    """A ("t", "ch") mesh of every rank's devices along "t" (one column),
    rank by rank: each rank owns a contiguous run of shards.  A rank's
    local devices default to its CUDA devices; every rank must bring as
    many."""
    local = (cuda_devices() if local_devices is None
             else [torch.device(d) for d in local_devices])
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, [str(d) for d in local])
    if len({len(p) for p in per_rank}) != 1:
        raise ValueError(f"ranks bring different device counts: {per_rank}")
    devices = np.empty(sum(map(len, per_rank)), dtype=object)
    devices[:] = [torch.device(d) for p in per_rank for d in p]
    ranks = np.array([r for r, p in enumerate(per_rank) for _ in p])
    return Mesh(devices.reshape(-1, 1), ranks.reshape(-1, 1))


def _wire(t: torch.Tensor, device) -> torch.Tensor:
    """A complex tensor as contiguous float32 pairs on ``device``."""
    return torch.view_as_real(t.to(device).contiguous())


class DistributedExchange:
    """The front end's exchange over the ranks of a mesh (``devices`` and
    ``ranks`` along its "t" axis); this rank runs the shards it owns."""

    def __init__(self, devices: list, ranks: list[int]):
        rank = dist.get_rank()
        mine = [g for g, r in enumerate(ranks) if r == rank]
        if not mine or mine != list(range(mine[0], mine[-1] + 1)):
            raise ValueError(f"rank {rank} must own a contiguous run of "
                             f"shards, has {mine}")
        self.first = mine[0]
        self.local = LocalExchange([devices[g] for g in mine])
        self.devices, self.home = self.local.devices, self.local.home
        self.prev = ranks[mine[0] - 1] if mine[0] > 0 else None
        self.next = ranks[mine[-1] + 1] if mine[-1] + 1 < len(ranks) else None
        self.last_rank = ranks[-1]

    def ring_tail(self, tails: list) -> list:
        halos = self.local.ring_tail(tails)
        ops, buf = [], None
        if self.next is not None:
            ops.append(dist.P2POp(dist.isend, _wire(tails[-1], self.home),
                                  self.next))
        if self.prev is not None:
            buf = torch.empty(tails[0].shape + (2,), dtype=RDTYPE,
                              device=self.home)
            ops.append(dist.P2POp(dist.irecv, buf, self.prev))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if buf is not None:
            halos[0] = torch.view_as_complex(buf)
        return halos

    def last_tail(self, tails: list) -> torch.Tensor:
        t = tails[-1]
        if dist.get_rank() == self.last_rank:
            buf = _wire(t, self.home).clone()
        else:
            buf = torch.empty(t.shape + (2,), dtype=RDTYPE, device=self.home)
        dist.broadcast(buf, src=self.last_rank)
        return torch.view_as_complex(buf)

    def gather(self, ys: list) -> torch.Tensor:
        mine = _wire(self.local.gather(ys), self.home)
        parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, mine)
        return torch.view_as_complex(torch.cat(parts, 0))


class HostShardedStream:
    """This rank's part of each superblock: ``assemble(local_iq)`` cuts its
    contiguous samples into one shard per local device of the mesh, the
    input ``ShardedReceiver.process`` takes on every rank."""

    def __init__(self, mesh: Mesh, block_per_device: int):
        self.mesh, self.block_per_device = mesh, block_per_device
        rank = dist.get_rank() if mesh.ranks is not None else 0
        devs = mesh.devices.reshape(-1)
        owners = (np.zeros(len(devs), int) if mesh.ranks is None
                  else mesh.ranks.reshape(-1))
        self.local_devices = [d for d, r in zip(devs, owners) if r == rank]
        self.n_global = len(devs)

    @property
    def local_samples_per_superblock(self) -> int:
        return self.block_per_device * len(self.local_devices)

    @property
    def global_samples_per_superblock(self) -> int:
        return self.block_per_device * self.n_global

    def assemble(self, local_iq) -> list[torch.Tensor]:
        """``local_iq``: this rank's contiguous complex samples of one
        superblock (``local_samples_per_superblock``)."""
        n = self.block_per_device
        local_iq = torch.as_tensor(local_iq)
        if local_iq.shape[-1] != self.local_samples_per_superblock:
            raise ValueError(f"expected {self.local_samples_per_superblock} "
                             f"samples, got {local_iq.shape[-1]}")
        return [local_iq[i * n:(i + 1) * n].to(d, CDTYPE)
                for i, d in enumerate(self.local_devices)]
