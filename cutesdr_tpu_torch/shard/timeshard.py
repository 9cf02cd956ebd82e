"""Time sharding of one wideband stream over the "t" axis of a mesh (port
of ``cutesdr_tpu/shard/timeshard.py``, its raw-halo mixdec branch).

One superblock of n_dev * S input samples is split so shard i owns the
samples [i*S, (i+1)*S).  Every front-end stage has a bounded history, so
the split is exact:

* the noise blanker (when on) runs ``noiseblanker.process_with_history``
  over [left neighbour's last ``history_len`` raw samples | shard];
* the mix + decimate kernel (K1, ``kernels.mixdec.process_planes``) takes
  the left neighbour's raw tail as its carry, with the phase base
  (nco_base + i*S*inc) mod 2^32: the oscillator has a closed form;
* the channel filter (K2, ``kernels.fastfir.filter_frames``) runs over
  [left neighbour's last NFIR-1 decimated samples | shard].

Shard 0's halos come from the carry (``TimeShardCarry``); the new carry is
the last shard's tails.  The filtered shards are gathered in order and the
decimated-rate tail (``pipeline.receiver.back_end``: S-meter, AGC, demod,
resampler) runs once on the first device of the axis (the JAX package
runs it replicated on every device, with the same result).

The front end is written against an exchange of three methods:
``ring_tail(tails)`` gives each shard its left neighbour's tail,
``last_tail(tails)`` the last shard's tail as the next carry, and
``gather(ys)`` the whole stream on the home device.  ``LocalExchange``
does it by device copies between the shards of this process;
``shard.multihost.DistributedExchange`` over ``torch.distributed``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cutesdr_tpu_torch.kernels import fastfir as fastfir_k
from cutesdr_tpu_torch.kernels import mixdec
from cutesdr_tpu_torch.ops import nco, noiseblanker
from cutesdr_tpu_torch.pipeline import receiver as rx
from cutesdr_tpu_torch.shard.mesh import Mesh
from cutesdr_tpu_torch.types import CDTYPE, RDTYPE, resolve_device


class TimeShardCarry(NamedTuple):
    """The sharded front end's carries, on the home device."""
    nco_base: torch.Tensor    # int64 0-dim: uint32 DDS phase at the
                              # superblock's start
    in_tail: torch.Tensor     # [raw_tail_length] complex64 raw input
    dec_tail: torch.Tensor    # [NFIR-1] complex64 decimated samples
    nb_tail: torch.Tensor | None   # [history_len] raw input, blanker on


def tree_to(tree, device):
    """A NamedTuple of tensors (nested) with every tensor on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple):
        return type(tree)(*(tree_to(t, device) for t in tree))
    return tree


class LocalExchange:
    """The shards of this process, one per entry of ``devices`` (entries
    may repeat): halos and the gathered stream move by device copies."""

    first = 0                 # global index of the first local shard

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.home = self.devices[0]

    def ring_tail(self, tails: list) -> list:
        """Each shard's left neighbour's tail on its device; None for the
        stream's first shard, whose halo is the carry."""
        return [None] + [t.to(d) for t, d in zip(tails[:-1],
                                                 self.devices[1:])]

    def last_tail(self, tails: list) -> torch.Tensor:
        return tails[-1].to(self.home, copy=True)

    def gather(self, ys: list) -> torch.Tensor:
        return torch.cat([y.to(self.home) for y in ys], -1)


def _halos(ex, tails: list, carry_tail: torch.Tensor) -> list:
    halos = ex.ring_tail(tails)
    if ex.first == 0:
        halos[0] = carry_tail
    return halos


def front_end_sharded(cfg: rx.ReceiverConfig, ex, params: list,
                      carry: TimeShardCarry, shards: list, probes=None):
    """The front end of this process's shards.  ``shards``: one (re, im)
    pair of float32 planes per device of ``ex.devices``; ``params``: the
    receiver's params on each of them.  Returns the whole filtered
    stream on ``ex.home`` and the carry of the next superblock (its
    ``nco_base`` not yet advanced).  With a probes dict the p7 (blanker),
    p1 (decimated) and p2 (filtered) taps are gathered whole."""
    S = shards[0][0].shape[-1]
    need = max(carry.in_tail.shape[-1],
               0 if carry.nb_tail is None else carry.nb_tail.shape[-1])
    if S < need:
        raise ValueError(f"shards of {S} samples are shorter than the "
                         f"{need}-sample halo")
    nb_tail = carry.nb_tail
    if cfg.nb_on:
        nb = rx._nb_cfg(cfg)
        h = nb_tail.shape[-1]
        xs = [torch.complex(re, im) for re, im in shards]
        tails = [x[S - h:] for x in xs]
        blanked = [noiseblanker.process_with_history(
            nb, torch.cat([halo, x], -1), S)
            for halo, x in zip(_halos(ex, tails, nb_tail), xs)]
        nb_tail = ex.last_tail(tails)
        shards = [(y.real, y.imag) for y in blanked]
        if probes is not None:
            probes["p7_blanker"] = ex.gather(blanked)

    h = carry.in_tail.shape[-1]
    tails = [torch.complex(re[S - h:], im[S - h:]) for re, im in shards]
    ys = []
    for i, ((re, im), halo, p) in enumerate(zip(
            shards, _halos(ex, tails, carry.in_tail), params)):
        offset = ((ex.first + i) * S * p.dec.phase_inc) & nco.MASK
        base = (carry.nco_base.to(re.device) + offset) & nco.MASK
        _, y = mixdec.process_planes(cfg.plan, p.dec,
                                     mixdec.MixDecCarry(halo, base), re, im,
                                     p.dc_offset)
        ys.append(y)
    in_tail = ex.last_tail(tails)
    if probes is not None:
        probes["p1_downconvert"] = ex.gather(ys)

    t = carry.dec_tail.shape[-1]
    tails = [y[y.shape[-1] - t:] for y in ys]
    filt = [fastfir_k.filter_frames(p.chan_filter.h_freq,
                                    torch.cat([halo, y], -1), t + 1)
            for y, halo, p in zip(ys, _halos(ex, tails, carry.dec_tail),
                                  params)]
    dec_tail = ex.last_tail(tails)
    y_all = ex.gather(filt)
    if probes is not None:
        probes["p2_fastfir"] = y_all
    return y_all, TimeShardCarry(carry.nco_base, in_tail, dec_tail, nb_tail)


class ShardedReceiver:
    """One stream time-sharded over the ``axis`` of ``mesh``: each step
    takes a superblock of n_dev * cfg.block_size samples and gives the
    single receiver's audio and meters over it (within the AGC's and the
    resampler's rounding: the back end runs once over the superblock).
    A mesh that spans ranks (``shard.multihost.global_time_mesh``)
    exchanges its halos over ``torch.distributed``; every rank then
    holds the whole output."""

    def __init__(self, cfg: rx.ReceiverConfig, mesh: Mesh, axis: str = "t"):
        self.cfg, self.mesh, self.axis = cfg, mesh, axis
        devices = mesh.axis_devices(axis)
        ranks = mesh.axis_ranks(axis)
        self.n_dev = len(devices)
        if ranks is None:
            self.exchange = LocalExchange(devices)
        else:
            from cutesdr_tpu_torch.shard.multihost import DistributedExchange
            self.exchange = DistributedExchange(devices, ranks)
        self.device = resolve_device(self.exchange.home)
        for d in set(self.exchange.devices):
            resolve_device(d)
        self.params, self.state = rx.init(cfg, self.device)
        nb_tail = None
        if cfg.nb_on:
            nb_tail = torch.zeros(noiseblanker.history_len(rx._nb_cfg(cfg)),
                                  dtype=CDTYPE, device=self.device)
        self.ts_carry = TimeShardCarry(
            nco_base=self.state.dec.phase, in_tail=self.state.dec.raw_tail,
            dec_tail=self.state.chan_filter.tail, nb_tail=nb_tail)

    @property
    def params(self) -> rx.ReceiverParams:
        return self._params

    @params.setter
    def params(self, params: rx.ReceiverParams) -> None:
        """Assigning the params also places them once on each device of
        the axis, so a step copies no params."""
        self._params = params
        placed = {}
        for d in self.exchange.devices:
            if d not in placed:
                placed[d] = tree_to(params, d)
        self._shard_params = [placed[d] for d in self.exchange.devices]

    @property
    def superblock_size(self) -> int:
        return self.n_dev * self.cfg.block_size

    def _local_slices(self, n: int) -> list[slice]:
        if n != self.superblock_size:
            raise ValueError(f"expected a superblock of {self.superblock_size}"
                             f" samples, got {n}")
        S = self.cfg.block_size
        return [slice((self.exchange.first + i) * S,
                      (self.exchange.first + i + 1) * S)
                for i in range(len(self.exchange.devices))]

    def process(self, iq) -> rx.StepOutput:
        """One superblock of complex samples (host or any device), or the
        list of this process's shards (``HostShardedStream.assemble``)."""
        devs = self.exchange.devices
        if isinstance(iq, (list, tuple)):
            xs = [torch.as_tensor(x).to(d, CDTYPE) for x, d in zip(iq, devs)]
        else:
            iq = torch.as_tensor(iq)
            xs = [iq[s].to(d, CDTYPE)
                  for s, d in zip(self._local_slices(iq.shape[-1]), devs)]
        return self._step([(x.real, x.imag) for x in xs])

    def process_planes(self, re, im) -> rx.StepOutput:
        """One superblock as float32 or int16 planes (int16 is cast on the
        device, exactly)."""
        re, im = torch.as_tensor(re), torch.as_tensor(im)
        planes = []
        for s, d in zip(self._local_slices(re.shape[-1]),
                        self.exchange.devices):
            planes.append((re[s].to(d).to(RDTYPE), im[s].to(d).to(RDTYPE)))
        return self._step(planes)

    def _step(self, planes: list) -> rx.StepOutput:
        cfg = self.cfg
        probes = {} if cfg.probes else None
        y_all, carry = front_end_sharded(cfg, self.exchange,
                                         self._shard_params,
                                         self.ts_carry, planes, probes)
        sm_c, agc_c, dm_c, rs_c, out = rx.back_end(cfg, self.params,
                                                   self.state, y_all, probes)
        self.ts_carry = carry._replace(nco_base=nco.advance(
            carry.nco_base, self.params.dec.phase_inc, self.superblock_size))
        self.state = self.state._replace(smeter=sm_c, agc=agc_c, demod=dm_c,
                                         resamp=rs_c)
        return out

    def host_stream(self):
        """The per-process ingest assembler: each rank contributes only the
        shards it owns (``shard.multihost.HostShardedStream``)."""
        from cutesdr_tpu_torch.shard.multihost import HostShardedStream
        return HostShardedStream(self.mesh, self.cfg.block_size)
