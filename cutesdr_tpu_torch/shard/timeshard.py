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

Where every device of the axis is the same CUDA device and the mesh has
no ranks (``make_mesh(time=4, devices=["cuda:0"] * 4)``), the whole
superblock replays as one CUDA graph (``pipeline.receiver.
GraphedStepper``): each shard's K1 and K2 with its halos, the
``LocalExchange`` copies, the gather, the back end and the carry update,
as the JAX package jits its sharded step as one function.  The carry's
phase base advances by the device value of the tune's increment, which
a retune (assigning ``params``) writes in place, as the single
receiver's graph takes it.  A mesh over several cards, or over ranks
(``DistributedExchange``), runs the same step eagerly: the machine that
checks the port has one card, so nothing there could hold a cross-card
or NCCL capture to its eager step.
"""

from __future__ import annotations

import dataclasses
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
    pair of float32 or int16 planes per device of ``ex.devices``;
    ``params``: the receiver's params on each of them.  Returns the whole
    filtered stream on ``ex.home`` and the carry of the next superblock
    (its ``nco_base`` not yet advanced).  With a probes dict the p7
    (blanker), p1 (decimated) and p2 (filtered) taps are gathered whole."""
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
        xs = [torch.complex(re.to(RDTYPE), im.to(RDTYPE))
              for re, im in shards]
        tails = [x[S - h:] for x in xs]
        blanked = [noiseblanker.process_with_history(
            nb, torch.cat([halo, x], -1), S)
            for halo, x in zip(_halos(ex, tails, nb_tail), xs)]
        nb_tail = ex.last_tail(tails)
        shards = [(y.real, y.imag) for y in blanked]
        if probes is not None:
            probes["p7_blanker"] = ex.gather(blanked)

    h = carry.in_tail.shape[-1]
    tails = [torch.complex(re[S - h:].to(RDTYPE), im[S - h:].to(RDTYPE))
             for re, im in shards]
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


def sharded_step(cfg: rx.ReceiverConfig, ex, shard_params: list,
                 params: rx.ReceiverParams, carry: tuple, shards: list,
                 n_in: int) -> tuple[tuple, rx.StepOutput]:
    """One superblock of ``n_in`` samples: the sharded front end, the back
    end once on the gathered block and the carry update.  ``carry`` is
    (``TimeShardCarry``, ``ReceiverState``: the back end's carries);
    returns the next one and the ``StepOutput``."""
    ts, state = carry
    probes = {} if cfg.probes else None
    y_all, ts = front_end_sharded(cfg, ex, shard_params, ts, shards, probes)
    sm_c, agc_c, dm_c, rs_c, out = rx.back_end(cfg, params, state, y_all,
                                               probes)
    ts = ts._replace(nco_base=nco.advance(ts.nco_base, params.dec.phase_inc,
                                          n_in))
    return (ts, state._replace(smeter=sm_c, agc=agc_c, demod=dm_c,
                               resamp=rs_c)), out


class ShardedReceiver(rx.GraphedStepper):
    """One stream time-sharded over the ``axis`` of ``mesh``: each step
    takes a superblock of n_dev * cfg.block_size samples and gives the
    single receiver's audio and meters over it (within the AGC's and the
    resampler's rounding: the back end runs once over the superblock).
    A mesh that spans ranks (``shard.multihost.global_time_mesh``)
    exchanges its halos over ``torch.distributed``; every rank then
    holds the whole output.  Over shards of one card a superblock
    replays one CUDA graph (module notes).  ``state`` holds the back
    end's carries and ``ts_carry`` the front end's (copies of the graph's
    buffers where a graph holds them; assigning either loads it)."""

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
        self._one_card = (ranks is None and self.device.type == "cuda"
                          and all(d == self.device
                                  for d in self.exchange.devices))
        params, state = rx.init(cfg, self.device)
        nb_tail = None
        if cfg.nb_on:
            nb_tail = torch.zeros(noiseblanker.history_len(rx._nb_cfg(cfg)),
                                  dtype=CDTYPE, device=self.device)
        ts_carry = TimeShardCarry(
            nco_base=state.dec.phase, in_tail=state.dec.raw_tail,
            dec_tail=state.chan_filter.tail, nb_tail=nb_tail)
        self._start(params, (ts_carry, state))
        self._place(params)

    @property
    def graphed(self) -> bool:
        """Whether a superblock replays a CUDA graph: every shard on the
        same CUDA device, no ranks."""
        return self._one_card

    @property
    def params(self) -> rx.ReceiverParams:
        return self._params

    @params.setter
    def params(self, params: rx.ReceiverParams) -> None:
        """Assigning the params also places them once on each device of
        the axis, so a step copies no params (a graph takes them in
        place)."""
        rx.GraphedStepper.params.fset(self, params)
        self._place(params)

    def _place(self, params: rx.ReceiverParams) -> None:
        placed = {}
        for d in self.exchange.devices:
            if d not in placed:
                placed[d] = tree_to(params, d)
        self._shard_params = [placed[d] for d in self.exchange.devices]

    @property
    def state(self) -> rx.ReceiverState:
        return self.carry[1]

    @state.setter
    def state(self, value: rx.ReceiverState) -> None:
        self.carry = (self._live_carry()[0], value)

    @property
    def ts_carry(self) -> TimeShardCarry:
        return self.carry[0]

    @ts_carry.setter
    def ts_carry(self, value: TimeShardCarry) -> None:
        self.carry = (value, self._live_carry()[1])

    @property
    def superblock_size(self) -> int:
        return self.n_dev * self.cfg.block_size

    @property
    def _block(self) -> tuple:
        return (self.superblock_size,)

    def _route_cfg(self) -> rx.ReceiverConfig:
        """The configuration whose block is the superblock: the back end's
        resampler route is decided at its length."""
        return dataclasses.replace(
            self.cfg, frames_per_block=self.cfg.frames_per_block * self.n_dev)

    def _graph_key(self, params: rx.ReceiverParams) -> tuple:
        return rx.graph_key(self._route_cfg(), params)

    def _device_params(self, params: rx.ReceiverParams) -> rx.ReceiverParams:
        return rx.device_params(self._route_cfg(), params, self.device)

    def _step(self, cfg, params, carry, re, im):
        """The graphed step over the superblock's planes on one card."""
        S = cfg.block_size
        shards = [(re[i * S:(i + 1) * S], im[i * S:(i + 1) * S])
                  for i in range(self.n_dev)]
        return sharded_step(cfg, self.exchange, [params] * self.n_dev,
                            params, carry, shards, self.superblock_size)

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
        if self.graphed:
            if isinstance(iq, (list, tuple)):
                iq = torch.cat([torch.as_tensor(x).to(self.device, CDTYPE)
                                for x in iq])
            iq = self._to_device(iq, CDTYPE)
            self._local_slices(iq.shape[-1])
            return self._graph_step().run(iq)
        if isinstance(iq, (list, tuple)):
            xs = [torch.as_tensor(x).to(d, CDTYPE) for x, d in zip(iq, devs)]
        else:
            iq = torch.as_tensor(iq)
            xs = [iq[s].to(d, CDTYPE)
                  for s, d in zip(self._local_slices(iq.shape[-1]), devs)]
        return self._eager_shards([(x.real, x.imag) for x in xs])

    def process_planes(self, re, im) -> rx.StepOutput:
        """One superblock as float32 or int16 planes (each shard's K1 reads
        int16 planes as they are)."""
        re, im = torch.as_tensor(re), torch.as_tensor(im)
        slices = self._local_slices(re.shape[-1])
        if self.graphed:
            return self._run_planes(self._to_device(re), self._to_device(im))
        if not self._wire(re, im):
            re, im = re.to(RDTYPE), im.to(RDTYPE)
        return self._eager_shards([(re[s].to(d), im[s].to(d))
                                   for s, d in zip(slices,
                                                   self.exchange.devices)])

    def _eager_shards(self, planes: list) -> rx.StepOutput:
        self._state, out = sharded_step(self.cfg, self.exchange,
                                        self._shard_params, self._params,
                                        self._state, planes,
                                        self.superblock_size)
        return out

    def host_stream(self):
        """The per-process ingest assembler: each rank contributes only the
        shards it owns (``shard.multihost.HostShardedStream``)."""
        from cutesdr_tpu_torch.shard.multihost import HostShardedStream
        return HostShardedStream(self.mesh, self.cfg.block_size)
