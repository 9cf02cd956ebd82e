"""Channel banks (port of ``cutesdr_tpu/shard/channels.py``): C receivers
of one configuration, run as one batched step.

* ``ChannelBank``: C channels tuned across one shared wideband stream
  (BASELINE config 4: 64 USB channels from one 10 MSPS stream).
* ``StackedReceiver``: C chains over C separate streams, one row each
  (the two receivers of a dual-ADC radio, antenna-array elements).

Both hold their params and state on one explicit device and run
``pipeline.receiver.bank_receiver_step``.  With a mesh (``shard.mesh``)
the C channels split evenly into one sub-bank per device along its "ch"
axis: the shared block is copied to each device (a StackedReceiver's
rows go to theirs), and the outputs are concatenated on the first.

A bank's params and state are the single receiver's NamedTuples with a
leading channel axis on every state tensor and on the per-channel params
(``PER_CHANNEL``: the DDS increment, the channel filter's H, the DC cal).
Every other param (AGC and demod constants, taps, the volume) is one
value shared by the bank, as every JAX entry point that builds a bank
leaves it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from cutesdr_tpu_torch.ops import nco
from cutesdr_tpu_torch.pipeline import receiver as rx
from cutesdr_tpu_torch.types import resolve_device

PER_CHANNEL = {("dec", "phase_inc"), ("chan_filter", "h_freq"),
               ("dc_offset",)}


def _stack(leaves: list, path: tuple, per_channel, device):
    """One field of a bank from the same field of each channel: stacked
    where ``per_channel`` holds its path (None: every field), else the
    one value every channel agrees on."""
    first = leaves[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*(
            _stack([leaf[i] for leaf in leaves], path + (name,),
                   per_channel, device)
            for i, name in enumerate(first._fields)))
    if per_channel is None or path in per_channel:
        if isinstance(first, torch.Tensor):
            return torch.stack(leaves)
        return torch.tensor(leaves, dtype=torch.int64, device=device)
    same = (torch.equal if isinstance(first, torch.Tensor)
            else lambda a, b: a == b)
    if not all(same(leaf, first) for leaf in leaves[1:]):
        raise ValueError(f"{'.'.join(path)} differs across channels; a bank "
                         "shares it")
    return first


def stack_params(channels: Sequence[rx.ReceiverParams],
                 device) -> rx.ReceiverParams:
    """A bank's params from one ReceiverParams per channel: the
    ``PER_CHANNEL`` fields stacked, every other field the one value all
    channels hold (ValueError where they differ)."""
    return _stack(list(channels), (), PER_CHANNEL, torch.device(device))


def stack_state(channels: Sequence[rx.ReceiverState]) -> rx.ReceiverState:
    """A bank's state: every tensor of the channels' states stacked."""
    return _stack(list(channels), (), None, None)


def bank_init(cfg: rx.ReceiverConfig, tune_freqs: Sequence[float],
              device) -> tuple[rx.ReceiverParams, rx.ReceiverState]:
    """(params, state) of a bank with one channel per tune frequency."""
    device = torch.device(device)
    p0, s0 = rx.init(cfg, device)
    params = stack_params([rx.tune_params(cfg, p0, f) for f in tune_freqs],
                          device)
    return params, stack_state([s0] * len(tune_freqs))


def _cat_outputs(outs: list, device) -> rx.StepOutput:
    """The sub-banks' outputs as one bank's, on ``device``."""
    cat = lambda ts: torch.cat([t.to(device) for t in ts])
    probes = None
    if outs[0].probes is not None:
        probes = {k: cat([o.probes[k] for o in outs]) for k in outs[0].probes}
    return rx.StepOutput(*(cat(f) for f in zip(*(o[:-1] for o in outs))),
                         probes=probes)


class _Bank(rx.GraphedStepper):
    """The bank entry points over ``bank_receiver_step``, on the card
    unless ``device`` says otherwise; host numpy input is moved to the
    bank's device.  With a ``mesh`` the channels split into one sub-bank
    (``parts``) per device along its ``axis``.

    Where ``rx.bank_graph_rule(cfg, device)`` holds (``graphed``: on a
    CUDA device, probes too), each block replays
    ``bank_receiver_step_planes`` as one CUDA graph, as ``Receiver``
    replays its step (``rx.GraphedStepper``: ``state`` reads and loads the
    graph's buffers, a change of ``params`` lands in place or captures
    anew), the JAX package's jitted bank step; over a mesh each sub-bank
    captures its own on its device.  The channels' DDS increments are a
    device tensor that ``set_tune_freqs`` writes in place, and the volume
    and the resample ratio device values of the captured params."""

    shared_input: bool
    _bank = True

    def __init__(self, cfg: rx.ReceiverConfig, tune_freqs: Sequence[float],
                 device="cuda", mesh=None, axis: str = "ch"):
        self.cfg = rx.bank_safe_config(cfg)
        self.parts = None
        if mesh is not None:
            devices = mesh.axis_devices(axis)
            k, rest = divmod(len(tune_freqs), len(devices))
            if rest:
                raise ValueError(f"{len(tune_freqs)} channels not divisible "
                                 f"by {len(devices)} devices")
            self.parts = [type(self)(cfg, tune_freqs[j * k:(j + 1) * k], d)
                          for j, d in enumerate(devices)]
            self.device = self.parts[0].device
            return
        self.device = resolve_device(device)
        self._start(*bank_init(self.cfg, tune_freqs, self.device))

    @property
    def graphed(self) -> bool:
        """Whether this bank's blocks replay a CUDA graph (a mesh's: each
        sub-bank's)."""
        if self.parts is not None:
            return all(p.graphed for p in self.parts)
        return rx.bank_graph_rule(self.cfg, self.device)

    @property
    def n_channels(self) -> int:
        if self.parts is not None:
            return sum(p.n_channels for p in self.parts)
        return self._params.dec.phase_inc.shape[0]

    @property
    def _block(self) -> tuple:
        n = self.cfg.block_size
        return (n,) if self.shared_input else (self.n_channels, n)

    def _step(self, cfg, params, state, re, im):
        return rx.bank_receiver_step_planes(cfg, params, state, re, im,
                                            self.shared_input)

    def _split(self, call: str, *blocks) -> rx.StepOutput:
        """``call`` on each sub-bank: the shared block whole, or a stack's
        rows of that sub-bank's channels; the outputs joined."""
        outs, row = [], 0
        for part in self.parts:
            k = part.n_channels
            args = (blocks if self.shared_input
                    else [b[row:row + k] for b in blocks])
            outs.append(getattr(part, call)(*args))
            row += k
        return _cat_outputs(outs, self.device)

    def process(self, iq) -> rx.StepOutput:
        if self.parts is not None:
            return self._split("process", iq)
        return super().process(iq)

    def process_planes(self, re, im) -> rx.StepOutput:
        """The block as float32 or int16 planes (the radio's 16-bit wire
        format, which K1 reads as it is)."""
        if self.parts is not None:
            return self._split("process_planes", re, im)
        return super().process_planes(re, im)

    def set_tune_freqs(self, freqs: Sequence[float]) -> None:
        """Retune every channel between blocks (one frequency each): the
        increments are written in place, into the bank's tensor and the
        graph's copy of it."""
        if len(freqs) != self.n_channels:
            raise ValueError(f"{len(freqs)} frequencies for "
                             f"{self.n_channels} channels")
        if self.parts is not None:
            row = 0
            for part in self.parts:
                part.set_tune_freqs(freqs[row:row + part.n_channels])
                row += part.n_channels
            return
        incs = torch.tensor([nco.phase_increment(f - self.cfg.cw_offset,
                                                 self.cfg.input_rate)
                             for f in freqs], dtype=torch.int64)
        held = [self._params.dec.phase_inc]
        if self._graph is not None:
            held.append(self._graph.params.dec.phase_inc)
        for t in held:
            t.copy_(incs)


class ChannelBank(_Bank):
    """C channels of one configuration over one shared block of
    cfg.block_size samples per step; audio [C, cap] and n_audio [C]."""

    shared_input = True


class StackedReceiver(_Bank):
    """C chains of one configuration over C separate streams: input
    [C, cfg.block_size] per step; audio [C, cap] and n_audio [C]."""

    shared_input = False
