"""Carry a JAX receiver's params and stream state into the port.

``from_jax`` takes the JAX package's ``ReceiverParams`` / ``ReceiverState``
as nested NamedTuples of numpy arrays (the caller maps ``np.asarray`` over
them; this module never imports jax) and returns the port's, so a stream
can continue on the port mid-way.  Both JAX decimator layouts are taken:

* the Pallas mixdec carry (``raw_tail``, ``phase_base``): the raw tail,
  the port's own layout and length, and the phase;
* the fused XLA carry (``NcoCarry.phase_acc`` plus a ``FusedCarry.tail`` of
  the last L-1-d MIXED, DC-removed samples): the raw tail is rebuilt as
  tail * conj(osc_backdated) + dc, with zeros before it for the history
  that carry does not hold.

The Pallas four-step filter's pre-permuted ``h2`` is mapped back to
natural-order H.  The AGC, S-meter, resampler and demodulator params and
carries (for AM, SAM and FM: FIR tails, IIR state, PLL state, squelch
flag, de-emphasis) and the noise blanker's carry map field by field onto
the port's NamedTuples of the same names.

``from_jax_bank`` does the same for a JAX channel bank (every leaf with a
leading channel axis): channel by channel through ``from_jax``, then
stacked as ``shard.channels`` stacks a bank.

``from_jax_combiner`` carries a JAX diversity combiner's params and carry
(``shard/coherent``: two-branch or M-branch) into the port's, and
``from_jax_timeshard`` a JAX time-sharded receiver's ``TimeShardCarry``
(its Pallas-mixdec layout: raw tails) into ``shard.timeshard``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from cutesdr_tpu_torch.kernels import mixdec
from cutesdr_tpu_torch.ops import fastfir, nco
from cutesdr_tpu_torch.pipeline import receiver as rx
from cutesdr_tpu_torch.shard import channels, coherent, timeshard
from cutesdr_tpu_torch.types import CDTYPE, complex_tensor


def h_from_permuted(h2: np.ndarray) -> np.ndarray:
    """Natural-order H from the four-step kernel's planes h2[2, n2, 128]
    (inverse of ``cutesdr_tpu/kernels/fastfir4._permute_h``:
    h2[k2, k1] = H[k2 + n2*k1])."""
    h2 = np.asarray(h2)
    return (h2[0] + 1j * h2[1]).T.reshape(-1)


def _raw_tail_from_fused(tail: np.ndarray, phase: int, inc: int,
                         dc: complex) -> np.ndarray:
    """Undo the mix of a fused-layout tail: its sample k (of T) was mixed
    with the back-dated phase phase - (T - k)*inc (mod 2^32)."""
    t = len(tail)
    k = torch.arange(-t, 0, dtype=torch.int64)
    osc = nco.oscillator(nco.accumulator(torch.tensor(phase), inc, k))
    osc = osc.numpy().astype(np.complex128)
    return np.asarray(tail, np.complex128) * np.conj(osc) + dc


def _like(template, value, dev):
    """``value`` (a JAX leaf as numpy, or a NamedTuple of them) in the form
    of the port's ``template``: NamedTuples field by field, tensors on
    ``dev`` in the template's dtype, host scalars in the template's type
    (np.float32, int)."""
    if template is None:
        return None
    if isinstance(template, tuple):
        return type(template)(*(_like(t, getattr(value, f), dev)
                                for f, t in zip(template._fields, template)))
    if isinstance(template, torch.Tensor):
        return torch.tensor(np.asarray(value), device=dev).to(template.dtype)
    return type(template)(np.asarray(value))


def from_jax(cfg: rx.ReceiverConfig, params, state, device):
    """(port params, port state) from JAX ReceiverParams/ReceiverState of
    numpy arrays, for the same configuration."""
    dev = torch.device(device)
    base_p, base_s = rx.init(cfg, dev)
    dc = complex(np.asarray(params.dc_offset))

    # decimator: raw tail + phase, in either JAX layout
    t_len = mixdec.raw_tail_length(cfg.plan)
    if hasattr(state.dec, "raw_tail"):
        inc = int(params.dec.phase_inc)
        phase = int(state.dec.phase_base)
        raw = np.asarray(state.dec.raw_tail)
    elif hasattr(state.dec, "tail"):
        inc = int(params.nco.phase_inc)
        phase = int(state.nco.phase_acc)
        raw = _raw_tail_from_fused(state.dec.tail, phase, inc, dc)
        raw = np.concatenate([np.zeros(t_len - len(raw), raw.dtype), raw])
    else:
        raise NotImplementedError(
            "the cascade decimator layout is not ported yet")
    dec_p = base_p.dec._replace(phase_inc=inc)
    dec_c = mixdec.MixDecCarry(
        raw_tail=complex_tensor(raw, dev),
        phase=torch.tensor(phase, dtype=torch.int64, device=dev))

    cf = params.chan_filter
    h = h_from_permuted(cf.h2) if hasattr(cf, "h2") else np.asarray(cf.h_freq)
    ff_p = fastfir.FastFirParams(h_freq=complex_tensor(h, dev))
    ff_c = fastfir.FastFirCarry(
        tail=complex_tensor(state.chan_filter.tail, dev))

    # the rest maps field by field onto the port's NamedTuples
    like_p = {k: _like(getattr(base_p, k), getattr(params, k), dev)
              for k in ("agc", "smeter", "demod", "resamp")}
    like_s = {k: _like(getattr(base_s, k), getattr(state, k), dev)
              for k in ("blanker", "agc", "smeter", "demod", "resamp")}
    out_p = rx.ReceiverParams(
        dec=dec_p, chan_filter=ff_p, **like_p,
        dc_offset=torch.tensor(dc, dtype=CDTYPE, device=dev),
        audio_gain=float(np.float32(params.audio_gain)))
    out_s = rx.ReceiverState(dec=dec_c, chan_filter=ff_c, **like_s)
    return out_p, out_s


def _row(tree, c: int):
    """Channel ``c`` of a JAX bank's tree of numpy arrays."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(_row(leaf, c) for leaf in tree))
    return np.asarray(tree)[c]


def from_jax_bank(cfg: rx.ReceiverConfig, params, state, device):
    """(port params, port state) of a bank from a JAX bank's
    ReceiverParams/ReceiverState of numpy arrays with a leading channel
    axis.  Raises ValueError where the JAX channels differ in a param the
    port's bank keeps as one shared value."""
    n_ch = np.asarray(params.dc_offset).shape[0]
    rows = [from_jax(cfg, _row(params, c), _row(state, c), device)
            for c in range(n_ch)]
    return (channels.stack_params([p for p, _ in rows], device),
            channels.stack_state([s for _, s in rows]))


def from_jax_combiner(params, carry, device):
    """(port CombinerParams, port carry) from a JAX combiner's
    ``CombinerParams`` and ``CombinerCarry`` or ``ArrayCombinerCarry`` of
    numpy arrays."""
    dev = torch.device(device)
    out_p = coherent.CombinerParams(
        alpha=float(np.float32(params.alpha)),
        manual=bool(np.asarray(params.manual)),
        fixed_gain=complex_tensor(params.fixed_gain, dev))
    if hasattr(carry, "gains"):
        return out_p, coherent.ArrayCombinerCarry(
            gains=complex_tensor(carry.gains, dev))
    return out_p, coherent.CombinerCarry(gain=complex_tensor(carry.gain,
                                                             dev))


def from_jax_timeshard(carry, device) -> timeshard.TimeShardCarry:
    """The port's ``TimeShardCarry`` from a JAX one of numpy arrays (the
    raw-tail layout of JAX's Pallas mixdec branch): the uint32
    ``nco_base`` as int64, the tails as complex64, a zero-length blanker
    tail as None."""
    dev = torch.device(device)
    nb = np.asarray(carry.nb_tail)
    return timeshard.TimeShardCarry(
        nco_base=torch.tensor(int(carry.nco_base), dtype=torch.int64,
                              device=dev),
        in_tail=complex_tensor(carry.in_tail, dev),
        dec_tail=complex_tensor(carry.dec_tail, dev),
        nb_tail=complex_tensor(nb, dev) if nb.size else None)
