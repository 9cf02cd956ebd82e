"""Carry a JAX receiver's params and stream state into the port.

``from_jax`` takes the JAX package's ``ReceiverParams`` / ``ReceiverState``
as nested NamedTuples of numpy arrays (the caller maps ``np.asarray`` over
them; this module never imports jax) and returns the port's, so a stream
can continue on the port mid-way.  Both JAX decimator layouts are taken:

* the Pallas mixdec carry (``raw_tail``, ``phase_base``): the last L-1-d
  raw samples and the phase;
* the fused XLA carry (``NcoCarry.phase_acc`` plus a ``FusedCarry.tail`` of
  MIXED, DC-removed samples): the raw tail is rebuilt as
  tail * conj(osc_backdated) + dc.

The Pallas four-step filter's pre-permuted ``h2`` is mapped back to
natural-order H.
"""

from __future__ import annotations

import numpy as np
import torch

from cutesdr_tpu_torch.kernels import mixdec
from cutesdr_tpu_torch.ops import agc, decimator, fastfir, nco, resampler, smeter
from cutesdr_tpu_torch.pipeline import receiver as rx
from cutesdr_tpu_torch.types import CDTYPE, RDTYPE, complex_tensor


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


def from_jax(cfg: rx.ReceiverConfig, params, state, device):
    """(port params, port state) from JAX ReceiverParams/ReceiverState of
    numpy arrays, for the same configuration."""
    dev = torch.device(device)
    base_p, _ = rx.init(cfg, dev)
    r = lambda v: torch.tensor(np.float32(v), dtype=RDTYPE, device=dev)
    f = np.float32
    dc = complex(np.asarray(params.dc_offset))

    # decimator: raw tail + phase, in either JAX layout
    t_len = decimator.tail_length(cfg.plan)
    if hasattr(state.dec, "raw_tail"):
        inc = int(params.dec.phase_inc)
        phase = int(state.dec.phase_base)
        raw = np.asarray(state.dec.raw_tail)[-t_len:] if t_len else \
            np.zeros(0, np.complex64)
    elif hasattr(state.dec, "tail"):
        inc = int(params.nco.phase_inc)
        phase = int(state.nco.phase_acc)
        raw = _raw_tail_from_fused(state.dec.tail, phase, inc, dc)
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

    ap = params.agc
    agc_p = agc.AgcParams(
        knee=f(ap.knee), gain_slope=f(ap.gain_slope),
        fixed_gain=f(ap.fixed_gain), manual_gain=f(ap.manual_gain),
        attack_rise_alpha=f(ap.attack_rise_alpha),
        attack_fall_alpha=f(ap.attack_fall_alpha),
        decay_rise_alpha=f(ap.decay_rise_alpha),
        decay_fall_alpha=f(ap.decay_fall_alpha),
        hang_time=int(ap.hang_time))
    ac = state.agc
    agc_c = agc.AgcCarry(
        sig_delay=complex_tensor(ac.sig_delay, dev),
        mag_tail=torch.tensor(np.asarray(ac.mag_tail, np.float32),
                              device=dev),
        attack_ave=r(ac.attack_ave), decay_ave=r(ac.decay_ave),
        hang_timer=torch.tensor(int(ac.hang_timer), dtype=torch.int32,
                                device=dev))

    sm_p = smeter.SMeterParams(attack_alpha=f(params.smeter.attack_alpha),
                               decay_alpha=f(params.smeter.decay_alpha))
    sc = state.smeter
    sm_c = smeter.SMeterCarry(attack_ave=r(sc.attack_ave),
                              decay_ave=r(sc.decay_ave),
                              average_mag=r(sc.average_mag),
                              peak_mag=r(sc.peak_mag))

    if params.resamp is not None:
        rs_p = resampler.ResamplerParams(dt_hi=f(params.resamp.dt_hi),
                                         dt_lo=f(params.resamp.dt_lo))
        tail = np.asarray(state.resamp.tail)
        rs_c = resampler.ResamplerCarry(
            tail=(complex_tensor(tail, dev) if np.iscomplexobj(tail) else
                  torch.tensor(tail.astype(np.float32), device=dev)),
            t0=r(state.resamp.t0))
    else:
        rs_p, rs_c = None, None

    out_p = rx.ReceiverParams(
        dec=dec_p, chan_filter=ff_p, agc=agc_p, smeter=sm_p, demod=None,
        resamp=rs_p,
        dc_offset=torch.tensor(dc, dtype=CDTYPE, device=dev),
        audio_gain=float(np.float32(params.audio_gain)))
    out_s = rx.ReceiverState(dec=dec_c, chan_filter=ff_c, agc=agc_c,
                             smeter=sm_c, demod=None, resamp=rs_c)
    return out_p, out_s
