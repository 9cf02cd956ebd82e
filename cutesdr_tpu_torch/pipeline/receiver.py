"""The receiver chain as one streaming step (port of
``cutesdr_tpu/pipeline/receiver.py``).

Noise blanker (optional) -> DC cal + NCO mix + polyphase decimation
(mixdec kernel) -> overlap-save
channel filter (fastfir kernel) -> S-meter (smeter kernel) -> AGC (scan
kernels) -> demod (AM, SAM with the seqloop_sam kernel, FM with the
seqloop_fm kernel, or SSB/CW; mono or stereo) -> exact-rational or banded
resample (banded: the resamp kernel) -> gain.

Numeric knobs (tune frequency, filter H, AGC constants, resample ratio,
volume, DC cal) are plain values in ``ReceiverParams``, swapped between
blocks; the stream state is one ``ReceiverState`` handed across blocks.
The rational resampler runs from 131,072 demodulated samples up, as in
the JAX package.  The AGC's guess-verify solves (K4 for the two-rate
averagers, N3h for hang mode's decay averager: one launch each, a bank's
rows in the same launch), the S-meter kernel, the affine scan (the
demods' one-poles), FM's biquad (N2) and the AGC's sequential fallback
(kernel N1) take every size, single stream and bank.  Tensors on the CPU
run every kernel's plain version; CUDA tensors launch the kernels.  A
mode, rate or filter-size change keeps the stream: ``migrate_state``
carries the state into the new configuration's
(``Receiver.reconfigure``).  With ``probes`` on, the step also returns
the testbench's named taps (p1-p7).

The step is ``front`` (blanker, mix + decimate, channel filter) then
``back_end`` (S-meter, AGC, demod, resampler); the time-sharded and the
pipelined receivers (``shard.timeshard``, ``shard.pipeline``) call the
two apart.

``bank_receiver_step`` runs C channels of one configuration at once (a
leading channel axis on the state and on the per-channel params): one
mixdec, one batched channel-filter, one S-meter and one launch of each
AGC solve for the bank, the AGC's fallback and the PLL tiers voted
bank-wide, and, as in the JAX package's bank, never the rational
resampler.

The step's data-dependent choices (the AGC's sequential fallback, FM's
and SAM's PLL tiers) are made on the device, as the JAX package's
``lax.cond``s make them inside its ``jax.jit`` of the step, so on the card
neither step makes a host read.  Every step of the port on one CUDA
device replays as CUDA graphs (``pipeline/stepgraph``), the JAX
package's jits:

* ``Receiver`` where ``graph_rule(cfg, device)`` holds, and a bank
  (``shard/channels``) where ``bank_graph_rule(cfg, device)`` does: any
  CUDA device, in every mode (USB, LSB, CWU, CWL, AM, FM, SAM; mono and
  stereo), with the two-rate or the hang-mode AGC or the AGC off, with or
  without the noise blanker, with or without ``probes`` (the taps, FM's
  and SAM's p6 and ``pll_tier`` too, are outputs of the graph, cloned on
  return as the audio is);
* ``shard.coherent.DiversityReceiver`` (the combine and this step, one
  graph), ``shard.timeshard.ShardedReceiver`` over shards of one card
  (the whole superblock, one graph) and ``shard.pipeline.
  PipelinedReceiver`` on one card (a graph a stage), all through
  ``GraphedStepper`` or ``StepGraph``;
* eager: every CPU step, and a time shard or a pipeline over several
  cards or ranks (their module notes say why).

A graph is captured at the first block, for its block shape and the host
values of its params (``graph_key``).  The tune, the volume and a banded
resample ratio are device values of the captured params
(``device_params``: K1 reads the tune's increment by pointer; a bank's
increments are a tensor that ``set_tune_freqs`` writes in place), which
the setters fill in place, so they reach the graph on the next block
with no capture; so do a new channel filter and DC cal (tensors copied in
place).  A change of the AGC's constants, or of the resampler's route
between the exact rational and the banded path (the rate lock leaving or
reaching the nominal ratio), captures a new graph at the next block in
place of the old; ``reconfigure`` drops it.  The eager step
(``receiver_step_planes``, ``bank_receiver_step_planes``) stays: it is
the step of every path the rules leave out, and the reference the graph
is held to on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.autograd import profiler as _profiler

from cutesdr_tpu_torch import metrics
from cutesdr_tpu_torch.demod import DEMOD_AM, DEMOD_FM, DEMOD_SAM, MODE_IDS
from cutesdr_tpu_torch.demod import am as am_demod
from cutesdr_tpu_torch.demod import fm as fm_demod
from cutesdr_tpu_torch.demod import sam as sam_demod
from cutesdr_tpu_torch.demod import ssb as ssb_demod
from cutesdr_tpu_torch.design.decimation_plan import (DecimationPlan,
                                                      plan_decimation)
from cutesdr_tpu_torch.kernels import fastfir as fastfir_k
from cutesdr_tpu_torch.kernels import mixdec
from cutesdr_tpu_torch.ops import (agc, fastfir, nco, noiseblanker,
                                   resampler, smeter)
from cutesdr_tpu_torch.pipeline import stepgraph
from cutesdr_tpu_torch.types import CDTYPE, RDTYPE, resolve_device

SOUNDCARD_RATE = 48000.0

# Per-mode filter-edge limits (gui/mainwindow.cpp:1000-1054):
# (hi_min, hi_max, low_min, low_max, symmetric)
MODE_LIMITS = {
    "am":  (500, 10000, -10000, -500, True),
    "sam": (100, 10000, -10000, -100, False),
    "fm":  (5000, 15000, -15000, -5000, True),
    "usb": (500, 20000, 0, 200, False),
    "lsb": (-200, 0, -20000, -500, False),
    "cwu": (50, 1000, -1000, -50, False),
    "cwl": (50, 1000, -1000, -50, False),
}

MODE_DEFAULT_CUTS = {
    "am": (-5000, 5000), "sam": (-5000, 5000), "fm": (-7500, 7500),
    "usb": (100, 2800), "lsb": (-2800, -100),
    "cwu": (-250, 250), "cwl": (-250, 250),
}

PORTED_MODES = tuple(MODE_LIMITS)   # all seven modes of the JAX package
# The single stream's resampler takes the exact rational path from this
# many demodulated samples up (the JAX package's value, kept after timing
# both tails on an H100: ``chip_kernel_times.py --only gate``).  At
# 62.5 kHz the rational conv1d tail is the faster from 65,536 samples up
# (by 7 us a block there) and the banded K9 tail below 16,384; no bench
# row or smoke path runs between, so each takes the faster tail with
# this value.  At 78.125 kHz the banded tail is the faster at every size
# to 262,144, but no bench row or smoke path at that rate reaches this
# gate (PERF.md, F5).
RATIONAL_MIN_SAMPLES = 131072


@dataclass(frozen=True)
class ReceiverConfig:
    input_rate: float = 2_000_000.0
    mode: str = "usb"
    low_cut: float | None = None       # Hz relative to tune freq
    hi_cut: float | None = None
    tune_freq: float = 0.0             # NCO offset within the passband
    cw_offset: float = 0.0             # CW tone offset (cwu/cwl)
    frames_per_block: int = 1          # fastfir frames per step
    agc_on: bool = True
    agc_hang: bool = False
    agc_thresh_db: float = -100.0
    agc_manual_gain_db: float = 30.0
    agc_slope: float = 0.0
    agc_decay_ms: float = 200.0
    squelch_ui: int = 0
    fm_deemphasis_us: float = 0.0
    nb_on: bool = False
    nb_threshold: float = 50.0
    nb_width_us: float = 2.0
    stereo: bool = False
    audio_rate: float | None = SOUNDCARD_RATE   # None: raw demod-rate audio
    resampler_interp: bool = True
    resampler_periods: int = resampler.SINC_PERIODS
    fastfir_nfft: int = fastfir.NFFT
    fastfir_ntaps: int = fastfir.NFIR
    probes: bool = False

    def __post_init__(self):
        if self.mode not in MODE_LIMITS:
            raise ValueError(f"unknown mode {self.mode!r}")
        lo, hi = MODE_DEFAULT_CUTS[self.mode]
        if self.low_cut is None:
            object.__setattr__(self, "low_cut", float(lo))
        if self.hi_cut is None:
            object.__setattr__(self, "hi_cut", float(hi))

    @cached_property
    def max_output_bw(self) -> float:
        """LSB-ish modes key off the low-edge limit, others off the high
        edge (dsp/demodulator.cpp:116-119)."""
        hi_min, hi_max, low_min, low_max, _ = MODE_LIMITS[self.mode]
        if self.mode in ("lsb", "cwl"):
            return float(-low_min)
        return float(hi_max)

    @cached_property
    def plan(self) -> DecimationPlan:
        return plan_decimation(self.input_rate, self.max_output_bw)

    @property
    def output_rate(self) -> float:
        return self.plan.out_rate

    @property
    def fastfir_valid(self) -> int:
        return fastfir.valid_per_frame(self.fastfir_nfft, self.fastfir_ntaps)

    @property
    def block_size(self) -> int:
        """Input samples per step: frames_per_block overlap-save frames."""
        return self.plan.decimation * self.fastfir_valid * self.frames_per_block

    @property
    def latency_sec(self) -> float:
        return self.block_size / self.input_rate

    @property
    def audio_block_cap(self) -> int:
        n_demod = self.fastfir_valid * self.frames_per_block
        if self.audio_rate is None:
            return n_demod
        return resampler.max_out_for(n_demod, self.output_rate / self.audio_rate)

    @property
    def mode_id(self) -> int:
        return MODE_IDS[self.mode]


class ReceiverParams(NamedTuple):
    """A bank has one phase increment, channel-filter H and DC cal per
    channel (a leading channel axis); the other params are shared."""
    dec: mixdec.MixDecParams         # composed taps + NCO phase increment
    chan_filter: fastfir.FastFirParams
    agc: agc.AgcParams
    smeter: smeter.SMeterParams
    demod: Any                       # Am/Sam/FmParams; None for SSB/CW
    resamp: Any                      # ResamplerParams or None
    dc_offset: torch.Tensor          # NCO-spur I/Q cal, complex64 0-dim
    audio_gain: float                # volume (linear)


class ReceiverState(NamedTuple):
    """A bank has a leading channel axis on every tensor."""
    blanker: Any                     # BlankerCarry, or None with nb_on off
    dec: mixdec.MixDecCarry          # raw input tail + DDS phase
    chan_filter: fastfir.FastFirCarry
    agc: agc.AgcCarry
    smeter: smeter.SMeterCarry
    demod: Any
    resamp: Any                      # ResamplerCarry or None


class StepOutput(NamedTuple):
    """A bank adds a leading channel axis to every field."""
    audio: torch.Tensor              # [audio_block_cap] float32, or
                                     # complex64 for stereo (left = real)
    n_audio: torch.Tensor            # valid audio samples (int32 0-dim)
    smeter_ave_db: torch.Tensor
    smeter_peak_db: torch.Tensor
    probes: Any                      # dict of taps if cfg.probes else None


def _agc_cfg(cfg: ReceiverConfig) -> agc.AgcConfig:
    return agc.AgcConfig(cfg.agc_on, cfg.agc_hang, cfg.plan.out_rate)


def _nb_cfg(cfg: ReceiverConfig) -> noiseblanker.BlankerConfig:
    return noiseblanker.BlankerConfig(cfg.nb_on, cfg.nb_threshold,
                                      cfg.nb_width_us, cfg.input_rate)


def _demod_init(cfg: ReceiverConfig, device):
    fs = cfg.plan.out_rate
    m = cfg.mode_id
    if m == DEMOD_AM:
        return am_demod.init((cfg.hi_cut - cfg.low_cut) / 2.0, fs, device)
    if m == DEMOD_SAM:
        return sam_demod.init(fs, device)
    if m == DEMOD_FM:
        return fm_demod.init(fs, device, cfg.squelch_ui, cfg.hi_cut,
                             deemphasis_us=cfg.fm_deemphasis_us)
    return None, None                # ssb/cw: stateless


_DEMODS = {DEMOD_AM: am_demod, DEMOD_SAM: sam_demod, DEMOD_FM: fm_demod}


def _demod_apply(cfg: ReceiverConfig, params, carry, x: torch.Tensor,
                 probes=None):
    """Demodulate one block; with a probes dict and a mono PLL mode (SAM,
    FM) also records the P6 tap, the per-sample phase error x100 (the
    reference's PROFILE_6 sites, dsp/samdemod.cpp:92, dsp/fmdemod.cpp:120),
    and ``pll_tier``, the tier taken (a 0-dim int32 device tensor: the
    demods pick it on the device; a session reads it with the block's
    other scalars)."""
    mod = _DEMODS.get(cfg.mode_id)
    if mod is None:
        f = ssb_demod.process_stereo if cfg.stereo else ssb_demod.process
        return f(carry, x)
    if (probes is not None and not cfg.stereo
            and cfg.mode_id in (DEMOD_SAM, DEMOD_FM)):
        c, y, p6, tier = mod.probed(params, carry, x)
        probes["p6_pll"] = p6
        probes["pll_tier"] = tier
        return c, y
    f = mod.process_stereo if cfg.stereo else mod.process
    return f(params, carry, x)


def init(cfg: ReceiverConfig, device) -> tuple[ReceiverParams, ReceiverState]:
    """Build (params, state) for a configuration on ``device``."""
    device = torch.device(device)
    fs_out = cfg.plan.out_rate
    # the mixer shifts the tuned station to +cw_offset inside the channel
    # filter: f_nco = tune - offset
    dec_p, dec_c = mixdec.init(cfg.plan, cfg.tune_freq - cfg.cw_offset,
                               device)
    ff_p, ff_c = fastfir.init(cfg.low_cut, cfg.hi_cut, cfg.cw_offset, fs_out,
                              device, nfft=cfg.fastfir_nfft,
                              ntaps=cfg.fastfir_ntaps)
    acfg = _agc_cfg(cfg)
    agc_p = agc.make_params(acfg, cfg.agc_thresh_db, cfg.agc_manual_gain_db,
                            cfg.agc_slope, cfg.agc_decay_ms)
    agc_c = agc.init_carry(acfg, device)
    sm_p, sm_c = smeter.init(fs_out, device)
    dm_p, dm_c = _demod_init(cfg, device)
    if cfg.audio_rate is not None:
        rs_p, rs_c = resampler.init(fs_out / cfg.audio_rate, device,
                                    complex_input=cfg.stereo,
                                    periods=cfg.resampler_periods)
    else:
        rs_p, rs_c = None, None
    nb_c = (noiseblanker.init_carry(_nb_cfg(cfg), device) if cfg.nb_on
            else None)
    params = ReceiverParams(
        dec=dec_p, chan_filter=ff_p, agc=agc_p, smeter=sm_p, demod=dm_p,
        resamp=rs_p, dc_offset=torch.zeros((), dtype=CDTYPE, device=device),
        audio_gain=1.0)
    state = ReceiverState(blanker=nb_c, dec=dec_c, chan_filter=ff_c,
                          agc=agc_c, smeter=sm_c, demod=dm_c, resamp=rs_c)
    return params, state


def _fit_leaf(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Carry an old state tensor into a new template: identical shape and
    dtype pass through; 1-D histories keep their most recent samples at
    the end (delay lines and filter tails store newest last); anything
    else takes the fresh template."""
    if old.shape == new.shape and old.dtype == new.dtype:
        return old
    if old.dim() == 1 and new.dim() == 1 and old.dtype == new.dtype:
        n = min(old.shape[0], new.shape[0])
        if n == 0:
            return new
        out = new.clone()
        out[new.shape[0] - n:] = old[old.shape[0] - n:]
        return out
    return new


def _fit_tree(old, new):
    """``_fit_leaf`` over NamedTuples of tensors; where the two structures
    differ, the fresh template."""
    if isinstance(old, torch.Tensor) and isinstance(new, torch.Tensor):
        return _fit_leaf(old, new)
    if isinstance(new, tuple) and type(old) is type(new):
        return type(new)(*(_fit_tree(o, f) for o, f in zip(old, new)))
    return new


def migrate_state(old_cfg: ReceiverConfig, old: ReceiverState,
                  new_cfg: ReceiverConfig,
                  fresh: ReceiverState) -> ReceiverState:
    """Carry stream state across a mode / rate / filter-size change, by the
    JAX package's rules (the reference rebuilds the decimation chain and
    the demodulator on a mode change, dsp/demodulator.cpp:107-157, while
    the stream position and the oscillator phase roll on):

    * input-rate histories keep their most recent samples when the input
      rate is unchanged, else start fresh: the blanker (when on in both),
      and the decimator carry (raw input tail and DDS phase, the layout of
      JAX's Pallas mixdec carry);
    * output-rate histories (channel filter tail, AGC delay and magnitude
      windows, demodulator state, resampler tail) carry only when the
      decimated rate is unchanged, the demodulator only within one mode;
    * level trackers always carry: the AGC averages, the S-meter, the
      resampler's fractional time."""
    same_in = old_cfg.input_rate == new_cfg.input_rate
    same_out = old_cfg.output_rate == new_cfg.output_rate
    nb_c = (_fit_tree(old.blanker, fresh.blanker)
            if old_cfg.nb_on and new_cfg.nb_on and same_in else fresh.blanker)
    dec_c = _fit_tree(old.dec, fresh.dec) if same_in else fresh.dec
    chan_c = (_fit_tree(old.chan_filter, fresh.chan_filter) if same_out
              else fresh.chan_filter)
    if same_out:
        agc_c = _fit_tree(old.agc, fresh.agc)
    else:   # keep the level trackers, restart the rate-sized windows
        agc_c = fresh.agc._replace(attack_ave=old.agc.attack_ave,
                                   decay_ave=old.agc.decay_ave)
    dm_c = (_fit_tree(old.demod, fresh.demod)
            if old_cfg.mode == new_cfg.mode else fresh.demod)
    if old.resamp is not None and fresh.resamp is not None:
        rs_c = (_fit_tree(old.resamp, fresh.resamp) if same_out
                else fresh.resamp._replace(t0=old.resamp.t0))
    else:
        rs_c = fresh.resamp
    return ReceiverState(blanker=nb_c, dec=dec_c, chan_filter=chan_c,
                         agc=agc_c, smeter=old.smeter, demod=dm_c,
                         resamp=rs_c)


def _blank(cfg: ReceiverConfig, carry, re: torch.Tensor, im: torch.Tensor,
           probes):
    """The noise blanker over one block of planes.  With a probes dict its
    output is one complex64 block, recorded as ``p7_blanker``, whose
    real and imaginary views go on as the planes."""
    nb = _nb_cfg(cfg)
    if probes is None:
        return noiseblanker.process_planes(nb, carry, re, im)
    carry, y = noiseblanker.process_joined(nb, carry, re, im)
    probes["p7_blanker"] = y
    return carry, y.real, y.imag


def _front_prefilter(cfg: ReceiverConfig, params: ReceiverParams,
                     state: ReceiverState, re: torch.Tensor,
                     im: torch.Tensor, probes=None):
    """Blanker -> DC cal -> mix + decimate (everything before the channel
    filter).  A bank's blanker carry has a channel axis, as the JAX bank's
    vmapped one does; over a block shared by the channels the blanker runs
    once, on the first channel's carry, and every channel takes its
    result (so the bank's ``p7_blanker`` is that block expanded over the
    channel axis, a view)."""
    nb_c = state.blanker
    if cfg.nb_on:
        re, im = re.to(RDTYPE), im.to(RDTYPE)   # the blanker's float planes
        shared = re.dim() == 1 and nb_c.mag_tail.dim() == 2
        if shared:
            n_ch = nb_c.mag_tail.shape[0]
            c0 = noiseblanker.BlankerCarry(*(t[0] for t in nb_c))
            c0, re, im = _blank(cfg, c0, re, im, probes)
            nb_c = noiseblanker.BlankerCarry(*(
                t.expand((n_ch,) + t.shape).clone() for t in c0))
            if probes is not None:
                p7 = probes["p7_blanker"]
                probes["p7_blanker"] = p7.expand((n_ch,) + p7.shape)
        else:
            nb_c, re, im = _blank(cfg, nb_c, re, im, probes)
    dec_c, base = mixdec.process_planes(cfg.plan, params.dec, state.dec, re,
                                        im, params.dc_offset)
    if probes is not None:
        probes["p1_downconvert"] = base
    return nb_c, dec_c, base


def _levels(cfg: ReceiverConfig, params: ReceiverParams,
            state: ReceiverState, filt: torch.Tensor):
    """S-meter + AGC on the channel-filtered samples (one stream, or a
    bank's [C, n] rows)."""
    sm_c, _ = smeter.process(params.smeter, state.smeter, filt)
    agc_c, leveled = agc.process(_agc_cfg(cfg), params.agc, state.agc, filt)
    return sm_c, agc_c, leveled


def _tail(cfg: ReceiverConfig, params: ReceiverParams, state: ReceiverState,
          audio: torch.Tensor, sm_c: smeter.SMeterCarry, fast: bool,
          probes=None):
    """Resample -> gain -> output assembly.  Only the single stream
    (``fast``) takes the rational resampler, as in the JAX package.  With
    a probes dict the resampled audio is the ``p5_resampled`` tap, which
    becomes the output's ``probes``."""
    if cfg.audio_rate is not None:
        cap = resampler.max_out_for(audio.shape[-1],
                                    cfg.output_rate / cfg.audio_rate)
        rs_c, audio_out, n_audio = resampler.process(
            params.resamp, state.resamp, audio, cap,
            interp=cfg.resampler_interp,
            rational=_nominal(cfg, audio.shape[-1], fast))
        audio_out = audio_out * params.audio_gain
        if probes is not None:
            probes["p5_resampled"] = audio_out
    else:
        rs_c, audio_out = state.resamp, audio * params.audio_gain
        n_audio = torch.full(audio.shape[:-1], audio.shape[-1],
                             dtype=torch.int32, device=audio.device)
    sm_c, peak = smeter.get_peak(sm_c)
    out = StepOutput(audio=audio_out, n_audio=n_audio,
                     smeter_ave_db=smeter.get_ave(sm_c),
                     smeter_peak_db=peak, probes=probes)
    return sm_c, rs_c, out


def _nominal(cfg: ReceiverConfig, n: int, fast: bool):
    """The nominal (p, q) a block of ``n`` demodulated samples may take the
    rational resampler at (the single stream from RATIONAL_MIN_SAMPLES
    up), else None."""
    if not fast or n < RATIONAL_MIN_SAMPLES:
        return None
    return resampler.rational_for(cfg.output_rate, cfg.audio_rate)


def rational_tail(cfg: ReceiverConfig, params: ReceiverParams) -> bool:
    """Whether the single stream's resampler takes the exact rational path
    with these params (``resampler.rational_route``)."""
    if cfg.audio_rate is None:
        return False
    n = cfg.fastfir_valid * cfg.frames_per_block
    return resampler.rational_route(
        params.resamp, _nominal(cfg, n, True), n, cfg.audio_block_cap,
        cfg.resampler_periods)


def _tap(probes, name: str, t: torch.Tensor) -> None:
    if probes is not None:
        probes[name] = t


def front(cfg: ReceiverConfig, params: ReceiverParams, state: ReceiverState,
          re: torch.Tensor, im: torch.Tensor, probes=None):
    """The wideband front end of one block (blanker -> DC cal -> mix +
    decimate -> channel filter): returns the blanker, decimator and
    channel-filter carries and the filtered block."""
    nb_c, dec_c, base = _front_prefilter(cfg, params, state, re, im, probes)
    ff_c, filt = fastfir_k.process(params.chan_filter, state.chan_filter,
                                   base)
    _tap(probes, "p2_fastfir", filt)
    return nb_c, dec_c, ff_c, filt


def back_end(cfg: ReceiverConfig, params: ReceiverParams,
             state: ReceiverState, filt: torch.Tensor, probes=None):
    """The tail of the chain at the decimated rate (S-meter -> AGC ->
    demod -> resample), single stream: returns the S-meter, AGC, demod and
    resampler carries and the ``StepOutput``.  The time-sharded and the
    pipelined receivers run it on a filtered block that the front end
    made elsewhere."""
    sm_c, agc_c, leveled = _levels(cfg, params, state, filt)
    _tap(probes, "p3_agc", leveled)
    dm_c, audio = _demod_apply(cfg, params.demod, state.demod, leveled,
                               probes)
    _tap(probes, "p4_demod", audio)
    sm_c, rs_c, out = _tail(cfg, params, state, audio, sm_c, fast=True,
                            probes=probes)
    return sm_c, agc_c, dm_c, rs_c, out


def receiver_step_planes(cfg: ReceiverConfig, params: ReceiverParams,
                         state: ReceiverState, re: torch.Tensor,
                         im: torch.Tensor
                         ) -> tuple[ReceiverState, StepOutput]:
    """One block of cfg.block_size samples given as float32 or int16 re/im
    planes (K1 reads int16 planes as they are; the blanker, where it is
    on, their float32 cast): ``front`` then ``back_end``.  With
    ``cfg.probes`` the output's ``probes`` holds the testbench's named
    taps (gui/testbench.h:29-38): references to tensors the step computes
    anyway, never copies, never read on the host."""
    probes = {} if cfg.probes else None
    nb_c, dec_c, ff_c, filt = front(cfg, params, state, re, im, probes)
    sm_c, agc_c, dm_c, rs_c, out = back_end(cfg, params, state, filt, probes)
    return ReceiverState(blanker=nb_c, dec=dec_c, chan_filter=ff_c,
                         agc=agc_c, smeter=sm_c, demod=dm_c,
                         resamp=rs_c), out


def receiver_step(cfg: ReceiverConfig, params: ReceiverParams,
                  state: ReceiverState,
                  iq: torch.Tensor) -> tuple[ReceiverState, StepOutput]:
    """One block of cfg.block_size complex64 samples.  The planes go to the
    mixdec kernel as strided views, without a copy."""
    if iq.dtype != CDTYPE:
        raise ValueError(f"expected complex64 input, got {iq.dtype}")
    return receiver_step_planes(cfg, params, state, iq.real, iq.imag)


def bank_safe_config(cfg: ReceiverConfig) -> ReceiverConfig:
    """The configuration a channel bank runs: every configuration runs as
    a bank unchanged (the JAX package's hook, kept as its entry point for
    banks)."""
    return cfg


def bank_receiver_step_planes(cfg: ReceiverConfig, params: ReceiverParams,
                              state: ReceiverState, re: torch.Tensor,
                              im: torch.Tensor, shared_input: bool = True
                              ) -> tuple[ReceiverState, StepOutput]:
    """One block of a channel bank, as float32 or int16 planes
    (``receiver_step_planes``): [block_size] shared by every channel
    (``shared_input``, a ChannelBank) or [C, block_size], one stream per
    channel (a StackedReceiver).  The demods take a bank as
    they are (FM and SAM vote their PLL tier bank-wide).  With
    ``cfg.probes`` the taps p1-p5 and p7 come with a leading channel axis,
    and no p6 (the bank-voted PLL has no probed form), as in the JAX
    package's bank."""
    n_ch = state.chan_filter.tail.shape[0]
    want = (cfg.block_size,) if shared_input else (n_ch, cfg.block_size)
    if tuple(re.shape) != want or tuple(im.shape) != want:
        raise ValueError(f"bank input: expected planes of {want}, got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    probes = {} if cfg.probes else None
    nb_c, dec_c, base = _front_prefilter(cfg, params, state, re, im, probes)
    ff_c, filt = fastfir_k.batch_call(params.chan_filter, state.chan_filter,
                                      base)
    _tap(probes, "p2_fastfir", filt)
    sm_c, agc_c, leveled = _levels(cfg, params, state, filt)
    _tap(probes, "p3_agc", leveled)
    dm_c, audio = _demod_apply(cfg, params.demod, state.demod, leveled)
    _tap(probes, "p4_demod", audio)
    sm_c, rs_c, out = _tail(cfg, params, state, audio, sm_c, fast=False,
                            probes=probes)
    return ReceiverState(blanker=nb_c, dec=dec_c, chan_filter=ff_c,
                         agc=agc_c, smeter=sm_c, demod=dm_c,
                         resamp=rs_c), out


def bank_receiver_step(cfg: ReceiverConfig, params: ReceiverParams,
                       state: ReceiverState, iq: torch.Tensor,
                       shared_input: bool = True
                       ) -> tuple[ReceiverState, StepOutput]:
    """``bank_receiver_step_planes`` of a complex64 block ([block_size] or
    [C, block_size]); the planes are strided views, not copies."""
    if iq.dtype != CDTYPE:
        raise ValueError(f"expected complex64 input, got {iq.dtype}")
    return bank_receiver_step_planes(cfg, params, state, iq.real, iq.imag,
                                     shared_input)


# --- live param updates as pure (cfg, params) -> params functions ---

def tune_params(cfg: ReceiverConfig, params: ReceiverParams,
                freq_hz: float) -> ReceiverParams:
    inc = nco.phase_increment(freq_hz - cfg.cw_offset, cfg.input_rate)
    return params._replace(dec=params.dec._replace(phase_inc=inc))


def filter_params(cfg: ReceiverConfig, params: ReceiverParams,
                  low_cut: float, hi_cut: float) -> ReceiverParams:
    return params._replace(
        chan_filter=fastfir.retune(params.chan_filter, low_cut, hi_cut,
                                   cfg.cw_offset, cfg.output_rate,
                                   ntaps=cfg.fastfir_ntaps))


def ratio_params(params: ReceiverParams, ratio: float) -> ReceiverParams:
    if params.resamp is None:
        return params
    return params._replace(resamp=resampler.set_rate(params.resamp, ratio))


def volume_params(params: ReceiverParams, vol_0_99: int) -> ReceiverParams:
    # 0..99 -> -50..0 dB, 0 = mute (interface/soundout.cpp:181-190)
    g = 0.0 if vol_0_99 <= 0 else 10.0 ** ((min(vol_0_99, 99) - 99) / 39.2)
    return params._replace(audio_gain=float(np.float32(g)))


def graph_rule(cfg: ReceiverConfig, device) -> bool:
    """The rule (module notes): whether a ``Receiver`` of ``cfg`` on
    ``device`` replays its step as one CUDA graph: on any CUDA device,
    every configuration (probes too)."""
    return torch.device(device).type == "cuda"


def bank_graph_rule(cfg: ReceiverConfig, device) -> bool:
    """Whether a bank of ``cfg`` on ``device`` (a ``ChannelBank``, a
    ``StackedReceiver``, each sub-bank of one over a mesh) replays
    ``bank_receiver_step_planes`` as one CUDA graph: on a CUDA device, in
    every mode and AGC setting, with or without probes, as the single
    stream."""
    return graph_rule(cfg, device)


def _device_paths(cfg: ReceiverConfig, params: ReceiverParams,
                  bank: bool = False) -> set:
    """The params a graph holds as device values, so that a block may
    change them without a capture: the tune (K1 reads its increment by
    pointer; a bank's increments are a tensor already), the volume and,
    off the rational route (a bank is always off it), the resample
    ratio."""
    paths = {("dec", "phase_inc"), ("audio_gain",)}
    if params.resamp is not None and (bank or not rational_tail(cfg, params)):
        paths |= {("resamp", "dt_hi"), ("resamp", "dt_lo")}
    return paths


def device_params(cfg: ReceiverConfig, params: ReceiverParams,
                  device, bank: bool = False) -> ReceiverParams:
    """The params a graph is captured with: a copy of every tensor, and
    the values of ``_device_paths`` as 0-dim device tensors."""
    lifted = _device_paths(cfg, params, bank)
    dtypes = {("dec", "phase_inc"): torch.int64}

    def leaf(path, v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if path in lifted:
            return torch.full((), v, dtype=dtypes.get(path, RDTYPE),
                              device=device)
        return v
    return stepgraph.tree_map(leaf, params)


def graph_key(cfg: ReceiverConfig, params: ReceiverParams,
              bank: bool = False) -> tuple:
    """What a captured step bakes in: the params' host values and tensor
    shapes, the values of ``_device_paths`` excepted."""
    lifted = _device_paths(cfg, params, bank)

    def part(path, v):
        if isinstance(v, torch.Tensor):
            return (tuple(v.shape), v.dtype)
        if path in lifted:
            return "device"
        return v.tobytes() if isinstance(v, np.ndarray) else v
    return tuple(part(p, v) for p, v in stepgraph.walk(params))


def _update_params(static: ReceiverParams, old: ReceiverParams,
                   new: ReceiverParams) -> None:
    """Write ``new`` into a graph's ``static`` params in place, where
    ``old`` (of the same key) is what they hold now: its changed tensors
    copied, its changed device values filled."""
    for (_, dst), (_, was), (_, v) in zip(stepgraph.walk(static),
                                          stepgraph.walk(old),
                                          stepgraph.walk(new)):
        if not isinstance(dst, torch.Tensor) or v is was:
            continue
        if isinstance(v, torch.Tensor):
            dst.copy_(v)
        elif v != was:
            dst.fill_(v)


class _Graphed:
    """A captured step: its key, its device params (``held``), the host
    params they hold (``host``) and the ``StepGraph`` of ``step(cfg,
    params, state, *block)`` over blocks of ``block`` (a shape), given as
    planes (int16 ones where ``wire``) or, with ``planes`` False, as the
    complex block."""

    def __init__(self, cfg: ReceiverConfig, params: ReceiverParams,
                 held: ReceiverParams, key, state, device: torch.device,
                 step, block, planes: bool = True, wire: bool = False):
        self.key = key
        self.wire = wire
        self.host = params
        self.params = held
        self.step = stepgraph.StepGraph(
            lambda p, st, *x: step(cfg, p, st, *x), self.params, state,
            block, device, planes=planes, wire=wire)


class GraphedStepper:
    """Params, state and the replayed CUDA graph of a streaming step, the
    bookkeeping ``Receiver``, the banks (``shard/channels``), the
    diversity receiver and the one-card time shard share.

    Where ``graphed`` holds, each block replays the step as one CUDA graph
    (module notes): ``carry`` (``state`` unless a subclass splits it) then
    reads a copy of the graph's static buffers and assigning it copies
    into them, and ``params`` stays the host form, whose changes reach
    the graph in place (a change of ``_graph_key`` captures a new graph
    at the next block).  A subclass gives ``graphed``, ``_step`` (the
    eager step over the block's planes or, with ``_planes`` False, over
    the complex block), ``_block`` (the input block's shape) and
    ``_bank``.

    ``process(iq)`` takes a complex64 block, ``process_planes(re, im)``
    the block as float32 or int16 planes (the radio's 16-bit wire format);
    host numpy input is moved to the device.  Where the step takes planes,
    int16 planes go to it as they are (a graph's static block is then
    int16, and K1 reads it), so the dtype of the planes is part of what a
    capture bakes in: a block of the other kind captures anew, the state
    carried over.  While tracing is on (``metrics``) each call is an
    ``entry`` span: on a graph split into ``entry.input``,
    ``entry.replay`` and ``entry.outputs`` (``StepGraph.run_traced``), else
    around ``entry.step``."""

    _bank = False
    _planes = True

    def _start(self, params: ReceiverParams, state) -> None:
        self._params, self._state = params, state
        self._graph: _Graphed | None = None   # holds the state when set
        self._key = None                      # _graph_key of the params

    def _graph_key(self, params: ReceiverParams) -> tuple:
        """What a captured step bakes in (``graph_key``)."""
        return graph_key(self.cfg, params, self._bank)

    def _device_params(self, params: ReceiverParams) -> ReceiverParams:
        """The params a graph is captured with (``device_params``)."""
        return device_params(self.cfg, params, self.device, self._bank)

    @property
    def params(self) -> ReceiverParams:
        return self._params

    @params.setter
    def params(self, value: ReceiverParams) -> None:
        self._params = value
        self._key = None
        g = self._graph
        if g is not None:
            self._key = self._graph_key(value)
            if g.key == self._key:
                _update_params(g.params, g.host, value)
                g.host = value

    @property
    def carry(self):
        """The stream state (a copy of the graph's static buffers where a
        graph holds it)."""
        if self._graph is None:
            return self._state
        return stepgraph.clone(self._graph.step.state)

    @carry.setter
    def carry(self, value) -> None:
        if self._graph is None:
            self._state = value
        else:
            self._graph.step.load_state(value)

    state = carry

    def _live_carry(self):
        """The stream state itself: the graph's static buffers where a
        graph holds it (read, never kept: the next block overwrites
        them)."""
        return self._state if self._graph is None else self._graph.step.state

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        if (isinstance(a, torch.Tensor) and dtype in (None, a.dtype)
                and self._here(a.device)):
            return a              # as ``.to`` returns it, at less host cost
        return torch.as_tensor(a).to(device=self.device, dtype=dtype)

    def _here(self, device: torch.device) -> bool:
        """Whether ``device`` is this one as ``.to`` reads it: a CUDA
        device given without an index is the current one."""
        mine = self.device
        if device.type != mine.type:
            return False
        if mine.index is None:
            return (mine.type != "cuda"
                    or device.index == torch.cuda.current_device())
        return device.index == mine.index

    def _input(self, iq) -> torch.Tensor:
        """A complex block as ``_run`` takes it."""
        return self._to_device(iq, CDTYPE)

    def process(self, iq) -> StepOutput:
        if metrics.tracing_on or _profiler._is_profiler_enabled:
            return self._traced((iq,))
        return self._run(self._input(iq))

    def process_planes(self, re, im) -> StepOutput:
        if metrics.tracing_on or _profiler._is_profiler_enabled:
            return self._traced((re, im))
        return self._run_planes(self._to_device(re), self._to_device(im))

    def _traced(self, x: tuple) -> StepOutput:
        """``process`` (one block) or ``process_planes`` (two planes) with
        the entry's spans (class notes)."""
        metrics.tracing(True)
        with metrics.span("entry", block=True):
            if len(x) == 2:
                x = (self._to_device(x[0]), self._to_device(x[1]))
            else:
                x = (self._input(x[0]),)
            if self.graphed:
                return self._graph_step(self._wire(*x)).run_traced(*x)
            with metrics.span("entry.step"):
                return self._run_planes(*x) if len(x) == 2 else self._run(*x)

    def _wire(self, *x: torch.Tensor) -> bool:
        """Whether a block reaches the step as int16 planes: two int16
        planes, where the step takes planes."""
        return self._planes and len(x) == 2 and x[0].dtype == torch.int16

    def _graph_step(self, wire: bool = False) -> stepgraph.StepGraph:
        """The graph of the current params over a complex or, with
        ``wire``, an int16 static block, captured anew where their key or
        the block's kind changed (the state carried over from the last
        one)."""
        if self._key is None:
            self._key = self._graph_key(self._params)
        g = self._graph
        if g is None or g.key != self._key or g.wire != wire:
            state = self._state if g is None else g.step.state
            self._graph = _Graphed(self.cfg, self._params,
                                   self._device_params(self._params),
                                   self._key, state, self.device, self._step,
                                   self._block, self._planes, wire)
            self._state = None
        return self._graph.step

    def _eager(self, x: tuple) -> StepOutput:
        self._state, out = self._step(self.cfg, self._params, self._state,
                                      *x)
        return out

    def _run(self, iq: torch.Tensor) -> StepOutput:
        """One complex64 block on the device: replayed, or the eager step
        over its planes (strided views, not copies) or over the block."""
        if self.graphed:
            return self._graph_step().run(iq)
        return self._eager((iq.real, iq.imag) if self._planes else (iq,))

    def _run_planes(self, re: torch.Tensor, im: torch.Tensor) -> StepOutput:
        """One block as float32 or int16 planes on the device: int16
        planes as they are where the step takes planes, else cast (int16
        wire values are already in the +-32767 full-scale convention, so
        the cast is exact)."""
        wire = self._wire(re, im)
        if self.graphed:
            return self._graph_step(wire).run_planes(re, im)
        if not wire:
            re, im = re.to(RDTYPE), im.to(RDTYPE)
        return self._eager((re, im) if self._planes
                           else (torch.complex(re, im),))


class Receiver(GraphedStepper):
    """Stateful wrapper: owns params and state on one device, the card
    unless ``device`` says otherwise (no CUDA device raises).

    ``process(iq)`` takes a complex64 block, ``process_planes(re, im)`` the
    block as float32 or int16 planes (``GraphedStepper``).

    Where ``graph_rule(cfg, device)`` holds (``graphed``), each block
    replays the step as one CUDA graph (``GraphedStepper``)."""

    def __init__(self, cfg: ReceiverConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._start(*init(cfg, self.device))

    @property
    def graphed(self) -> bool:
        """Whether this receiver's blocks replay a CUDA graph."""
        return graph_rule(self.cfg, self.device)

    @property
    def _block(self) -> tuple:
        return (self.cfg.block_size,)

    @staticmethod
    def _step(cfg, params, state, re, im):
        return receiver_step_planes(cfg, params, state, re, im)

    # --- live reconfiguration between blocks (a graph takes them in
    # place: the tune, the volume, a banded ratio, the filter and the DC
    # cal; a change of the AGC constants or of the resampler's route
    # captures a new one) ---
    def set_tune_freq(self, freq_hz: float) -> None:
        self.params = tune_params(self.cfg, self.params, freq_hz)

    def set_filter(self, low_cut: float, hi_cut: float) -> None:
        self.params = filter_params(self.cfg, self.params, low_cut, hi_cut)

    def set_agc(self, thresh_db=None, manual_gain_db=None, slope=None,
                decay_ms=None) -> None:
        c = self.cfg
        self.params = self.params._replace(agc=agc.make_params(
            _agc_cfg(c),
            c.agc_thresh_db if thresh_db is None else thresh_db,
            c.agc_manual_gain_db if manual_gain_db is None else manual_gain_db,
            c.agc_slope if slope is None else slope,
            c.agc_decay_ms if decay_ms is None else decay_ms))

    def set_resample_ratio(self, ratio: float) -> None:
        self.params = ratio_params(self.params, ratio)

    def set_volume(self, vol_0_99: int) -> None:
        self.params = volume_params(self.params, vol_0_99)

    def set_dc_offset(self, i_off: float, q_off: float) -> None:
        self.params = self.params._replace(dc_offset=torch.full(
            (), complex(np.float32(i_off), np.float32(q_off)), dtype=CDTYPE,
            device=self.device))

    # --- structural reconfiguration (migrated stream state) ---
    def reconfigure(self, new_cfg: ReceiverConfig,
                    preserve_gain: bool = True) -> None:
        """Switch to a new configuration (mode / rate / filter sizes)
        without dropping the stream: the state migrates through
        ``migrate_state``; with ``preserve_gain`` the volume and the DC cal
        carry over.  The captured graph is dropped."""
        old_cfg, old_state = self.cfg, self.state
        gain, dc = self.params.audio_gain, self.params.dc_offset
        self._graph, self._key = None, None
        self.cfg = new_cfg
        self._params, fresh = init(new_cfg, self.device)
        if preserve_gain:
            self._params = self._params._replace(audio_gain=gain,
                                                 dc_offset=dc)
        self._state = migrate_state(old_cfg, old_state, new_cfg, fresh)
