"""End-to-end latency accounting and low-latency size selection (the
port's copy of ``cutesdr_tpu/design/latency.py``'s ``latency_report`` and
``choose_fastfir_sizes``; plain Python).

The reference has no explicit latency budget; its latency falls out of the
~10 ms DSP block (dsp/demodulator.cpp:145-146), the 1025-tap channel
filter's group delay (dsp/fastfir.cpp:55-57) and the half-filled
16384-sample sound queue (interface/soundout.cpp:312-334).  Here the same
quantities are modeled explicitly so a target latency can be traded
against filter sharpness.

Components of one sample's input -> audio delay:

* block accumulation: a block of ``cfg.block_size`` input samples must
  arrive before the step runs, ``block_size / input_rate`` (worst case;
  the average sample waits half that);
* decimator group delay: the composed half-band/CIC cascade is linear
  phase, ``(len(H_eq) - 1) / 2`` input samples;
* channel-filter group delay: the ntaps windowed-sinc bandpass is linear
  phase, ``(ntaps - 1) / 2`` decimated samples;
* resampler group delay: the interpolation sinc is centered,
  ``resampler_periods / 2`` decimated samples;
* audio queue: the rate-locked output queue plays from its half-fill set
  point, ``OUTQSIZE / 2`` samples at the audio rate (only with an audio
  sink in the loop).

Compute time is not modeled: arrival time dominates.
"""

from __future__ import annotations

from dataclasses import replace
from typing import TYPE_CHECKING

from cutesdr_tpu_torch.io.audio_sink import OUTQSIZE
from cutesdr_tpu_torch.ops.resampler import SINC_PERIODS

if TYPE_CHECKING:  # no import cycle: ReceiverConfig imports design/*
    from cutesdr_tpu_torch.pipeline.receiver import ReceiverConfig

MIN_NFFT = 128           # smallest overlap-save frame worth dispatching
MAX_NFFT = 32768


def latency_report(cfg: "ReceiverConfig", include_queue: bool = False) -> dict:
    """Per-component latency (seconds) of a configuration."""
    fs_in, fs_out = cfg.input_rate, cfg.output_rate
    comp = {
        "block_accumulation": cfg.block_size / fs_in,
        "decimator_group_delay": (len(cfg.plan.composed_taps()) - 1) / 2 / fs_in,
        "fastfir_group_delay": (cfg.fastfir_ntaps - 1) / 2 / fs_out,
    }
    if cfg.audio_rate is not None:
        periods = getattr(cfg, "resampler_periods", SINC_PERIODS)
        comp["resampler_group_delay"] = periods / 2 / fs_out
    if include_queue and cfg.audio_rate is not None:
        comp["audio_queue_half_fill"] = OUTQSIZE / 2 / cfg.audio_rate
    comp["total"] = sum(comp.values())
    return comp


def _sized(cfg: "ReceiverConfig", nfft: int) -> "ReceiverConfig":
    return replace(cfg, fastfir_nfft=nfft, fastfir_ntaps=nfft // 2 + 1,
                   frames_per_block=1)


def choose_fastfir_sizes(cfg: "ReceiverConfig",
                         target_latency_s: float) -> "ReceiverConfig":
    """A copy of ``cfg`` with the largest channel-filter sizes whose
    pipeline latency (block accumulation + filter group delays, no queue)
    meets ``target_latency_s``.

    Keeps the reference's tap ratio ``ntaps = nfft/2 + 1`` (each frame
    yields nfft/2 samples, the transition width ~2*fs_out/ntaps); a larger
    nfft is a sharper filter and more latency.  Raises ValueError if even
    the smallest frame (MIN_NFFT) cannot meet the target."""
    best = None
    nfft = MIN_NFFT
    while nfft <= MAX_NFFT:
        cand = _sized(cfg, nfft)
        if latency_report(cand)["total"] > target_latency_s:
            break
        best = cand
        nfft *= 2
    if best is None:
        floor = latency_report(_sized(cfg, MIN_NFFT))["total"]
        raise ValueError(
            f"target {target_latency_s * 1e3:.2f} ms unreachable: the "
            f"minimum-size pipeline needs {floor * 1e3:.2f} ms at "
            f"input_rate={cfg.input_rate:.0f} (decimation x{cfg.plan.decimation})")
    return best
