"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``cutesdr_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version at the main paths' shapes (and
times both: the kernel's call time back to back and its own device time
from torch.profiler (``chip_kernel_times.device_ms``; ``device_by`` in
the ``kernels`` line names CUDA events instead where the profiler
returned no event), one PyTorch call
that computes the same function where there is one, and the kernel's
bound from the bytes and operations of its inputs), replays the golden / reference-binary fixtures (usb2m, usb, lsb,
cwu, am, sam, fm, stereo sam; the resampler, noise blanker and display
fixtures) through the port on the card, then drives the receiver paths
with the input resident on the card, each over chained steps, 48 kHz
audio (``path_specs``):

* the flagship, USB at 2 MSPS, tune 100 kHz, frames_per_block=256
  (8,388,608 input samples), the same with hang-mode AGC, the same with
  the resample ratio 50 ppm off nominal (the audio rate lock), so its
  262,144-sample tail takes the banded resampler kernel, and the same
  width with the 16384/8193 channel filter that design/latency grows to
  (a size the fastfir kernel does not take: the plain FFT route);
* FM, SAM and AM at frames_per_block=256 (262,144 demodulated samples,
  8,388,608 or 16,777,216 input samples), each recovering its modulating
  tone; SAM's first block acquires through the seqloop_sam kernel;
* the flagship USB and its hang-mode twin with one guess-verify round
  allowed, so the AGC takes its sequential fallback (kernel N1) on its
  blocks;
* FM at full width on carrier-less noise (``fm noise``), whose blocks
  take the chunked tier, one launch of the FM PLL kernel (K7) each (its
  launches and host reads a step: the ``--profile`` line);
* an FM monitor on an idle channel at the low-latency configuration
  (512/257 filter, one frame: 256 demodulated samples), whose noise
  blocks take the seqloop_fm kernel;
* channel banks: 64 USB channels across one 10 MSPS stream (the JAX
  package's config 4, one frame per step), an 8-channel FM monitor whose
  bank-wide vote sends every block to seqloop_fm over 8 streams, 4 SAM
  channels acquiring through seqloop_sam, and a StackedReceiver of two
  separate full-width 2 MSPS streams, each replaying one CUDA graph;
* ``check_graph``: the single-stream paths (hang mode and its fallback
  among them) and five banks, eager against graphed through a retune, a
  volume and a ratio change, bitwise, a replay with no host read, no
  kernel launch and one graph launch; then the flagship and full-width
  FM with probes on (the taps bitwise too), the two- and four-branch
  ``DiversityReceiver`` (a retune, a volume change and, pairwise,
  steering in place: one capture), ``ShardedReceiver`` over four shards
  of cuda:0 (a retune in place) and ``PipelinedReceiver`` on cuda:0 (two
  captures a stage, one block late), each against its eager step
  functions, bitwise, with no host read and no kernel launch a replayed
  step; ``check_graph_rule``: 84 receivers, 14 banks and four probes
  configurations the rules admit;
* a live ``ReceiverSession`` at the default block (one frame, 2 MSPS
  USB) with the noise blanker and the spectrum display, fed int16 planes
  of a tone with impulses while an audio consumer drains its queue
  100 ppm fast (so the rate lock moves the ratio) and the mode walks
  usb -> am -> fm -> usb, then a usb -> am walk with a 29-tap sinc (odd
  P through the resampler kernel) (``check_session``);
* the serving surface (``check_serving``, inputs from a generator of
  its own): the flagship and full-width FM with probes on (the taps'
  shapes, the audio bitwise the flagship's without probes, FM's tier
  tap against the tiers counted and K7's launches), a two-branch
  ``DiversitySession`` and a four-branch ``DiversityReceiver`` at the
  flagship's width (gains, the combine's tone-SNR gain over one branch,
  the combine against float64, host reads a block), a ``BankSession``
  over the 64-channel grid (S-meters, mini-spectra, the monitor's audio
  after ``select``, the probe frame's channel), and the session's probe
  scope walked through p7, p2, p6 and off, then a ``SpectrumServer`` on
  127.0.0.1 round-tripping /probe, /spectrum.json and /tune;
* the multi-device layer (``check_shard``, inputs from a generator of its
  own): the flagship over four time shards on one card (two superblocks
  of 33,554,432 samples against the single receiver over the same eight
  blocks, one CUDA graph a superblock; each shard's mixdec and fastfir
  call and the gathered 1,048,576-sample S-meter and AGC solves,
  recorded on the same step run eagerly, held against their plain
  versions), the two-stage ``PipelinedReceiver`` with its front on a
  second stream (bitwise the single receiver one block late), the
  64-channel bank over a 4-entry channel axis (bitwise the unsharded
  bank), and the four shards across a one-rank NCCL world (a helper
  process of this script, ``--timeshard-rank``), each path's time, Msps
  and real-time factor beside its reference's;
* the command line (``check_cli``: ``cli.main`` in this process, as
  ``python -m cutesdr_tpu_torch.cli`` runs it): ``run`` from a fake
  NetSDR at 2 MSPS (a helper process of this script, ``--fake-netsdr``)
  and from the native UDP ingest at 20 MSPS (``--udp-feed``), each at the
  10 ms default and at --target-latency-ms 0, with their real-time
  factors and lost packets or samples; ``run --dual``; ``record`` to
  SigMF and to a legacy file, played back by ``run`` bitwise equal to
  ``Receiver.process``; ``serve`` (single with a mode switch to FM, 8
  channels, dual-RX) with its settings file; ``spectrum``, ``latency``
  and ``discover``.  Nothing leaves 127.0.0.1;
* the bench (``check_bench``): ``bench_torch.py`` in a process of its
  own (the flagship's one JSON line over 10 reps) and the twelve suite
  rows through ``cli bench --suite`` at 2 steps a rep, each row's
  launches, PLL tiers and AGC fallbacks counted over its timed reps and
  its wall time at or above its CUDA-event time; the rows together
  launch K1-K9.

The scans (K3, K5) are also held to the float64 solve of their float32
inputs (no farther from it than 1.5x their plain versions), as is FM's
biquad (N2, ``check_biquad``); the AGC's solves over a bank's rows (K4,
``check_solve_rows``: 64 x 1,024 and 4 x 262,144) and hang mode's decay
solve (N3h, ``check_hang_solve``: bench row 12's keyed carrier, 1 and 4 x
262,144, 64 x 1,024, holds across chunk boundaries) to their plain
rounds, with the same flags (all rows and each row), patterns, timers
and rounds, also cut at one round (the forced fallback); N1 to its
plain loop bitwise, and the PLL kernels (K7, K8) to theirs bitwise at
every shape, with K7's chunked-tier flag against the torch chunked
tier's (forced repairs, an acquisition block, banks of 4 and 64
streams), and their walk's cycles a sample from a clock64() probe.
Before each path every launch count is set to 0; after it, every kernel
that the path's configuration routes to must have launched, and no
other.
Prints one line per phase, a JSON line of per-kernel results, the card's
name and power limit, and as its last line ``{"ok": true, "device":
{...}}``.  Any failed phase raises, so the script exits non-zero.  It
needs a CUDA device; it never imports jax.

    python3 chip_smoke.py --profile [--only LABEL,...]

builds the kernels and profiles the same receiver paths, the session,
the serving paths, the time shards and the pipeline, and the command
line's ``run`` paths instead (step
time, device busy time, launches and host reads per step or block; see
``profile_paths``, ``profile_serving``, ``profile_shard`` and
``profile_cli``); with ``--only``, only the lines of ``profile_paths``,
``profile_serving`` and ``profile_shard`` whose label is listed (the
receiver paths, FM's biquad alone, the session, the serving paths, the
time shard and the pipeline), on the same inputs as the whole run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import threading
import time
import types
import wave

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from chip_kernel_times import device_ms, event_counts, warm_up  # noqa: E402
from cutesdr_tpu_torch import bench_suite, kernels, metrics  # noqa: E402
from cutesdr_tpu_torch.demod import fm, sam  # noqa: E402
from cutesdr_tpu_torch.design.decimation_plan import (  # noqa: E402
    plan_decimation)
from cutesdr_tpu_torch.design.fastfir_design import (  # noqa: E402
    design_fastfir)
from cutesdr_tpu_torch.design.latency import latency_report  # noqa: E402
from cutesdr_tpu_torch.io.audio_sink import RateLockedQueue  # noqa: E402
from cutesdr_tpu_torch.kernels import (  # noqa: E402
    _build, agcseq, fastfir, mixdec, resamp, scan, seqloop)
from cutesdr_tpu_torch.ops import (  # noqa: E402
    agc, decimator, nco, noiseblanker, resampler)
from cutesdr_tpu_torch.ops import fastfir as ff_ops  # noqa: E402
from cutesdr_tpu_torch.ops.util import (  # noqa: E402
    distance_since_last_true, first_order_recurrence, max_affine_recurrence)
from cutesdr_tpu_torch.pipeline import receiver as rx  # noqa: E402
from cutesdr_tpu_torch.pipeline import spectrum, stepgraph  # noqa: E402
from cutesdr_tpu_torch.session import ReceiverSession  # noqa: E402
from cutesdr_tpu_torch.shard import channels  # noqa: E402

FIXDIR = os.path.join(ROOT, "tests", "fixtures")
N_IN = 8_388_608          # flagship input samples per step
N_DEMOD = 262_144         # decimated samples per step (256 frames of 1024)
SEED = 1234

KERNELS = {   # name -> (source, TPU kernel it replaces)
    "mixdec": ("cutesdr_tpu_torch/csrc/mixdec.cu",
               "cutesdr_tpu/kernels/mixdec.py:696"),
    # K1 over int16 planes: the same kernel with an int16 load stage
    "mixdec_int16": ("cutesdr_tpu_torch/csrc/mixdec.cu",
                     "cutesdr_tpu/kernels/mixdec.py:696"),
    "fastfir": ("cutesdr_tpu_torch/csrc/fastfir.cu",
                "cutesdr_tpu/kernels/fastfir4.py:238"),
    "fastfir_batch": ("cutesdr_tpu_torch/csrc/fastfir.cu",
                      "cutesdr_tpu/kernels/fastfir4.py:297"),
    "scan_plain": ("cutesdr_tpu_torch/csrc/scan.cu",
                   "cutesdr_tpu/kernels/scan1.py:137"),
    "scan_solve": ("cutesdr_tpu_torch/csrc/scan.cu",
                   "cutesdr_tpu/kernels/scan1.py:243"),
    "smeter": ("cutesdr_tpu_torch/csrc/smeter.cu",
               "cutesdr_tpu/kernels/scan1.py:398"),
    "seqloop_fm": ("cutesdr_tpu_torch/csrc/seqloop.cu",
                   "cutesdr_tpu/kernels/seqloop.py:164"),
    "seqloop_sam": ("cutesdr_tpu_torch/csrc/seqloop.cu",
                    "cutesdr_tpu/kernels/seqloop.py:235"),
    "resamp": ("cutesdr_tpu_torch/csrc/resamp.cu",
               "cutesdr_tpu/kernels/resamp1.py:222"),
    # N1 has no Pallas counterpart: it replaces the recurrence JAX runs as
    # a lax.scan (ops/agc.py _averager_scan)
    "agcseq": ("cutesdr_tpu_torch/csrc/agcseq.cu",
               "cutesdr_tpu/ops/agc.py:134"),
    # N3h and N2 have none either: hang mode's decay solve (a
    # lax.while_loop of solves) and FM's biquad (a lax.associative_scan)
    "hang_solve": ("cutesdr_tpu_torch/csrc/scan.cu",
                   "cutesdr_tpu/ops/agc.py:256"),
    "biquad": ("cutesdr_tpu_torch/csrc/iir.cu",
               "cutesdr_tpu/ops/iir.py:52"),
}
# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
RESAMP_TOL = 2e-5         # x the block's peak: the two differ only in the
                          # order of the tap sum
SEQ_TOL = 1e-6            # rad: kernel and plain loop round alike
PLL_STEP_OPS = 20         # float32 operations of one PLL step (two wraps
                          # of five, the update, the clamp, three sums)
# which outputs of the seqloop wrappers are angles (compared wrapped):
# FM (phase, freq, freqs, err), SAM (phase, freq, pre-update phases)
ANGLES = {"seqloop_fm": (True, False, False, True),
          "seqloop_sam": (True, False, True)}


def phase(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5, calls: int = 20) -> float:
    """Per-call time of fn(): the median over ``reps`` CUDA-event timings of
    ``calls`` back-to-back calls, after one warm-up.  Back to back, the
    card runs ahead of the host wherever a call's device work outlasts
    its host overhead; where it does not, the time is the host's."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def randn(n: int, gen: torch.Generator, scale: float = 1.0) -> torch.Tensor:
    return torch.randn(n, generator=gen, device="cuda") * scale


def max_err(name: str, got, want, tol: float) -> float:
    """Max abs error of a kernel's outputs against its plain version's;
    raises if it exceeds ``tol``."""
    err = float(max((g.double() - w.double()).abs().max().item()
                    for g, w in zip(got, want)))
    if not err <= tol:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{err:.3e} > {tol:.3e}")
    return err


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take for work that moves ``nbytes``
    (each input read once, each output written once) and does ``ops``
    float32 operations: the larger of the two over the card's peaks."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / F32_OPS_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fir_library(h_freq: torch.Tensor, z: torch.Tensor, ntaps: int):
    """One PyTorch call that computes the overlap-save filter's function:
    a complex ``conv1d`` with the filter's time-domain taps (the inverse
    transform of H, which holds 1/NFFT), one group per channel of a bank;
    float32 without TF32.  Used only as a yardstick."""
    nfft = h_freq.shape[-1]
    taps = (torch.fft.ifft(h_freq) * nfft)[..., :ntaps].flip(-1)
    weight = taps.reshape(-1, 1, ntaps).contiguous()
    inp = z.reshape(1, -1, z.shape[-1])

    def run():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return torch.nn.functional.conv1d(
                inp, weight, groups=weight.shape[0]).reshape(
                    z.shape[:-1] + (-1,))
    return run


def library_time(label: str, fn, want) -> float | None:
    """ms of a library call (median as ``time_ms``) and its max abs
    difference from the kernel's result; None where PyTorch cannot run
    it on this card."""
    try:
        got = fn()
    except (RuntimeError, NotImplementedError) as e:
        phase(f"  library call for {label} not run: {str(e)[:120]}")
        return None
    diff = float((got - want).abs().max())
    ms = time_ms(fn)
    phase(f"  library call for {label}: {ms:.4f} ms, max abs difference "
          f"from the kernel {diff:.3e}")
    return ms


def compare(name: str, got, want, tol: float, results: dict,
            kernel_fn, plain_fn, label: str = "", work=None,
            library=None) -> None:
    """Check a kernel against its plain version and time both (the
    kernel's call time back to back and its own device time per call);
    for the main shape (no ``label``) also record its bound from ``work``
    = (bytes, operations) and the time of ``library`` = (one PyTorch call
    computing the same function, the kernel's result), or None."""
    err = max_err(name + label, got, want, tol)
    warm_up(kernel_fn)
    ms, (dev, dev_by) = time_ms(kernel_fn), device_ms(kernel_fn)
    plain_ms = time_ms(plain_fn)
    b = bound(*work) if work else {}
    phase(f"kernel {name}{label}: max_abs_err {err:.3e} (tol {tol:.3e}) "
          f"kernel {ms:.4f} ms (device {dev:.4f} ms, {dev_by})  plain "
          f"{plain_ms:.4f} ms"
          + (f"  bound {b['bound_ms']:.4f} ms ({b['bound_by']})" if b
             else ""))
    lib = library_time(name + label, *library) if library else None
    if not label:
        results[name] = {"max_abs_err": err, "ms": ms, "device_ms": dev,
                         "device_by": dev_by, "plain_ms": plain_ms, **b,
                         "library_ms": lib}


def mixdec_planes(gen, n: int, layout: str):
    """re, im planes of n samples: views of one complex tensor ("iq", as
    the receiver passes them: the kernel's float2 path), every third
    float of one buffer ("strided": the general-stride path), or int16
    planes ("int16": the radio's wire planes, K1's int16 route;
    "int16 unaligned": the same starting one sample past a 4-byte
    boundary, so no pair is staged as one word)."""
    if layout == "iq":
        x = torch.complex(randn(n, gen, 1000.0), randn(n, gen, 1000.0))
        return x.real, x.imag
    if layout.startswith("int16"):
        skip = 1 if layout == "int16 unaligned" else 0
        return tuple(wire_plane(n + skip, gen)[skip:] for _ in range(2))
    buf = randn(3 * n, gen, 1000.0)
    return buf[0::3], buf[1::3]


def wire_plane(shape, gen) -> torch.Tensor:
    """An int16 plane of whole values, +-1000 RMS."""
    return torch.round(torch.randn(shape, generator=gen, device="cuda")
                       * 1000.0).to(torch.int16)


def hold_wire_route(label: str, run_wire, run_float, gpu_label: str) -> None:
    """K1 on int16 planes (``run_wire``) bitwise K1's float2 route on the
    same planes cast to float32 (``run_float``), carry included; then both
    routes' device ms a call, in turns (float, int16, int16, float)."""
    (cw, yw), (cf, yf) = run_wire(), run_float()
    torch.cuda.synchronize()
    if not (same_bits(yw, yf) and same_bits(cw.raw_tail, cf.raw_tail)
            and torch.equal(cw.phase, cf.phase)):
        raise AssertionError(f"mixdec int16{label}: not bitwise the float2 "
                             "route on the cast planes")
    warm_up(run_wire)
    turns = [device_ms(f)[0] for f in (run_float, run_wire, run_wire,
                                        run_float)]
    phase(f"kernel mixdec int16{label}: bitwise the float2 route on the "
          f"cast planes; device ms a call in turns (float2, int16, int16, "
          f"float2) {[round(t, 5) for t in turns]} ({gpu_label})")


def held_tail(carry, recent: torch.Tensor) -> torch.Tensor:
    """A mixdec carry's raw tail whose trailing samples, the L-1-d the sum
    reads, are ``recent`` ([t] or [C, t]), zeros before them (the history
    a longer plan would read; the draws stay those of a tail of t)."""
    pad = carry.raw_tail.shape[-1] - recent.shape[-1]
    return torch.cat([recent.new_zeros(recent.shape[:-1] + (pad,)), recent],
                     -1)


def check_mixdec(gen, results, input_rate, label, n=N_IN, layout="iq",
                 gpu_label=""):
    """K1 on one stream of n samples at the plan for ``input_rate``; on
    int16 planes also bitwise its float2 route on the cast planes, both
    timed in turns (``hold_wire_route``)."""
    plan = plan_decimation(input_rate, 20_000.0)
    params, carry = mixdec.init(plan, input_rate / 17.0, "cuda")
    t = decimator.tail_length(plan)
    carry = carry._replace(
        raw_tail=held_tail(carry, torch.complex(randn(t, gen, 1000.0),
                                                randn(t, gen, 1000.0))),
        phase=torch.tensor(2**32 - 12345, dtype=torch.int64, device="cuda"))
    re, im = mixdec_planes(gen, n, layout)
    dc = torch.tensor(0.37 - 0.21j, dtype=torch.complex64, device="cuda")
    run_k = lambda: mixdec.process_planes(plan, params, carry, re, im, dc)
    run_p = lambda: mixdec.process_planes_plain(plan, params, carry, re, im,
                                                dc)
    (ck, yk), (cp, yp) = run_k(), run_p()
    torch.cuda.synchronize()
    if not (torch.equal(ck.raw_tail, cp.raw_tail)
            and int(ck.phase) == int(cp.phase)):
        raise AssertionError("mixdec carries differ")
    scale = float(yp.abs().max())
    D, L = plan.decimation, len(params.h_eq)
    # bytes: the two input planes, tail, taps, output; operations: the DC
    # cal (2), oscillator phase and sincos (counted 2) and complex mix (6)
    # per input sample, a complex-by-real tap (4) per tap and output
    wire = layout.startswith("int16")
    work = ((4 if wire else 8) * n + 8 * t + 4 * L + 8 * n // D,
            10 * n + 4 * L * n // D)
    compare("mixdec_int16" if wire else "mixdec", [yk.real, yk.imag],
            [yp.real, yp.imag], 5e-5 * scale, results, run_k, run_p, label,
            work=work)
    if wire:
        x = torch.complex(re.float(), im.float())
        hold_wire_route(label, run_k, lambda: mixdec.process_planes(
            plan, params, carry, x.real, x.imag, dc), gpu_label)
    lp = mixdec.launch_plan(n // D, 1, D, L, _build.sm_count(re.device))
    phase(f"  (D={D}, {L} taps, {n} samples, {layout} planes; "
          f"{lp.n_tiles} blocks of {lp.tile_out} outputs, {lp.threads} "
          f"threads, {lp.smem_bytes} B shared)")


def check_fastfir(gen, results):
    """K2 at the flagship's 256 frames and the session's one frame."""
    h = design_fastfir(100.0, 2800.0, 0.0, 62_500.0)
    hf = torch.from_numpy(h.astype(np.complex64)).cuda()
    for frames in (N_DEMOD // 1024, 1):
        z = torch.complex(randn(1024 + 1024 * frames, gen, 100.0),
                          randn(1024 + 1024 * frames, gen, 100.0))
        run_k = lambda: fastfir.filter_frames(hf, z, 1025)
        run_p = lambda: fastfir.filter_frames_plain(hf, z, 1025)
        yk, yp = run_k(), run_p()
        scale = float(yp.abs().max())
        compare("fastfir", [yk.real, yk.imag], [yp.real, yp.imag],
                5e-5 * scale, results, run_k, run_p,
                "" if frames > 1 else " 1 frame",
                work=fastfir_work(1, frames),
                library=(fir_library(hf, z, 1025), yk))


def fastfir_work(n_ch: int, frames: int, nfft: int = 2048,
                 ntaps: int = 1025) -> tuple[float, float]:
    """(bytes, operations) of the overlap-save filter: history + block in,
    H, block out (complex64); two radix-2 FFTs (5 N log2 N each) and the
    complex product per frame."""
    n = frames * (nfft - ntaps + 1)
    nbytes = n_ch * 8 * ((ntaps - 1 + n) + nfft + n)
    ops = n_ch * frames * (10 * nfft * int(np.log2(nfft)) + 6 * nfft)
    return nbytes, ops


def check_fastfir_batch(gen, results):
    """K6 with a distinct H per channel: 64 channels of one frame (the
    config-4 bank's step) and 4 channels of 256 frames."""
    for n_ch, frames in ((64, 1), (4, 256)):
        hs = [design_fastfir(100.0 + 10.0 * c, 2800.0 - 15.0 * c, 0.0,
                             78_125.0) for c in range(n_ch)]
        hf = torch.from_numpy(np.stack(hs).astype(np.complex64)).cuda()
        z = torch.complex(randn(n_ch * (1024 + 1024 * frames), gen, 100.0),
                          randn(n_ch * (1024 + 1024 * frames), gen, 100.0)
                          ).reshape(n_ch, -1)
        run_k = lambda: fastfir.filter_frames_batch(hf, z, 1025)
        run_p = lambda: fastfir.filter_frames_plain(hf, z, 1025)
        yk, yp = run_k(), run_p()
        scale = float(yp.abs().max())
        compare("fastfir_batch", [yk.real, yk.imag], [yp.real, yp.imag],
                5e-5 * scale, results, run_k, run_p,
                "" if frames == 1 else f" {n_ch}x{frames}",
                work=fastfir_work(n_ch, frames),
                library=(fir_library(hf, z, 1025), yk))
        phase(f"  ({n_ch} channels x {frames} frames, 2048/1025)")


def check_mixdec_bank(gen, wire: bool = False, gpu_label: str = ""):
    """K1 with its channel axis: 64 channels at D = 128 over one shared
    131,072-sample block (the config-4 bank), and 2 stacked channels at
    D = 32 (the stacked path's 8,388,608 samples each); each channel with
    its own increment, phase (near the wrap), raw tail and DC cal.  With
    ``wire`` over int16 planes, also bitwise the float2 route on the cast
    planes (``hold_wire_route``)."""
    for input_rate, n_ch, n, shared in ((10e6, 64, 131_072, True),
                                         (2e6, 2, N_IN, False)):
        plan = plan_decimation(input_rate, 20_000.0)
        params, carry = mixdec.init(plan, 0.0, "cuda")
        t = decimator.tail_length(plan)
        params = params._replace(phase_inc=torch.tensor(
            [nco.phase_increment(-input_rate * (0.45 - 0.014 * c),
                                 input_rate) for c in range(n_ch)],
            dtype=torch.int64, device="cuda"))
        carry = mixdec.MixDecCarry(
            raw_tail=held_tail(carry, torch.complex(
                randn(n_ch * t, gen, 1000.0),
                randn(n_ch * t, gen, 1000.0)).reshape(n_ch, t)),
            phase=2**32 - 12345 * torch.arange(1, n_ch + 1, device="cuda"))
        dc = torch.complex(randn(n_ch, gen), randn(n_ch, gen))
        rows = n if shared else n_ch * n
        if wire:
            re, im = (wire_plane(rows, gen) for _ in range(2))
            x = torch.complex(re.float(), im.float())
        else:
            x = torch.complex(randn(rows, gen, 1000.0),
                              randn(rows, gen, 1000.0))
        x = x if shared else x.reshape(n_ch, n)
        if not wire:
            re, im = x.real, x.imag
        elif not shared:
            re, im = re.reshape(n_ch, n), im.reshape(n_ch, n)
        run_k = lambda: mixdec.process_planes(plan, params, carry, re, im,
                                              dc)
        run_p = lambda: mixdec.process_planes_plain(plan, params, carry,
                                                    re, im, dc)
        (ck, yk), (cp, yp) = run_k(), run_p()
        torch.cuda.synchronize()
        if not (torch.equal(ck.raw_tail, cp.raw_tail)
                and torch.equal(ck.phase, cp.phase)):
            raise AssertionError("mixdec bank carries differ")
        label = (f" {n_ch} channels {'shared' if shared else 'stacked'} "
                 f"D={plan.decimation}")
        compare("mixdec_int16" if wire else "mixdec", [yk.real, yk.imag],
                [yp.real, yp.imag], 5e-5 * float(yp.abs().max()), {}, run_k,
                run_p, label)
        if wire:
            hold_wire_route(label, run_k, lambda: mixdec.process_planes(
                plan, params, carry, x.real, x.imag, dc), gpu_label)


def check_seqloops_bank(gen):
    """K7 and K8 over C = 8 streams in one launch, each stream with its
    own initial state: 1,024 samples, and 256 + 256 chained from the
    first call's returned states; bitwise against the plain loops run on
    [8] tensors."""
    fm_p, _ = fm.init(62_500.0, "cuda")
    sam_p, _ = sam.init(31_250.0, "cuda")
    phase0 = torch.rand(8, generator=gen, device="cuda") * 6.0 - 3.0
    freq0 = randn(8, gen, 0.01)
    loops = {"seqloop_fm": (fm_p, seqloop.fm_pll_scan,
                            seqloop.fm_pll_scan_plain),
             "seqloop_sam": (sam_p, seqloop.sam_pll_scan,
                             seqloop.sam_pll_scan_plain)}
    for name, (p, kernel, plain) in loops.items():
        th = ((torch.rand(8 * 1024, generator=gen, device="cuda") * 2 - 1)
              * np.pi).reshape(8, 1024)
        args = (p.pll_alpha, p.pll_beta, p.nco_limit, phase0, freq0)
        run_k = lambda: kernel(*args, th)
        run_p = lambda: plain(*args, th)
        err, unequal = seq_err(name, run_k(), run_p())
        ms, plain_ms = time_ms(run_k), time_ms(run_p, reps=3, calls=1)
        phase(f"kernel {name} 8 streams x 1024 noise: max_abs_err {err:.3e}, "
              f"{unequal} values not bitwise equal, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.1f} ms")
        th = th[:, :512].contiguous()
        err, unequal_chained = seq_err(
            name, chained(kernel, p, phase0, freq0, th, 256),
            chained(plain, p, phase0, freq0, th, 256))
        phase(f"kernel {name} 8 streams x 256+256 chained: max_abs_err "
              f"{err:.3e}, {unequal_chained} values not bitwise equal")
        if unequal or unequal_chained:
            raise AssertionError(f"{name}: the bank kernel is not bitwise "
                                 "equal to its plain loop")


def torch_chunked_flag(p, phase0, freq0, th, halo: int):
    """The flag of FM's chunked tier in torch (``fm._pll_chunked``) at any
    halo, per stream of th, over its whole 128-sample chunks."""
    _, c = fm.init(62_500.0, "cuda")
    c = c._replace(nco_phase=torch.as_tensor(phase0, device="cuda"),
                   nco_freq=torch.as_tensor(freq0, device="cuda"))
    n = th.shape[-1] // fm.PLL_CHUNK * fm.PLL_CHUNK
    return fm._pll_chunked(p, c, th[..., :n].contiguous(), halo)[0]


def seq_theta(kind: str, n: int, fs: float, gen, offset_hz: float = 150.0):
    """Seeded noise, a tone ``offset_hz`` off the NCO, or an acquisition
    block (noise, then the tone from 37 samples past the middle)."""
    noise = pll_theta("noise", n, fs, offset_hz, gen)
    if kind == "noise":
        return noise
    tone = pll_theta("tone", n, fs, offset_hz, gen)
    if kind == "tone":
        return tone
    k = torch.arange(n, device="cuda")
    return torch.where(k < n // 2 + 37, noise, tone)


def check_seqloop_redesign(gen, results):
    """The redesigned K7 and K8, bitwise against the plain loops: K7 with
    forced repairs (a 1-sample halo on noise at 250 kHz, whose repair
    walks stop mid-stream, also with the stager warp sleeping
    4 us after every group's barrier, so that each stop reaches a stager
    far behind the walker; a 3 Hz tone, whose chunks almost never
    bit-sync, at 62.5 kHz), on an acquisition
    block, and banks of 4 and 64 streams of both kernels (noise, tone and
    acquisition streams, each with its own start state); K7's flag
    against the torch chunked tier's at the same halo.  Then cycles a
    sample of one stream's walk from the kernels' clock64() probe, with
    the magic-constant round and with rintf."""
    fm62, _ = fm.init(62_500.0, "cuda")
    fm250, _ = fm.init(250_000.0, "cuda")
    sam31, _ = sam.init(31_250.0, "cuda")
    noise250 = seq_theta("noise", 8192, 250e3, gen)
    cases = [("forced repair, halo 1, noise 250 kHz", fm250, noise250, 1,
              False, 0),
             ("forced repair, 3 Hz tone", fm62,
              seq_theta("tone", 8192, 62.5e3, gen, 3.0), 128, False, 0),
             ("acquisition", fm62, seq_theta("acq", 8192, 62.5e3, gen), 128,
              None, 0),
             ("forced repair, halo 1, noise 250 kHz, stager 4 us late",
              fm250, noise250, 1, False, 4000)]
    phase0 = torch.tensor(0.5, device="cuda")
    freq0 = torch.tensor(0.0, device="cuda")
    for label, p, th, halo, flag_want, stager_ns in cases:
        args = (p.pll_alpha, p.pll_beta, p.nco_limit, phase0, freq0)
        valid, *got = seqloop.fm_pll_chunked(*args, th, halo, stager_ns)
        err, unequal = seq_err("seqloop_fm", got,
                               seqloop.fm_pll_scan_plain(*args, th))
        flag = bool(torch_chunked_flag(p, phase0, freq0, th, halo))
        phase(f"kernel seqloop_fm {label} n={th.numel()}: max_abs_err "
              f"{err:.3e}, {unequal} values not bitwise equal, flag "
              f"{bool(valid)} (torch chunked tier {flag})")
        if unequal or bool(valid) != flag or (
                flag_want is not None and flag != flag_want):
            raise AssertionError(f"seqloop_fm {label}: not the loop, or the "
                                 "flag differs from the torch chunked tier")
    kinds = ("noise", "tone", "acq")
    for c in (4, 64):
        for name, p, fs, kernel, plain in (
                ("seqloop_fm", fm62, 62.5e3, seqloop.fm_pll_chunked,
                 seqloop.fm_pll_scan_plain),
                ("seqloop_sam", sam31, 31.25e3, seqloop.sam_pll_scan,
                 seqloop.sam_pll_scan_plain)):
            th = torch.stack([seq_theta(kinds[i % 3], 2048, fs, gen)
                              for i in range(c)])
            ph0 = torch.rand(c, generator=gen, device="cuda") * 6.0 - 3.0
            fr0 = randn(c, gen, 0.01)
            args = (p.pll_alpha, p.pll_beta, p.nco_limit, ph0, fr0)
            got = kernel(*args, th)
            if name == "seqloop_fm":
                flags, got = got[0], got[1:]
                if not torch.equal(flags, torch_chunked_flag(p, ph0, fr0, th,
                                                             128)):
                    raise AssertionError(f"K7 bank of {c}: flags differ from "
                                         "the torch chunked tier's")
            err, unequal = seq_err(name, got, plain(*args, th))
            phase(f"kernel {name} bank {c} x 2048 (noise, tone, acquisition):"
                  f" max_abs_err {err:.3e}, {unequal} values not bitwise "
                  "equal")
            if unequal:
                raise AssertionError(f"{name} bank of {c}: not bitwise the "
                                     "plain loop")
    for name, kind, p, fs in (("seqloop_fm", "fm", fm62, 62.5e3),
                              ("seqloop_sam", "sam", sam31, 31.25e3)):
        th = seq_theta("noise", 32_768, fs, gen)
        cyc = {fast: seqloop.chain_cycles(kind, p.pll_alpha, p.pll_beta,
                                          p.nco_limit, th, fast)
               for fast in (True, False)}
        results[name]["cycles_per_sample"] = cyc[True][0]
        results[name]["step_cycles"] = cyc[True][1]
        results[name]["cycles_per_sample_rintf"] = cyc[False][0]
        phase(f"kernel {name} walk: {cyc[True][0]:.1f} cycles a sample "
              f"(clock64, one lane, fast wrap; the steps alone "
              f"{cyc[True][1]:.1f}), {cyc[False][0]:.1f} with the plain "
              f"wrap (steps {cyc[False][1]:.1f})")


EPS32 = float(np.finfo(np.float32).eps)


def float64_bar(label: str, got, plain, exact) -> tuple[float, float, float]:
    """The scans' bar against the float64 solve ``exact`` of the same
    float32 inputs: the kernel's max error from it no worse than 1.5x the
    plain version's, or than 2 float32 ulps of the output's scale where
    the plain version is closer still.  Returns (kernel error, plain
    error, the tolerance of kernel against plain: the bar plus the plain
    version's own error); raises if the kernel misses the bar."""
    err_k = float((got.double() - exact).abs().max())
    err_p = float((plain.double() - exact).abs().max())
    bar = max(1.5 * err_p, 2 * EPS32 * float(exact.abs().max()))
    phase(f"  {label}: from the float64 solve kernel {err_k:.3e}, plain "
          f"{err_p:.3e} (bar {bar:.3e})")
    if not err_k <= bar:
        raise AssertionError(f"{label}: the kernel is {err_k:.3e} from the "
                             f"float64 solve, above its bar {bar:.3e}")
    return err_k, err_p, bar + err_p


def check_scans(gen, results, gen_new):
    """K3 (the affine scan) and K5 (the S-meter's final values), each one
    launch, against their plain versions and the float64 solve of the
    same float32 inputs (``float64_bar``): K3 at 262,144 with per-sample
    a, 262,144 through ``scan.ema`` with FM's DC-tracker alpha (a scalar
    a, B = alpha*x formed in the kernel), and 8 x 256 rows with per-row
    initial states; K5 at 262,144, 262,143 (a partial last chunk), 1,024
    (the session's block, one chunk: no look-back) and 64 x 1,024 (the
    bank's rows).  The K4 round check keeps its inputs from ``gen``; the
    new cases draw from ``gen_new``."""
    n = N_DEMOD
    a = 0.99 + 0.005 * torch.rand(n, generator=gen, device="cuda")
    b = randn(n, gen, 0.01)
    x0 = torch.tensor(-3.0, device="cuda")
    run_k = lambda: scan.first_order_scan(a, b, x0)
    run_p = lambda: scan.first_order_scan_plain(a, b, x0)
    exact = first_order_recurrence(a.double(), b.double(), x0.double())
    _, _, tol = float64_bar("scan_plain", run_k(), run_p(), exact)
    # bytes: a, b in, x out; operations: one multiply-add a sample
    compare("scan_plain", [run_k()], [run_p()], tol, results, run_k, run_p,
            work=(12 * n, 2 * n))

    pk = randn(n, gen, 0.3) - 3.0
    pat = torch.rand(n, generator=gen, device="cuda") > 0.5
    ra, fa = np.float32(1 / 125.0), np.float32(1 / 312.0)
    run_k = lambda: scan.guess_round(pk, pat, x0, ra, fa)
    run_p = lambda: scan.guess_round_plain(pk, pat, x0, ra, fa)
    (xk, npk, ck), (xp, npp, cp) = run_k(), run_p()
    n_flip = int((npk != npp).sum())
    if n_flip > 4 or abs(int(ck) - int(cp)) > 4:
        raise AssertionError(f"scan_solve one round: pattern/count differ: "
                             f"{n_flip} flips, count {int(ck)} vs {int(cp)}")
    compare("scan_solve", [xk], [xp], 1e-5, results, run_k, run_p,
            " one round")

    mag = randn(n, gen, 10.0) - 60.0
    aa, ad = np.float32(1 / 625.0), np.float32(1 / 31250.0)
    a0 = torch.tensor(-120.0, device="cuda")
    check_smeter(mag, aa, ad, a0, a0, results, "")

    # K3: a scalar a, through the EMA (FM's DC tracker at 62.5 kHz), and
    # rows with their own initial states
    alpha = fm.init(62_500.0, "cuda")[0].dc_alpha
    x = randn(n, gen_new, 0.05)
    xs0 = torch.tensor(0.01, device="cuda")
    run_k = lambda: scan.ema(alpha, x, xs0)
    run_p = lambda: scan.ema_plain(alpha, x, xs0)
    c = float(torch.as_tensor(1.0 - alpha, dtype=torch.float32))
    exact = first_order_recurrence(c, (x * alpha).double(), xs0.double())
    _, _, tol = float64_bar("scan_plain ema", run_k(), run_p(), exact)
    compare("scan_plain", [run_k()], [run_p()], tol, results, run_k, run_p,
            " ema (scalar a)", work=(8 * n, 3 * n))
    a = 0.99 + 0.005 * torch.rand(8, 256, generator=gen_new, device="cuda")
    b = randn(8 * 256, gen_new, 0.01).reshape(8, 256)
    rows0 = randn(8, gen_new)
    run_k = lambda: scan.first_order_scan(a, b, rows0)
    run_p = lambda: scan.first_order_scan_plain(a, b, rows0)
    exact = first_order_recurrence(a.double(), b.double(), rows0.double())
    _, _, tol = float64_bar("scan_plain 8x256", run_k(), run_p(), exact)
    compare("scan_plain", [run_k()], [run_p()], tol, results, run_k, run_p,
            " 8x256 rows", work=(12 * 8 * 256, 2 * 8 * 256))

    for label, shape in ((" 262,143", (n - 1,)), (" 1,024", (1024,)),
                         (" 64x1,024", (64, 1024))):
        mag = (randn(int(np.prod(shape)), gen_new, 10.0) - 60.0).reshape(
            shape)
        lead = shape[:-1]
        s0 = (randn(64, gen_new, 5.0) - 100.0 if lead
              else torch.tensor(-120.0, device="cuda"))
        check_smeter(mag, aa, ad, s0, s0 + 3.0, results, label)


def smeter_tol(mag, aa, ad, a0, d0, label) -> tuple:
    """K5 and its plain version on ``mag`` ([n] or [C, n]), each held to
    the float64 solve of the same float32 magnitudes and alphas: (kernel
    call, plain call, kernel outputs, plain outputs, tolerance of kernel
    against plain)."""
    run_k = lambda: scan.smeter_last(mag, aa, ad, a0, d0)
    run_p = lambda: scan.smeter_last_plain(mag, aa, ad, a0, d0)
    ca = float(torch.as_tensor(1.0 - aa, dtype=torch.float32))
    a64 = first_order_recurrence(ca, (mag * aa).double(), a0.double())
    d64 = max_affine_recurrence(float(np.float32(1.0) - ad),
                                (mag * ad).double(), a64, d0.double())
    (ak, dk), (ap, dp) = run_k(), run_p()
    tol = max(float64_bar(f"smeter{label} {k}", g, p, e[..., -1])[2]
              for k, g, p, e in (("attack", ak, ap, a64),
                                 ("decay", dk, dp, d64)))
    return run_k, run_p, [ak, dk], [ap, dp], tol


def check_smeter(mag, aa, ad, a0, d0, results, label):
    """K5 on ``mag`` against its plain version and the float64 solve."""
    run_k, run_p, got, want, tol = smeter_tol(mag, aa, ad, a0, d0, label)
    # bytes: the magnitudes in; operations: two averager updates and the
    # snap a sample
    compare("smeter", got, want, tol, results, run_k, run_p, label,
            work=(4 * mag.numel(), 5 * mag.numel()))


def check_agcseq(gen, results):
    """N1 (the AGC's sequential averagers) against its plain per-sample
    loop, to the bit: 4,096 samples of window peaks under a stepping
    envelope, two-rate and hang mode, 1 and 64 streams with their own
    carries; then the flagship's 262,144 samples (two-rate, bitwise
    again, the plain loop timed once), with the kernel's time there in
    both modes taken before any plain loop runs."""
    fs = 62_500.0

    def args(peak, hang):
        p = agc.make_params(agc.AgcConfig(True, hang, fs), -100.0, 30.0, 0.0,
                            200.0)
        lead = peak.shape[:-1]
        k = torch.arange(int(np.prod(lead)), device="cuda").reshape(lead)
        return (peak, -5.0 + 0.25 * k.float(), -4.0 + 0.5 * k.float(),
                (k * 97 % max(p.hang_time, 1)).to(torch.int32),
                (p.attack_rise_alpha, p.attack_fall_alpha),
                (p.decay_rise_alpha, p.decay_fall_alpha),
                p.hang_time if hang else None)

    def bitwise(label, a):
        got, want = agcseq.averager_scan(*a), agcseq.averager_scan_plain(*a)
        unequal = sum(int((g != w).sum()) for g, w in zip(got, want))
        phase(f"kernel agcseq {label}: {unequal} values not bitwise equal")
        if unequal:
            raise AssertionError(f"agcseq {label}: the kernel is not bitwise "
                                 "equal to its plain loop")

    small = []
    for n_ch in (1, 64):
        peak = torch.stack([envelope_peak(gen, 4096) for _ in range(n_ch)])
        small.append((n_ch, peak[0] if n_ch == 1 else peak))
    peak = envelope_peak(gen, N_DEMOD)
    # the kernel's times first: after the plain loops' hundreds of
    # thousands of small launches the profiler loses kernel records
    timed = {}
    for hang in (False, True):
        a = args(peak, hang)
        run_k = lambda: agcseq.averager_scan(*a)
        warm_up(run_k)
        timed[hang] = time_ms(run_k, reps=3, calls=5), device_ms(run_k)
    for n_ch, pk in small:
        for hang in (False, True):
            bitwise(f"{n_ch} x 4096 {'hang' if hang else 'two-rate'}",
                    args(pk, hang))
    a = args(peak, False)
    out = []
    plain_ms = time_once(lambda: out.append(agcseq.averager_scan_plain(*a)))
    got = agcseq.averager_scan(*a)
    if not all(torch.equal(g, w) for g, w in zip(got, out[0])):
        raise AssertionError("agcseq 262,144: not bitwise equal")
    for hang, (ms, (dev, dev_by)) in timed.items():
        phase(f"kernel agcseq 1 x {N_DEMOD} {'hang' if hang else 'two-rate'}"
              f": kernel {ms:.4f} ms (device {dev:.4f} ms, {dev_by}), plain "
              f"{plain_ms:.1f} ms (two-rate, 1 call, bitwise equal)")
    ms, (dev, dev_by) = timed[False]
    # bytes: the peaks in, the series out; operations: two averager steps
    # (compare, multiply, multiply, add) and the max
    results["agcseq"] = {"max_abs_err": 0.0, "ms": ms, "device_ms": dev,
                         "device_by": dev_by, "plain_ms": plain_ms,
                         **bound(8 * N_DEMOD, 9 * N_DEMOD),
                         "library_ms": None}


def check_skips(gen):
    """The device-decided forms of N1, K7 and K8 (the flag they read
    themselves; the receiver's step replays as a CUDA graph through
    them), each against its plain version with the same flag: set, the
    kernel leaves ``out`` as it was (K7's flag 0) and N1 counts nothing;
    clear, the kernel writes what its plain version returns over ``out``
    and N1 counts one run.  4,096 samples: window peaks under a stepping
    envelope (both AGC modes), PLL phases of noise at 62.5 kHz."""
    fs = 62_500.0
    peak = envelope_peak(gen, 4096)
    theta = pll_theta("noise", 4096, fs, 150.0, gen)
    fm_p, _ = fm.init(fs, "cuda")
    sam_p, _ = sam.init(fs, "cuda")
    zero = torch.zeros((), device="cuda")
    sentinel = lambda t: torch.full_like(t, 7)
    for flag in (True, False):
        skip = torch.tensor(flag, device="cuda")
        for hang in (False, True):
            p = agc.make_params(agc.AgcConfig(True, hang, fs), -100.0, 30.0,
                                0.0, 200.0)
            timer0 = torch.zeros((), dtype=torch.int32, device="cuda")
            a = (peak, zero - 5.0, zero - 4.0, timer0,
                 (p.attack_rise_alpha, p.attack_fall_alpha),
                 (p.decay_rise_alpha, p.decay_fall_alpha),
                 p.hang_time if hang else None)
            runs = []
            for fn in (agcseq.averager_scan, agcseq.averager_scan_plain):
                out = (sentinel(zero), sentinel(zero),
                       sentinel(timer0) if hang else timer0,
                       sentinel(peak))
                count = torch.zeros((), dtype=torch.int32, device="cuda")
                runs.append((fn(*a, out=out, skip=skip, count=count), count))
            (got, nk), (want, np_) = runs
            if not (all(torch.equal(g, w) for g, w in zip(got, want))
                    and int(nk) == int(np_) == (not flag)):
                raise AssertionError(f"agcseq skip={flag} hang={hang}: the "
                                     "kernel differs from its plain form")
        for name, p, fn, plain, series in (
                ("seqloop_fm", fm_p, seqloop.fm_pll_chunked,
                 seqloop.fm_pll_chunked_plain, 2),
                ("seqloop_sam", sam_p, seqloop.sam_pll_scan,
                 seqloop.sam_pll_scan_plain, 1)):
            a = (p.pll_alpha, p.pll_beta, p.nco_limit, 0.5, 0.001, theta)
            runs = []
            for f in (fn, plain):
                out = (sentinel(zero), sentinel(zero),
                       *(sentinel(theta) for _ in range(series)))
                runs.append(f(*a, skip=skip, out=out))
            got, want = runs
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name} skip={flag}: the kernel "
                                     "differs from its plain form")
        phase(f"kernel agcseq, seqloop_fm, seqloop_sam with the skip flag "
              f"{'set' if flag else 'clear'}: bitwise their plain forms "
              "(4,096 samples)")


def flagship_agc_inputs(gen) -> list[tuple]:
    """The two-rate averagers' inputs of a flagship USB block after one
    warm block: (peak, x0, rise, fall, n_iters) of each solve the AGC
    launches, recorded at the solve's entry (the eager step, which a
    graphed receiver replays)."""
    cfg = rx.ReceiverConfig(mode="usb", input_rate=2e6, tune_freq=100e3,
                            frames_per_block=256)
    params, state = rx.init(cfg, "cuda")
    blocks = stimulus(cfg, 2, gen, carriers=({"offset_hz": 1000.0},))
    state, _ = rx.receiver_step(cfg, params, state, blocks[0])
    seen, real = [], scan.guess_verify_solve
    scan.guess_verify_solve = lambda *a, **k: seen.append(a) or real(*a, **k)
    try:
        rx.receiver_step(cfg, params, state, blocks[1])
    finally:
        scan.guess_verify_solve = real
    torch.cuda.synchronize()
    return seen


def envelope_peak(gen, n: int) -> torch.Tensor:
    """The AGC window peak of seeded noise under a stepping envelope (one
    level every 512 samples over 30 dB): a series whose averagers take
    several guess-verify rounds."""
    cfg = agc.AgcConfig(True, False, 62_500.0)
    env = 10.0 ** (1 + 3 * torch.rand(n // 512, generator=gen,
                                      device="cuda")).repeat_interleave(512)
    x = torch.complex(randn(n, gen), randn(n, gen)) * env
    return agc._prefix(cfg, agc.init_carry(cfg, "cuda"), x)[2]


def exact_solve(args, x: torch.Tensor) -> torch.Tensor:
    """The float64 solve of the two-rate averager with the branch pattern
    that the trajectory ``x`` induces (its converged pattern) and the
    float32 coefficients both versions use: the reference that shows
    each version's own float32 reassociation error."""
    peak, x0, rise, fall = args[:4]
    one = np.float32(1.0)
    pat = peak > scan.shift1(x, x0)
    A = torch.where(pat, float(one - rise), float(one - fall))
    B = torch.where(pat, float(rise), float(fall)).float() * peak
    return first_order_recurrence(A.double(), B.double(), x0.double())


def solve_errors(label: str, args) -> tuple:
    """The guess-verify solve kernel and its plain version on ``args``:
    the same ok, rounds within one, and the kernel no farther from the
    float64 solve of its pattern than the plain version is from its own,
    or 1e-5.  Returns (kernel x, plain x, kernel rounds, plain rounds,
    the plain version's distance from its float64 solve)."""
    (xk, okk, rk), (xp, okp, rp) = (scan.guess_verify_solve(*args),
                                    scan.guess_verify_solve_plain(*args))
    okk, rk, okp = bool(okk), int(rk), bool(okp)
    phase(f"  scan_solve{label}: ok {okk} (plain {okp}), rounds {rk} "
          f"(plain {rp})")
    if okk != okp or abs(rk - rp) > 1:
        raise AssertionError(f"scan_solve{label}: ok {okk} / {okp}, "
                             f"rounds {rk} / {rp}")
    err_k = float((xk.double() - exact_solve(args, xk)).abs().max())
    err_p = float((xp.double() - exact_solve(args, xp)).abs().max())
    phase(f"  scan_solve{label}: from the float64 solve of its pattern "
          f"kernel {err_k:.3e}, plain {err_p:.3e}")
    if err_k > max(err_p, 1e-5):
        raise AssertionError(f"scan_solve{label}: the kernel is "
                             f"{err_k:.3e} from the exact solve, the "
                             f"plain version {err_p:.3e}")
    return xk, xp, rk, rp, err_p


def check_guess_verify(gen, results):
    """The guess-verify solve (one launch: warm start and every round)
    against its plain version (the per-round loop): the flagship's two
    averagers on a real USB block, and a stepping envelope's attack
    averager, which takes several rounds; the same ok, rounds within one,
    x within 1e-5 decades of the plain version's x plus the plain
    version's own distance from the float64 solve of its pattern (the
    decay averager's 12,500-sample memory puts the plain log-depth solve
    ~8e-5 from it; the attack's, ~1.5e-6), and the kernel no farther
    from the float64 solve than that, or 1e-5.  With two rounds allowed
    the envelope does not converge, and the kernel must say so."""
    cases = [(f" flagship {'attack' if i == 0 else 'decay'}", a)
             for i, a in enumerate(flagship_agc_inputs(gen))]
    pk = envelope_peak(gen, N_DEMOD)
    p = agc.make_params(agc.AgcConfig(True, False, 62_500.0), -100.0, 30.0,
                        0.0, 200.0)
    env = (pk, torch.tensor(-5.0, device="cuda"), p.attack_rise_alpha,
           p.attack_fall_alpha, agc.GUESS_ITERS)
    cases.append((" envelope", env))
    if len(cases) != 3:
        raise AssertionError(f"the flagship block ran {len(cases) - 1} "
                             "guess-verify solves, not 2")
    for label, args in cases:
        run_k = lambda: scan.guess_verify_solve(*args)
        run_p = lambda: scan.guess_verify_solve_plain(*args)
        xk, xp, rk, rp, err_p = solve_errors(label, args)
        if label == " envelope" and rp < 3:
            raise AssertionError(f"the envelope took {rp} rounds, not >= 3")
        n = args[0].numel()
        # bytes: the peaks in, x out; operations: per round run the two
        # branch updates and their comparison a sample, and the warm start
        compare("scan_solve", [xk], [xp], 1e-5 + err_p, results, run_k,
                run_p, "" if label == " flagship attack" else label,
                work=(8 * n, 6 * n * (rk + 1)))
    x, ok, rounds = scan.guess_verify_solve(*env[:4], 2)
    phase(f"  scan_solve envelope, 2 rounds allowed: ok {bool(ok)}, rounds "
          f"{int(rounds)}")
    if bool(ok) or int(rounds) != 2:
        raise AssertionError("scan_solve: a solve cut at 2 rounds reported "
                             "convergence")


def check_guess_verify_small(gen):
    """The solve kernel at the small blocks that take it (every
    single-stream size): 256 samples (the CLI's 10 ms default at 2 and 20
    MSPS) and 1,024 (the session's block), both averagers over a
    10 -> 1,000 step of seeded noise: the same ok and rounds within one as
    the plain version, x no farther from the float64 solve of its pattern
    than 1.5x the plain version, or 2 ulps of the output's scale (the
    scans' bar: the kernel sums in another order)."""
    cfg = agc.AgcConfig(True, False, 62_500.0)
    p = agc.make_params(cfg, -100.0, 30.0, 0.0, 200.0)
    for n in (256, 1024):
        env = torch.where(torch.arange(n, device="cuda") < n // 2, 10.0,
                          1000.0)
        x = torch.complex(randn(n, gen), randn(n, gen)) * env
        pk = agc._prefix(cfg, agc.init_carry(cfg, "cuda"), x)[2]
        for name, rise, fall in (
                ("attack", p.attack_rise_alpha, p.attack_fall_alpha),
                ("decay", p.decay_rise_alpha, p.decay_fall_alpha)):
            args = (pk, torch.tensor(-5.0, device="cuda"), rise, fall,
                    agc.GUESS_ITERS)
            xk, okk, rk = scan.guess_verify_solve(*args)
            xp, okp, rp = scan.guess_verify_solve_plain(*args)
            okk, rk, okp = bool(okk), int(rk), bool(okp)
            err_k = float((xk.double() - exact_solve(args, xk)).abs().max())
            err_p = float((xp.double() - exact_solve(args, xp)).abs().max())
            phase(f"  scan_solve {n} {name}: ok {okk} (plain {okp}), rounds "
                  f"{rk} (plain {rp}), from the float64 solve kernel "
                  f"{err_k:.3e}, plain {err_p:.3e}")
            ulp = float(xp.abs().max()) * 2.0 ** -23
            if (okk != okp or abs(rk - rp) > 1
                    or err_k > max(1.5 * err_p, 2 * ulp)):
                raise AssertionError(f"scan_solve at {n} ({name}) disagrees "
                                     "with its plain version")


# ------------------------------------------- K4 rows, N3h, N2 (the banks) --

def per_row(fn, peak: torch.Tensor, x0, *rest) -> list:
    """``fn`` on each row of ``peak`` alone (with its own initial
    state(s)): the plain version's per-row results, since a bank's rows
    are independent streams, each frozen once it validates."""
    outs = []
    for c in range(peak.shape[0]):
        pick = lambda v: v[c] if isinstance(v, torch.Tensor) and v.dim() else v
        outs.append(fn(peak[c], pick(x0), *(pick(v) for v in rest)))
    return outs


def row_bits(label: str, kernel_rows, whole) -> None:
    """Each row of a bank launch bitwise that row's own launch."""
    bad = [c for c, (r, w) in enumerate(zip(kernel_rows, whole))
           if not same_bits(r, w)]
    if bad:
        raise AssertionError(f"{label}: rows {bad[:6]} of the bank launch "
                             "differ from their own launches")


def solve_rows_case(label: str, args, results=None, main: bool = False):
    """K4 over the rows of ``args[0]`` ([C, n]) against its plain version
    (the log-depth rounds the bank ran before, frozen rows and all): the
    same all-rows flag, the same per-row flags as each row alone, rounds
    within one, x within 1e-5 plus the plain version's own distance from
    the float64 solve of its pattern, the kernel no farther from its own
    than that or 1e-5; each row bitwise its own launch."""
    peak, x0, rise, fall, iters = args
    xk, row_ok, okk, rk = scan.guess_verify_solve_rows(*args)
    xp, okp, rp = scan.guess_verify_solve_plain(*args)
    okk, okp, rk = bool(okk), bool(okp), int(rk)
    alone = per_row(scan.guess_verify_solve_plain, peak, x0, rise, fall,
                    iters)
    want_rows = [bool(o) for _, o, _ in alone]
    got_rows = row_ok.tolist()
    singles = per_row(scan.guess_verify_solve, peak, x0, rise, fall, iters)
    row_bits(f"scan_solve{label}", list(xk), [x for x, _, _ in singles])
    err_k = float((xk.double() - exact_solve(args, xk)).abs().max())
    err_p = float((xp.double() - exact_solve(args, xp)).abs().max())
    phase(f"  scan_solve{label}: ok {okk} (plain {okp}), rows ok "
          f"{sum(got_rows)}/{len(got_rows)} (plain {sum(want_rows)}), "
          f"rounds {rk} (plain {rp}); from the float64 solve of its "
          f"pattern kernel {err_k:.3e}, plain {err_p:.3e}")
    # a solve cut before it converged is not the solve of its pattern:
    # there the flags decide (the fallback runs), not the distance
    if (okk != okp or got_rows != want_rows or abs(rk - rp) > 1
            or (okk and err_k > max(err_p, 1e-5))):
        raise AssertionError(f"scan_solve{label} disagrees with its plain "
                             "version")
    if results is not None:
        n = peak.numel()
        compare("scan_solve", [xk], [xp], 1e-5 + err_p, results,
                lambda: scan.guess_verify_solve(*args),
                lambda: scan.guess_verify_solve_plain(*args), label,
                work=(8 * n, 6 * n * (rk + 1)))


def check_solve_rows(gen):
    """K4 with a row axis (the banks' two-rate averagers): 64 x 1,024 (the
    64-channel bank's rows: a block a row, no grid barrier) and 4 x
    262,144 (rows of many chunks: the cooperative launch), both averagers
    of each, with the rows' own initial states; then each with one round
    allowed, where rows that cannot validate must say so (the bank's
    forced fallback)."""
    p = agc.make_params(agc.AgcConfig(True, False, 62_500.0), -100.0, 30.0,
                        0.0, 200.0)
    for rows, n in ((64, 1024), (4, N_DEMOD)):
        peak = torch.stack([envelope_peak(gen, n) for _ in range(rows)])
        x0 = -5.0 + 0.5 * torch.rand(rows, generator=gen, device="cuda")
        # a 1,024-sample window peak validates in one round; unsmoothed
        # noise, whose pattern flips sample to sample, does not
        rough = -3.0 + 0.3 * randn(rows * n, gen).reshape(rows, n)
        for name, rise, fall in (
                ("attack", p.attack_rise_alpha, p.attack_fall_alpha),
                ("decay", p.decay_rise_alpha, p.decay_fall_alpha)):
            solve_rows_case(f" {rows}x{n:,} {name}",
                            (peak, x0, rise, fall, agc.GUESS_ITERS), {})
            solve_rows_case(f" {rows}x{n:,} {name}, 1 round",
                            (peak if n > 1024 else rough, x0, rise, fall, 1))


def hang_params(fs: float, decay_ms: float = 200.0):
    return agc.make_params(agc.AgcConfig(True, True, fs), -100.0, 30.0, 0.0,
                           decay_ms)


def hang_exact(args, d: torch.Tensor) -> torch.Tensor:
    """The float64 solve of the hang-mode decay averager with the pattern
    that the trajectory ``d`` induces and the float32 rates both versions
    use."""
    peak, d0, timer0, rise, fall, hang_time = args[:6]
    pat = peak > scan.shift1(d, d0)
    dist = distance_since_last_true(pat, timer0)
    hold = ~pat & (scan.shift1(dist, timer0) < hang_time)
    alpha = torch.where(pat, float(rise), torch.where(hold, 0.0, float(fall)))
    alpha = alpha.float()
    return first_order_recurrence((1.0 - alpha).double(),
                                  (alpha * peak).double(), d0.double())


def plain_hang_rounds(args) -> tuple:
    """``scan.hang_solve_plain`` and the rounds its loop ran."""
    seen, real = [], scan.guess_verify
    scan.guess_verify = lambda *a: (lambda r: seen.append(r[2]) or r)(
        real(*a))
    try:
        d, timer, ok = scan.hang_solve_plain(*args)
    finally:
        scan.guess_verify = real
    return d, timer, bool(ok), seen[0]


def hang_case(label: str, args, results=None, main: bool = False) -> None:
    """N3h against hang mode's plain rounds (each through K3 on the card):
    the same patterns (the rising flags each trajectory induces), timers,
    flags (all rows, and each row as its own plain solve) and rounds; d
    within 1e-5 plus the plain version's own distance from the float64
    solve of its pattern, the kernel no farther from its own than that or
    1e-5 (the solve is K3's arithmetic: bitwise the plain d is expected,
    and the count of unequal values is printed); each row of a bank
    bitwise its own launch."""
    peak, d0 = args[0], args[1]
    dk, tk, row_ok, okk, rk = scan.hang_solve_rows(*args)
    dp, tp, okp, rp = plain_hang_rounds(args)
    okk, rk = bool(okk), int(rk)
    pat_k, pat_p = (peak > scan.shift1(d, d0) for d in (dk, dp))
    unequal = int((dk != dp).sum())
    if peak.dim() == 2:
        want_rows = [plain_hang_rounds((peak[c], d0[c], args[2][c],
                                        *args[3:]))[2]
                     for c in range(peak.shape[0])]
        singles = [scan.hang_solve(peak[c], d0[c], args[2][c], *args[3:])
                   for c in range(peak.shape[0])]
        row_bits(f"hang_solve{label}", list(dk), [d for d, _, _ in singles])
    else:
        want_rows = [okp]
    got_rows = row_ok.tolist()
    err_k = float((dk.double() - hang_exact(args, dk)).abs().max())
    err_p = float((dp.double() - hang_exact(args, dp)).abs().max())
    phase(f"  hang_solve{label}: ok {okk} (plain {okp}), rows ok "
          f"{sum(got_rows)}/{len(got_rows)} (plain {sum(want_rows)}), "
          f"rounds {rk} (plain {rp}), patterns equal "
          f"{bool(torch.equal(pat_k, pat_p))}, timers equal "
          f"{bool(torch.equal(tk, tp))}, {unequal} d values not bitwise "
          f"the plain version's; from the float64 solve of its pattern "
          f"kernel {err_k:.3e}, plain {err_p:.3e}")
    if not (okk == okp and got_rows == want_rows and rk == rp
            and torch.equal(pat_k, pat_p) and torch.equal(tk, tp)
            and (not okk or err_k <= max(err_p, 1e-5))):
        raise AssertionError(f"hang_solve{label} disagrees with its plain "
                             "version")
    if results is not None:
        n = peak.numel()
        # bytes: the peaks in, d out; operations: per round the distance,
        # the rate, the update and the compare a sample (~8)
        compare("hang_solve", [dk], [dp], 1e-5 + err_p, results,
                lambda: scan.hang_solve(*args),
                lambda: scan.hang_solve_plain(*args),
                "" if main else label, work=(8 * n, 8 * n * rk))


def keyed_hang_args() -> tuple:
    """The hang-mode decay solve's inputs on bench row 12's keyed carrier
    (agc_hang_keyed_2msps, 16,384 demodulated samples a block), recorded
    at the solve's entry on the third block of an eager receiver."""
    row = bench_suite.rows()[12]
    cfg = row.cfg
    x = torch.from_numpy(row.stimulus(cfg)).cuda()
    params, state = rx.init(cfg, "cuda")
    seen, real = [], scan.hang_solve
    for b in range(3):
        if b == 2:
            scan.hang_solve = lambda *a: seen.append(a) or real(*a)
        try:
            state, _ = rx.receiver_step(cfg, params, state, x)
        finally:
            scan.hang_solve = real
    torch.cuda.synchronize()
    return seen[0]


def boundary_hang_args(gen) -> tuple:
    """Hold windows that cross chunk boundaries: a 2 ms hold (125 samples
    at 62.5 kHz) after spikes 8 samples before each 2,048-sample boundary,
    over three rows whose timers carry in at 0, mid-hold and at the cap,
    8,192 samples a row."""
    fs, n = 62_500.0, 8192
    p = hang_params(fs, decay_ms=2.0)
    base = -4.0 + 0.05 * randn(3 * n, gen).reshape(3, n)
    spikes = torch.arange(2040, n, 2048, device="cuda")
    base[:, spikes] = -1.0
    base[1, 1000:1004] = -0.5
    d0 = torch.tensor([-4.0, -2.0, -3.0], device="cuda")
    timer0 = torch.tensor([0, p.hang_time // 2, p.hang_time],
                          dtype=torch.int32, device="cuda")
    return (base, d0, timer0, p.decay_rise_alpha, p.decay_fall_alpha,
            p.hang_time, agc.GUESS_ITERS)


def check_hang_solve(gen, results):
    """N3h (hang mode's decay solve, one launch) against its plain rounds
    (``hang_case``): bench row 12's keyed carrier (1 x 16,384), the
    flagship's width on a stepping envelope (1 x 262,144), 4 x 262,144 and
    64 x 1,024 rows with their own d0 and timers, and hold windows across
    chunk boundaries (3 x 8,192); each again with one round allowed (the
    forced fallback: not converged where the plain version is not)."""
    p = hang_params(62_500.0)
    cases = [(" keyed 1x16,384", keyed_hang_args())]
    for rows, n in ((1, N_DEMOD), (4, N_DEMOD), (64, 1024)):
        peak = torch.stack([envelope_peak(gen, n) for _ in range(rows)])
        d0 = -5.0 + 0.5 * torch.rand(rows, generator=gen, device="cuda")
        timer0 = (torch.rand(rows, generator=gen, device="cuda")
                  * p.hang_time).to(torch.int32)
        if rows == 1:
            peak, d0, timer0 = peak[0], d0[0], timer0[0]
        cases.append((f" {rows}x{n:,}", (peak, d0, timer0, p.decay_rise_alpha,
                                         p.decay_fall_alpha, p.hang_time,
                                         agc.GUESS_ITERS)))
    cases.append((" chunk-boundary holds 3x8,192", boundary_hang_args(gen)))
    for label, args in cases:
        hang_case(label, args, results, main=label == " 1x262,144")
        hang_case(label + ", 1 round", args[:6] + (1,))


def biquad64(x: torch.Tensor, coefs, w1: torch.Tensor,
             w2: torch.Tensor) -> tuple:
    """The biquad in float64, sample by sample, from the same float32
    input, coefficients and states: (y, final w[n-1], final w[n-2])."""
    b0, b1, b2, a1, a2 = (float(c) for c in coefs)
    xs = x.double().reshape(-1, x.shape[-1]).cpu().numpy()
    s1 = w1.double().reshape(-1).expand(xs.shape[0]).cpu().numpy()
    s2 = w2.double().reshape(-1).expand(xs.shape[0]).cpu().numpy()
    y = np.empty_like(xs)
    ends = np.empty((2, xs.shape[0]))
    for r in range(xs.shape[0]):
        p1, p2, row, out = float(s1[r]), float(s2[r]), xs[r].tolist(), y[r]
        for i, v in enumerate(row):
            w = v - a1 * p1 - a2 * p2
            out[i] = b0 * w + b1 * p1 + b2 * p2
            p1, p2 = w, p1
        ends[:, r] = p1, p2
    cuda = lambda a, shape: torch.from_numpy(a).reshape(shape).cuda()
    return (cuda(y, x.shape), cuda(ends[0], w1.shape),
            cuda(ends[1], w1.shape))


def check_biquad(gen, results):
    """N2 (FM's 3 kHz audio biquad, one launch) against its plain version
    (the Hillis-Steele prefix) and the float64 solve of the same float32
    inputs and coefficients (``float64_bar``: no farther from it than 1.5x
    the plain version), at FM's rate (62.5 kHz: the lowpass's poles
    closest to the unit circle of the port's FM rates): full-width FM
    (1 x 262,144, from nonzero states), the 8-channel FM monitor's rows
    (8 x 256) and a partial last chunk (2 x 5,000); the new states
    too."""
    from cutesdr_tpu_torch.kernels import iir as iir_k
    fs = rx.ReceiverConfig(mode="fm", **FULL).output_rate
    coefs = fm.init(fs, "cuda")[0].lp_iir
    for label, shape in (("", (N_DEMOD,)), (" 8x256", (8, 256)),
                         (" 2x5,000", (2, 5000))):
        x = randn(int(np.prod(shape)), gen, 0.3).reshape(shape)
        lead = shape[:-1]
        w1 = randn(max(1, int(np.prod(lead))), gen, 0.5).reshape(lead)
        w2 = randn(max(1, int(np.prod(lead))), gen, 0.5).reshape(lead)
        run_k = lambda: iir_k.biquad(x, coefs, w1, w2)
        run_p = lambda: iir_k.biquad_plain(x, coefs, w1, w2)
        (yk, k1, k2), (yp, p1, p2) = run_k(), run_p()
        exact = biquad64(x, coefs, w1, w2)
        _, _, tol = float64_bar(f"biquad{label}", yk, yp, exact[0])
        for name, k, p, e in (("w[n-1]", k1, p1, exact[1]),
                              ("w[n-2]", k2, p2, exact[2])):
            _, _, tol_s = float64_bar(f"biquad{label} {name}", k, p, e)
            max_err(f"biquad{label} {name}", [k], [p], tol_s)
        n = x.numel()
        # bytes: x in, y out; operations: the thread's composition (~12),
        # the step (4) and y (5) a sample
        compare("biquad", [yk], [yp], tol, results, run_k, run_p, label,
                work=(8 * n, 21 * n))


def resamp_case(gen, n_streams: int, n: int, ratio: float, nominal: float,
                cplx: bool, periods: int = resampler.SINC_PERIODS):
    """The banded resampler's inputs for ``n_streams`` blocks of ``n``
    samples at ``ratio`` (capacity sized for ``nominal``, as the receiver
    sizes it), as ``ops/resampler._banded_process`` forms them: z =
    [tail | block] and the output times from a random start in [0, dt).
    Returns (z, t_int, t_frac, M, valid)."""
    params, _ = resampler.init(ratio, "cuda", complex_input=cplx)
    K, M = resampler.band_size(n, resampler.max_out_for(n, nominal), periods)
    t0 = torch.rand(n_streams, 1, generator=gen, device="cuda") * ratio
    t_int, t_frac = resampler._times(
        params, t0, torch.arange(K, dtype=torch.float32, device="cuda"))
    z = randn(n_streams * (n + periods), gen, 1000.0)
    if cplx:
        z = torch.complex(z, randn(z.numel(), gen, 1000.0))
    return z.reshape(n_streams, -1), t_int, t_frac, M, t_int < n


def check_resamp(gen, results, gen_new):
    """K9 against its plain version on the valid outputs (the caller masks
    the rest): the flagship's rate-locked tail (1 x 262,144 at 125/96
    x (1 + 50e-6)) in both modes, the 64-channel bank's tail (64 x 1,024 at
    78,125/48,000), a complex stereo tail (4 x 32,768 at 31,250/48,000 x
    (1 + 1e-4)), the session's default block (1 x 1,024 at 125/96), and
    the flagship's tail with a 29-tap sinc (odd P: the plain version's
    direct form against the kernel's separable one; its inputs from
    ``gen_new``, so the other cases' inputs stay those of earlier runs)."""
    flagship = 62_500.0 / 48_000.0
    P = resampler.SINC_PERIODS
    cases = [("", 1, N_DEMOD, flagship * (1 + 50e-6), flagship, False, True,
              P),
             (" interp=False", 1, N_DEMOD, flagship * (1 + 50e-6), flagship,
              False, False, P),
             (" bank 64x1024", 64, 1024, 78_125.0 / 48_000.0,
              78_125.0 / 48_000.0, False, True, P),
             (" stereo 4x32768", 4, 32_768, 31_250.0 / 48_000.0 * (1 + 1e-4),
              31_250.0 / 48_000.0, True, True, P),
             (" 1x1024", 1, 1024, flagship, flagship, False, True, P),
             (" P=29", 1, N_DEMOD, flagship * (1 + 50e-6), flagship, False,
              True, 29)]
    for label, n_st, n, ratio, nominal, cplx, interp, periods in cases:
        z, t_int, t_frac, M, valid = resamp_case(
            gen if periods == P else gen_new, n_st, n, ratio, nominal, cplx,
            periods)
        run_k = lambda: resamp.resample_band(z, t_int, t_frac, M, periods,
                                             interp)
        run_p = lambda: resamp.resample_band_plain(z, t_int, t_frac, M,
                                                   periods, interp)
        zero = torch.zeros((), dtype=z.dtype, device="cuda")
        yk, yp = (torch.where(valid, y, zero) for y in (run_k(), run_p()))
        planes = lambda y: [y.real, y.imag] if cplx else [y]
        # bytes: z and the times in, y out; operations: per valid output
        # the per-output terms (~40) and per tap the window (12), position
        # and sinc (6) and one multiply-add per plane
        n_planes = 2 if cplx else 1
        work = (4 * z.numel() * n_planes + 8 * t_int.numel()
                + 4 * t_int.numel() * n_planes,
                int(valid.sum()) * (periods * (18 + 2 * n_planes) + 40))
        compare("resamp", planes(yk), planes(yp),
                RESAMP_TOL * float(yp.abs().max()), results, run_k, run_p,
                label, work=work)
        lp = resamp.launch_plan(t_int.shape[-1], n_st, M, periods,
                                _build.sm_count(z.device))
        phase(f"  ({n_st} x {n}, {t_int.shape[-1]} outputs a stream, "
              f"M = {M}, P = {periods}, {lp.blocks * n_st} blocks of "
              f"{lp.outputs_per_block} outputs, ratio {ratio:.9f}, "
              f"{'complex' if cplx else 'real'}, interp={interp}, "
              f"bound {bound(*work)['bound_ms']:.4f} ms)")


def time_once(fn) -> float:
    """ms of a single call of fn(), for the plain per-sample loops."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def angle_err(got, want) -> float:
    """Largest wrapped angle difference."""
    d = got.double() - want.double()
    return float(torch.remainder(d + np.pi, 2 * np.pi).sub(np.pi).abs().max())


def pll_theta(kind: str, n: int, fs: float, offset_hz: float, gen):
    """Input phases in [-pi, pi): seeded uniform noise (the worst case,
    wraps everywhere) or a tone ``offset_hz`` off the NCO (locked)."""
    if kind == "noise":
        return (torch.rand(n, generator=gen, device="cuda") * 2 - 1) * np.pi
    k = torch.arange(n, dtype=torch.float64, device="cuda")
    w = 2 * np.pi * offset_hz / fs
    return (torch.remainder(k * w + 0.3 + np.pi, 2 * np.pi) - np.pi).float()


def seq_err(name: str, got, want) -> tuple[float, int]:
    """Largest difference of a seqloop kernel's outputs from its plain
    loop's (angles wrapped) and the count of values not bitwise equal
    (compared as int32, so -0 and +0 differ); raises beyond SEQ_TOL."""
    err = max(angle_err(g, w) if is_angle else float((g - w).abs().max())
              for g, w, is_angle in zip(got, want, ANGLES[name]))
    unequal = sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
                  for g, w in zip(got, want))
    if not err <= SEQ_TOL:
        raise AssertionError(f"{name} disagrees with its plain loop: "
                             f"{err:.3e} > {SEQ_TOL:.1e}")
    return err, unequal


def chained(fn, p, phase0, freq0, th, split: int):
    """fn over th[..., :split], then over th[..., split:] from the state
    the first call returned (one per stream of a [C, n] th): (final
    phase, final freq, *series concatenated)."""
    first = fn(p.pll_alpha, p.pll_beta, p.nco_limit, phase0, freq0,
               th[..., :split].contiguous())
    second = fn(p.pll_alpha, p.pll_beta, p.nco_limit, first[0], first[1],
                th[..., split:].contiguous())
    return (second[0], second[1],
            *(torch.cat(pair, -1) for pair in zip(first[2:], second[2:])))


def check_seqloops(gen, results):
    """K7 and K8 against their plain per-sample loops at the FM (62.5 kHz)
    and SAM (31.25 kHz) paths' rates: 32,768 samples of noise and of a
    locked tone, and the full-width 262,144 samples of noise.  The kernel
    is timed as the others are; the plain loop (one launch per torch op
    per sample) once.  Then FM's chunked tier (torch) at 262,144 on the
    same noise against K7's one launch: the same flag, and the same bits
    where it validates.  Last, partial tiles
    and the carry between calls: two chained calls of 256 samples (the FM
    idle channel's block) and of 31,768 then 777 samples (neither whole
    1,024-sample tiles), on noise."""
    fm_p, fm_c = fm.init(62_500.0, "cuda")
    sam_p, _ = sam.init(31_250.0, "cuda")
    phase0 = torch.tensor(0.5, device="cuda")
    freq0 = torch.tensor(0.0, device="cuda")
    loops = {"seqloop_fm": (fm_p, 62_500.0, 1000.0, seqloop.fm_pll_scan,
                            seqloop.fm_pll_scan_plain),
             "seqloop_sam": (sam_p, 31_250.0, 100.0, seqloop.sam_pll_scan,
                             seqloop.sam_pll_scan_plain)}
    # device times at 262,144 first: the plain loops below launch millions
    # of small kernels, after which the profiler has lost kernel records
    dev = {}
    for name, (p, fs, off, kernel, _) in loops.items():
        th = pll_theta("noise", N_DEMOD, fs, off, gen)
        dev[name] = device_ms(lambda: kernel(p.pll_alpha, p.pll_beta,
                                             p.nco_limit, phase0, freq0, th),
                              calls=10)
    for n, kind in ((32_768, "noise"), (32_768, "tone"), (N_DEMOD, "noise")):
        for name, (p, fs, off, kernel, plain) in loops.items():
            th = pll_theta(kind, n, fs, off, gen)
            args = (p.pll_alpha, p.pll_beta, p.nco_limit, phase0, freq0, th)
            run_k = lambda: kernel(*args)
            got = run_k()
            out = []
            plain_ms = time_once(lambda: out.append(plain(*args)))
            err, unequal = seq_err(name, got, out[0])
            ms = time_ms(run_k)
            phase(f"kernel {name} n={n} {kind}: max_abs_err {err:.3e} (tol "
                  f"{SEQ_TOL:.0e}), {unequal} values not bitwise equal, "
                  f"kernel {ms:.4f} ms (median of 5x20 calls), plain "
                  f"{plain_ms:.1f} ms (1 call)")
            if n == N_DEMOD:
                # bytes: theta in, the series out (FM two, SAM one);
                # operations: ~20 a step (PLL_STEP_OPS), one step a
                # sample: the function's work, not the chunked schedule's
                series = 2 if name == "seqloop_fm" else 1
                results[name] = {"max_abs_err": err, "ms": ms,
                                 "device_ms": dev[name][0],
                                 "device_by": dev[name][1],
                                 "plain_ms": plain_ms,
                                 **bound(4 * n * (1 + series),
                                         PLL_STEP_OPS * n),
                                 "library_ms": None}
                if name == "seqloop_fm":
                    check_fm_chunked(fm_p, fm_c, phase0, freq0, th, got, ms)
    for n1, n2 in ((256, 256), (32_768 - 1000, 777)):
        for name, (p, fs, off, kernel, plain) in loops.items():
            th = pll_theta("noise", n1 + n2, fs, off, gen)
            err, unequal = seq_err(
                name, chained(kernel, p, phase0, freq0, th, n1),
                chained(plain, p, phase0, freq0, th, n1))
            phase(f"kernel {name} n={n1}+{n2} chained, noise: max_abs_err "
                  f"{err:.3e} (tol {SEQ_TOL:.0e}), {unequal} values not "
                  "bitwise equal")


def check_fm_chunked(p, c, phase0, freq0, th, k_out, k_ms):
    """FM's chunked tier in torch (``fm._pll_chunked``, ``ops/pll``'s
    chunked scan, the parent's card route) against K7's one launch
    (``seqloop.fm_pll_chunked``) on the same noise: the same flag, and
    where it holds the same bits; both timed."""
    c = c._replace(nco_phase=phase0, nco_freq=freq0)
    run = lambda: fm._pll_chunked(p, c, th)
    run_k = lambda: seqloop.fm_pll_chunked(p.pll_alpha, p.pll_beta,
                                           p.nco_limit, phase0, freq0, th)
    valid, (ph, fr, _dc, _audio, errs) = run()
    k_valid, k_ph, k_fr, k_freqs, k_errs = run_k()
    valid, k_valid = bool(valid), bool(k_valid)
    if valid != k_valid:
        raise AssertionError(f"K7's flag {k_valid} is not the torch chunked "
                             f"tier's {valid}")
    if not (torch.equal(k_errs, k_out[3]) and torch.equal(k_freqs, k_out[2])):
        raise AssertionError("K7 gave other bits on a second call")
    if valid and not (torch.equal(errs, k_errs) and float(fr) == float(k_fr)
                      and float(ph) == float(k_ph)):
        raise AssertionError("FM chunked tier validated but differs from K7")
    ms = time_ms(run, reps=3, calls=2)
    phase(f"FM chunked tier (torch) n={th.numel()} noise: valid {valid}, "
          f"K7 flag {k_valid}, "
          f"{'bitwise equal to K7, ' if valid else ''}{ms:.2f} ms "
          f"(median of 3x2 calls) against K7's one launch {k_ms:.4f} ms")


def check_other_shapes(gen):
    """Correctness only, at shapes other configurations give the kernels:
    a x128 plan with output offset d=3 on a short block across a carry;
    4096-, 512- and 8192-point filter frames; 4096/3073 streamed in
    1,024-sample blocks, shorter than the filter's history; scans with a
    partial last chunk."""
    plan = plan_decimation(2e6, 1000.0)                  # 2 MSPS CW plan
    params, carry = mixdec.init(plan, 123_456.7, "cuda")
    re, im = randn(plan.decimation * 1024, gen, 1000.0), \
        randn(plan.decimation * 1024, gen, 1000.0)
    dc = torch.tensor(1.5 - 0.5j, dtype=torch.complex64, device="cuda")
    for _ in range(2):                                   # across a carry
        ck, yk = mixdec.process_planes(plan, params, carry, re, im, dc)
        cp, yp = mixdec.process_planes_plain(plan, params, carry, re, im, dc)
        err = max_err("mixdec d=3", [yk.real, yk.imag], [yp.real, yp.imag],
                      5e-5 * float(yp.abs().max()))
        carry = ck
    phase(f"kernel mixdec D={plan.decimation} d=3: max_abs_err {err:.3e}")
    for nfft, ntaps in ((4096, 3073), (512, 257), (8192, 4097)):
        h = design_fastfir(100.0, 2800.0, 0.0, 62_500.0, fft_size=nfft,
                           fir_size=ntaps)
        hf = torch.from_numpy(h.astype(np.complex64)).cuda()
        z = torch.complex(randn(ntaps - 1 + 8 * (nfft - ntaps + 1), gen, 100.),
                          randn(ntaps - 1 + 8 * (nfft - ntaps + 1), gen, 100.))
        yk = fastfir.filter_frames(hf, z, ntaps)
        yp = fastfir.filter_frames_plain(hf, z, ntaps)
        err = max_err(f"fastfir {nfft}", [yk.real, yk.imag],
                      [yp.real, yp.imag], 5e-5 * float(yp.abs().max()))
        phase(f"kernel fastfir {nfft}/{ntaps}: max_abs_err {err:.3e}")
    # a block shorter than the tail (4096/3073: 1,024 new samples against
    # a 3,072-sample history), streamed through the two-pointer read over
    # chained calls, against the plain streaming form
    pk, ck = ff_ops.init(100.0, 2800.0, 0.0, 62_500.0, "cuda", nfft=4096,
                         ntaps=3073)
    cp = ck
    for _ in range(4):
        x = torch.complex(randn(1024, gen, 100.0), randn(1024, gen, 100.0))
        ck, yk = fastfir.process(pk, ck, x)
        cp, yp = ff_ops.process(pk, cp, x)
        err = max_err("fastfir short block", [yk.real, yk.imag],
                      [yp.real, yp.imag], 5e-5 * float(yp.abs().max()))
        if not torch.equal(ck.tail, cp.tail):
            raise AssertionError("fastfir short block: tails differ")
    phase(f"kernel fastfir 4096/3073, 1,024-sample blocks chained: "
          f"max_abs_err {err:.3e}, tails equal")
    n = N_DEMOD - 1000
    a = 0.99 + 0.005 * torch.rand(n, generator=gen, device="cuda")
    b = randn(n, gen, 0.01)
    err = max_err("scan_plain partial", [scan.first_order_scan(a, b, -3.0)],
                  [scan.first_order_scan_plain(a, b, -3.0)], 1e-5)
    phase(f"kernel scan_plain n={n}: max_abs_err {err:.3e}")


def check_plain_filter_sizes(gen):
    """Channel-filter sizes the fastfir kernel does not take (design/
    latency's 16384/8193, nfft = 2000) stream through the plain FFT
    route on the card: no launch, the plain streaming form's result."""
    for nfft, ntaps in ((16384, 8193), (2000, 1025)):
        pk, ck = ff_ops.init(100.0, 2800.0, 0.0, 62_500.0, "cuda",
                             nfft=nfft, ntaps=ntaps)
        x = torch.complex(randn(2 * (nfft - ntaps + 1), gen, 100.0),
                          randn(2 * (nfft - ntaps + 1), gen, 100.0))
        before = dict(kernels.LAUNCHES)
        _, yk = fastfir.process(pk, ck, x)
        _, yp = ff_ops.process(pk, ck, x)
        if kernels.LAUNCHES != before or not torch.equal(yk, yp):
            raise AssertionError(f"fastfir {nfft}/{ntaps} did not take the "
                                 "plain route")
        phase(f"fastfir {nfft}/{ntaps}: the plain FFT route, no launch")


def snr_db(want, got, skip=0):
    """SNR of ``got`` against ``want`` (real or complex) from ``skip``."""
    n = min(len(want), len(got))
    err = np.abs(got[skip:n] - want[skip:n])
    return 10 * np.log10(np.mean(np.abs(want[skip:n]) ** 2)
                         / max(np.mean(err ** 2), 1e-30))


def fixture_audio(cfg, iq_re, iq_im, n_blocks) -> np.ndarray:
    """The fixture's blocks through the port; stereo as [n, 2]."""
    r = rx.Receiver(cfg, "cuda")
    got = []
    for blk in range(n_blocks):
        sl = slice(blk * cfg.block_size, (blk + 1) * cfg.block_size)
        a = r.process(iq_re[sl] + 1j * iq_im[sl]).audio
        if a.is_complex():
            a = torch.stack([a.real, a.imag], -1)
        got.append(a.double().cpu().numpy())
    return np.concatenate(got)


def check_fixtures():
    for name in ("usb2m", "usb", "lsb", "cwu", "am", "sam", "fm"):
        gold = np.load(os.path.join(FIXDIR, f"golden_{name}.npz"))
        meta = json.loads(str(gold["meta"]))
        ref = np.load(os.path.join(FIXDIR, f"refgold_{name}.npz"))
        rmeta = json.loads(str(ref["meta"]))
        cfg = rx.ReceiverConfig(input_rate=meta["input_rate"],
                                mode=meta["mode"],
                                tune_freq=meta["tune_freq"],
                                cw_offset=meta["cw_offset"], audio_rate=None,
                                agc_on=True, agc_thresh_db=-90.0)
        got = fixture_audio(cfg, gold["iq_re"], gold["iq_im"],
                            meta["n_blocks"])
        s_gold = snr_db(gold["audio"], got, int(meta["skip"]))
        s_ref = snr_db(ref["audio"], got, rmeta["skip"])
        phase(f"fixture {name} (D={cfg.plan.decimation}): golden "
              f"{s_gold:.2f} dB (bound {meta['min_snr_db']}), refgold "
              f"{s_ref:.2f} dB (bound {rmeta['min_snr_prod_db']})")
        if not (s_gold > meta["min_snr_db"]
                and s_ref > rmeta["min_snr_prod_db"]):
            raise AssertionError(f"fixture {name} below its pinned bound")
    # stereo SAM, as tests/test_refgold_fixtures.py drives it
    d = np.load(os.path.join(FIXDIR, "refgold_sam_stereo.npz"))
    meta = json.loads(str(d["meta"]))
    cfg = rx.ReceiverConfig(input_rate=meta["input_rate"], mode="sam",
                            tune_freq=meta["tune_freq"], audio_rate=None,
                            stereo=True, agc_on=True, agc_thresh_db=-90.0)
    got = fixture_audio(cfg, d["iq_re"], d["iq_im"], meta["n_blocks"])
    s_ref = snr_db(d["audio"], got, meta["skip"])
    phase(f"fixture sam_stereo: refgold {s_ref:.2f} dB (bound "
          f"{meta['min_snr_prod_db']})")
    if not s_ref > meta["min_snr_prod_db"]:
        raise AssertionError("fixture sam_stereo below its pinned bound")


def check_refgold_extras():
    """The resampler, noise blanker and display fixtures through the port
    on the card, at the bars of tests/test_refgold_fixtures.py: the
    reference-exact banded resampler (through K9) with identical output
    counts and >= 110 dB; identical blanked-sample sets and >= 140 dB;
    the display's pixel map within 1 pixel."""
    d = np.load(os.path.join(FIXDIR, "refgold_resampler.npz"))
    meta = json.loads(str(d["meta"]))
    x = torch.complex(torch.from_numpy(d["iq_re"].astype(np.float32)),
                      torch.from_numpy(d["iq_im"].astype(np.float32))).cuda()
    ref = d["out_re"] + 1j * d["out_im"]
    chunk = meta["chunk"]
    params, carry = resampler.init(meta["rate"], "cuda", complex_input=True)
    before = kernels.LAUNCHES["resamp"]
    got = []
    for pos in range(0, x.numel(), chunk):
        cap = resampler.max_out_for(chunk, meta["rate"])
        carry, y, nv = resampler.process(params, carry, x[pos:pos + chunk],
                                         cap, interp=False)
        got.append(y[:int(nv)].cpu().numpy())
    got = np.concatenate(got)
    skip = meta["skip"]
    snr = snr_db(ref, got, skip) if len(got) == len(ref) else float("nan")
    launched = kernels.LAUNCHES["resamp"] - before
    phase(f"fixture resampler: {len(got)} outputs (reference {len(ref)}), "
          f"{snr:.2f} dB (bound 110), {launched} resamp launches")
    if not (len(got) == len(ref) and snr > 110.0 and launched > 0):
        raise AssertionError("fixture resampler below its bar")

    d = np.load(os.path.join(FIXDIR, "refgold_blanker.npz"))
    meta = json.loads(str(d["meta"]))
    x = torch.complex(torch.from_numpy(d["iq_re"].astype(np.float32)),
                      torch.from_numpy(d["iq_im"].astype(np.float32))).cuda()
    ref = d["out_re"] + 1j * d["out_im"]
    cfg = noiseblanker.BlankerConfig(True, meta["threshold"],
                                     meta["width_us"], meta["fs"])
    carry = noiseblanker.init_carry(cfg, "cuda")
    got = []
    for pos in range(0, x.numel(), meta["chunk"]):
        carry, y = noiseblanker.process(cfg, carry,
                                        x[pos:pos + meta["chunk"]])
        got.append(y.cpu().numpy())
    got, skip = np.concatenate(got), meta["skip"]
    same = np.array_equal(np.abs(got[skip:]) == 0, np.abs(ref[skip:]) == 0)
    snr = snr_db(ref, got, skip)
    phase(f"fixture blanker: {int((got[skip:] == 0).sum())} blanked, sets "
          f"{'identical' if same else 'DIFFER'}, {snr:.2f} dB (bound 140)")
    if not (same and snr > 140.0):
        raise AssertionError("fixture blanker below its bar")

    d = np.load(os.path.join(FIXDIR, "refgold_fftdisp.npz"))
    meta = json.loads(str(d["meta"]))
    N = meta["fft_size"]
    x = torch.from_numpy((d["iq_re"].astype(np.float64)
                          + 1j * d["iq_im"].astype(np.float64))
                         .astype(np.complex64)).cuda()
    cfg = spectrum.SpectrumConfig(fft_size=N, ave_size=meta["ave_size"],
                                  sample_rate=meta["sample_rate"],
                                  db_compensation=20 * np.log10(2.0))
    st = spectrum.init(cfg, "cuda")
    for fr in range(meta["frames"]):
        st, _ = spectrum.accumulate(cfg, st, x[fr * N:(fr + 1) * N])
    pix = spectrum.screen_map(
        cfg, spectrum.db_spectrum(cfg, st), meta["height"], meta["width"],
        meta["max_db"], meta["min_db"], -meta["sample_rate"] / 2,
        meta["sample_rate"] / 2).cpu().numpy()
    ref = d["pix"].astype(int)
    m = min(len(ref), len(pix))
    diff = np.abs(ref[:m] - pix[:m].astype(int))
    phase(f"fixture fftdisp: pixels within {diff.max()} of the reference "
          f"(bound 1), top {pix[:m].min()} of {meta['height']}")
    if not (diff.max() <= 1 and pix[:m].min() < meta["height"] // 4):
        raise AssertionError("fixture fftdisp beyond 1 pixel")


def stimulus(cfg, n_blocks: int, gen, carriers=({},),
             noise_db: float = -90.0) -> list[torch.Tensor]:
    """Seeded noise (``noise_db`` dBFS) plus one carrier per dict of
    ``carriers``: at ``freq_hz`` (default tune + ``offset_hz``),
    ``signal_db`` dBFS (default -30), frequency-modulated by ``fm_dev_hz``
    or amplitude-modulated to ``am_depth`` at ``mod_hz``.  Made on the card
    in float64, phase-continuous across blocks."""
    n = cfg.block_size
    k = torch.arange(n, dtype=torch.float64, device="cuda")
    noise = 32767.0 * 10 ** (noise_db / 20)
    out = []
    for b in range(n_blocks):
        t = (k + b * n) / cfg.input_rate
        sig = noise * torch.complex(
            torch.randn(n, generator=gen, device="cuda", dtype=torch.float64),
            torch.randn(n, generator=gen, device="cuda", dtype=torch.float64))
        for c in carriers:
            f = c.get("freq_hz", cfg.tune_freq + c.get("offset_hz", 0.0))
            mod_hz = c.get("mod_hz", 0.0)
            ph = torch.remainder(2 * np.pi * f * t, 2 * np.pi)
            if c.get("fm_dev_hz"):
                ph = ph + (c["fm_dev_hz"] / mod_hz) * torch.sin(
                    2 * np.pi * mod_hz * t)
            env = 32767.0 * 10 ** (c.get("signal_db", -30.0) / 20) * (
                1.0 + c.get("am_depth", 0.0) * torch.cos(2 * np.pi * mod_hz
                                                        * t))
            sig = sig + torch.polar(env, ph)
        out.append(sig.to(torch.complex64))
        del t, sig
    return out


def banded_tail(cfg, bank: bool, params) -> bool:
    """Whether the resampler takes the banded path (the resamp kernel):
    every bank, blocks below the rational gate, and a ratio off the
    nominal p/q (the audio rate lock's correction)."""
    if cfg.audio_rate is None:
        return False
    return bank or not rx.rational_tail(cfg, params)


def routed_kernels(cfg, bank: bool, params, counted=None,
                   wire: bool = False) -> set[str]:
    """The kernels a configuration's path routes to, by the port's gates.
    The choices JAX makes with ``lax.cond`` are made on the card: every
    FM block launches K7 and every SAM block K8 (a kernel that returns at
    once where the linear tier held), and every block with the AGC on
    launches N1 (which returns at once where the solves converged),
    single stream and bank, two-rate and hang mode (``counted``: the
    fallbacks, in ``bench_suite.counts()``'s form, a bench row's; default
    the counts as they stand).  The AGC's two-rate averagers are K4
    (``scan_solve``, a bank's rows in one launch), hang mode's decay
    averager N3h (``hang_solve``).  Every path runs the S-meter kernel;
    the affine scan runs the AM/SAM DC block and FM's three EMAs; FM's
    audio biquad is N2 (``biquad``).  K1 takes its int16 route where the
    path is fed int16 planes (``wire``) and no blanker reads them
    first."""
    counted = counted or bench_suite.counts()
    want = {"mixdec_int16" if wire and not cfg.nb_on else "mixdec",
            "smeter"}
    if fastfir.kernel_supported(cfg.fastfir_nfft, cfg.fastfir_ntaps):
        want.add("fastfir_batch" if bank else "fastfir")
    if banded_tail(cfg, bank, params):
        want.add("resamp")
    if cfg.agc_on:
        want |= {"scan_solve", "agcseq"}
        if cfg.agc_hang:
            want.add("hang_solve")
    if cfg.mode in ("am", "sam", "fm"):
        want.add("scan_plain")
    if cfg.mode == "fm":
        want |= {"seqloop_fm", "biquad"}
    if cfg.mode == "sam":
        want.add("seqloop_sam")
    if counted["agc_fallbacks"]:
        want.add("agcseq")
    return want


@contextlib.contextmanager
def guess_rounds(n_iters):
    """The AGC's guess-verify rounds capped at ``n_iters`` (None: as they
    are), so that a path forces the sequential fallback."""
    kept = agc.GUESS_ITERS
    agc.GUESS_ITERS = n_iters or kept
    try:
        yield
    finally:
        agc.GUESS_ITERS = kept


def fallback_check(launches, tiers, n_blocks):
    """A path with one guess-verify round allowed: the AGC fell back on
    at least one block, and each block was one launch of N1 (which ran
    the recurrence on the blocks that fell back), in two-rate and in hang
    mode alike."""
    fallbacks = agc.STATS["scan_fallbacks"]
    if not (fallbacks >= 1 and launches["agcseq"] == n_blocks):
        raise AssertionError(f"agc fallback path: {fallbacks} fallbacks, "
                             f"{launches['agcseq']} agcseq launches over "
                             f"{n_blocks} blocks")


def tone_peak(audio: np.ndarray, rate: float) -> tuple[float, float]:
    """The frequency of the audio spectrum's peak bin (Hann window) and
    its peak/floor in dB (floor: the median outside +-20 bins)."""
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio)))) ** 2
    f = np.fft.rfftfreq(len(audio), 1 / rate)
    k = int(np.argmax(spec))
    floor = np.median(np.delete(spec, np.s_[max(0, k - 20):k + 21]))
    return float(f[k]), float(10 * np.log10(spec[k] / floor))


def tone_ratio(audio: np.ndarray, rate: float, tone_hz: float,
               label: str, tol_hz: float = 2.0) -> float:
    """Peak/floor of the audio spectrum; raises unless the peak is the
    modulating tone (within ``tol_hz``) at > 60 dB."""
    if not np.all(np.isfinite(audio)):
        raise AssertionError(f"{label}: non-finite audio")
    peak_hz, ratio = tone_peak(audio, rate)
    phase(f"{label} audio: {len(audio)} samples, peak at {peak_hz:.2f} Hz, "
          f"peak/floor {ratio:.1f} dB")
    if abs(peak_hz - tone_hz) > tol_hz or ratio < 60.0:
        raise AssertionError(f"{label}: the {tone_hz:g} Hz tone was not "
                             "recovered")
    return ratio


def make_receiver(kind: str, cfg, freqs, ratio_ppm: float = 0.0):
    """The entry point a user calls: a Receiver, or a bank of channels
    tuned to ``freqs`` over one shared stream or one stream each; with
    ``ratio_ppm`` the resample ratio that far off nominal, as the audio
    rate lock sets it."""
    if kind == "single":
        r = rx.Receiver(cfg)
    else:
        bank = (channels.ChannelBank if kind == "bank"
                else channels.StackedReceiver)
        r = bank(cfg, freqs)
    if ratio_ppm:
        r.set_resample_ratio(cfg.output_rate / cfg.audio_rate
                             * (1 + ratio_ppm * 1e-6))
    return r


def path_blocks(kind: str, cfg, gen, stim, n_blocks: int):
    """A path's input blocks: one stream, or for a StackedReceiver one
    stream per dict of ``stim["streams"]``, stacked per block."""
    if kind != "stacked":
        return stimulus(cfg, n_blocks, gen, **stim)
    streams = [stimulus(cfg, n_blocks, gen, **s) for s in stim["streams"]]
    return [torch.stack(rows) for rows in zip(*streams)]


def channel_audio(out) -> list[np.ndarray]:
    """The valid audio of each channel of a step (one for a Receiver)."""
    audio, n = out.audio, out.n_audio
    if audio.dim() == 1:
        audio, n = audio[None], n[None]
    n = n.tolist()
    return [a[:k].double().cpu().numpy() for a, k in zip(audio, n)]


def reset_counts() -> None:
    """Every launch count and tier count set to 0 (after the card is
    idle)."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    agc.STATS["scan_fallbacks"] = 0
    for stats in (fm.STATS, sam.STATS):
        stats.update(dict.fromkeys(stats, 0))


def check_routed(label: str, launches: dict, want: set) -> None:
    """The kernels of ``want`` launched, and no other."""
    wrong = {k: v for k, v in launches.items() if (v > 0) != (k in want)}
    if wrong:
        raise AssertionError(f"{label}: launches {wrong} do not match the "
                             f"kernels its configuration routes to {want}")


def drive_path(label, kind, cfg, freqs, blocks, timed, gpu_label, tones=(),
               skip=1, need=(), may_fall_back=True, check=None,
               ratio_ppm=0.0):
    """Drive one receiver path over ``blocks`` with the counts zeroed just
    before and read just after; check the routed kernels (and ``need``)
    launched and no other; check each (channel, tone) of ``tones`` on the
    audio after the first ``skip`` blocks and every channel's audio
    finite; then time the chained steps over ``timed``, the blocks that
    continue the same signal.  The AGC may take its sequential fallback
    while it settles, except where ``may_fall_back`` is False.
    ``check(launches, tiers, n_blocks)`` adds a path's own conditions."""
    r = make_receiver(kind, cfg, freqs, ratio_ppm)
    reset_counts()
    audio = [channel_audio(r.process(b)) for b in blocks]
    launches = dict(kernels.LAUNCHES)
    tiers = dict({"fm": fm.STATS, "sam": sam.STATS}.get(cfg.mode, {}))
    fallbacks = agc.STATS["scan_fallbacks"]
    phase(f"{label} launches {launches}, pll tiers {tiers}, agc scan "
          f"fallbacks {fallbacks} over {len(blocks)} blocks")
    if fallbacks and not may_fall_back:
        raise AssertionError(f"{label}: the AGC fell back to the "
                             "sequential scan")
    check_routed(label, launches,
                 routed_kernels(cfg, kind != "single", r.params) | set(need))
    if check is not None:
        check(launches, tiers, len(blocks))
    if not all(np.all(np.isfinite(a)) for blk in audio for a in blk):
        raise AssertionError(f"{label}: non-finite audio")
    for ch, tone_hz in tones:
        tone_ratio(np.concatenate([blk[ch] for blk in audio[skip:]]),
                   cfg.audio_rate, tone_hz, f"{label} channel {ch}")

    torch.cuda.synchronize()
    agc.STATS["scan_fallbacks"] = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for b in timed:
        r.process(b)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / len(timed)
    n_in = timed[0].numel()
    signal_ms = 1e3 * cfg.block_size / cfg.input_rate
    phase(f"{label} step: {ms:.3f} ms/step, "
          f"{n_in / (ms * 1e-3) / 1e6:.1f} Msps, {signal_ms / ms:.3f}x real "
          f"time over {len(timed)} chained steps (agc scan fallbacks "
          f"{agc.STATS['scan_fallbacks']}), input resident ({gpu_label})")
    return launches


def fm_monitor_check(cfg):
    """The 8-channel FM monitor: once the AGC delay line has filled (its
    all-zero blocks lock trivially), the bank-wide vote sends every block
    to K7's loop over the 8 streams; one K7 launch every block."""
    n = cfg.fastfir_valid * cfg.frames_per_block
    fill = -(-agc.AgcConfig(True, False, cfg.output_rate).delay_samples // n)

    def check(launches, tiers, n_blocks):
        if not (tiers["scan"] >= n_blocks - fill
                and launches["seqloop_fm"] == n_blocks
                and tiers["chunked"] == 0):
            raise AssertionError(f"fm monitor: tiers {tiers}, K7 launches "
                                 f"{launches['seqloop_fm']} over {n_blocks} "
                                 f"blocks (delay fill {fill})")
    return check


def fm_noise_check(launches, tiers, n_blocks):
    """FM on carrier-less noise at full width: every block past the first
    leaves the linear tier and takes the chunked tier, and every block is
    one launch of K7 (the torch chunked scan never runs on the card)."""
    if not (tiers["chunked"] >= n_blocks - 1
            and launches["seqloop_fm"] == n_blocks):
        raise AssertionError(f"fm noise: tiers {tiers}, K7 launches "
                             f"{launches['seqloop_fm']} over {n_blocks} "
                             "blocks")


def sam_acquire_check(launches, tiers, n_blocks):
    if not (tiers["scan"] >= 1 and launches["seqloop_sam"] == n_blocks):
        raise AssertionError(f"bank sam: tiers {tiers}, K8 launches "
                             f"{launches['seqloop_sam']}")


def path_specs() -> list:
    """Every receiver path: (label, kind, config, channel frequencies,
    stimulus arguments, blocks, drive_path arguments)."""
    full = dict(input_rate=2e6, tune_freq=100e3, frames_per_block=256)
    # a monitor on an idle channel: noise only, 256 samples per step, so
    # the chunked tier's gate is closed and every block takes K7
    idle = dict(input_rate=2e6, tune_freq=100e3, frames_per_block=1,
                fastfir_nfft=512, fastfir_ntaps=257)
    tone = lambda **kw: dict(carriers=(kw,))
    # BASELINE config 4 (cutesdr_tpu/bench_suite.py:115-117): 64 USB
    # channels across one 10 MSPS stream, one frame per step
    grid = [-4.5e6 + 140e3 * i for i in range(64)]
    mon = [100e3 + 50e3 * i for i in range(8)]
    sam4 = [100e3 + 60e3 * i for i in range(4)]
    fm_tone = dict(fm_dev_hz=3000.0, mod_hz=1000.0)
    am_tone = dict(offset_hz=100.0, mod_hz=400.0, am_depth=0.5)
    usb_cfg = rx.ReceiverConfig(mode="usb", **full)
    return [
        ("flagship usb", "single", usb_cfg, None, tone(offset_hz=1000.0), 4,
         dict(tones=((0, 1000.0),), steps=8, may_fall_back=False)),
        ("fm", "single", rx.ReceiverConfig(mode="fm", **full), None,
         tone(**fm_tone), 3, dict(tones=((0, 1000.0),), steps=4)),
        ("sam", "single", rx.ReceiverConfig(mode="sam", **full), None,
         tone(**am_tone), 3,
         dict(tones=((0, 400.0),), steps=4, need=("seqloop_sam",))),
        ("am", "single", rx.ReceiverConfig(mode="am", **full), None,
         tone(mod_hz=1000.0, am_depth=0.5), 3,
         dict(tones=((0, 1000.0),), steps=4)),
        ("fm idle channel", "single", rx.ReceiverConfig(mode="fm", **idle),
         None, dict(carriers=(), noise_db=-60.0), 16,
         dict(steps=16, need=("seqloop_fm",))),
        ("usb hang", "single", rx.ReceiverConfig(mode="usb", agc_hang=True,
                                                 **full),
         None, tone(offset_hz=1000.0), 3,
         dict(tones=((0, 1000.0),), steps=4, may_fall_back=False)),
        ("usb ratelock", "single", usb_cfg, None, tone(offset_hz=1000.0), 3,
         dict(tones=((0, 1000.0),), steps=4, may_fall_back=False,
              ratio_ppm=50.0)),
        ("bank usb 64ch", "bank",
         rx.ReceiverConfig(input_rate=10e6, mode="usb"), grid,
         dict(carriers=(dict(freq_hz=grid[0] + 1000.0),
                        dict(freq_hz=grid[37] + 1000.0)), noise_db=-60.0),
         12, dict(tones=((0, 1000.0), (37, 1000.0)), skip=2, steps=8)),
        ("bank fm monitor 8ch", "bank", rx.ReceiverConfig(mode="fm", **idle),
         mon,
         dict(carriers=(dict(freq_hz=mon[0], **fm_tone),
                        dict(freq_hz=mon[5], **fm_tone))),
         48, dict(tones=((0, 1000.0),), skip=8, steps=16,
                  need=("seqloop_fm",),
                  check=fm_monitor_check(rx.ReceiverConfig(mode="fm",
                                                           **idle)))),
        ("bank sam 4ch", "bank",
         rx.ReceiverConfig(mode="sam", input_rate=2e6, frames_per_block=32),
         sam4,
         dict(carriers=tuple(dict(freq_hz=f + 100.0, mod_hz=400.0,
                                  am_depth=0.5) for f in sam4)),
         3, dict(tones=((0, 400.0),), steps=4, need=("seqloop_sam",),
                 check=sam_acquire_check)),
        ("stacked usb 2ch", "stacked", usb_cfg, [100e3, 100e3],
         dict(streams=(tone(offset_hz=1000.0), tone(offset_hz=1500.0))), 3,
         dict(tones=((0, 1000.0), (1, 1500.0)), steps=4,
              may_fall_back=False)),
        # design/latency's grown filter: the plain FFT route, no fastfir
        ("usb nfft16384", "single",
         rx.ReceiverConfig(mode="usb", input_rate=2e6, tune_freq=100e3,
                           frames_per_block=32, fastfir_nfft=16384,
                           fastfir_ntaps=8193), None,
         tone(offset_hz=1000.0), 3,
         dict(tones=((0, 1000.0),), steps=2, may_fall_back=False)),
        # one guess-verify round allowed: the AGC's sequential fallback,
        # one launch of N1 a block
        ("usb agc fallback", "single", usb_cfg, None,
         tone(offset_hz=1000.0), 2,
         dict(tones=((0, 1000.0),), steps=2, guess_iters=1,
              need=("agcseq",), check=fallback_check)),
        ("usb hang agc fallback", "single",
         rx.ReceiverConfig(mode="usb", agc_hang=True, **full), None,
         tone(offset_hz=1000.0), 2,
         dict(tones=((0, 1000.0),), steps=2, guess_iters=1,
              need=("agcseq",), check=fallback_check)),
        # carrier-less noise at full width: the chunked tier every block,
        # one K7 launch each (last, so the paths before keep their inputs)
        ("fm noise", "single", rx.ReceiverConfig(mode="fm", **full), None,
         dict(carriers=(), noise_db=-60.0), 3,
         dict(steps=4, need=("seqloop_fm",), check=fm_noise_check)),
    ]


# ---------------------------------------------------------------- graphs
# ``check_graph``: the single-stream step replayed as one CUDA graph
# (``Receiver``) against the eager step (``rx.receiver_step_planes``) from
# the same state over the same blocks, bitwise.

GRAPH_BLOCKS = 12         # blocks each run of a path
GRAPH_CHANGE = 6          # the block a retune, volume and ratio change
GRAPH_STEPS = 20          # chained steps timed each way


def graph_specs() -> list:
    """(label, kind, config, channel frequencies, stimulus arguments,
    guess-verify rounds) of every path ``check_graph`` drives: the tiers
    and fallbacks the card decides (N1, K7's chunked and scan tiers, K8),
    the resampler's two routes, hang mode (N3h), and the banks (K4 over
    rows, N3h over rows, N2, the bank-wide votes)."""
    fm_cfg = rx.ReceiverConfig(mode="fm", **FULL)
    usb_cfg = rx.ReceiverConfig(mode="usb", **FULL)
    hang_cfg = rx.ReceiverConfig(mode="usb", agc_hang=True, **FULL)
    idle = dict(input_rate=2e6, tune_freq=100e3, frames_per_block=1,
                fastfir_nfft=512, fastfir_ntaps=257)
    tone = lambda **kw: dict(carriers=(kw,))
    # the banks of path_specs: BASELINE config 4's 64-channel grid, the
    # FM monitor, four SAM channels, two separate full-width streams
    grid = [-4.5e6 + 140e3 * i for i in range(64)]
    grid_stim = dict(carriers=(dict(freq_hz=grid[0] + 1000.0),
                               dict(freq_hz=grid[37] + 1000.0)),
                     noise_db=-60.0)
    mon = [100e3 + 50e3 * i for i in range(8)]
    sam4 = [100e3 + 60e3 * i for i in range(4)]
    bank10 = rx.ReceiverConfig(input_rate=10e6, mode="usb")
    return [
        ("flagship usb", "single", usb_cfg, None, tone(offset_hz=1000.0),
         None),
        ("am", "single", rx.ReceiverConfig(mode="am", **FULL), None,
         tone(mod_hz=1000.0, am_depth=0.5), None),
        ("fm locked", "single", fm_cfg, None,
         tone(fm_dev_hz=3000.0, mod_hz=1000.0), None),
        ("fm noise", "single", fm_cfg, None,
         dict(carriers=(), noise_db=-60.0), None),
        # a clean carrier 3 Hz off the tune: the loop acquires, and its
        # chunks almost never bit-sync (K7's scan tier)
        ("fm never-syncing tone", "single", fm_cfg, None,
         dict(carriers=(dict(offset_hz=3.0),), noise_db=-140.0), None),
        ("fm idle channel", "single", rx.ReceiverConfig(mode="fm", **idle),
         None, dict(carriers=(), noise_db=-60.0), None),
        ("sam acquiring", "single", rx.ReceiverConfig(mode="sam", **FULL),
         None, tone(offset_hz=100.0, mod_hz=400.0, am_depth=0.5), None),
        ("usb agc fallback", "single", usb_cfg, None,
         tone(offset_hz=1000.0), 1),
        ("cw", "single", rx.ReceiverConfig(mode="cwu", **FULL), None,
         tone(offset_hz=0.0), None),
        ("usb ratelock", "single", usb_cfg, None, tone(offset_hz=1000.0),
         None),
        ("usb hang", "single", hang_cfg, None, tone(offset_hz=1000.0), None),
        ("usb hang agc fallback", "single", hang_cfg, None,
         tone(offset_hz=1000.0), 1),
        ("bank usb 64ch", "bank", bank10, grid, grid_stim, None),
        ("bank usb 64ch hang", "bank",
         dataclasses.replace(bank10, agc_hang=True), grid, grid_stim, None),
        ("bank fm monitor 8ch", "bank", rx.ReceiverConfig(mode="fm", **idle),
         mon, dict(carriers=(dict(freq_hz=mon[0], fm_dev_hz=3000.0,
                                  mod_hz=1000.0),)), None),
        ("bank sam 4ch", "bank",
         rx.ReceiverConfig(mode="sam", input_rate=2e6, frames_per_block=32),
         sam4, dict(carriers=tuple(dict(freq_hz=f + 100.0, mod_hz=400.0,
                                        am_depth=0.5) for f in sam4)),
         None),
        ("stacked usb 2ch agc fallback", "stacked", usb_cfg, [100e3, 100e3],
         dict(streams=(tone(offset_hz=1000.0), tone(offset_hz=1500.0))), 1),
    ]


# the device symbols (``cutesdr::``) of each counted wrapper's kernels;
# fastfir_batch launches fastfir's kernel, and is counted under it
KERNEL_SYMBOLS = {
    "mixdec": r"mixdec_kernel<\d+, [01], float>",
    "mixdec_int16": r"mixdec_kernel<\d+, 2, short>",
    "fastfir": "fastfir_kernel",
    "scan_plain": "affine_scan_kernel",
    "scan_solve": "solve_kernel|solve_one_kernel|solve_rows_kernel",
    "hang_solve": "hang_kernel|hang_rows_kernel", "biquad": "biquad_kernel",
    "smeter": "smeter_kernel",
    "seqloop_fm": "fm_chunked_kernel|pll_walk_kernel<true>",
    "seqloop_sam": "pll_walk_kernel<false>", "resamp": "resamp_kernel",
    "agcseq": "agc_seq_kernel"}


def device_kernel_counts(events) -> dict:
    """How many times the card ran each wrapper's kernels in a profile,
    from the kernel events' names (a graph's nodes included)."""
    counts = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for e in events:
        if "CUDA" not in str(e.device_type):
            continue
        for k, sym in KERNEL_SYMBOLS.items():
            if re.search(rf"cutesdr::(?:{sym})(?=[<(])", e.key):
                counts[k] += e.count
    return counts


def captured_kernel_counts(launches: dict) -> dict:
    """``launches`` (a graph's counts a replay) in ``device_kernel_counts``'
    keys."""
    counts = {k: launches.get(k, 0) for k in KERNEL_SYMBOLS}
    counts["fastfir"] += launches.get("fastfir_batch", 0)
    return counts


def step_counts() -> dict:
    """The launches, PLL tiers and AGC fallbacks counted since the last
    reset (after the card is idle)."""
    torch.cuda.synchronize()
    return {"launches": dict(kernels.LAUNCHES), "fm": dict(fm.STATS),
            "sam": dict(sam.STATS), "fallbacks": agc.STATS["scan_fallbacks"]}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to the bit (NaN and the sign of zero included); strided views
    (a bank's carries) too."""
    view = lambda t: (torch.view_as_real(t) if t.is_complex() else t
                      ).contiguous().reshape(-1).view(torch.uint8)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        view(a), view(b))


def step_ms(step, blocks) -> float:
    """The median wall ms of ``step(*b)`` over chained blocks ``b`` (tuples
    of arguments), each step ended by a synchronize."""
    times = []
    for b in blocks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


FIELDS = ("audio", "n_audio", "smeter_ave_db", "smeter_peak_db")


def output_bits(want: list, got: list) -> list:
    """(block, field) of every output field, probe tap included, that is
    not the same bits in ``got`` as in ``want``."""
    bad = []
    for b, (w, g) in enumerate(zip(want, got)):
        bad += [(b, f) for f in FIELDS
                if not same_bits(getattr(w, f), getattr(g, f))]
        if w.probes is not None:
            if g.probes is None or g.probes.keys() != w.probes.keys():
                bad.append((b, "probes"))
                continue
            bad += [(b, k) for k, v in w.probes.items()
                    if not same_bits(v, g.probes[k])]
    return bad


def replay_check(label: str, step, x, graphs: list) -> dict:
    """One graphed step ``step(x)`` under torch.profiler (each session
    records the second of two steps; the first warms the tracer up): no
    host read (``aten::_local_scalar_dense``), no kernel launch
    (``cudaLaunchKernel``: the input and the outputs move by memcpy), one
    graph launch for each of ``graphs``, and the card running each
    kernel as many times as the graphs count a replay (the kernel events
    by name).  A session that lost kernel records, as a profiler now and
    then does after many launches (``chip_kernel_times.device_ms``), is
    taken again, up to three.  Returns the kernels the card ran."""
    from torch.profiler import ProfilerActivity, profile, schedule
    captured = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for g in graphs:
        for k, v in captured_kernel_counts(g.launches).items():
            captured[k] += v
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                step(x)
                torch.cuda.synchronize()
                prof.step()
        events = prof.key_averages()
        ran = device_kernel_counts(events)
        if ran == captured:
            break
    count = {e.key: e.count for e in events}
    reads = count.get("aten::_local_scalar_dense", 0)
    launches = count.get("cudaLaunchKernel", 0)
    graph_launches = sum(v for k, v in count.items()
                         if k.startswith("cudaGraphLaunch"))
    if reads or launches or graph_launches != len(graphs) or ran != captured:
        raise AssertionError(f"{label}: a replayed step made {reads} host "
                             f"reads, {launches} kernel launches and "
                             f"{graph_launches} graph launches (want "
                             f"{len(graphs)}); the card ran {ran}, the "
                             f"graphs count {captured}")
    return ran


def graph_path(label, kind, cfg, freqs, stim, iters, gen,
               gpu_label) -> dict:
    """One path of ``check_graph``: GRAPH_BLOCKS blocks eager and graphed
    from one state, the retune, volume and ratio change on GRAPH_CHANGE
    (a bank: every channel retuned through ``set_tune_freqs``, in place);
    outputs, carries and counts bitwise equal; one replay under the
    profiler with no host read, one graph launch, and the card running
    each kernel as many times as the graph counts a replay (the kernel
    events by name); the step's ms both ways.  A path whose label ends in
    " int16" feeds the graph the blocks rounded to int16 planes (an int16
    static block, K1's int16 route) and the eager step their float32 cast
    (K1's float route): the same bits, K1's launches counted under the
    other route.  Returns the graphed run's counts."""
    ratio = cfg.output_rate / cfg.audio_rate
    ppm = 50e-6 if label == "usb ratelock" else 0.0
    wire = label.endswith(" int16")
    blocks = [(b.real.contiguous(), b.imag.contiguous()) for b in path_blocks(
        kind, cfg, gen, stim, GRAPH_BLOCKS + 1 + GRAPH_STEPS)]
    fed = blocks
    if wire:
        fed = [tuple(torch.round(p).to(torch.int16) for p in b)
               for b in blocks]
        blocks = [tuple(p.float() for p in b) for b in fed]
    r = make_receiver(kind, cfg, freqs)
    if not r.graphed:
        raise AssertionError(f"graph {label}: the rule leaves it eager")
    if ppm:
        r.set_resample_ratio(ratio * (1 + ppm))
    params, state = stepgraph.clone(r.params), stepgraph.clone(r.state)
    changes = (cfg.tune_freq + 25.0, 72, ratio * (1 + ppm + 20e-6))
    if kind == "single":
        step = rx.receiver_step_planes
    else:
        step = lambda *a: rx.bank_receiver_step_planes(*a, r.shared_input)
        retuned = [f + 25.0 for f in freqs]

    def eager(re, im):
        nonlocal state
        state, out = step(cfg, params, state, re, im)
        return out

    def change_eager(params):
        if kind == "single":
            params = rx.tune_params(cfg, params, changes[0])
        else:
            incs = [nco.phase_increment(f - cfg.cw_offset, cfg.input_rate)
                    for f in retuned]
            params = params._replace(dec=params.dec._replace(
                phase_inc=torch.tensor(incs, dtype=torch.int64,
                                       device="cuda")))
        return rx.ratio_params(rx.volume_params(params, changes[1]),
                               changes[2])

    def change_graphed():
        if kind == "single":
            r.set_tune_freq(changes[0])
        else:
            r.set_tune_freqs(retuned)
        r.params = rx.ratio_params(rx.volume_params(r.params, changes[1]),
                                   changes[2])

    with guess_rounds(iters):
        reset_counts()
        want = []
        for i, (re, im) in enumerate(blocks[:GRAPH_BLOCKS]):
            if i == GRAPH_CHANGE:
                params = change_eager(params)
            want.append(eager(re, im))
        want_counts = step_counts()
        reset_counts()
        got = []
        for i, (re, im) in enumerate(fed[:GRAPH_BLOCKS]):
            if i == GRAPH_CHANGE:
                change_graphed()
            got.append(r.process_planes(re, im))
        got_counts = step_counts()
        if wire:
            # K1's launches, counted under the float route's name
            k1 = got_counts["launches"]
            if k1["mixdec"] or k1["mixdec_int16"] != GRAPH_BLOCKS:
                raise AssertionError(f"graph {label}: K1 launches {k1}")
            got_counts["launches"] = dict(k1, mixdec=k1["mixdec_int16"],
                                          mixdec_int16=0)
        bad = output_bits(want, got)
        carries = list(zip(stepgraph.walk(state), stepgraph.walk(r.state)))
        bad += [("carry", p) for (p, w), (_, g) in carries
                if isinstance(w, torch.Tensor) and not same_bits(w, g)]
        if bad or got_counts != want_counts:
            raise AssertionError(f"graph {label}: eager and graphed differ "
                                 f"at {bad[:6]}; counts {want_counts} "
                                 f"against {got_counts}")
        re, im = blocks[GRAPH_BLOCKS]
        eager(re, im)
        if wire:
            ran = replay_check(f"graph {label}",
                               lambda x: r.process_planes(*x),
                               fed[GRAPH_BLOCKS], [r._graph.step])
        else:
            ran = replay_check(f"graph {label}", r.process,
                               torch.complex(re, im), [r._graph.step])
        timed = blocks[GRAPH_BLOCKS + 1:]
        eager_ms = step_ms(eager, timed)
        graph_ms = step_ms(r.process_planes, fed[GRAPH_BLOCKS + 1:])
    tiers = {k: v for k, v in {**{f"fm_{t}": n for t, n in
                                  got_counts["fm"].items()},
                               **{f"sam_{t}": n for t, n in
                                  got_counts["sam"].items()}}.items() if v}
    phase(f"graph {label}: {GRAPH_BLOCKS} blocks bitwise eager = graphed "
          f"(outputs{', taps' if cfg.probes else ''}, {len(carries)} carry "
          f"leaves, counts; tiers {tiers}, agc fallbacks "
          f"{got_counts['fallbacks']}), replay: 0 host reads, 0 kernel "
          f"launches, 1 graph launch, the card ran the counted kernels "
          f"({sum(ran.values())}); ms a step (median of {len(timed)} "
          f"chained): "
          f"eager {eager_ms:.4f}, graphed {graph_ms:.4f} ({gpu_label})")
    print(json.dumps({"graph_path": label, "eager_ms": eager_ms,
                      "graphed_ms": graph_ms, "tiers": tiers,
                      "agc_fallbacks": got_counts["fallbacks"],
                      "launches": got_counts["launches"],
                      "replay_kernels_ran": ran,
                      "gpu": gpu_label}), flush=True)
    return got_counts


def check_graph_rule(gen, gpu_label: str) -> dict:
    """Every configuration the graph rules admit at one frame (2 MSPS:
    the seven modes, mono and stereo, the two-rate or the hang-mode AGC
    or the AGC off, the blanker on or off: 84 receivers; a two-channel
    ChannelBank of each mode in both AGC modes: 14 banks; USB and FM with
    probes on, a receiver and a bank each) captures, and replays three
    blocks bitwise the eager step's.  Returns the graphed runs'
    launches."""
    total = dict.fromkeys(KERNELS, 0)
    t0 = time.perf_counter()
    n = 0

    def replayed(cfg, kind, freqs):
        nonlocal n
        blocks = [(b.real.contiguous(), b.imag.contiguous())
                  for b in stimulus(cfg, 3, gen,
                                    carriers=(dict(offset_hz=700.0),))]
        r = make_receiver(kind, cfg, freqs)
        params, state = stepgraph.clone(r.params), stepgraph.clone(r.state)
        step = (rx.receiver_step_planes if kind == "single" else
                lambda *a: rx.bank_receiver_step_planes(*a, True))
        reset_counts()
        got = [r.process_planes(re, im) for re, im in blocks]
        torch.cuda.synchronize()
        for k, v in kernels.LAUNCHES.items():
            total[k] += v
        for (re, im), g in zip(blocks, got):
            state, w = step(cfg, params, state, re, im)
            if not (r.graphed and r._graph is not None
                    and all(same_bits(a, b) for a, b in zip(w[:4], g[:4]))):
                raise AssertionError(f"graph rule: {kind} {cfg} not "
                                     "replayed bitwise the eager step")
        n += 1

    for mode in rx.PORTED_MODES:
        for stereo, agc, nb_on in itertools.product(
                (False, True), ("two-rate", "hang", "off"), (False, True)):
            replayed(rx.ReceiverConfig(
                mode=mode, stereo=stereo, agc_on=agc != "off",
                agc_hang=agc == "hang", nb_on=nb_on, tune_freq=100e3),
                "single", None)
        for hang in (False, True):
            replayed(rx.ReceiverConfig(mode=mode, agc_hang=hang,
                                       tune_freq=100e3),
                     "bank", [100e3, 150e3])
    for kind, freqs in (("single", None), ("bank", [100e3, 150e3])):
        for mode in ("usb", "fm"):
            replayed(rx.ReceiverConfig(mode=mode, probes=True,
                                       tune_freq=100e3), kind, freqs)
    phase(f"graph rule: {n} admitted configurations (receivers and banks, "
          "probes on among them) captured and replayed bitwise the eager "
          f"step ({time.perf_counter() - t0:.1f} s, {gpu_label})")
    return total


# The entry points beyond ``Receiver`` and the banks, each replaying CUDA
# graphs on one card: the diversity receivers (the combine and the step one
# graph), the time shard (the superblock one graph) and the pipeline (a
# graph a stage, two captures each).  Fewer, larger blocks than
# GRAPH_BLOCKS: a diversity block or a superblock is 134-268 MB.
ENTRY_BLOCKS = 8          # blocks (superblocks) each run of an entry path
ENTRY_CHANGE = 4          # the block the changes made in place land on
ENTRY_STEPS = 6           # chained steps timed each way


def graph_entry(label, g, eager, blocks, change, carries, graphs, replayed,
                gpu_label, late: bool = False) -> dict:
    """One entry path of ``check_graph``: ENTRY_BLOCKS blocks through
    ``eager(x)`` (the eager step functions from the entry point's fresh
    state) and through ``g.process(x)`` (graphed), ``change(i, graphed)``
    before each block; outputs (one block late and a flush with
    ``late``), carries (``carries()``: the eager's and the graphed's) and
    counts bitwise equal, the graphs (``graphs()``) captured once at the
    first block and never again; one step under the profiler
    (``replay_check``: no host read, no kernel launch, a graph launch for
    each of ``replayed()``); the step's ms both ways.  Returns the
    graphed run's counts."""
    run, extra = blocks[:ENTRY_BLOCKS], blocks[ENTRY_BLOCKS]
    timed = [(x,) for x in blocks[ENTRY_BLOCKS + 1:]]
    reset_counts()
    want = []
    for i, x in enumerate(run):
        change(i, False)
        want.append(eager(x))
    want_counts = step_counts()
    reset_counts()
    got = []
    for i, x in enumerate(run):
        change(i, True)
        got.append(g.process(x))
        if i == 0:
            first = [id(t) for t in graphs()]
    if late:
        if got[0] is not None:
            raise AssertionError(f"graph {label}: an output at the first "
                                 "block")
        got = got[1:] + [g.flush()]
    got_counts = step_counts()
    bad = output_bits(want, got)
    pairs = list(zip(*(stepgraph.walk(c) for c in carries())))
    bad += [("carry", p) for (p, w), (_, v) in pairs
            if isinstance(w, torch.Tensor) and not same_bits(w, v)]
    if bad or got_counts != want_counts:
        raise AssertionError(f"graph {label}: eager and graphed differ at "
                             f"{bad[:6]}; counts {want_counts} against "
                             f"{got_counts}")
    if [id(t) for t in graphs()] != first:
        raise AssertionError(f"graph {label}: captured again after the "
                             "first block")
    eager(extra)
    ran = replay_check(f"graph {label}", g.process, extra, replayed())
    eager_ms = step_ms(eager, timed)
    graph_ms = step_ms(g.process, timed)
    phase(f"graph {label}: {ENTRY_BLOCKS} blocks bitwise eager = graphed "
          f"{'one block late ' if late else ''}(outputs, {len(pairs)} carry "
          f"leaves, counts; {len(first)} capture(s) at the first block, "
          f"none after the changes on block {ENTRY_CHANGE}), replay: 0 host "
          f"reads, 0 kernel launches, {len(replayed())} graph launch(es), "
          f"the card ran the counted kernels ({sum(ran.values())}); ms a "
          f"step (median of {len(timed)} chained): eager {eager_ms:.4f}, "
          f"graphed {graph_ms:.4f} ({gpu_label})")
    print(json.dumps({"graph_path": label, "eager_ms": eager_ms,
                      "graphed_ms": graph_ms, "captures": len(first),
                      "graph_launches_per_step": len(replayed()),
                      "launches": got_counts["launches"],
                      "replay_kernels_ran": ran, "gpu": gpu_label}),
          flush=True)
    return got_counts


def graph_diversity(gen, gpu_label: str, n_branches: int) -> dict:
    """``diversity usb 2br`` / ``diversity array 4br``: a
    ``DiversityReceiver`` at the flagship's width against the eager
    combine (``coherent.process`` / ``array_process`` with host-bool
    params) and ``rx.receiver_step``; a retune and a volume change on
    ENTRY_CHANGE (pairwise: steering fixed there and back to tracking two
    blocks later), in place."""
    from cutesdr_tpu_torch.shard import coherent
    cfg = rx.ReceiverConfig(mode="usb", **FULL)
    pair = n_branches == 2
    label = "diversity usb 2br" if pair else "diversity array 4br"
    gains = (1.0, DIVERSITY_GAIN) if pair else ARRAY_GAINS
    blocks = [diversity_block(cfg, gen, b, gains, 20.0 if pair else 30.0,
                              (1.0, abs(DIVERSITY_GAIN)) if pair else None)
              for b in range(ENTRY_BLOCKS + 1 + ENTRY_STEPS)]
    g = coherent.DiversityReceiver(cfg, n_branches=n_branches)
    if not g.graphed:
        raise AssertionError(f"graph {label}: the rule leaves it eager")
    params, (state, cc) = stepgraph.clone(g.params), stepgraph.clone(g.carry)
    if pair:
        cp, combine = coherent.init(g.smoothing_blocks)[0], coherent.process
    else:
        cp = coherent.array_init(n_branches, g.smoothing_blocks)[0]
        combine = coherent.array_process
    steer = 0.7 * np.exp(1j * np.deg2rad(35.0))
    tune = cfg.tune_freq + 25.0

    def eager(x):
        nonlocal state, cc
        cc, y = combine(cp, cc, x)
        state, out = rx.receiver_step(cfg, params, state, y)
        return out

    def change(i, graphed):
        nonlocal params, cp
        if i == ENTRY_CHANGE:
            if graphed:
                g.set_tune_freq(tune)
                g.set_volume(72)
            else:
                params = rx.volume_params(rx.tune_params(cfg, params, tune),
                                          72)
        if not pair or i not in (ENTRY_CHANGE, ENTRY_CHANGE + 2):
            return
        fixed = i == ENTRY_CHANGE
        if graphed:
            g.set_steering(steer if fixed else None)
        else:
            cp = cp._replace(manual=fixed, fixed_gain=torch.tensor(
                complex(np.complex64(steer)), dtype=torch.complex64,
                device="cuda") if fixed else cp.fixed_gain)

    out = graph_entry(label, g, eager, blocks, change,
                      lambda: ((state, cc), g.carry),
                      lambda: [g._graph.step], lambda: [g._graph.step],
                      gpu_label)
    del blocks
    return out


def graph_timeshard(gen, gpu_label: str) -> dict:
    """``timeshard usb 4x``: ``ShardedReceiver`` over four shards of
    cuda:0 (the superblock one graph) against ``timeshard.sharded_step``
    run eagerly over the same shard views; a retune and a volume change
    (assigned params) on ENTRY_CHANGE, in place."""
    from cutesdr_tpu_torch.shard import ShardedReceiver, make_mesh
    from cutesdr_tpu_torch.shard import timeshard
    cfg = rx.ReceiverConfig(mode="usb", **FULL)
    sbs = superblocks(cfg, gen, ENTRY_BLOCKS + 1 + ENTRY_STEPS)
    g = ShardedReceiver(cfg, make_mesh(time=SHARDS,
                                       devices=["cuda:0"] * SHARDS))
    if not g.graphed:
        raise AssertionError("graph timeshard usb 4x: eager on one card")
    params, carry = stepgraph.clone(g.params), stepgraph.clone(g.carry)
    ex, S = timeshard.LocalExchange([g.device] * SHARDS), cfg.block_size
    tune = cfg.tune_freq + 25.0

    def eager(x):
        nonlocal carry
        shards = [(x[i * S:(i + 1) * S].real, x[i * S:(i + 1) * S].imag)
                  for i in range(SHARDS)]
        carry, out = timeshard.sharded_step(cfg, ex, [params] * SHARDS,
                                            params, carry, shards,
                                            g.superblock_size)
        return out

    def change(i, graphed):
        nonlocal params
        if i == ENTRY_CHANGE:
            if graphed:
                g.params = rx.volume_params(rx.tune_params(cfg, g.params,
                                                           tune), 72)
            else:
                params = rx.volume_params(rx.tune_params(cfg, params, tune),
                                          72)

    out = graph_entry("timeshard usb 4x", g, eager, sbs, change,
                      lambda: (carry, g.carry), lambda: [g._graph.step],
                      lambda: [g._graph.step], gpu_label)
    del sbs
    return out


def graph_pipelined(gen, gpu_label: str) -> dict:
    """``pipelined usb``: ``PipelinedReceiver`` on cuda:0 (two front and
    two back captures, the front on a stream of its own) against the
    single receiver's eager step one block late; a retune and a volume
    change on ENTRY_CHANGE, in place: the front's params with that block,
    the back's with the next, whose back stage runs then."""
    from cutesdr_tpu_torch.shard import PipelinedReceiver
    cfg = rx.ReceiverConfig(mode="usb", **FULL)
    blocks = stimulus(cfg, ENTRY_BLOCKS + 1 + ENTRY_STEPS, gen,
                      carriers=(dict(offset_hz=1000.0),))
    g = PipelinedReceiver(cfg, "cuda:0", "cuda:0")
    if not g.graphed:
        raise AssertionError("graph pipelined usb: eager on one card")
    params = stepgraph.clone(g.params)
    state = rx.ReceiverState(**stepgraph.clone(g.front_state),
                             **stepgraph.clone(g.back_state))

    def eager(x):
        nonlocal state
        state, out = rx.receiver_step(cfg, params, state, x)
        return out

    tune = cfg.tune_freq + 25.0

    def change(i, graphed):
        nonlocal params
        if i == ENTRY_CHANGE:
            if graphed:
                g.params = rx.volume_params(rx.tune_params(cfg, g.params,
                                                           tune), 72)
            else:
                params = rx.volume_params(rx.tune_params(cfg, params, tune),
                                          72)
        if graphed and i == ENTRY_CHANGE + 1:
            g.back_params = g.params

    graphs = lambda: [*g._graphs[0], *g._graphs[1]]
    out = graph_entry("pipelined usb", g, eager, blocks, change,
                      lambda: (state, rx.ReceiverState(**g.front_state,
                                                       **g.back_state)),
                      graphs, lambda: [g._graphs[0][0], g._graphs[1][0]],
                      gpu_label, late=True)
    del blocks
    return out


def check_graph(gen, gpu_label: str, gen_entries, gen_wire) -> dict:
    """Every path of ``graph_specs`` (``graph_path``); the card must have
    decided each kind of block: an AGC fallback (N1), K7's chunked and
    scan tiers, K8's scan tier.  Then, on inputs of ``gen_entries``, the
    flagship and full-width FM with probes on (``graph_path``: the taps
    bitwise too), on inputs of ``gen_wire`` the flagship, the 64-channel
    bank and the stacked pair fed int16 planes (``graph_path``'s " int16"
    paths), then the diversity receivers, the time shard and the
    pipeline (``graph_entry``).  Returns the graphed runs' launches."""
    total = dict.fromkeys(KERNELS, 0)
    seen = {"fallbacks": 0, "fm_chunked": 0, "fm_scan": 0, "sam_scan": 0}
    specs = [(spec, gen) for spec in graph_specs()]
    fm_cfg = rx.ReceiverConfig(mode="fm", probes=True, **FULL)
    specs += [(("usb probes", "single",
                rx.ReceiverConfig(mode="usb", probes=True, **FULL), None,
                dict(carriers=(dict(offset_hz=1000.0),)), None),
               gen_entries),
              (("fm probes", "single", fm_cfg, None,
                dict(carriers=(), noise_db=-60.0), None), gen_entries)]
    wired = {"flagship usb", "bank usb 64ch", "stacked usb 2ch agc fallback"}
    specs += [((label + " int16",) + spec[1:], gen_wire)
              for spec in graph_specs() if (label := spec[0]) in wired]
    for (label, kind, cfg, freqs, stim, iters), g in specs:
        counts = graph_path(label, kind, cfg, freqs, stim, iters, g,
                            gpu_label)
        for k, v in counts["launches"].items():
            total[k] += v
        seen["fallbacks"] += counts["fallbacks"]
        seen["fm_chunked"] += counts["fm"]["chunked"]
        seen["fm_scan"] += counts["fm"]["scan"]
        seen["sam_scan"] += counts["sam"]["scan"]
    missing = [k for k, v in seen.items() if not v]
    if missing:
        raise AssertionError(f"graph paths: no block of {missing}")
    for entry in (lambda: graph_diversity(gen_entries, gpu_label, 2),
                  lambda: graph_diversity(gen_entries, gpu_label, 4),
                  lambda: graph_timeshard(gen_entries, gpu_label),
                  lambda: graph_pipelined(gen_entries, gpu_label)):
        for k, v in entry()["launches"].items():
            total[k] += v
    return total


def check_paths(gen, gpu_label) -> dict:
    """Every receiver path; returns the launches summed over the paths."""
    total = dict.fromkeys(KERNELS, 0)
    for label, kind, cfg, freqs, stim, n_blocks, kw in path_specs():
        kw = dict(kw)
        blocks = path_blocks(kind, cfg, gen, stim, n_blocks + kw.pop("steps"))
        with guess_rounds(kw.pop("guess_iters", None)):
            launched = drive_path(label, kind, cfg, freqs, blocks[:n_blocks],
                                  blocks[n_blocks:], gpu_label, **kw)
        for k, v in launched.items():
            total[k] += v
        del blocks
    return total


def profile_paths(gen, gpu_label, only=None) -> None:
    """``--profile``: where the time goes on each receiver path (with
    ``only``, a set of labels: those paths alone).  The
    path's blocks run once (acquisition, AGC settling), then the chained
    steps that continue its signal twice over: unprofiled for the step
    time, and under torch.profiler.
    Device busy time per step is the sum of the device-side events
    (kernels, copies; one stream, so they do not overlap); the aten ops,
    which carry their kernels' time as well, are left out so that nothing
    counts twice.  Launches are cudaLaunchKernel calls, host reads
    aten::_local_scalar_dense calls (``.item()``, ``bool`` of a device
    tensor).  Prints one JSON line per path."""
    from torch.profiler import ProfilerActivity, profile
    keep = lambda label: only is None or label in only
    for label, kind, cfg, freqs, stim, n_blocks, kw in path_specs():
        steps = kw["steps"]
        # a path left out still draws its blocks, so that the paths kept
        # see the inputs of the whole run
        blocks = path_blocks(kind, cfg, gen, stim, n_blocks + 2 * steps)
        if not keep(label):
            del blocks
            continue
        r = make_receiver(kind, cfg, freqs, kw.get("ratio_ppm", 0.0))

        def run_steps(first):
            for b in blocks[first:first + steps]:
                r.process(b)
            torch.cuda.synchronize()

        with guess_rounds(kw.get("guess_iters")):
            for b in blocks[:n_blocks]:
                r.process(b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_steps(n_blocks)
            ms = (time.perf_counter() - t0) * 1e3 / steps
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run_steps(n_blocks + steps)
        profile_report(label, ms, prof, steps, gpu_label)
        del blocks
    if keep(BIQUAD_LABEL):
        profile_biquad(gpu_label)
    if keep(SESSION_LABEL):
        profile_session(gpu_label)


BIQUAD_LABEL = "fm biquad (N2) alone"
SESSION_LABEL = "session usb nb"


def profile_biquad(gpu_label) -> None:
    """FM's 3 kHz audio biquad (``ops/iir.process``, N2) alone at the
    full-width FM block (262,144 samples): its device items (the
    Hillis-Steele levels' kernels) and device ms a call."""
    from torch.profiler import ProfilerActivity, profile
    from cutesdr_tpu_torch.ops import iir
    params, carry = fm.init(62_500.0, "cuda")
    x = torch.randn(N_DEMOD, device="cuda")
    iir.process(params.lp_iir, carry.lp_iir, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iir.process(params.lp_iir, carry.lp_iir, x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        iir.process(params.lp_iir, carry.lp_iir, x)
        torch.cuda.synchronize()
    profile_report(BIQUAD_LABEL, ms, prof, 1, gpu_label)


def profile_report(label: str, ms: float, prof, steps: int,
                   gpu_label: str) -> None:
    """One JSON line of a profiled window of ``steps`` steps: device busy
    time (the device-side events' self time), the largest device items by
    kernel name and by the aten op that launched them (an op's self
    device time), launches, host reads and CUDA graph replays per step
    (``graphed``: the step replayed a graph), and the device items
    (kernels and copies, a graph's nodes included) per step."""
    events = prof.key_averages()
    device = {e.key: e.self_device_time_total / 1e3 / steps
              for e in events if "CUDA" in str(e.device_type)}
    by_op = {e.key: e.self_device_time_total / 1e3 / steps
             for e in events if "CUDA" not in str(e.device_type)
             and e.key.startswith("aten::")}
    launches, host_reads = event_counts(events, steps)
    graph_launches = sum(e.count for e in events
                         if e.key.startswith("cudaGraphLaunch")) / steps
    device_items = sum(e.count for e in events
                       if "CUDA" in str(e.device_type)) / steps
    busy = sum(device.values())
    top = lambda d: [[round(t, 4), k[:70]] for t, k in sorted(
        ((t, k) for k, t in d.items() if t > 0), reverse=True)[:8]]
    print(json.dumps({
        "path": label, "ms_per_step": ms, "device_busy_ms": busy,
        "busy_share": busy / ms,
        "launches_per_step": launches, "host_reads_per_step": host_reads,
        "graphed": graph_launches > 0,
        "graph_launches_per_step": graph_launches,
        "device_items_per_step": device_items,
        "top_device_ms": top(device), "top_ops_ms": top(by_op),
        "gpu": gpu_label}), flush=True)


class RecordingQueue(RateLockedQueue):
    """The session's audio queue, keeping a copy of every block the
    session puts into it (the audio the script checks)."""

    def __post_init__(self):
        super().__post_init__()
        self.blocks: list[np.ndarray] = []

    def put_block(self, samples: np.ndarray) -> None:
        self.blocks.append(np.array(samples))
        super().put_block(samples)


SESSION_WALK = (("usb", 1000.0), ("am", 400.0), ("fm", 1000.0),
                ("usb", 1000.0))   # mode, the tone its audio carries


def session_planes(cfg, n: int, seed: int):
    """int16 wire planes of n samples: a -20 dBFS carrier 1 kHz above the
    tune, amplitude-modulated (400 Hz, 50 %) and frequency-modulated
    (1 kHz, 300 Hz deviation), so USB hears the carrier, AM the 400 Hz
    and FM the 1 kHz tone; -60 dBFS noise; a 3-sample impulse near full
    scale every 20 ms.  Returns (re, im, impulse indices)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / cfg.input_rate
    amp = 32767.0 * 10 ** (-20 / 20)
    x = amp * (1 + 0.5 * np.cos(2 * np.pi * 400.0 * t)) * np.exp(1j * (
        2 * np.pi * (cfg.tune_freq + 1000.0) * t
        + 0.3 * np.sin(2 * np.pi * 1000.0 * t)))
    x += 32767.0 * 10 ** (-60 / 20) / np.sqrt(2) * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    period = int(0.02 * cfg.input_rate)
    starts = np.arange(period // 2, n - 3, period)
    hits = (starts[:, None] + np.arange(3)).reshape(-1)
    x[hits] = 30000.0 + 30000.0j
    return (np.round(x.real).astype(np.int16),
            np.round(x.imag).astype(np.int16), hits)


def session_cfg(periods: int = resampler.SINC_PERIODS):
    """The session's configuration: the default block (one frame), 2 MSPS
    USB tuned 100 kHz up, the noise blanker on; ``periods`` sinc taps."""
    return rx.ReceiverConfig(input_rate=2e6, mode="usb", tune_freq=100e3,
                             nb_on=True, resampler_periods=periods)


def check_session(gpu_label: str, periods: int = resampler.SINC_PERIODS,
                  walk=SESSION_WALK, n_blocks: int = 512) -> dict:
    """``session usb nb``: a ReceiverSession at the default configuration
    (``periods`` sinc taps) with the noise blanker and the spectrum
    display, fed int16 planes of ``session_planes`` (``n_blocks`` blocks:
    8.4 s of signal at 512) through ``pump_planes`` in 131 ms packets
    while an audio consumer drains ``audio_queue`` 100 ppm fast, walking
    the modes of ``walk``.  Checks: no input sample dropped, the rate
    lock moved the ratio, each mode's tone in its audio after a 0.5 s
    transient, the spectrum peak at the tone, the impulses blanked, every
    tensor on the card, the launches the path routes to.  Prints the
    real-time factor (signal seconds over wall seconds).  Returns the
    launch counts."""
    cfg = session_cfg(periods)
    bs = cfg.block_size
    n = bs * n_blocks
    re, im, hits = session_planes(cfg, n, SEED)
    packet = bs * 8
    n_packets = n // packet
    reset_counts()
    sess = ReceiverSession(cfg)
    sess.audio_queue = RecordingQueue(stereo=cfg.stereo)
    sess.precompile([m for m, _ in walk])
    sess.start()
    t0 = time.perf_counter()
    marks, consumed = [], 0
    seg = -(-n_packets // len(walk))
    for i in range(n_packets):
        if i % seg == 0:
            sess.set_mode(walk[i // seg][0])
            marks.append(len(sess.audio_queue.blocks))
        sl = slice(i * packet, (i + 1) * packet)
        sess.pump_planes(re[sl], im[sl])
        want = int((i + 1) * packet / cfg.input_rate * 48_000 * (1 + 100e-6))
        sess.audio_queue.get(want - consumed)
        consumed = want
    sess.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    signal_s = n / cfg.input_rate
    m = sess.metrics
    ratio = sess.receiver.params.resamp
    phase(f"session usb nb P={periods}: {signal_s:.2f} s of signal in "
          f"{wall:.2f} s wall,"
          f" {signal_s / wall:.3f}x real time; samples_in {m.samples_in} of "
          f"{n}, blocks {m.blocks}, audio out {m.audio_samples_out}, ppm "
          f"{m.ppm_error:+d}, correction {sess._last_correction:.3e}, "
          f"ratio {float(ratio.dt_hi) + float(ratio.dt_lo):.9f}, overflows "
          f"{m.audio_overflows}, underflows {m.audio_underflows}; launches "
          f"{launches}, fm tiers {dict(fm.STATS)} ({gpu_label})")
    if m.samples_in != n:
        raise AssertionError(f"session dropped input: {m.samples_in} of {n}")
    if sess._last_correction == 0.0:
        raise AssertionError("session: the rate lock never moved the ratio")

    blocks = sess.audio_queue.blocks
    for k, (mode, tone_hz) in enumerate(walk):
        end = marks[k + 1] if k + 1 < len(marks) else len(blocks)
        audio = np.concatenate(blocks[marks[k]:end]).astype(np.float64)
        tone_ratio(audio[24_000:], 48_000.0, tone_hz,
                   f"session segment {k} ({mode})")

    db = sess.analyzer.spectrum_db()
    nfft = sess.spectrum_cfg.fft_size
    f_peak = (int(np.argmax(db)) - nfft // 2) * cfg.input_rate / nfft
    phase(f"session spectrum: peak {db.max():.1f} dB at {f_peak:.0f} Hz "
          f"(tone {cfg.tune_freq + 1000.0:.0f} Hz)")
    if abs(f_peak - (cfg.tune_freq + 1000.0)) > 2 * cfg.input_rate / nfft:
        raise AssertionError("session: the spectrum peak is not the tone")

    # the blanker of the session's configuration on the first blocks: every
    # impulse sample is zero at its delayed position
    nb = rx._nb_cfg(cfg)
    span = bs * 16
    _, br, bi = noiseblanker.process_planes(
        nb, noiseblanker.init_carry(nb, "cuda"),
        torch.from_numpy(re[:span]).cuda().float(),
        torch.from_numpy(im[:span]).cuda().float())
    pos = hits[hits < span - nb.delay_samples - 1] + nb.delay_samples + 1
    blanked = int(((br[pos] == 0) & (bi[pos] == 0)).sum())
    phase(f"session blanker: {blanked} of {len(pos)} impulse samples "
          f"zeroed in the first {span} samples")
    if blanked != len(pos):
        raise AssertionError("session: impulses not blanked")

    def tensors(tree):
        if isinstance(tree, torch.Tensor):
            yield tree
        elif isinstance(tree, tuple):
            for sub in tree:
                yield from tensors(sub)
    devices = {t.device.type for t in tensors(
        (sess.receiver.state, sess.receiver.params, sess.analyzer.state))}
    if devices != {"cuda"}:
        raise AssertionError(f"session tensors on {devices}")
    want = set().union(*(routed_kernels(dataclasses.replace(cfg, mode=mode),
                                        False, sess.receiver.params,
                                        wire=True)
                         for mode, _ in walk))
    check_routed("session", launches, want)
    return launches


def profile_session(gpu_label: str) -> None:
    """``--profile`` of the session: 2 s of ``session_planes`` through
    pump_planes in USB, then one packet of 8 blocks under the profiler
    (the per-step numbers are per receiver block)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = session_cfg()
    packet = cfg.block_size * 8
    re, im, _ = session_planes(cfg, packet * 32, SEED)
    sess = ReceiverSession(cfg)
    sess.start()
    for i in range(30):
        sess.pump_planes(re[i * packet:(i + 1) * packet],
                         im[i * packet:(i + 1) * packet])
    sess.flush()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.pump_planes(re[30 * packet:31 * packet], im[30 * packet:31 * packet])
    sess.flush()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sess.pump_planes(re[31 * packet:], im[31 * packet:])
        sess.flush()
        torch.cuda.synchronize()
    sess.stop()
    profile_report(SESSION_LABEL, ms, prof, 8, gpu_label)


# --- the serving surface: probe taps, the probe scope and its server, the
# diversity receivers, the bank session.  Their inputs come from a
# generator of their own, so that the earlier paths keep theirs.
FULL = dict(input_rate=2e6, tune_freq=100e3, frames_per_block=256)
DIVERSITY_GAIN = 0.8 * np.exp(1j * np.deg2rad(40.0))
ARRAY_GAINS = (1.0, 0.9 * np.exp(1j * np.deg2rad(30.0)),
               0.6 * np.exp(-1j * np.deg2rad(60.0)),
               0.3 * np.exp(1j * np.deg2rad(120.0)))


def event_ms(fn, steps) -> float:
    """Milliseconds a call of ``fn(step)`` over ``steps``, on CUDA
    events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for st in steps:
        fn(st)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(steps)


def check_usb_probes(gen, gpu_label) -> dict:
    """``usb probes``: the flagship with probes on over the flagship's
    blocks, next to the flagship without them from the same (fresh)
    state: p1-p5 there with the JAX package's shapes and dtypes (the
    decimated block complex64 for p1-p3, float32 for p4, the audio
    capacity for p5) and finite, the audio, n_audio and S-meters the same
    bits, the same kernels launched the same number of times.  Times a
    step of each."""
    off_cfg = rx.ReceiverConfig(mode="usb", **FULL)
    on_cfg = dataclasses.replace(off_cfg, probes=True)
    blocks = stimulus(off_cfg, 5, gen, carriers=(dict(offset_hz=1000.0),))
    runs = {}
    for name, cfg in (("off", off_cfg), ("on", on_cfg)):
        r = rx.Receiver(cfg)
        reset_counts()
        outs = [r.process(b) for b in blocks[:3]]
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        ms = event_ms(r.process, blocks[3:])
        runs[name] = (outs, launches, r, ms)
    (off, l_off, _, ms_off), (on, l_on, r_on, ms_on) = runs["off"], runs["on"]
    phase(f"usb probes launches {l_on} (probes off {l_off}); step "
          f"{ms_on:.3f} ms with probes, {ms_off:.3f} ms without "
          f"({gpu_label})")
    if l_on != l_off:
        raise AssertionError("usb probes: the launches differ from the "
                             "flagship's without probes")
    check_routed("usb probes", l_on, routed_kernels(on_cfg, False,
                                                    r_on.params))
    n = on_cfg.fastfir_valid * on_cfg.frames_per_block
    want = {"p1_downconvert": ((n,), torch.complex64),
            "p2_fastfir": ((n,), torch.complex64),
            "p3_agc": ((n,), torch.complex64),
            "p4_demod": ((n,), torch.float32),
            "p5_resampled": ((on_cfg.audio_block_cap,), torch.float32)}
    for a, b in zip(off, on):
        got = {k: (tuple(v.shape), v.dtype) for k, v in b.probes.items()}
        if got != want:
            raise AssertionError(f"usb probes: taps {got}, want {want}")
        if not all(bool(torch.isfinite(torch.view_as_real(v) if v.is_complex()
                                       else v).all())
                   for v in b.probes.values()):
            raise AssertionError("usb probes: a tap is not finite")
        for f in ("audio", "n_audio", "smeter_ave_db", "smeter_peak_db"):
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"usb probes: {f} differs from the "
                                     "step without probes")
    tone_ratio(np.concatenate([channel_audio(o)[0] for o in on[1:]]),
               on_cfg.audio_rate, 1000.0, "usb probes")
    return l_on


def check_fm_probes(gen, gpu_label) -> dict:
    """``fm probes``: full-width FM with probes on, on carrier-less noise
    (the chunked tier, as ``fm noise``): each block's p6_pll a finite
    float32 series of the decimated length and its pll_tier the tier
    demod/fm.STATS counted for it; one K7 launch for each block, and at
    least every block past the first off the linear tier."""
    cfg = rx.ReceiverConfig(mode="fm", probes=True, **FULL)
    blocks = stimulus(cfg, 4, gen, carriers=(), noise_db=-60.0)
    r = rx.Receiver(cfg)
    n = cfg.fastfir_valid * cfg.frames_per_block
    reset_counts()
    tiers = []
    for b in blocks:
        before, k7 = dict(fm.STATS), kernels.LAUNCHES["seqloop_fm"]
        out = r.process(b)
        tier, p6 = int(out.probes["pll_tier"]), out.probes["p6_pll"]
        taken = [k for k, v in fm.STATS.items() if v != before[k]]
        if taken != [fm.TIER_NAMES[tier]]:
            raise AssertionError(f"fm probes: pll_tier {tier}, STATS moved "
                                 f"{taken}")
        if kernels.LAUNCHES["seqloop_fm"] - k7 != 1:
            raise AssertionError("fm probes: not one K7 launch a block")
        if (tuple(p6.shape) != (n,) or p6.dtype != torch.float32
                or not bool(torch.isfinite(p6).all())):
            raise AssertionError(f"fm probes: p6 {tuple(p6.shape)} "
                                 f"{p6.dtype}")
        tiers.append(tier)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    phase(f"fm probes: tiers {tiers}, launches {launches} ({gpu_label})")
    if sum(t != fm.TIER_LINEAR for t in tiers) < len(blocks) - 1:
        raise AssertionError("fm probes: the noise blocks kept the linear "
                             "tier")
    check_routed("fm probes", launches,
                 routed_kernels(cfg, False, r.params) | {"seqloop_fm"})
    return launches


def http_json(port: int, path: str, body=None) -> dict:
    """GET (body None) or POST a JSON body to the loopback server."""
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def check_session_probes(gpu_label: str) -> dict:
    """``session probe scope``: the session walk's configuration (2 MSPS
    USB with the blanker, one frame a block) fed ``session_planes``
    through pump_planes while set_probe walks p7 as a spectrum (its peak
    at the tone), p2 as a scope on a positive trigger (a record arrives),
    p6 after set_mode("fm") (the tier counts move), then off (the
    receiver without probes back).  No input sample dropped; prints the
    real-time factor.  Then a SpectrumServer on 127.0.0.1 (port 0) wired
    to the session round-trips POST /probe, GET /spectrum.json (with a
    probe frame) and POST /tune.  Returns the launch counts of the
    walk."""
    from cutesdr_tpu_torch.serve import SpectrumServer
    cfg = session_cfg()
    bs = cfg.block_size
    packet = bs * 8
    seg_packets = 8
    n = packet * seg_packets * 4
    re, im, _ = session_planes(cfg, n, SEED + 9)
    reset_counts()
    sess = ReceiverSession(cfg)
    sess.start()
    steps = (("p7", dict(view="spectrum")),
             ("p2", dict(view="scope", trigger_mode="pos",
                         trigger_level=0.0)),
             ("p6", dict(view="spectrum")), ("off", {}))
    frames, t0 = [], time.perf_counter()
    for k, (tap, kw) in enumerate(steps):
        if tap == "p6":
            sess.set_mode("fm")
        sess.set_probe(tap, **kw)
        for i in range(k * seg_packets, (k + 1) * seg_packets):
            sl = slice(i * packet, (i + 1) * packet)
            sess.pump_planes(re[sl], im[sl])
        sess.flush()
        frames.append(sess.probe_frame())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    m = sess.metrics
    phase(f"session probe scope: {n / cfg.input_rate:.2f} s of signal in "
          f"{wall:.2f} s wall, {n / cfg.input_rate / wall:.3f}x real time; "
          f"samples_in {m.samples_in} of {n}, pll tiers "
          f"{m.pll_tier_blocks}; launches {launches} ({gpu_label})")
    if m.samples_in != n:
        raise AssertionError(f"session probe scope dropped input: "
                             f"{m.samples_in} of {n}")
    p7, p2, p6, off = frames
    db = np.asarray(p7["db"])
    f_peak = (int(np.argmax(db)) - len(db) // 2) * p7["sample_rate"] / len(db)
    phase(f"session probe p7 spectrum: peak {db.max():.1f} dB at "
          f"{f_peak:.0f} Hz; p2 record "
          f"{None if p2['record'] is None else len(p2['record'])} samples")
    if (p7["tap"] != "p7_blanker"
            or abs(f_peak - (cfg.tune_freq + 1000.0))
            > 2 * p7["sample_rate"] / len(db)):
        raise AssertionError("session probe scope: the p7 peak is not the "
                             "tone")
    if p2["tap"] != "p2_fastfir" or p2["record"] is None:
        raise AssertionError("session probe scope: no p2 record")
    if p6["tap"] != "p6_pll" or sum(m.pll_tier_blocks) < seg_packets * 8:
        raise AssertionError("session probe scope: p6 / tier counts "
                             f"{m.pll_tier_blocks}")
    if off is not None or sess.cfg.probes:
        raise AssertionError("session probe scope: off left probes on")
    want = set().union(*(routed_kernels(dataclasses.replace(cfg, mode=mode),
                                        False, sess.receiver.params,
                                        wire=True)
                         for mode in ("usb", "fm")))
    check_routed("session probe scope", launches, want)

    srv = SpectrumServer(host="127.0.0.1", port=0,
                         sample_rate=cfg.input_rate,
                         on_tune=sess.tune_clicked,
                         on_probe=sess.set_probe).start()
    try:
        sess.on_spectrum = lambda db: srv.update(
            db, smeter_db=sess.metrics.smeter_ave_db,
            probe=sess.probe_frame())
        applied = http_json(srv.port, "/probe", {"tap": "p2",
                                                 "view": "spectrum"})
        if applied != {"tap": "p2_fastfir"}:
            raise AssertionError(f"server /probe: {applied}")
        for i in range(4):
            sl = slice(i * packet, (i + 1) * packet)
            sess.pump_planes(re[sl], im[sl])
        sess.flush()
        frame = http_json(srv.port, "/spectrum.json")
        tuned = http_json(srv.port, "/tune",
                          {"freq_hz": cfg.tune_freq + 49.0})
        probe = frame.get("probe") or {}
        phase(f"server round trip: frame of {len(frame['db'])} bins, probe "
              f"{probe.get('tap')} ({len(probe.get('db', []))} bins), tune "
              f"-> {tuned}")
        if (probe.get("tap") != "p2_fastfir"
                or len(probe.get("db", [])) != 2048
                or tuned != {"tune_hz": sess.current_tune}):
            raise AssertionError("server round trip failed")
        http_json(srv.port, "/probe", {"tap": "off"})
    finally:
        srv.stop()
        sess.stop()
    return launches


def tone_snr_db(audio: np.ndarray, rate: float, tone_hz: float) -> float:
    """Power within +-5 bins of the tone over the rest of the band below
    ``rate``/2 (Hann window), in dB."""
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio)))) ** 2
    k = int(round(tone_hz * len(audio) / rate))
    sig = spec[k - 5:k + 6].sum()
    return 10 * np.log10(sig / (spec[1:].sum() - sig))


def diversity_block(cfg, gen, b: int, gains, snr_db: float,
                    noise_scale=None) -> torch.Tensor:
    """One block of coherent branches on the card: branch i = gains[i] x a
    -20 dBFS carrier 1 kHz above the tune, plus independent complex noise
    ``snr_db`` below the carrier, scaled by ``noise_scale[i]`` (equal SNR:
    |gains[i]|)."""
    n = cfg.block_size
    t = (torch.arange(n, dtype=torch.float64, device="cuda") + b * n) \
        / cfg.input_rate
    amp = 32767.0 * 10 ** (-20 / 20)
    s = torch.polar(torch.full_like(t, amp), torch.remainder(
        2 * np.pi * (cfg.tune_freq + 1000.0) * t, 2 * np.pi))
    sigma = amp * 10 ** (-snr_db / 20) / np.sqrt(2)
    rows = []
    for i, g in enumerate(gains):
        scale = 1.0 if noise_scale is None else noise_scale[i]
        noise = torch.complex(
            torch.randn(n, generator=gen, device="cuda", dtype=torch.float64),
            torch.randn(n, generator=gen, device="cuda", dtype=torch.float64))
        rows.append(complex(g) * s + (sigma * scale) * noise)
    return torch.stack(rows).to(torch.complex64)


def check_diversity(gen, gpu_label: str) -> dict:
    """``diversity usb 2br``: a DiversitySession at the flagship's width,
    two branches of 8,388,608 samples a block (branch 1 = 0.8 at 40
    degrees x branch 0's carrier, independent noise at equal SNR, 20 dB
    in the 2 MHz band), 6 blocks, each block's own gain estimate
    (``smoothing_blocks=1``: an EMA still settling steps the combined
    carrier's phase at every block edge, and those clicks, not the noise,
    would set the audio's tone SNR).  Checks: the gain within 0.05 of the
    injected one; the combined audio's tone SNR >= branch 0 alone + 2 dB,
    branch 0 through a plain Receiver; the session combiner's gain within
    1e-5 relative of the float64 EMA of its blocks, and the combiner at
    its default smoothing over two chained blocks (gain and combined
    stream) within 1e-5 relative of its float64 value; the session's host
    reads a block no more than a ReceiverSession's on branch 0.  Returns
    the session's launch counts."""
    from cutesdr_tpu_torch.session import DiversitySession
    from cutesdr_tpu_torch.shard import coherent
    cfg = rx.ReceiverConfig(mode="usb", **FULL)
    gains, scale = (1.0, DIVERSITY_GAIN), (1.0, abs(DIVERSITY_GAIN))
    n_blocks = 6
    blocks = [diversity_block(cfg, gen, b, gains, 20.0, scale)
              for b in range(n_blocks + 2)]
    sess = DiversitySession(cfg, smoothing_blocks=1.0)
    sess.audio_queue = RecordingQueue(stereo=False)
    sess.start()
    reset_counts()
    t0 = time.perf_counter()
    for x in blocks[:n_blocks]:
        sess.pump(x.cpu().numpy())
    sess.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check_routed("diversity usb 2br", launches,
                 routed_kernels(cfg, False, sess.receiver.params))
    g = sess.gain
    # the first two blocks hold the filters' fill and the AGC's settling
    combined = np.concatenate(sess.audio_queue.blocks[2:]).astype(np.float64)
    plain = rx.Receiver(cfg)
    alone = [channel_audio(plain.process(x[0]))[0] for x in blocks[:n_blocks]]
    alone = np.concatenate(alone[2:])
    snr_c = tone_snr_db(combined, 48_000.0, 1000.0)
    snr_0 = tone_snr_db(alone, 48_000.0, 1000.0)
    signal_s = n_blocks * cfg.block_size / cfg.input_rate
    phase(f"diversity usb 2br: gain {abs(g):.4f} at "
          f"{np.degrees(np.angle(g)):.2f} deg (injected 0.8 at 40); tone "
          f"SNR combined {snr_c:.2f} dB, branch 0 alone {snr_0:.2f} dB; "
          f"{signal_s:.2f} s of signal in {wall:.2f} s wall, "
          f"{signal_s / wall:.3f}x real time, host input; launches "
          f"{launches} ({gpu_label})")
    if abs(g - DIVERSITY_GAIN) > 0.05:
        raise AssertionError("diversity: gain estimate off")
    if snr_c < snr_0 + 2.0:
        raise AssertionError("diversity: the combine gained < 2 dB")

    # the session's own combiner: its carried gain against the float64
    # EMA of the blocks it combined (at alpha = 1 the last block's estimate)
    def g_block64(x64):
        return (x64[1] * x64[0].conj()).sum() / (x64[0].abs() ** 2).sum()

    a = sess.receiver.comb_params.alpha
    g64 = torch.tensor(1.0, dtype=torch.complex128, device="cuda")
    for x in blocks[:n_blocks]:
        g64 = (1 - a) * g64 + a * g_block64(x.to(torch.complex128))
    g_sess = sess.receiver.comb_state.gain.to(torch.complex128)
    rel_sess = float((g_sess - g64).abs() / g64.abs())
    # the combiner at its default smoothing (alpha = 1/8) over two chained
    # blocks: the second starts from a carried gain that is not 1, so the
    # EMA update runs on the card at full width; the gain and the second
    # block's combined stream against their float64 values
    cp, cc = coherent.init(device="cuda")
    g64 = torch.tensor(1.0, dtype=torch.complex128, device="cuda")
    for x in blocks[:2]:
        cc, y = coherent.process(cp, cc, x)
        x64 = x.to(torch.complex128)
        g64 = (1 - cp.alpha) * g64 + cp.alpha * g_block64(x64)
    y64 = (x64[0] + g64.conj() * x64[1]) / torch.sqrt(1 + g64.abs() ** 2)
    rel = float((y.to(torch.complex128) - y64).abs().max() / y64.abs().max())
    rel_g = float((cc.gain.to(torch.complex128) - g64).abs() / g64.abs())
    phase(f"diversity combine vs float64: session gain {rel_sess:.3e}, "
          f"EMA gain after 2 blocks at alpha {cp.alpha:g} {rel_g:.3e}, "
          f"combined stream {rel:.3e} relative (bar 1e-5 each)")
    if max(rel_sess, rel_g, rel) > 1e-5:
        raise AssertionError("diversity: combine off its float64 value")

    # host reads a block: the diversity session against a receiver session
    from chip_kernel_times import call_counts
    rsess = ReceiverSession(cfg)
    rsess.start()
    for x in blocks[:2]:
        rsess.pump(x[0].cpu().numpy())
    div_in = blocks[n_blocks].cpu().numpy()
    rs_in = blocks[n_blocks + 1][0].cpu().numpy()
    _, div_reads = call_counts(lambda: sess.pump(div_in))
    _, rs_reads = call_counts(lambda: rsess.pump(rs_in))
    phase(f"diversity host reads a block {div_reads:g}, receiver session "
          f"{rs_reads:g}")
    if div_reads > rs_reads:
        raise AssertionError("diversity: more host reads than a receiver "
                             "session")
    sess.stop()
    rsess.stop()
    return launches


def check_diversity_array(gen, gpu_label: str) -> dict:
    """``diversity array 4br``: DiversityReceiver(n_branches=4) at the
    flagship's width (4 x 8,388,608 samples a block, 30 dB SNR in the
    band), two blocks: gains[0] exactly 1, the others within 0.05 of the
    injected ones, the tone in the audio."""
    from cutesdr_tpu_torch.shard.coherent import DiversityReceiver
    cfg = rx.ReceiverConfig(mode="usb", **FULL)
    drx = DiversityReceiver(cfg, smoothing_blocks=1.0, n_branches=4)
    reset_counts()
    outs = [drx.process(diversity_block(cfg, gen, b, ARRAY_GAINS, 30.0))
            for b in range(3)]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    gains = drx.last_gains
    phase(f"diversity array 4br: gains "
          f"{[f'{abs(v):.4f}@{np.degrees(np.angle(v)):.2f}' for v in gains]}"
          f" ({gpu_label})")
    if gains[0] != 1.0 or max(abs(a - complex(b)) for a, b in
                              zip(gains[1:], ARRAY_GAINS[1:])) > 0.05:
        raise AssertionError("diversity array: gains off")
    check_routed("diversity array 4br", launches,
                 routed_kernels(cfg, False, drx.params))
    tone_ratio(np.concatenate([channel_audio(o)[0] for o in outs[1:]]),
               48_000.0, 1000.0, "diversity array 4br")
    return launches


def check_bank_session(gen, gpu_label: str) -> dict:
    """``bank session usb 64ch``: a BankSession over the JAX package's
    config 4 (64 USB channels at -4.5 MHz + 140 kHz * i of one 10 MSPS
    stream, one frame a block), tones 1000, 1500 and 700 Hz above
    channels 3, 20 and 50 (-30 dBFS, noise -60 dBFS).  Checks: those
    channels' S-meters > 30 dB above every other channel's, their
    mini-spectra peak where their tones land, after select(20) the
    monitor's audio carries 1500 Hz, and the p2 probe frame reports the
    monitor channel.  Prints the real-time factor."""
    from cutesdr_tpu_torch.bank import SPECTRA_BINS, BankSession
    grid = [-4.5e6 + 140e3 * i for i in range(64)]
    tones = {3: 1000.0, 20: 1500.0, 50: 700.0}
    cfg = rx.ReceiverConfig(input_rate=10e6, mode="usb")
    n_blocks = 32
    blocks = stimulus(cfg, n_blocks, gen, noise_db=-60.0, carriers=tuple(
        dict(freq_hz=grid[c] + f) for c, f in tones.items()))
    sess = BankSession(cfg, grid)
    sess.audio_queue = RecordingQueue(stereo=False)
    sess.start()
    reset_counts()
    t0 = time.perf_counter()
    for x in blocks[:8]:
        sess.pump(x.cpu().numpy())
    sess.flush()
    sess.select(20)
    mark = len(sess.audio_queue.blocks)
    for x in blocks[8:24]:
        sess.pump(x.cpu().numpy())
    sess.flush()
    end = len(sess.audio_queue.blocks)
    sess.set_probe("p2")       # rebuilds the bank: its carries restart
    for x in blocks[24:]:
        sess.pump(x.cpu().numpy())
    sess.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    frame = sess.probe_frame()
    signal_s = n_blocks * cfg.block_size / cfg.input_rate
    others = max(v for c, v in enumerate(sess.smeter_db) if c not in tones)
    phase(f"bank session usb 64ch: {signal_s:.3f} s of signal in "
          f"{wall:.2f} s wall, {signal_s / wall:.3f}x real time (host "
          f"input); S-meters {[round(float(sess.smeter_db[c]), 1) for c in tones]}"
          f" dB, others <= {others:.1f} dB; probe frame channel "
          f"{frame['channel']} of monitor {sess.monitor} ({gpu_label})")
    for c in tones:
        if sess.smeter_db[c] < others + 30.0:
            raise AssertionError(f"bank session: channel {c}'s S-meter")
    n_aud = len(sess.audio_queue.blocks[-1])
    k = max(1, ((n_aud // 2 + 1) // 8) // SPECTRA_BINS)
    for c, f in tones.items():
        want = int(f / (k * 48_000.0 / n_aud))
        got = int(np.argmax(sess.channel_spectra[c]))
        if abs(got - want) > 1:
            raise AssertionError(f"bank session: channel {c}'s mini-spectrum "
                                 f"peaks at bin {got}, the tone at {want}")
    audio = np.concatenate(sess.audio_queue.blocks[mark + 1:end]).astype(
        np.float64)
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    f_peak = float(np.argmax(spec)) * 48_000.0 / len(audio)
    snr = tone_snr_db(audio, 48_000.0, 1500.0)
    phase(f"bank session monitor 20 audio: {len(audio)} samples, peak at "
          f"{f_peak:.1f} Hz, tone SNR {snr:.1f} dB")
    if abs(f_peak - 1500.0) > 48_000.0 / len(audio) or snr < 30.0:
        raise AssertionError("bank session: the monitor's audio is not "
                             "channel 20's tone")
    if frame["channel"] != sess.monitor or frame["tap"] != "p2_fastfir":
        raise AssertionError("bank session: the probe frame's channel")
    check_routed("bank session usb 64ch", launches,
                 routed_kernels(cfg, True, sess.bank.params))
    sess.stop()
    return launches


def check_serving(gen, gpu_label: str) -> dict:
    """Every serving-surface path; returns their launches summed."""
    total = dict.fromkeys(KERNELS, 0)
    for fn in (check_usb_probes, check_fm_probes, check_diversity,
               check_diversity_array, check_bank_session):
        for k, v in fn(gen, gpu_label).items():
            total[k] += v
    for k, v in check_session_probes(gpu_label).items():
        total[k] += v
    return total


def profile_serving(gen, gpu_label: str, only=None) -> None:
    """``--profile`` of the serving surface: one JSON line each for the
    flagship with probes on feeding its p2 tap to a ProbeSpectrum on the
    card, full-width FM with probes on noise, the probe scope's session
    (p2 spectrum), the diversity session, the 4-branch receiver and the
    bank session with the monitor's p2 spectrum (per block).  With
    ``only`` (a set of labels) those lines alone, the others' inputs still
    drawn so that the lines kept see the inputs of the whole run."""
    from torch.profiler import ProfilerActivity, profile

    from cutesdr_tpu_torch.bank import BankSession
    from cutesdr_tpu_torch.session import DiversitySession
    from cutesdr_tpu_torch.shard.coherent import DiversityReceiver
    from cutesdr_tpu_torch.testbench.probes import ProbeSpectrum

    def measure(label, step, inputs, warm, steps, blocks_per_call=1):
        if only is not None and label not in only:
            return
        for x in inputs[:warm]:
            step(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in inputs[warm:warm + steps]:
            step(x)
        torch.cuda.synchronize()
        per_block = steps * blocks_per_call
        ms = (time.perf_counter() - t0) * 1e3 / per_block
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for x in inputs[warm + steps:warm + 2 * steps]:
                step(x)
            torch.cuda.synchronize()
        profile_report(label, ms, prof, per_block, gpu_label)

    usb = rx.ReceiverConfig(mode="usb", probes=True, **FULL)
    r = rx.Receiver(usb)
    spec = ProbeSpectrum(usb.output_rate)
    measure("usb probes (p2 spectrum)",
            lambda x: spec.feed(r.process(x).probes["p2_fastfir"]),
            stimulus(usb, 8, gen, carriers=(dict(offset_hz=1000.0),)), 2, 3)
    fmc = rx.ReceiverConfig(mode="fm", probes=True, **FULL)
    r = rx.Receiver(fmc)
    measure("fm probes", r.process,
            stimulus(fmc, 8, gen, carriers=(), noise_db=-60.0), 2, 3)

    cfg = session_cfg()
    packet = cfg.block_size * 8
    re, im, _ = session_planes(cfg, packet * 12, SEED + 9)
    keep = lambda label: only is None or label in only
    if keep("session probe scope (p2 spectrum)"):
        sess = ReceiverSession(cfg)
        sess.start()
        sess.set_probe("p2")
        measure("session probe scope (p2 spectrum)",
                lambda i: sess.pump_planes(re[i * packet:(i + 1) * packet],
                                           im[i * packet:(i + 1) * packet])
                or sess.flush(), list(range(12)), 4, 4, blocks_per_call=8)
        sess.stop()

    full = rx.ReceiverConfig(mode="usb", **FULL)
    div_in = [diversity_block(full, gen, b, (1.0, DIVERSITY_GAIN), 20.0,
                              (1.0, abs(DIVERSITY_GAIN))).cpu().numpy()
              for b in range(6)]
    dsess = DiversitySession(full, smoothing_blocks=1.0)
    dsess.start()
    measure("diversity usb 2br", dsess.pump, div_in, 2, 2)
    dsess.stop()
    del div_in
    drx = DiversityReceiver(full, smoothing_blocks=1.0, n_branches=4)
    measure("diversity array 4br", drx.process,
            [diversity_block(full, gen, b, ARRAY_GAINS, 30.0)
             for b in range(6)], 2, 2)
    del drx

    grid = [-4.5e6 + 140e3 * i for i in range(64)]
    bcfg = rx.ReceiverConfig(input_rate=10e6, mode="usb")
    label = "bank session usb 64ch (p2 spectrum)"
    inputs = [x.cpu().numpy() for x in stimulus(
        bcfg, 24, gen, noise_db=-60.0,
        carriers=(dict(freq_hz=grid[20] + 1500.0),))]
    if keep(label):
        bsess = BankSession(bcfg, grid)
        bsess.start()
        bsess.set_probe("p2")
        measure(label, bsess.pump, inputs, 8, 8)
        bsess.stop()


# ------------------------------------------------------ the multi-device layer
# ``check_shard`` drives the port's shard modules at the flagship's width:
# four time shards on one card (``make_mesh(time=4, devices=[cuda:0] * 4)``),
# the two-stage pipeline on two streams of one card, config 4's bank over a
# 4-device channel axis, and the time shards across a one-rank NCCL world
# (a helper process of this script, ``--timeshard-rank``: NCCL refuses two
# ranks on one GPU).  Inputs come from a generator of their own (SEED + 11).

SHARDS = 4
SHARD_AUDIO_TOL = 5e-4    # x peak: the bar of JAX tests/test_shard.py
SHARD_SMETER_TOL = 0.1    # dB
PIPE_TOL = 1e-5           # x peak: JAX tests/test_pipeline_pp.py


def hold_audio(label: str, out, refs, tol: float = SHARD_AUDIO_TOL
               ) -> tuple[float, float]:
    """``out``'s valid audio against the concatenated valid audio of the
    outputs ``refs`` (within ``tol`` x their peak) and its S-meter against
    the last one's (0.1 dB); returns (max abs error / peak, S-meter
    difference in dB)."""
    want = torch.cat([r.audio[:int(r.n_audio)] for r in refs]).double()
    got = out.audio[:int(out.n_audio)].double()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: audio {tuple(got.shape)}, want "
                             f"{tuple(want.shape)} finite")
    err = float((got - want).abs().max() / want.abs().max())
    sm = abs(float(out.smeter_ave_db) - float(refs[-1].smeter_ave_db))
    if err > tol or sm > SHARD_SMETER_TOL:
        raise AssertionError(f"{label}: audio {err:.3e} x peak (tol "
                             f"{tol:g}), S-meter {sm:.4f} dB")
    return err, sm


@contextlib.contextmanager
def recording(module, name: str):
    """The calls of ``module.name`` made inside the block: their
    arguments, in order (the call goes through)."""
    seen, real = [], getattr(module, name)
    setattr(module, name, lambda *a, **k: seen.append(a) or real(*a, **k))
    try:
        yield seen
    finally:
        setattr(module, name, real)


def superblocks(cfg, gen, n: int) -> list[torch.Tensor]:
    """``n`` superblocks of SHARDS flagship blocks each (a tone 1 kHz above
    the tune over -90 dBFS noise, phase-continuous)."""
    blocks = stimulus(cfg, n * SHARDS, gen,
                      carriers=(dict(offset_hz=1000.0),))
    return [torch.cat(blocks[i * SHARDS:(i + 1) * SHARDS]) for i in range(n)]


def rate_line(label: str, ms: float, n_in: int, fs: float, ref_ms: float,
              gpu_label: str, ref: str = "the single receiver") -> None:
    """One line of a path's time, Msps and real-time factor beside those of
    ``ref`` over the same samples."""
    msps = n_in / (ms * 1e-3) / 1e6
    rt = n_in / fs * 1e3 / ms
    phase(f"{label}: {ms:.3f} ms, {msps:.1f} Msps, {rt:.2f}x real time; "
          f"{ref} over the same samples {ref_ms:.3f} ms, "
          f"{n_in / (ref_ms * 1e-3) / 1e6:.1f} Msps, "
          f"{n_in / fs * 1e3 / ref_ms:.2f}x ({gpu_label})")


def wall_ms(fn, inputs) -> float:
    """Host milliseconds a call of ``fn(x)`` over ``inputs``, ending in a
    synchronize (work on more than one stream)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(inputs)


def hold_shard_kernels(calls: dict) -> None:
    """Each kernel call recorded on the time-shard path, held against its
    plain version on the same inputs: K1 on a shard with its left
    neighbour's raw halo and its own phase base, K2's stateless form on
    [neighbour's decimated tail | shard], K5 and K4 on the gathered
    1,048,576-sample block."""
    for i, (plan, params, carry, re, im, dc) in enumerate(calls["mixdec"]):
        (_, yk), (_, yp) = (mixdec.process_planes(plan, params, carry, re, im,
                                                  dc),
                            mixdec.process_planes_plain(plan, params, carry,
                                                        re, im, dc))
        err = max_err(f"mixdec timeshard shard {i}", [yk.real, yk.imag],
                      [yp.real, yp.imag], 5e-5 * float(yp.abs().max()))
        phase(f"kernel mixdec timeshard shard {i} (phase base "
              f"{int(carry.phase)}): max_abs_err {err:.3e}")
    for i, (h, z, ntaps) in enumerate(calls["filter_frames"]):
        yk, yp = (fastfir.filter_frames(h, z, ntaps),
                  fastfir.filter_frames_plain(h, z, ntaps))
        err = max_err(f"fastfir timeshard shard {i}", [yk.real, yk.imag],
                      [yp.real, yp.imag], 5e-5 * float(yp.abs().max()))
        phase(f"kernel fastfir timeshard shard {i} ({z.shape[-1]} samples "
              f"with the halo): max_abs_err {err:.3e}")
    for mag, aa, ad, a0, d0 in calls["smeter_last"]:
        label = f" timeshard {mag.shape[-1]:,}"
        _, _, got, want, tol = smeter_tol(mag, aa, ad, a0, d0, label)
        err = max_err("smeter" + label, got, want, tol)
        phase(f"kernel smeter{label}: max_abs_err {err:.3e} (tol {tol:.3e})")
    for j, args in enumerate(calls["guess_verify_solve"]):
        label = (f" timeshard {args[0].numel():,} "
                 f"{'attack' if j % 2 == 0 else 'decay'}")
        xk, xp, _, _, err_p = solve_errors(label, args)
        err = max_err("scan_solve" + label, [xk], [xp], 1e-5 + err_p)
        phase(f"kernel scan_solve{label}: max_abs_err {err:.3e}")


def check_timeshard(gen, gpu_label: str) -> dict:
    """``timeshard usb 4x``: the flagship over four time shards on one
    card, two superblocks of 33,554,432 samples, against the single
    receiver over the same eight blocks; then the recorded kernel calls
    against their plain versions; then both timed over two more
    superblocks."""
    from cutesdr_tpu_torch.shard import ShardedReceiver, make_mesh
    from cutesdr_tpu_torch.shard import timeshard
    label = "timeshard usb 4x"
    cfg = rx.ReceiverConfig(mode="usb", **FULL)
    sbs = superblocks(cfg, gen, 4)
    n = cfg.block_size
    mesh = make_mesh(time=SHARDS, devices=["cuda:0"] * SHARDS)
    srx = ShardedReceiver(cfg, mesh)
    single = rx.Receiver(cfg)
    reset_counts()
    outs = [srx.process(sb) for sb in sbs[:2]]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    # the kernel calls of the path, recorded on its step run eagerly from
    # a fresh state over the same superblocks (a graph's arguments are
    # its static buffers; ``graph_timeshard`` holds the graph to this
    # step bitwise)
    ref = ShardedReceiver(cfg, mesh)
    carry, S = ref.carry, n
    with contextlib.ExitStack() as stack:
        calls = {name: stack.enter_context(recording(mod, name))
                 for mod, name in ((timeshard.mixdec, "process_planes"),
                                   (timeshard.fastfir_k, "filter_frames"),
                                   (scan, "smeter_last"),
                                   (scan, "guess_verify_solve"))}
        for sb in sbs[:2]:
            carry, _ = timeshard.sharded_step(
                cfg, ref.exchange, [ref.params] * SHARDS, ref.params, carry,
                [(sb[i * S:(i + 1) * S].real, sb[i * S:(i + 1) * S].imag)
                 for i in range(SHARDS)], ref.superblock_size)
        torch.cuda.synchronize()
    fallbacks = agc.STATS["scan_fallbacks"]
    phase(f"{label} launches {launches}, agc scan fallbacks {fallbacks} "
          f"over 2 superblocks (graphed {srx.graphed})")
    check_routed(label, launches, routed_kernels(cfg, False, srx.params))
    for sb, out in zip(sbs[:2], outs):
        refs = [single.process(sb[b * n:(b + 1) * n]) for b in range(SHARDS)]
        err, sm = hold_audio(label, out, refs)
        phase(f"{label} superblock: audio {err:.3e} x peak, S-meter "
              f"{sm:.4f} dB from the single receiver's")
    tone_ratio(channel_audio(outs[1])[0], cfg.audio_rate, 1000.0, label)
    hold_shard_kernels({"mixdec": calls["process_planes"][SHARDS:],
                        "filter_frames": calls["filter_frames"][SHARDS:],
                        "smeter_last": calls["smeter_last"][-1:],
                        "guess_verify_solve": calls["guess_verify_solve"][-2:]})
    del calls
    ms = wall_ms(srx.process, sbs[2:])
    ref_ms = wall_ms(single.process, [sb[b * n:(b + 1) * n] for sb in sbs[2:]
                                      for b in range(SHARDS)]) * SHARDS
    rate_line(f"{label} per superblock", ms, SHARDS * n, cfg.input_rate,
              ref_ms, gpu_label)
    return launches


def check_pipelined(gen, gpu_label: str) -> dict:
    """``pipelined usb``: the flagship through ``PipelinedReceiver`` with
    both stages on cuda:0 (the front on a stream of its own), four blocks
    and a flush against the single receiver one block late: bitwise, or
    else within 1e-5 x peak, said so."""
    from cutesdr_tpu_torch.shard import PipelinedReceiver
    label = "pipelined usb"
    cfg = rx.ReceiverConfig(mode="usb", **FULL)
    blocks = stimulus(cfg, 12, gen, carriers=(dict(offset_hz=1000.0),))
    pp = PipelinedReceiver(cfg, "cuda:0", "cuda:0")
    single = rx.Receiver(cfg)
    reset_counts()
    outs = [pp.process(b) for b in blocks[:4]] + [pp.flush()]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    phase(f"{label} launches {launches} over 4 blocks")
    check_routed(label, launches, routed_kernels(cfg, False, pp.params))
    if outs[0] is not None or any(o is None for o in outs[1:]):
        raise AssertionError(f"{label}: the outputs are not one block late")
    refs = [single.process(b) for b in blocks[:4]]
    bitwise = all(torch.equal(getattr(o, f), getattr(r, f))
                  for o, r in zip(outs[1:], refs)
                  for f in ("audio", "n_audio", "smeter_ave_db",
                            "smeter_peak_db"))
    errs = [hold_audio(label, o, [r], PIPE_TOL)[0]
            for o, r in zip(outs[1:], refs)]
    phase(f"{label}: {'bitwise equal to' if bitwise else 'not bitwise'} the "
          f"single receiver one block late (max {max(errs):.3e} x peak)")
    tone_ratio(np.concatenate([channel_audio(o)[0] for o in outs[2:]]),
               cfg.audio_rate, 1000.0, label)
    ms = wall_ms(pp.process, blocks[4:])
    pp.flush()
    ref_ms = wall_ms(single.process, blocks[4:])
    rate_line(f"{label} per block", ms, cfg.block_size, cfg.input_rate,
              ref_ms, gpu_label)
    return launches


def check_bank_mesh(gen, gpu_label: str) -> dict:
    """``bank usb 64ch mesh4``: BASELINE config 4 (64 USB channels of one
    10 MSPS stream, one frame) over ``make_mesh(channels=4)`` on cuda:0,
    against the unsharded bank over the same blocks: bitwise, or else at
    the bank tests' 90 dB a channel, said so."""
    label = "bank usb 64ch mesh4"
    from cutesdr_tpu_torch.shard import make_mesh
    grid = [-4.5e6 + 140e3 * i for i in range(64)]
    cfg = rx.ReceiverConfig(input_rate=10e6, mode="usb")
    blocks = stimulus(cfg, 16, gen, noise_db=-60.0,
                      carriers=(dict(freq_hz=grid[0] + 1000.0),
                                dict(freq_hz=grid[37] + 1000.0)))
    sharded = channels.ChannelBank(
        cfg, grid, mesh=make_mesh(channels=SHARDS,
                                  devices=["cuda:0"] * SHARDS))
    whole = channels.ChannelBank(cfg, grid)
    reset_counts()
    outs = [sharded.process(b) for b in blocks[:12]]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    phase(f"{label} launches {launches}, agc scan fallbacks "
          f"{agc.STATS['scan_fallbacks']} over 12 blocks")
    check_routed(label, launches,
                 routed_kernels(cfg, True, sharded.parts[0].params))
    refs = [whole.process(b) for b in blocks[:12]]
    bitwise = all(torch.equal(getattr(o, f), getattr(r, f))
                  for o, r in zip(outs, refs)
                  for f in ("audio", "n_audio", "smeter_ave_db",
                            "smeter_peak_db"))
    if not bitwise:
        for c in range(64):
            want = np.concatenate([channel_audio(r)[c] for r in refs])
            got = np.concatenate([channel_audio(o)[c] for o in outs])
            if snr_db(want, got) < 90.0:
                raise AssertionError(f"{label}: channel {c} at "
                                     f"{snr_db(want, got):.1f} dB")
    phase(f"{label}: {'bitwise equal to' if bitwise else 'within 90 dB of'}"
          " the unsharded bank")
    # Four blocks (2,516 samples at 48 kHz) give 19.08 Hz bins, the one
    # nearest 1 kHz at 992.05 Hz, outside tone_ratio's 2 Hz: the tone is
    # checked over ten blocks (7.63 Hz bins), and the four-block reading
    # is printed for both banks.
    for ch in (0, 37):
        for name, res in (("sharded", outs), ("unsharded", refs)):
            f, r = tone_peak(np.concatenate(
                [channel_audio(o)[ch] for o in res[2:6]]), cfg.audio_rate)
            phase(f"{label} channel {ch}, {name}, blocks 2-5: peak at "
                  f"{f:.2f} Hz, peak/floor {r:.1f} dB")
        tone_ratio(np.concatenate([channel_audio(o)[ch] for o in outs[2:]]),
                   cfg.audio_rate, 1000.0, f"{label} channel {ch}")
    ms = wall_ms(sharded.process, blocks[12:])
    ref_ms = wall_ms(whole.process, blocks[12:])
    rate_line(f"{label} per block", ms, cfg.block_size, cfg.input_rate,
              ref_ms, gpu_label, "the unsharded bank")
    return launches


def timeshard_rank(port: int) -> int:
    """``--timeshard-rank PORT``: the time shards across a one-rank NCCL
    world (``shard.multihost``: ``initialize``, ``global_time_mesh``,
    ``HostShardedStream``), two superblocks of the flagship against the
    local ``ShardedReceiver``; prints one JSON line of its launches and
    errors last."""
    from cutesdr_tpu_torch.shard import ShardedReceiver, make_mesh, multihost
    multihost.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        cfg = rx.ReceiverConfig(mode="usb", **FULL)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + 12)
        sbs = superblocks(cfg, gen, 3)
        srx = ShardedReceiver(cfg, multihost.global_time_mesh(
            ["cuda:0"] * SHARDS))
        local = ShardedReceiver(cfg, make_mesh(time=SHARDS,
                                               devices=["cuda:0"] * SHARDS))
        hs = srx.host_stream()
        reset_counts()
        outs = [srx.process(hs.assemble(sb)) for sb in sbs[:2]]
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        errs = [hold_audio("timeshard multihost 1rank", o,
                           [local.process(sb)])
                for o, sb in zip(outs, sbs[:2])]
        ms = wall_ms(lambda sb: srx.process(hs.assemble(sb)), sbs[2:])
        ref_ms = wall_ms(local.process, sbs[2:])
        print(json.dumps({"launches": launches, "errors": errs, "ms": ms,
                          "local_ms": ref_ms}), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def check_timeshard_multihost(gpu_label: str) -> dict:
    """``timeshard multihost 1rank``: ``timeshard_rank`` in a process of
    its own (NCCL over 127.0.0.1)."""
    label = "timeshard multihost 1rank"
    port = free_port(socket.SOCK_STREAM)
    env = dict(os.environ, NCCL_SOCKET_IFNAME="lo")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--timeshard-rank", str(port)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"{label} failed:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    launches = res["launches"]
    phase(f"{label} launches {launches}; audio and S-meter from the local "
          f"ShardedReceiver's {res['errors']}")
    cfg = rx.ReceiverConfig(mode="usb", **FULL)
    check_routed(label, launches, {"mixdec", "fastfir", "smeter",
                                   "scan_solve", "agcseq"})
    rate_line(f"{label} per superblock", res["ms"], SHARDS * cfg.block_size,
              cfg.input_rate, res["local_ms"], gpu_label,
              "the local ShardedReceiver")
    return launches


def check_shard(gen, gpu_label: str) -> dict:
    """Every path of the multi-device layer; returns their launches
    summed."""
    total = dict.fromkeys(KERNELS, 0)
    t0 = time.perf_counter()
    for fn in (check_timeshard, check_pipelined, check_bank_mesh):
        for k, v in fn(gen, gpu_label).items():
            total[k] += v
    for k, v in check_timeshard_multihost(gpu_label).items():
        total[k] += v
    phase(f"multi-device layer: {time.perf_counter() - t0:.1f} s")
    return total


def profile_shard(gen, gpu_label: str, only=None) -> None:
    """``--profile`` of ``timeshard usb 4x`` (per superblock) and
    ``pipelined usb`` (per block); with ``only``, the listed labels."""
    from torch.profiler import ProfilerActivity, profile

    from cutesdr_tpu_torch.shard import (PipelinedReceiver, ShardedReceiver,
                                         make_mesh)
    cfg = rx.ReceiverConfig(mode="usb", **FULL)
    srx = ShardedReceiver(cfg, make_mesh(time=SHARDS,
                                         devices=["cuda:0"] * SHARDS))
    pp = PipelinedReceiver(cfg, "cuda:0", "cuda:0")
    sbs = superblocks(cfg, gen, 5)
    n = cfg.block_size
    for label, step, inputs in (
            ("timeshard usb 4x (per superblock)", srx.process, sbs),
            ("pipelined usb", pp.process,
             [sb[b * n:(b + 1) * n] for sb in sbs for b in range(SHARDS)])):
        if only is not None and label not in only:
            continue
        warm, steps = len(inputs) // 5, 2 * len(inputs) // 5
        for x in inputs[:warm]:
            step(x)
        ms = wall_ms(step, inputs[warm:warm + steps])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for x in inputs[warm + steps:warm + 2 * steps]:
                step(x)
            torch.cuda.synchronize()
        profile_report(label, ms, prof, steps, gpu_label)


# --------------------------------------------------------- the command line
# ``check_cli`` drives the port's ``cli.main`` in this process, as a user's
# ``python -m cutesdr_tpu_torch.cli`` would, with its radio inputs made by
# helper processes of this script (``--fake-netsdr``, ``--udp-feed``), so
# that they do not share the run loop's interpreter lock.  Nothing leaves
# the machine: the radio, the UDP ingest and the web server are on
# 127.0.0.1, and ``discover`` sends its request to 127.0.0.1.

CLI_DIR = os.path.join(ROOT, "build", "chip_cli")
CLI_FS = 2e6              # NetSDR bandwidth index 3: 80 MHz / 40
CLI_FS_UDP = 20e6         # BASELINE config 5's rate, the native ingest
CLI_TUNE = 100e3
CLI_TONE = CLI_TUNE + 1000.0   # 1 kHz above the tune: 1 kHz audio
CLI_AMP = 3000.0          # int16 wire amplitude of the tone
PKT_SAMPLES = 256         # complex samples of a 1,028-byte 16-bit packet
CLI_TONE_TOL = 50.0       # Hz: a live run that falls behind drops blocks,
                          # and the seams spread the tone's peak


def tone_stream(fs: float, seconds: float) -> np.ndarray:
    """``seconds`` of the CLI tone at ``fs`` as whole 1,028-byte 16-bit
    packets, headers and a radio's sequence numbers (0 first, then
    1..65535 round) in place: [packets, 1028] bytes, built ahead of the
    stream (the payloads repeat after lcm(period, 256) samples)."""
    total = int(seconds * fs / PKT_SAMPLES)
    period = int(round(fs / np.gcd(int(CLI_TONE), int(fs))))
    cycle = int(np.lcm(period, PKT_SAMPLES)) // PKT_SAMPLES
    t = np.arange(min(cycle, total) * PKT_SAMPLES)
    iq = CLI_AMP * np.exp(2j * np.pi * (CLI_TONE / fs) * t)
    data = np.empty(2 * len(t), "<i2")
    data[0::2], data[1::2] = np.round(iq.real), np.round(iq.imag)
    payload = data.view(np.uint8).reshape(-1, 4 * PKT_SAMPLES)
    buf = np.empty((total, 4 + 4 * PKT_SAMPLES), np.uint8)
    buf[:, 4:] = np.resize(payload, (total, payload.shape[1]))
    k = np.arange(total)
    seq = np.where(k == 0, 0, (k - 1) % 65535 + 1)
    buf[:, 0], buf[:, 1] = 0x04, 0x82          # 0x8204 little-endian
    buf[:, 2], buf[:, 3] = seq & 0xFF, seq >> 8
    return buf


def paced_send(send, pkts: np.ndarray, fs: float, stop) -> int:
    """Send the packets one by one through ``send``, paced to ``fs``
    against the wall clock, until ``stop`` (an Event) is set; returns the
    packets sent."""
    t0 = time.perf_counter()
    sent = 0
    while sent < len(pkts) and not stop.is_set():
        due = min(len(pkts), int((time.perf_counter() - t0) * fs
                                 / PKT_SAMPLES) + 1)
        while sent < due:
            send(pkts[sent])
            sent += 1
        time.sleep(0.0002)
    return sent


def fake_netsdr(seconds: float) -> int:
    """``--fake-netsdr SECONDS``: a NetSDR on 127.0.0.1 (its port printed
    on the first line) for one client after another: it answers the
    handshake, acks sets and, once a client sets RX_STATE on, streams up
    to ``seconds`` of the CLI tone at 2 MSPS as 1,028-byte 16-bit packets
    to the client's UDP port (the NetSDR's: the TCP port), until the
    client sets RX_STATE idle or disconnects.  Runs until it is
    stopped."""
    import asyncio

    from cutesdr_tpu_torch.io import ascp
    from cutesdr_tpu_torch.io.ascp import AscpMessage, StreamAssembler, ci

    async def serve():
        udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        pkts = tone_stream(CLI_FS, seconds)

        async def handle(reader, writer):
            asm, stop, streams = StreamAssembler(), threading.Event(), []

            def stream():
                n = paced_send(lambda p: udp.sendto(p, ("127.0.0.1", port)),
                               pkts, CLI_FS, stop)
                print(f"fake netsdr: sent {n} packets", flush=True)

            while True:
                try:
                    data = await reader.read(4096)
                except ConnectionResetError:
                    break
                if not data:
                    break
                for msg in asm.feed(data):
                    item = msg.citem() if len(msg.body) >= 2 else None
                    if msg.msg_type == ascp.TYPE_HOST_REQ_CITEM:
                        m = AscpMessage(ascp.TYPE_TARG_RESP_CITEM)
                        m.add_citem(item)
                        if item == ci.GENERAL_INTERFACE_NAME:
                            m.body += b"NetSDR\0"
                        elif item == ci.GENERAL_INTERFACE_SERIALNUM:
                            m.body += b"SMOKE001\0"
                        elif item == ci.GENERAL_HARDFIRM_VERSION:
                            msg.rewind()
                            m.add_u8(msg.get_u8()).add_u16(123)
                        elif item == ci.GENERAL_STATUS_CODE:
                            m.add_u8(ci.STATUS_IDLE)
                        writer.write(m.to_bytes())
                    elif msg.msg_type == ascp.TYPE_HOST_SET_CITEM:
                        if item == ci.RX_STATE:
                            msg.rewind()
                            msg.get_u8()
                            if msg.get_u8() == ci.RX_STATE_ON:
                                if not streams:
                                    streams.append(threading.Thread(
                                        target=stream, daemon=True))
                                    streams[0].start()
                            else:
                                stop.set()
                        writer.write(msg.to_bytes())   # sets are acked
                    await writer.drain()
            stop.set()
            for t in streams:
                t.join()

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        print(port, flush=True)
        await server.serve_forever()

    asyncio.run(serve())
    return 0


def udp_feed(port: int, seconds: float) -> int:
    """``--udp-feed PORT SECONDS``: print a line when ready, wait until the
    native ingest has bound 127.0.0.1:PORT (a 1-byte probe, which the
    ingest ignores, is refused until then), then send ``seconds`` of the
    CLI tone at 20 MSPS as 1,028-byte 16-bit packets (78,125 a second),
    paced to the wall clock.  The packets are built ahead and sent in
    batches through libc's sendmmsg (one call a batch): a Python call a
    packet does not reach that rate."""
    import ctypes
    import ctypes.util

    libc = ctypes.CDLL(ctypes.util.find_library("c"), use_errno=True)
    libc.sendmmsg.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_uint,
                              ctypes.c_int]
    pkts = tone_stream(CLI_FS_UDP, seconds)
    total, size = pkts.shape
    # struct iovec {base, len} and struct mmsghdr {msghdr (56 bytes: name,
    # namelen, iov, iovlen, control, controllen, flags), msg_len} on
    # 64-bit Linux; a connected socket needs no name
    iov = np.zeros((total, 2), np.uint64)
    iov[:, 0] = pkts.ctypes.data + size * np.arange(total, dtype=np.uint64)
    iov[:, 1] = size
    msgs = np.zeros((total, 8), np.uint64)
    msgs[:, 2] = iov.ctypes.data + 16 * np.arange(total, dtype=np.uint64)
    msgs[:, 3] = 1
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.connect(("127.0.0.1", port))
        print("ready", flush=True)
        deadline, ok = time.time() + 120.0, 0
        while ok < 3:
            if time.time() > deadline:
                print("udp feed: the ingest never bound", flush=True)
                return 1
            try:
                s.send(b"\0")
                time.sleep(0.005)
                s.send(b"\0")          # raises if the first was refused
                ok += 1
            except ConnectionRefusedError:
                ok = 0
            time.sleep(0.005)
        t0 = time.perf_counter()
        sent = 0
        while sent < total:
            due = min(total, int((time.perf_counter() - t0) * CLI_FS_UDP
                                 / PKT_SAMPLES) + 1)
            while sent < due:
                k = libc.sendmmsg(s.fileno(), msgs.ctypes.data + 64 * sent,
                                  min(due - sent, 1024), 0)
                if k < 0:                # refused: the run has what it needs
                    break
                sent += k
            if k < 0:
                break
            time.sleep(0.0002)
        print(f"udp feed: sent {sent} packets in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    return 0


@contextlib.contextmanager
def helper(*args):
    """A helper process of this script (``--fake-netsdr`` or
    ``--udp-feed``) whose first line of output has been read; yields
    (process, that line).  On leaving, a feeder is waited for and a fake
    radio stopped; their last line is printed."""
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             *map(str, args)], stdout=subprocess.PIPE,
                            text=True)
    try:
        yield proc, proc.stdout.readline().strip()
    finally:
        if args[0] == "--fake-netsdr":
            proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        tail = proc.stdout.read().strip()
        if tail:
            phase(f"  ({tail.splitlines()[-1]})")
        proc.stdout.close()


def free_port(kind=socket.SOCK_DGRAM) -> int:
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Tee(io.TextIOBase):
    """Standard error, also kept for the script to read."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        return self.buf.write(s)

    def flush(self):
        self.out.flush()


def run_cli(argv, profiler=None) -> str:
    """``cli.main(argv)`` in this process (under ``profiler`` if given);
    raises unless it returns 0; returns what it wrote to standard
    error."""
    from cutesdr_tpu_torch import cli
    tee = _Tee(sys.stderr)
    with contextlib.redirect_stderr(tee):
        with profiler if profiler is not None else contextlib.nullcontext():
            rc = cli.main(argv)
            torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)}: rc {rc}")
    return tee.buf.getvalue()


RUN_LINE = re.compile(r"processed (\d+) samples in ([\d.]+)s \(([\d.]+) Msps, "
                      r"([\d.]+)x real time\)(.*) -> ")


def run_summary(err: str) -> dict:
    """The numbers of ``cli run``'s closing line: samples, seconds, Msps,
    the real-time factor and the source's counters (name=value)."""
    m = RUN_LINE.search(err)
    if m is None:
        raise AssertionError(f"cli run printed no closing line:\n{err}")
    out = {"samples": int(m[1]), "seconds": float(m[2]),
           "msps": float(m[3]), "realtime": float(m[4])}
    out.update((k, int(v)) for k, v in re.findall(r"(\w+)=(\d+)", m[5]))
    gain = re.search(r"rx2 gain ([\d.]+) ∠(-?[\d.]+)°", m[5])
    if gain:
        out["rx2_gain"] = float(gain[1]) * np.exp(1j * np.deg2rad(
            float(gain[2])))
    return out


def wav_audio(path: str) -> np.ndarray:
    with wave.open(path) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def cli_cfg(argv):
    """The receiver configuration the CLI builds from ``argv`` (radio:
    sources take their rate table and centre first)."""
    from cutesdr_tpu_torch import cli
    args = cli.build_parser().parse_args(argv)
    with contextlib.redirect_stderr(io.StringIO()):
        cli._apply_radio_rate(args)
        return cli._cfg_from_args(args)


def cli_routes(cfgs, bank: bool = False) -> set:
    """The kernels that the configurations' receivers route to (their
    single-stream params from ``rx.init``; a bank's are not read)."""
    return set().union(*(routed_kernels(
        c, bank, None if bank else rx.init(c, "cuda")[0]) for c in cfgs))


def cli_run_specs(seconds: float, radio_port: str):
    """The ``cli run`` paths: (label, argv without --out, the seconds a
    UDP feeder sends, or None): ``seconds`` of the live sources, half as
    much of the dual-RX generator.  ``PORT`` in an argv is the feeder's
    port."""
    radio = ["run", "--source", f"radio:127.0.0.1:{radio_port}",
             "--bw-index", "3", "--center", "0", "--freq", str(CLI_TUNE),
             "--mode", "usb", "--seconds", str(seconds)]
    udp = ["run", "--source", "udp:PORT", "--fs", str(CLI_FS_UDP),
           "--freq", str(CLI_TUNE), "--mode", "usb", "--seconds",
           str(seconds)]
    lat0 = ["--target-latency-ms", "0"]
    return [("cli run netsdr 2msps", radio, None),
            ("cli run netsdr 2msps lat0", radio + lat0, None),
            ("cli run udp 20msps", udp, seconds),
            ("cli run udp 20msps lat0", udp + lat0, seconds),
            ("cli run dual", ["run", "--dual", "--source",
                              f"dualtone:{CLI_TONE:.0f}:40:0.8", "--fs",
                              str(CLI_FS), "--freq", str(CLI_TUNE),
                              "--mode", "usb", "--seconds",
                              str(seconds / 2)], None)]


def drive_cli_run(label, argv, feed_seconds, profiler=None):
    """One ``cli run`` path from zeroed counts, with a UDP feeder beside it
    where ``feed_seconds`` is given: returns (argv as run, its standard
    error, the WAV's path, the launch counts)."""
    out = os.path.join(CLI_DIR, label.replace(" ", "_") + ".wav")
    argv = argv + ["--out", out]
    reset_counts()
    if feed_seconds is None:
        err = run_cli(argv, profiler)
    else:
        port = str(free_port())
        argv = [a.replace("PORT", port) for a in argv]
        with helper("--udp-feed", port, feed_seconds):
            err = run_cli(argv, profiler)
    return argv, err, out, dict(kernels.LAUNCHES)


def check_cli_run(label, argv, feed_seconds, gpu_label):
    """A ``cli run`` path: the tone at 1 kHz > 60 dB over the floor in the
    WAV's second half, the kernels its configuration routes to (and no
    other), and its numbers: Msps, the real-time factor, the source's
    lost packets or blocks, launches a block.  Returns (launches, the
    closing line's numbers)."""
    argv, err, out, launches = drive_cli_run(label, argv, feed_seconds)
    s = run_summary(err)
    cfg = cli_cfg(argv)
    blocks = s["samples"] // cfg.block_size
    extra = {k: v for k, v in s.items()
             if k not in ("samples", "seconds", "msps", "realtime",
                          "rx2_gain")}
    phase(f"{label}: block {cfg.block_size} (fastfir {cfg.fastfir_nfft}/"
          f"{cfg.fastfir_ntaps}), {blocks} blocks in {s['seconds']:.2f} s, "
          f"{s['msps']:.3f} Msps, {s['realtime']:.3f}x real time, {extra}, "
          f"{sum(launches.values()) / max(blocks, 1):.2f} launches a block "
          f"{launches} (host reads a block: its --profile line; "
          f"{gpu_label})")
    if blocks == 0:
        raise AssertionError(f"{label}: no block ran")
    audio = wav_audio(out).astype(np.float64)
    tone_ratio(audio[len(audio) // 2:], 48000.0, 1000.0, label,
               CLI_TONE_TOL)
    check_routed(label, launches, cli_routes([cfg]))
    return launches, s


def check_cli_file(fmt: str, radio_port: str, add) -> None:
    """``cli record`` of 1 s from the fake radio (SigMF cf32, or a legacy
    int16 file), then ``cli run`` over the capture twice: both WAVs and
    the WAV of ``Receiver.process`` block by block over the same file are
    equal, byte for byte."""
    from cutesdr_tpu_torch.io.filesource import FileSource, WavSink
    from cutesdr_tpu_torch.io.recorder import open_sigmf

    legacy = fmt == "int16"
    path = os.path.join(CLI_DIR, "capture.raw" if legacy else "capture")
    reset_counts()
    run_cli(["record", "--source", f"radio:127.0.0.1:{radio_port}",
             "--bw-index", "3", "--center", "0", "--freq", str(CLI_TUNE),
             "--seconds", "1", "--fmt", fmt, "--out", path]
            + (["--legacy"] if legacy else []))
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"cli record launched {kernels.LAUNCHES}")
    source = f"{path}:int16" if legacy else f"{path}.sigmf-data"
    argv = ["run", "--source", f"file:{source}", "--fs", str(CLI_FS),
            "--freq", str(CLI_TUNE), "--mode", "usb", "--seconds", "1",
            "--target-latency-ms", "0"]
    cfg = cli_cfg(argv)
    wavs = []
    for k in range(2):
        wavs.append(os.path.join(CLI_DIR, f"play_{fmt}_{k}.wav"))
        reset_counts()
        err = run_cli(argv + ["--out", wavs[-1]])
        add(kernels.LAUNCHES)
        check_routed(f"cli run file {fmt}", kernels.LAUNCHES,
                     cli_routes([cfg]))
    r = rx.Receiver(cfg)
    r.set_volume(99)
    src = FileSource(path, "int16") if legacy else open_sigmf(source)[0]
    direct = os.path.join(CLI_DIR, f"direct_{fmt}.wav")
    with WavSink(direct, 48000) as wav:
        for _ in range(int(CLI_FS / cfg.block_size)):
            out = r.process(src.next_block(cfg.block_size))
            wav.write(out.audio[:int(out.n_audio)].cpu().numpy())
    blobs = [open(p, "rb").read() for p in wavs + [direct]]
    s = run_summary(err)
    phase(f"cli record -> run ({'legacy int16' if legacy else 'SigMF cf32'}"
          f"): {len(blobs[0])} WAV bytes a play, {s['msps']:.2f} Msps from "
          f"the file; the plays equal {blobs[0] == blobs[1]}, equal to "
          f"Receiver.process {blobs[0] == blobs[2]}")
    if not blobs[0] == blobs[1] == blobs[2]:
        raise AssertionError(f"cli record -> run ({fmt}): the WAVs differ")
    audio = wav_audio(wavs[0]).astype(np.float64)
    tone_ratio(audio[len(audio) // 2:], 48000.0, 1000.0,
               f"cli run file {fmt}")


def wait_for_server(port: int, thread) -> None:
    deadline = time.time() + 120
    while True:
        try:
            http_json(port, "/spectrum.json")
            return
        except OSError:
            if time.time() > deadline or not thread.is_alive():
                raise
            time.sleep(0.05)


def check_cli_serve(gpu_label: str, add) -> None:
    """``cli serve`` with --realtime, each from zeroed counts: the single
    session over the sweep generator (its modes' receivers built and
    warmed at start) with a GET of /spectrum.json, a volume, a tune and a
    switch to FM (whose noise-only channel takes K7); a bank of 8
    channels (K6); the dual-RX session.  Each prints its status line and
    real-time factor.  The first serve's --settings file is loaded by a
    second serve, which saves it again."""
    settings = os.path.join(CLI_DIR, "settings.json")
    if os.path.exists(settings):
        os.remove(settings)
    single = ["serve", "--source", "sweep", "--freq", str(CLI_TUNE),
              "--realtime", "--settings", settings]

    def act_single(port):
        http_json(port, "/volume", {"volume": 42})
        frame = http_json(port, "/spectrum.json")
        tuned = http_json(port, "/tune", {"freq_hz": CLI_TUNE + 500.0})
        time.sleep(1.0)
        mode = http_json(port, "/mode", {"mode": "fm"})
        phase(f"cli serve: /spectrum.json {len(frame.get('db', []))} bins, "
              f"/tune -> {tuned}, /mode -> {mode}")
        if tuned != {"tune_hz": CLI_TUNE + 500.0} or mode != {"mode": "fm"}:
            raise AssertionError("cli serve: the server round trip failed")

    cfg = cli_cfg(single)
    sess = ReceiverSession(cfg)
    singles = [sess._mode_cfg(m) for m in ("am", "sam", "fm", "usb", "lsb",
                                           "cwu", "cwl")]
    singles.append(dataclasses.replace(cfg, probes=True))
    del sess
    freqs = ",".join(f"{CLI_TUNE + 20e3 * i:.0f}" for i in range(8))
    bank = ["serve", "--source", f"tone:{CLI_TONE:.0f}", "--freq",
            str(CLI_TUNE), "--realtime", "--channels", freqs]
    dual = ["serve", "--dual", "--source", f"dualtone:{CLI_TONE:.0f}:40:0.8",
            "--freq", str(CLI_TUNE), "--realtime"]
    for label, argv, seconds, cfgs, is_bank, act in (
            ("cli serve", single, 2.5, singles, False, act_single),
            ("cli serve 8 channels", bank, 1.5, [cli_cfg(bank)], True, None),
            ("cli serve dual", dual, 1.5, [cli_cfg(dual)], False, None)):
        port = free_port(socket.SOCK_STREAM)
        reset_counts()
        box = {}
        th = threading.Thread(target=lambda: box.update(err=run_cli(
            argv + ["--seconds", str(seconds), "--port", str(port)])),
            daemon=True)
        th.start()
        if act is not None:
            wait_for_server(port, th)
            act(port)
        th.join(180)
        if th.is_alive() or "err" not in box:
            raise AssertionError(f"{label}: serve did not end cleanly")
        launches = dict(kernels.LAUNCHES)
        add(launches)
        status = box["err"].strip().splitlines()[-1]
        phase(f"{label}: {status}; launches {launches} ({gpu_label})")
        need = {"seqloop_fm"} if label == "cli serve" else set()
        check_routed(label, launches, cli_routes(cfgs, is_bank) | need)
    with open(settings) as f:
        saved = json.load(f)
    run_cli(single + ["--seconds", "0.5", "--no-precompile", "--port",
                      str(free_port(socket.SOCK_STREAM))])
    with open(settings) as f:
        again = json.load(f)
    phase(f"cli serve --settings: saved mode {saved['demod_mode']}, volume "
          f"{saved['volume']}, tune {saved['radio']['demod_frequency']}; a "
          f"second serve loaded it and saved volume {again['volume']}")
    if (saved["demod_mode"], saved["volume"], again["volume"]) != (
            "fm", 42, 42):
        raise AssertionError("cli serve: the settings did not round-trip")


def check_cli_tools() -> None:
    """``cli spectrum`` (the tone's peak bin), ``cli latency`` (its JSON is
    ``latency_report``'s) and ``cli discover`` (its request sent to
    127.0.0.1: rc 0, no devices found); none launches a kernel."""
    from cutesdr_tpu_torch.io import discover

    reset_counts()
    lat_argv = ["latency", "--mode", "fm", "--target-latency-ms", "10"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_cli(["spectrum", "--source", f"tone:{CLI_TONE:.0f}", "--fs",
                 str(CLI_FS), "--fft-size", "4096"])
        run_cli(lat_argv + ["--with-queue"])
    spec, lat = (json.loads(x) for x in buf.getvalue().strip().splitlines())
    bin_hz = CLI_FS / 4096
    want = {k: round(v * 1e3, 3) for k, v in latency_report(
        cli_cfg(lat_argv), include_queue=True).items()}
    phase(f"cli spectrum: peak {spec['peak_db']:.1f} dB at "
          f"{spec['peak_freq_hz']:.0f} Hz (tone {CLI_TONE:.0f}, bin "
          f"{bin_hz:.0f} Hz), floor {spec['noise_floor_db']:.1f} dB; cli "
          f"latency: {lat}")
    if abs(spec["peak_freq_hz"] - CLI_TONE) > bin_hz:
        raise AssertionError("cli spectrum: the peak is not the tone")
    if {k: lat[k] for k in want} != want:
        raise AssertionError("cli latency: not latency_report's")

    class Loopback(socket.socket):
        def sendto(self, data, addr):     # never a broadcast from here
            return super().sendto(data, ("127.0.0.1", addr[1]))

    kept = discover.socket
    discover.socket = types.SimpleNamespace(
        **{k: getattr(socket, k) for k in dir(socket) if k.isupper()},
        socket=Loopback, timeout=socket.timeout)
    try:
        err = run_cli(["discover", "--timeout", "0.2"])
    finally:
        discover.socket = kept
    phase(f"cli discover (its request to 127.0.0.1): {err.strip()}")
    if "no devices found" not in err:
        raise AssertionError("cli discover: unexpected answer")
    if any(kernels.LAUNCHES.values()):
        raise AssertionError(f"cli spectrum/latency/discover launched "
                             f"{kernels.LAUNCHES}")


def check_cli(gpu_label: str) -> dict:
    """The command line on the card (``cli.main`` in this process): the
    ``run`` paths (a fake NetSDR at 2 MSPS and the native UDP ingest at 20
    MSPS, each at the 10 ms default and at --target-latency-ms 0; the
    dual-RX generator, its gain against 0.8/40 degrees), ``record`` to
    SigMF and to a legacy file played back by ``run``, ``serve``,
    ``spectrum``, ``latency`` and ``discover``.  Every path starts from
    zeroed counts and launches the kernels its configurations route to,
    and no other.  Returns the launches summed over the paths."""
    os.makedirs(CLI_DIR, exist_ok=True)
    total = dict.fromkeys(KERNELS, 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    with helper("--fake-netsdr", 2.0) as (_, radio_port):
        for label, argv, feed in cli_run_specs(2.0, radio_port):
            launches, s = check_cli_run(label, argv, feed, gpu_label)
            add(launches)
            if label == "cli run dual":
                err = abs(s["rx2_gain"] - DIVERSITY_GAIN)
                phase(f"{label}: rx2 gain off 0.8/40 degrees by {err:.4f} "
                      "(bar 0.05, as check_diversity's)")
                if err > 0.05:
                    raise AssertionError("cli run dual: gain estimate off")
        for fmt in ("cf32", "int16"):
            check_cli_file(fmt, radio_port, add)
    check_cli_serve(gpu_label, add)
    check_cli_tools()
    return total


def profile_cli(gpu_label: str) -> None:
    """``--profile`` of the ``cli run`` paths (half a second of signal
    each) under torch.profiler: a line per path, per block: busy ms,
    launches, host reads (aten::_local_scalar_dense); and the run loop's
    staged copies waited on (cudaEventSynchronize)."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(CLI_DIR, exist_ok=True)
    with helper("--fake-netsdr", 0.5) as (_, radio_port):
        for label, argv, feed in cli_run_specs(0.5, radio_port):
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            argv, err, _, _ = drive_cli_run(label, argv, feed, prof)
            s = run_summary(err)
            blocks = s["samples"] // cli_cfg(argv).block_size
            waits = {e.key: e.count for e in prof.key_averages()}.get(
                "cudaEventSynchronize", 0)
            phase(f"{label}: {s}; {waits / blocks:.2f} event waits a block")
            profile_report(label, s["seconds"] * 1e3 / blocks, prof, blocks,
                           gpu_label)


# ---------------------------------------------------------------- the bench
# ``check_bench`` runs the port's bench as its users call it: the flagship
# line from ``bench_torch.py`` in a process of its own, and the twelve suite
# rows through ``cli.main(["bench", "--suite", ...])`` in this process, each
# row's launches, PLL tiers and AGC fallbacks counted over its timed reps.

BENCH_DIR = os.path.join(ROOT, "build", "chip_bench")
BENCH_ITERS = 2           # chained steps a rep of a suite row
FLAGSHIP_REPS = 10
FLAGSHIP_ITERS = 8
KERNELS_K1_K9 = {"mixdec", "fastfir", "scan_plain", "scan_solve", "smeter",
                 "fastfir_batch", "seqloop_fm", "seqloop_sam", "resamp"}


def bench_row_check(label: str, res: dict, cfg, bank: bool, ms_key: str,
                    gpu_label: str) -> None:
    """A bench line: no error, the kernels its configuration routes to (by
    the tiers and fallbacks it counted) and no other, finite times with
    the wall time at or above the CUDA-event time."""
    if "error" in res:
        raise AssertionError(f"{label}: {res['error']}")
    params = rx.init(cfg, "cuda")[0]
    check_routed(label, res["launches"],
                 routed_kernels(cfg, bank, params, res,
                                res.get("wire") == "int16-planes"))
    ms, ev = res[ms_key], res["event_" + ms_key]
    if not (0 < ev <= ms and math.isfinite(ms)):
        raise AssertionError(f"{label}: wall {ms} ms against event {ev} ms")
    if res["device"]["name"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"{label}: measured on {res['device']}")
    rule = rx.bank_graph_rule if bank else rx.graph_rule
    if res["graphed"] != rule(cfg, "cuda") or (res["graphed"]
                                               and res["host_reads"]):
        raise AssertionError(f"{label}: graphed {res['graphed']}, host "
                             f"reads {res['host_reads']}")
    phase(f"{label}: {ms:.3f} ms wall, {ev:.3f} ms event a "
          f"{ms_key.split('_')[-1]} over {res.get('reps')} reps, graphed "
          f"{res['graphed']}, eager {res.get('eager_ms')} ms, host reads "
          f"{res['host_reads']} ({gpu_label})")


def check_bench(gpu_label: str) -> dict:
    """The flagship line (``bench_torch.py --reps 10 --iters 8``: one JSON
    line, n = 10) and every suite row at ``--iters 2`` (``cli bench
    --suite``): each prints its line here, launches the kernels its
    configuration routes to and no other, reports no error and a wall time
    at or above its event time; the rows together launch K1-K9.  Returns
    the launches summed over the rows and the flagship."""
    os.makedirs(BENCH_DIR, exist_ok=True)
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py"),
                           "--reps", str(FLAGSHIP_REPS), "--iters",
                           str(FLAGSHIP_ITERS)], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench_torch.py: rc {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    phase(f"bench flagship: {lines[0]}")
    flag = json.loads(lines[0])
    if (flag["metric"] != "iq_msps_per_gpu"
            or flag["stats"]["n"] != FLAGSHIP_REPS):
        raise AssertionError(f"bench flagship: {flag}")
    flag_cfg = rx.ReceiverConfig(mode="usb", audio_rate=48000.0, **FULL)
    bench_row_check("bench flagship", dict(flag, reps=FLAGSHIP_REPS),
                    flag_cfg, False, "ms_per_step", gpu_label)

    from cutesdr_tpu_torch import cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["bench", "--suite", "--iters", str(BENCH_ITERS),
                       "--details", os.path.join(BENCH_DIR, "details.json")])
    rows = [json.loads(x) for x in out.getvalue().strip().splitlines()]
    for res in rows:
        phase(f"bench row: {json.dumps(res)}")
    table = bench_suite.rows()
    if rc != 0 or [r["config"] for r in rows] != [
            r.name for r in table.values()]:
        raise AssertionError(f"bench suite: rc {rc}, rows "
                             f"{[r['config'] for r in rows]}")
    total = dict.fromkeys(KERNELS, 0)
    for k, (row, res) in enumerate(zip(table.values(), rows), 1):
        bench_row_check(f"bench row {k} {row.name}", res, row.cfg,
                        row.kind == "bank",
                        "ms_per_block" if row.kind == "session"
                        else "ms_per_step", gpu_label)
        for name, v in res["launches"].items():
            total[name] += v
    missing = KERNELS_K1_K9 - {k for k, v in total.items() if v}
    if missing:
        raise AssertionError(f"bench suite: {sorted(missing)} never launched")
    for name, v in flag["launches"].items():
        total[name] += v
    return total


def main() -> int:
    if sys.argv[1:2] == ["--fake-netsdr"]:
        return fake_netsdr(float(sys.argv[2]))
    if sys.argv[1:2] == ["--udp-feed"]:
        return udp_feed(int(sys.argv[2]), float(sys.argv[3]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--timeshard-rank"]:
        return timeshard_rank(int(sys.argv[2]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    phase(f"device: {name} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False   # the port has no matmul

    t0 = time.perf_counter()
    _build.library()
    phase(f"build: {time.perf_counter() - t0:.1f} s (built "
          f"{metrics.COUNTERS.get('setup.kernels_built', 0)}, hash "
          f"{_build.source_hash()})")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    # a second stream of inputs for the later checks, so that the earlier
    # checks' inputs stay as they were
    gen_new = torch.Generator(device="cuda")
    gen_new.manual_seed(SEED + 6)
    gen_pll = torch.Generator(device="cuda")         # K7/K8's newer checks
    gen_pll.manual_seed(SEED + 8)
    gen_serve = torch.Generator(device="cuda")       # the serving paths'
    gen_serve.manual_seed(SEED + 9)
    gen_small = torch.Generator(device="cuda")       # K4 at small blocks
    gen_small.manual_seed(SEED + 10)
    gen_shard = torch.Generator(device="cuda")       # the shard paths'
    gen_shard.manual_seed(SEED + 11)
    if sys.argv[1:3] == ["--profile", "--only"] and len(sys.argv) == 4:
        only = set(sys.argv[3].split(","))
        profile_paths(gen, smi, only)
        profile_serving(gen_serve, smi, only)
        profile_shard(gen_shard, smi, only)
        return 0
    if sys.argv[1:] == ["--profile"]:
        profile_paths(gen, smi)
        profile_serving(gen_serve, smi)
        profile_shard(gen_shard, smi)
        profile_cli(smi)
        return 0
    results: dict = {}
    check_mixdec(gen, results, 2e6, "")
    check_mixdec(gen, results, 2e6, " strided planes", layout="strided")
    check_mixdec(gen, results, 2e6, " session block", n=32_768)
    check_mixdec(gen, results, 250e3, " D=4", n=262_144)
    check_mixdec(gen, results, 20e6, " D=256")
    check_mixdec_bank(gen)
    gen_k1 = torch.Generator(device="cuda")          # K1's int16 route
    gen_k1.manual_seed(SEED + 17)
    check_mixdec(gen_k1, results, 2e6, "", layout="int16", gpu_label=smi)
    check_mixdec(gen_k1, results, 2e6, " session block", n=32_768,
                 layout="int16", gpu_label=smi)
    check_mixdec(gen_k1, results, 2e6, " unaligned", layout="int16 unaligned",
                 gpu_label=smi)
    check_mixdec_bank(gen_k1, wire=True, gpu_label=smi)
    check_fastfir(gen, results)
    check_fastfir_batch(gen, results)
    check_scans(gen, results, gen_new)
    check_guess_verify(gen_new, results)
    check_guess_verify_small(gen_small)
    gen_rows = torch.Generator(device="cuda")        # K4 rows, N3h, N2
    gen_rows.manual_seed(SEED + 14)
    check_solve_rows(gen_rows)
    check_hang_solve(gen_rows, results)
    check_biquad(gen_rows, results)
    check_agcseq(gen_new, results)
    gen_skip = torch.Generator(device="cuda")        # the skip flags'
    gen_skip.manual_seed(SEED + 13)
    check_skips(gen_skip)
    check_resamp(gen, results, gen_new)
    check_seqloops(gen, results)
    check_seqloops_bank(gen)
    check_seqloop_redesign(gen_pll, results)
    check_other_shapes(gen)
    check_plain_filter_sizes(gen_new)
    check_fixtures()
    check_refgold_extras()
    launches = check_paths(gen, smi)
    gen_graph = torch.Generator(device="cuda")       # the graph paths'
    gen_graph.manual_seed(SEED + 12)
    gen_entries = torch.Generator(device="cuda")     # the graphed entries'
    gen_entries.manual_seed(SEED + 15)
    gen_wire = torch.Generator(device="cuda")        # the int16 paths'
    gen_wire.manual_seed(SEED + 16)
    for k, v in check_graph(gen_graph, smi, gen_entries, gen_wire).items():
        launches[k] += v
    for k, v in check_graph_rule(gen_graph, smi).items():
        launches[k] += v
    for k, v in check_session(smi).items():
        launches[k] += v
    # an odd sinc length: the session's banded tails through K9 at P = 29
    for k, v in check_session(smi, 29, SESSION_WALK[:2]).items():
        launches[k] += v
    for k, v in check_serving(gen_serve, smi).items():
        launches[k] += v
    for k, v in check_shard(gen_shard, smi).items():
        launches[k] += v
    t0 = time.perf_counter()
    for k, v in check_cli(smi).items():
        launches[k] += v
    phase(f"command line: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for k, v in check_bench(smi).items():
        launches[k] += v
    phase(f"bench: {time.perf_counter() - t0:.1f} s")
    never = [k for k, v in launches.items() if v == 0]
    if never:
        raise AssertionError(f"kernels never launched on a path: {never}")

    line = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], **results[k]}
        for k, (src, rep) in KERNELS.items()]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
