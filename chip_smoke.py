"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``cutesdr_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version at the main paths' shapes,
replays the golden / reference-binary fixtures (usb2m, usb, lsb, cwu, am,
sam, fm, and stereo sam) through the port on the card, then drives the
receiver paths with the input resident on the card, each over chained
steps, 48 kHz audio (``path_specs``):

* the flagship, USB at 2 MSPS, tune 100 kHz, frames_per_block=256
  (8,388,608 input samples), and the same with hang-mode AGC;
* FM, SAM and AM at frames_per_block=256 (262,144 demodulated samples,
  8,388,608 or 16,777,216 input samples), each recovering its modulating
  tone; SAM's first block acquires through the seqloop_sam kernel;
* an FM monitor on an idle channel at the low-latency configuration
  (512/257 filter, one frame: 256 demodulated samples), whose noise
  blocks take the seqloop_fm kernel;
* channel banks: 64 USB channels across one 10 MSPS stream (the JAX
  package's config 4, one frame per step), an 8-channel FM monitor whose
  bank-wide vote sends every block to seqloop_fm over 8 streams, 4 SAM
  channels acquiring through seqloop_sam, and a StackedReceiver of two
  separate full-width 2 MSPS streams.

Before each path every launch count is set to 0; after it, every kernel
that the path's configuration routes to must have launched, and no other.
Prints one line per phase, a JSON line of per-kernel results, the card's
name and power limit, and as its last line ``{"ok": true, "device":
{...}}``.  Any failed phase raises, so the script exits non-zero.  It
needs a CUDA device; it never imports jax.

    python3 chip_smoke.py --profile

builds the kernels and profiles the same receiver paths instead (step
time, device busy time, launches and host reads per step; see
``profile_paths``).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from cutesdr_tpu.design.decimation_plan import plan_decimation  # noqa: E402
from cutesdr_tpu.design.fastfir_design import design_fastfir  # noqa: E402
from cutesdr_tpu_torch import kernels  # noqa: E402
from cutesdr_tpu_torch.demod import fm, sam  # noqa: E402
from cutesdr_tpu_torch.kernels import (  # noqa: E402
    _build, fastfir, mixdec, scan, seqloop)
from cutesdr_tpu_torch.ops import agc, nco  # noqa: E402
from cutesdr_tpu_torch.pipeline import receiver as rx  # noqa: E402
from cutesdr_tpu_torch.shard import channels  # noqa: E402

FIXDIR = os.path.join(ROOT, "tests", "fixtures")
N_IN = 8_388_608          # flagship input samples per step
N_DEMOD = 262_144         # decimated samples per step (256 frames of 1024)
SEED = 1234

KERNELS = {   # name -> (source, TPU kernel it replaces)
    "mixdec": ("cutesdr_tpu_torch/csrc/mixdec.cu",
               "cutesdr_tpu/kernels/mixdec.py:696"),
    "fastfir": ("cutesdr_tpu_torch/csrc/fastfir.cu",
                "cutesdr_tpu/kernels/fastfir4.py:238"),
    "fastfir_batch": ("cutesdr_tpu_torch/csrc/fastfir.cu",
                      "cutesdr_tpu/kernels/fastfir4.py:297"),
    "scan_plain": ("cutesdr_tpu_torch/csrc/scan.cu",
                   "cutesdr_tpu/kernels/scan1.py:137"),
    "scan_round": ("cutesdr_tpu_torch/csrc/scan.cu",
                   "cutesdr_tpu/kernels/scan1.py:243"),
    "smeter": ("cutesdr_tpu_torch/csrc/smeter.cu",
               "cutesdr_tpu/kernels/scan1.py:398"),
    "seqloop_fm": ("cutesdr_tpu_torch/csrc/seqloop.cu",
                   "cutesdr_tpu/kernels/seqloop.py:164"),
    "seqloop_sam": ("cutesdr_tpu_torch/csrc/seqloop.cu",
                    "cutesdr_tpu/kernels/seqloop.py:235"),
}
SEQ_TOL = 1e-6            # rad: kernel and plain loop round alike
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


def compare(name: str, got, want, tol: float, results: dict,
            kernel_fn, plain_fn, label: str = "") -> None:
    """Check a kernel against its plain version and time both."""
    err = max_err(name + label, got, want, tol)
    ms, plain_ms = time_ms(kernel_fn), time_ms(plain_fn)
    phase(f"kernel {name}{label}: max_abs_err {err:.3e} (tol {tol:.3e}) "
          f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
    if not label:
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_mixdec(gen, results, input_rate, label):
    plan = plan_decimation(input_rate, 20_000.0)
    params, carry = mixdec.init(plan, input_rate / 17.0, "cuda")
    carry = carry._replace(
        raw_tail=torch.complex(randn(carry.raw_tail.numel(), gen, 1000.0),
                               randn(carry.raw_tail.numel(), gen, 1000.0)),
        phase=torch.tensor(2**32 - 12345, dtype=torch.int64, device="cuda"))
    re, im = randn(N_IN, gen, 1000.0), randn(N_IN, gen, 1000.0)
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
    compare("mixdec", [yk.real, yk.imag], [yp.real, yp.imag], 5e-5 * scale,
            results, run_k, run_p, label)
    phase(f"  (D={plan.decimation}, {len(params.h_eq)} taps, "
          f"{N_IN} samples)")


def check_fastfir(gen, results):
    h = design_fastfir(100.0, 2800.0, 0.0, 62_500.0)
    hf = torch.from_numpy(h.astype(np.complex64)).cuda()
    z = torch.complex(randn(1024 + N_DEMOD, gen, 100.0),
                      randn(1024 + N_DEMOD, gen, 100.0))
    run_k = lambda: fastfir.filter_frames(hf, z, 1025)
    run_p = lambda: fastfir.filter_frames_plain(hf, z, 1025)
    yk, yp = run_k(), run_p()
    scale = float(yp.abs().max())
    compare("fastfir", [yk.real, yk.imag], [yp.real, yp.imag], 5e-5 * scale,
            results, run_k, run_p)


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
                "" if frames == 1 else f" {n_ch}x{frames}")
        phase(f"  ({n_ch} channels x {frames} frames, 2048/1025)")


def check_mixdec_bank(gen):
    """K1 with its channel axis: 64 channels at D = 128 over one shared
    131,072-sample block (the config-4 bank), and 2 stacked channels at
    D = 32 (the stacked path's 8,388,608 samples each); each channel with
    its own increment, phase (near the wrap), raw tail and DC cal."""
    for input_rate, n_ch, n, shared in ((10e6, 64, 131_072, True),
                                         (2e6, 2, N_IN, False)):
        plan = plan_decimation(input_rate, 20_000.0)
        params, carry = mixdec.init(plan, 0.0, "cuda")
        t = carry.raw_tail.numel()
        params = params._replace(phase_inc=torch.tensor(
            [nco.phase_increment(-input_rate * (0.45 - 0.014 * c),
                                 input_rate) for c in range(n_ch)],
            dtype=torch.int64, device="cuda"))
        carry = mixdec.MixDecCarry(
            raw_tail=torch.complex(randn(n_ch * t, gen, 1000.0),
                                   randn(n_ch * t, gen, 1000.0)
                                   ).reshape(n_ch, t),
            phase=2**32 - 12345 * torch.arange(1, n_ch + 1, device="cuda"))
        dc = torch.complex(randn(n_ch, gen), randn(n_ch, gen))
        rows = n if shared else n_ch * n
        x = torch.complex(randn(rows, gen, 1000.0), randn(rows, gen, 1000.0))
        x = x if shared else x.reshape(n_ch, n)
        run_k = lambda: mixdec.process_planes(plan, params, carry, x.real,
                                              x.imag, dc)
        run_p = lambda: mixdec.process_planes_plain(plan, params, carry,
                                                    x.real, x.imag, dc)
        (ck, yk), (cp, yp) = run_k(), run_p()
        torch.cuda.synchronize()
        if not (torch.equal(ck.raw_tail, cp.raw_tail)
                and torch.equal(ck.phase, cp.phase)):
            raise AssertionError("mixdec bank carries differ")
        compare("mixdec", [yk.real, yk.imag], [yp.real, yp.imag],
                5e-5 * float(yp.abs().max()), {}, run_k, run_p,
                f" {n_ch} channels {'shared' if shared else 'stacked'} "
                f"D={plan.decimation}")


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


def check_scans(gen, results):
    n = N_DEMOD
    a = 0.99 + 0.005 * torch.rand(n, generator=gen, device="cuda")
    b = randn(n, gen, 0.01)
    x0 = torch.tensor(-3.0, device="cuda")
    run_k = lambda: scan.first_order_scan(a, b, x0)
    run_p = lambda: scan.first_order_scan_plain(a, b, x0)
    compare("scan_plain", [run_k()], [run_p()], 1e-5, results, run_k, run_p)

    pk = randn(n, gen, 0.3) - 3.0
    pat = torch.rand(n, generator=gen, device="cuda") > 0.5
    ra, fa = np.float32(1 / 125.0), np.float32(1 / 312.0)
    run_k = lambda: scan.guess_round(pk, pat, x0, ra, fa)
    run_p = lambda: scan.guess_round_plain(pk, pat, x0, ra, fa)
    (xk, npk, ck), (xp, npp, cp) = run_k(), run_p()
    n_flip = int((npk != npp).sum())
    if n_flip > 4 or abs(int(ck) - int(cp)) > 4:
        raise AssertionError(f"scan_round pattern/count differ: {n_flip} "
                             f"flips, count {int(ck)} vs {int(cp)}")
    compare("scan_round", [xk], [xp], 1e-5, results, run_k, run_p)

    mag = randn(n, gen, 10.0) - 60.0
    aa, ad = np.float32(1 / 625.0), np.float32(1 / 31250.0)
    a0 = torch.tensor(-120.0, device="cuda")
    run_k = lambda: scan.smeter_last(mag, aa, ad, a0, a0)
    run_p = lambda: scan.smeter_last_plain(mag, aa, ad, a0, a0)
    compare("smeter", list(run_k()), list(run_p()), 1e-3, results, run_k,
            run_p)


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
    loop's (angles wrapped) and the count of values not bitwise equal;
    raises beyond SEQ_TOL."""
    err = max(angle_err(g, w) if is_angle else float((g - w).abs().max())
              for g, w, is_angle in zip(got, want, ANGLES[name]))
    unequal = sum(int((g != w).sum()) for g, w in zip(got, want))
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
    same noise: it must equal K7 where it validates.  Last, partial tiles
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
                results[name] = {"max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms}
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
    c = c._replace(nco_phase=phase0, nco_freq=freq0)
    run = lambda: fm._pll_chunked(p, c, th)
    valid, (ph, fr, _dc, _audio, errs) = run()
    valid = bool(valid)
    if valid and not (torch.equal(errs, k_out[3])
                      and float(fr) == float(k_out[1])):
        raise AssertionError("FM chunked tier validated but differs from K7")
    ms = time_ms(run, reps=3, calls=2)
    phase(f"FM chunked tier (torch) n={th.numel()} noise: valid {valid}, "
          f"{'bitwise equal to K7, ' if valid else ''}{ms:.2f} ms "
          f"(median of 3x2 calls) against K7 {k_ms:.4f} ms")


def check_other_shapes(gen):
    """Correctness only, at shapes other configurations give the kernels:
    a x128 plan with output offset d=3 on a short block, 4096- and
    512-point filter frames (the first needs 64 KB of shared memory),
    scans with a partial last chunk."""
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
    for nfft, ntaps in ((4096, 3073), (512, 257)):
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
    n = N_DEMOD - 1000
    a = 0.99 + 0.005 * torch.rand(n, generator=gen, device="cuda")
    b = randn(n, gen, 0.01)
    err = max_err("scan_plain partial", [scan.first_order_scan(a, b, -3.0)],
                  [scan.first_order_scan_plain(a, b, -3.0)], 1e-5)
    phase(f"kernel scan_plain n={n}: max_abs_err {err:.3e}")


def snr_db(want, got, skip):
    n = min(len(want), len(got))
    err = got[skip:n] - want[skip:n]
    return 10 * np.log10(np.mean(want[skip:n] ** 2)
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


def routed_kernels(cfg, bank: bool) -> set[str]:
    """The kernels a configuration's path routes to, by the port's gates
    (the seqloops by the tiers the demods report as taken).  A bank never
    takes the single-stream scan and S-meter kernels."""
    n = cfg.fastfir_valid * cfg.frames_per_block
    want = {"mixdec", "fastfir_batch" if bank else "fastfir"}
    if not bank and cfg.agc_on and scan.supported(n):
        want |= {"scan_plain", "scan_round"}
    if not bank and scan.smeter_supported(n):
        want.add("smeter")
    if fm.STATS["scan"]:
        want.add("seqloop_fm")
    if sam.STATS["scan"]:
        want.add("seqloop_sam")
    return want


def tone_ratio(audio: np.ndarray, rate: float, tone_hz: float,
               label: str) -> float:
    """Peak/floor of the audio spectrum; raises unless the peak is the
    modulating tone at > 60 dB."""
    if not np.all(np.isfinite(audio)):
        raise AssertionError(f"{label}: non-finite audio")
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio)))) ** 2
    f = np.fft.rfftfreq(len(audio), 1 / rate)
    k = int(np.argmax(spec))
    floor = np.median(np.delete(spec, np.s_[max(0, k - 20):k + 21]))
    ratio = 10 * np.log10(spec[k] / floor)
    phase(f"{label} audio: {len(audio)} samples, peak at {f[k]:.2f} Hz, "
          f"peak/floor {ratio:.1f} dB")
    if abs(f[k] - tone_hz) > 2.0 or ratio < 60.0:
        raise AssertionError(f"{label}: the {tone_hz:g} Hz tone was not "
                             "recovered")
    return ratio


def make_receiver(kind: str, cfg, freqs):
    """The entry point a user calls: a Receiver, or a bank of channels
    tuned to ``freqs`` over one shared stream or one stream each."""
    if kind == "single":
        return rx.Receiver(cfg, "cuda")
    bank = channels.ChannelBank if kind == "bank" else channels.StackedReceiver
    return bank(cfg, freqs, "cuda")


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


def drive_path(label, kind, cfg, freqs, blocks, timed, gpu_label, tones=(),
               skip=1, need=(), may_fall_back=True, check=None):
    """Drive one receiver path over ``blocks`` with the counts zeroed just
    before and read just after; check the routed kernels (and ``need``)
    launched and no other; check each (channel, tone) of ``tones`` on the
    audio after the first ``skip`` blocks and every channel's audio
    finite; then time the chained steps over ``timed``, the blocks that
    continue the same signal.  The AGC may take its sequential fallback
    while it settles, except where ``may_fall_back`` is False.
    ``check(launches, tiers, n_blocks)`` adds a path's own conditions."""
    r = make_receiver(kind, cfg, freqs)
    torch.cuda.synchronize()
    kernels.reset_launches()
    agc.STATS["scan_fallbacks"] = 0
    for stats in (fm.STATS, sam.STATS):
        stats.update(dict.fromkeys(stats, 0))
    audio = [channel_audio(r.process(b)) for b in blocks]
    launches = dict(kernels.LAUNCHES)
    tiers = dict({"fm": fm.STATS, "sam": sam.STATS}.get(cfg.mode, {}))
    fallbacks = agc.STATS["scan_fallbacks"]
    phase(f"{label} launches {launches}, pll tiers {tiers}, agc scan "
          f"fallbacks {fallbacks} over {len(blocks)} blocks")
    if fallbacks and not may_fall_back:
        raise AssertionError(f"{label}: the AGC fell back to the "
                             "sequential scan")
    want = routed_kernels(cfg, kind != "single") | set(need)
    wrong = {k: v for k, v in launches.items() if (v > 0) != (k in want)}
    if wrong:
        raise AssertionError(f"{label}: launches {wrong} do not match the "
                             f"kernels its configuration routes to {want}")
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
    to K7 over the 8 streams, one launch per block."""
    n = cfg.fastfir_valid * cfg.frames_per_block
    fill = -(-agc.AgcConfig(True, False, cfg.output_rate).delay_samples // n)

    def check(launches, tiers, n_blocks):
        if not (tiers["scan"] >= n_blocks - fill
                and launches["seqloop_fm"] == tiers["scan"]
                and tiers["chunked"] == 0):
            raise AssertionError(f"fm monitor: tiers {tiers}, K7 launches "
                                 f"{launches['seqloop_fm']} over {n_blocks} "
                                 f"blocks (delay fill {fill})")
    return check


def sam_acquire_check(launches, tiers, n_blocks):
    if not (tiers["scan"] >= 1 and launches["seqloop_sam"] == tiers["scan"]):
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
    ]


def check_paths(gen, gpu_label) -> dict:
    """Every receiver path; returns the launches summed over the paths."""
    total = dict.fromkeys(KERNELS, 0)
    for label, kind, cfg, freqs, stim, n_blocks, kw in path_specs():
        kw = dict(kw)
        blocks = path_blocks(kind, cfg, gen, stim, n_blocks + kw.pop("steps"))
        for k, v in drive_path(label, kind, cfg, freqs, blocks[:n_blocks],
                               blocks[n_blocks:], gpu_label, **kw).items():
            total[k] += v
        del blocks
    return total


def profile_paths(gen, gpu_label) -> None:
    """``--profile``: where the time goes on each receiver path.  The
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
    for label, kind, cfg, freqs, stim, n_blocks, kw in path_specs():
        r = make_receiver(kind, cfg, freqs)
        steps = kw["steps"]
        blocks = path_blocks(kind, cfg, gen, stim, n_blocks + 2 * steps)

        def run_steps(first):
            for b in blocks[first:first + steps]:
                r.process(b)
            torch.cuda.synchronize()

        for b in blocks[:n_blocks]:
            r.process(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_steps(n_blocks)
        ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_steps(n_blocks + steps)
        events = prof.key_averages()
        device = {e.key: e.self_device_time_total / 1e3 / steps
                  for e in events if "CUDA" in str(e.device_type)}
        count = {e.key: e.count / steps for e in events}
        busy = sum(device.values())
        top = sorted(((t, k[:70]) for k, t in device.items() if t > 0),
                     reverse=True)[:8]
        print(json.dumps({
            "path": label, "ms_per_step": ms, "device_busy_ms": busy,
            "busy_share": busy / ms,
            "launches_per_step": count.get("cudaLaunchKernel", 0.0),
            "host_reads_per_step": count.get("aten::_local_scalar_dense",
                                             0.0),
            "top_device_ms": [[round(t, 4), k] for t, k in top],
            "gpu": gpu_label}), flush=True)
        del blocks


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    phase(f"device: {name} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False   # the port has no matmul

    t0 = time.perf_counter()
    _build.library()
    phase(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds} s, hash {_build.source_hash()})")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    if sys.argv[1:] == ["--profile"]:
        profile_paths(gen, smi)
        return 0
    results: dict = {}
    check_mixdec(gen, results, 2e6, "")
    check_mixdec(gen, results, 20e6, " D=256")
    check_mixdec_bank(gen)
    check_fastfir(gen, results)
    check_fastfir_batch(gen, results)
    check_scans(gen, results)
    check_seqloops(gen, results)
    check_seqloops_bank(gen)
    check_other_shapes(gen)
    check_fixtures()
    launches = check_paths(gen, smi)
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
