"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``cutesdr_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version at the flagship shapes, replays
the golden / reference-binary fixtures through the port on the card, then
drives the flagship receiver (2 MSPS USB, tune 100 kHz, 48 kHz audio,
frames_per_block=256: 8,388,608 input samples per step) for chained steps
and checks that the audio carries the injected 1 kHz tone.  Prints one line
per phase, a JSON line of per-kernel results, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Any failed
phase raises, so the script exits non-zero.  It needs a CUDA device; it
never imports jax.
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
from cutesdr_tpu_torch.kernels import _build, fastfir, mixdec, scan  # noqa: E402
from cutesdr_tpu_torch.ops import agc  # noqa: E402
from cutesdr_tpu_torch.pipeline import receiver as rx  # noqa: E402

FIXDIR = os.path.join(ROOT, "tests", "fixtures")
N_IN = 8_388_608          # flagship input samples per step
N_DEMOD = 262_144         # decimated samples per step (256 frames of 1024)
SEED = 1234

KERNELS = {   # name -> (source, TPU kernel it replaces)
    "mixdec": ("cutesdr_tpu_torch/csrc/mixdec.cu",
               "cutesdr_tpu/kernels/mixdec.py:696"),
    "fastfir": ("cutesdr_tpu_torch/csrc/fastfir.cu",
                "cutesdr_tpu/kernels/fastfir4.py:238"),
    "scan_plain": ("cutesdr_tpu_torch/csrc/scan.cu",
                   "cutesdr_tpu/kernels/scan1.py:137"),
    "scan_round": ("cutesdr_tpu_torch/csrc/scan.cu",
                   "cutesdr_tpu/kernels/scan1.py:243"),
    "smeter": ("cutesdr_tpu_torch/csrc/smeter.cu",
               "cutesdr_tpu/kernels/scan1.py:398"),
}


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


def check_fixtures():
    for name in ("usb2m", "usb", "lsb", "cwu"):
        gold = np.load(os.path.join(FIXDIR, f"golden_{name}.npz"))
        meta = json.loads(str(gold["meta"]))
        ref = np.load(os.path.join(FIXDIR, f"refgold_{name}.npz"))
        rmeta = json.loads(str(ref["meta"]))
        cfg = rx.ReceiverConfig(input_rate=meta["input_rate"],
                                mode=meta["mode"],
                                tune_freq=meta["tune_freq"],
                                cw_offset=meta["cw_offset"], audio_rate=None,
                                agc_on=True, agc_thresh_db=-90.0)
        r = rx.Receiver(cfg, "cuda")
        got = []
        for blk in range(meta["n_blocks"]):
            sl = slice(blk * cfg.block_size, (blk + 1) * cfg.block_size)
            iq = gold["iq_re"][sl] + 1j * gold["iq_im"][sl]
            got.append(r.process(iq).audio.double().cpu().numpy())
        got = np.concatenate(got)
        s_gold = snr_db(gold["audio"], got, int(meta["skip"]))
        s_ref = snr_db(ref["audio"], got, rmeta["skip"])
        phase(f"fixture {name} (D={cfg.plan.decimation}): golden "
              f"{s_gold:.2f} dB (bound {meta['min_snr_db']}), refgold "
              f"{s_ref:.2f} dB (bound {rmeta['min_snr_prod_db']})")
        if not (s_gold > meta["min_snr_db"]
                and s_ref > rmeta["min_snr_prod_db"]):
            raise AssertionError(f"fixture {name} below its pinned bound")


def flagship_blocks(cfg, n_blocks: int, gen) -> list[torch.Tensor]:
    """Tone at tune + 1 kHz (-30 dBFS) plus seeded noise (-90 dBFS), made
    on the card, phase-continuous across blocks."""
    amp = 32767.0 * 10 ** (-30 / 20)
    noise = 32767.0 * 10 ** (-90 / 20)
    w = 2 * np.pi * (cfg.tune_freq + 1000.0) / cfg.input_rate
    k = torch.arange(cfg.block_size, dtype=torch.float64, device="cuda")
    out = []
    for b in range(n_blocks):
        ph = torch.remainder((k + b * cfg.block_size) * w, 2 * np.pi)
        sig = torch.polar(torch.full_like(ph, amp), ph)
        sig = sig + noise * torch.complex(
            torch.randn(cfg.block_size, generator=gen, device="cuda",
                        dtype=torch.float64),
            torch.randn(cfg.block_size, generator=gen, device="cuda",
                        dtype=torch.float64))
        out.append(sig.to(torch.complex64))
    return out


def check_flagship(gen, gpu_label):
    cfg = rx.ReceiverConfig(2e6, "usb", tune_freq=100e3, frames_per_block=256)
    assert cfg.block_size == N_IN
    r = rx.Receiver(cfg, "cuda")
    blocks = flagship_blocks(cfg, 4, gen)
    torch.cuda.synchronize()

    kernels.reset_launches()
    agc.STATS["scan_fallbacks"] = 0
    audio = []
    for b in blocks:
        out = r.process(b)
        audio.append(out.audio[:int(out.n_audio)].double().cpu().numpy())
    launches = dict(kernels.LAUNCHES)
    fallbacks = agc.STATS["scan_fallbacks"]
    phase(f"flagship launches {launches}, agc scan fallbacks {fallbacks}")
    if min(launches.values()) == 0:
        raise AssertionError("a kernel of the main path was never launched")
    if fallbacks:
        raise AssertionError("the AGC fell back to the sequential scan")

    a = np.concatenate(audio[1:])                   # skip the AGC settling
    if not np.all(np.isfinite(a)):
        raise AssertionError("non-finite audio")
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a)))) ** 2
    f = np.fft.rfftfreq(len(a), 1 / cfg.audio_rate)
    k = int(np.argmax(spec))
    floor = np.median(np.delete(spec, np.s_[max(0, k - 20):k + 21]))
    ratio = 10 * np.log10(spec[k] / floor)
    phase(f"flagship audio: {len(a)} samples, peak at {f[k]:.2f} Hz, "
          f"peak/floor {ratio:.1f} dB")
    if abs(f[k] - 1000.0) > 2.0 or ratio < 60.0:
        raise AssertionError("the 1 kHz tone was not recovered")

    steps = 12
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(steps):
        r.process(blocks[i % len(blocks)])
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / steps
    phase(f"flagship step: {ms:.3f} ms/step, "
          f"{cfg.block_size / (ms * 1e-3) / 1e6:.1f} Msps over {steps} "
          f"chained steps, input resident ({gpu_label})")
    return launches


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
    results: dict = {}
    check_mixdec(gen, results, 2e6, "")
    check_mixdec(gen, results, 20e6, " D=256")
    check_fastfir(gen, results)
    check_scans(gen, results)
    check_other_shapes(gen)
    check_fixtures()
    launches = check_flagship(gen, smi)

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
