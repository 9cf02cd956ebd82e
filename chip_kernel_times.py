"""Device time of the mixdec (K1), fastfir (K2, K6) and banded resampler
(K9) kernels and of the AGC's guess-verify solve (K4) on one NVIDIA GPU,
at the main paths' shapes.

    python3 chip_kernel_times.py [--root DIR] [--only PREFIX,...]

Imports ``cutesdr_tpu_torch`` from DIR (default: this file's directory),
so that an unpacked ``git archive`` of another commit, which builds its
own kernels into its own ``build/``, can be timed in the same call on the
same card (``--only`` keeps the cases whose label starts with one of the
prefixes): run it for each tree in turn (a, b, b, a) and compare.  Uses
only the wrappers' public calls and long-standing module functions
(``resampler._times``, ``agc._prefix``, ``agc._two_rate_parallel``),
which every version of the port since the resampler kernel has.  The AGC
solve is timed as the receiver calls it, one two-rate averager through
``agc._two_rate_parallel``, where the call time (``ms``) is what counts:
the rounds' host reads are the cost there.

Each case first runs back to back for half a second, so that the card's
clocks settle under its load.  Prints one JSON line per case: the
kernel's own device time per call (``device_ms``: torch.profiler's CUDA
kernel events whose name is in the ``cutesdr::`` namespace, summed over
20 calls; ``device_by`` says so, or names the CUDA-event timing that
``device_ms`` falls back to when the profiler returns no event), the SM
clock right after them (``sm_clock``, nvidia-smi), the wrapper's call
time back to back (``ms``, CUDA events), the root, and the card's name
and power limit.  ``device_ms`` is also what ``chip_smoke.py`` reports
for every kernel.  Needs a CUDA device; never imports jax.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

N_IN = 8_388_608     # flagship input samples per step
SEED = 1234


def profiled_ms(fn, calls: int = 20) -> float | None:
    """Per-call device time of the port's kernels that fn() launches: the
    self device time of the profiler's kernel events in the ``cutesdr::``
    namespace over ``calls`` calls (after one warm-up), divided by
    ``calls``; None if the profiler returned no such event."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.self_device_time_total for e in prof.key_averages()
          if "CUDA" in str(e.device_type) and "cutesdr::" in e.key]
    return sum(us) / calls / 1e3 if us and sum(us) > 0 else None


def queued_ms(fn, calls: int = 20) -> float:
    """Per-call device time of all of fn()'s device work, from CUDA events
    around ``calls`` calls that the host queues while the card spins for
    ~20 ms, so that the card runs them back to back: an upper bound of the
    kernel's own time (the wrapper's other launches and the gaps between
    them count too), unless a call waits for the card."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(fn, calls: int = 20, tries: int = 3) -> tuple[float, str]:
    """(per-call device time, how it was taken) of fn()'s kernels.  The
    profiler's kernel events (``profiled_ms``) where a session returns
    them.  Now and then a session returns no device event at all, on a
    kernel that launched; it is run again, up to ``tries`` sessions, and
    then the time comes from ``queued_ms``."""
    for _ in range(tries):
        ms = profiled_ms(fn, calls)
        if ms is not None:
            return ms, "profiler"
    print(f"device_ms: {tries} profiler sessions saw no cutesdr kernel; "
          "timing queued calls by CUDA events instead", flush=True)
    return queued_ms(fn, calls), "queued events"


def warm_up(fn, seconds: float = 0.5) -> None:
    """Call fn() back to back for ``seconds`` of wall time, so that the
    card's clocks have settled under this load before it is timed."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()


def sm_clock_mhz() -> str:
    """The card's SM clock now, as nvidia-smi reads it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def call_ms(fn, reps: int = 5, calls: int = 20) -> float:
    """Per-call time of fn() back to back: the median over ``reps``
    CUDA-event timings of ``calls`` calls, after one warm-up."""
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


def mixdec_case(mixdec, plan_decimation, nco, gen, input_rate, n, n_ch,
                shared):
    """A mixdec call on interleaved iq views (as the receiver passes them):
    one stream (n_ch 0), or a bank of n_ch channels over one shared block
    or one stacked row each; random tails and phases near the wrap."""
    plan = plan_decimation(input_rate, 20_000.0)
    params, carry = mixdec.init(plan, input_rate / 17.0, "cuda")
    t = carry.raw_tail.numel()
    rows = max(n_ch, 1)
    tail = torch.randn(rows * t, generator=gen, device="cuda",
                       dtype=torch.complex64) * 1000.0
    if n_ch:
        params = params._replace(phase_inc=torch.tensor(
            [nco.phase_increment(-input_rate * (0.45 - 0.014 * c),
                                 input_rate) for c in range(n_ch)],
            dtype=torch.int64, device="cuda"))
        carry = mixdec.MixDecCarry(
            raw_tail=tail.reshape(n_ch, t),
            phase=2**32 - 12345 * torch.arange(1, n_ch + 1, device="cuda"))
        dc = torch.randn(n_ch, generator=gen, device="cuda",
                         dtype=torch.complex64)
    else:
        carry = carry._replace(raw_tail=tail, phase=torch.tensor(
            2**32 - 12345, dtype=torch.int64, device="cuda"))
        dc = torch.tensor(0.37 - 0.21j, dtype=torch.complex64, device="cuda")
    x = torch.randn(n if shared or not n_ch else (n_ch, n), generator=gen,
                    device="cuda", dtype=torch.complex64) * 1000.0
    return lambda: mixdec.process_planes(plan, params, carry, x.real,
                                         x.imag, dc)


def fastfir_case(fastfir, design_fastfir, gen, n_ch, frames):
    """A fastfir call over ``frames`` 2048/1025 frames: one stream (n_ch
    0, K2) or n_ch channels with one H each (K6)."""
    import numpy as np
    rows = max(n_ch, 1)
    hs = [design_fastfir(100.0 + 10.0 * c, 2800.0 - 15.0 * c, 0.0, 78_125.0)
          for c in range(rows)]
    hf = torch.from_numpy(np.stack(hs).astype(np.complex64)).cuda()
    z = torch.randn(rows, 1024 + 1024 * frames, generator=gen,
                    device="cuda", dtype=torch.complex64) * 100.0
    if not n_ch:
        return lambda: fastfir.filter_frames(hf[0], z[0], 1025)
    return lambda: fastfir.filter_frames_batch(hf, z, 1025)


def resamp_case(resampler, resamp, gen, n_streams, n, ratio, nominal,
                cplx):
    """A banded-resampler call over ``n_streams`` blocks of ``n`` samples
    at ``ratio`` (capacity sized for ``nominal``), 28 taps, exact
    positions, output times from a random start, as
    ``ops/resampler._banded_process`` forms them."""
    params, _ = resampler.init(ratio, "cuda", complex_input=cplx)
    periods = resampler.SINC_PERIODS
    K, M = resampler.band_size(n, resampler.max_out_for(n, nominal), periods)
    t0 = torch.rand(n_streams, 1, generator=gen, device="cuda") * ratio
    t_int, t_frac = resampler._times(
        params, t0, torch.arange(K, dtype=torch.float32, device="cuda"))
    z = torch.randn(n_streams, n + periods, generator=gen, device="cuda",
                    dtype=torch.complex64 if cplx else torch.float32) * 1000.0
    return lambda: resamp.resample_band(z, t_int, t_frac, M, periods, True)


def agc_case(agc, gen, n, kind):
    """One two-rate averager (the attack's) of the AGC over n samples at
    62.5 kHz, as the receiver calls it: the window peak of a -30 dBFS tone
    in unit noise (the flagship's steady state), or of noise under an
    envelope stepping every 512 samples over 30 dB (more rounds)."""
    cfg = agc.AgcConfig(True, False, 62_500.0)
    p = agc.make_params(cfg, -100.0, 30.0, 0.0, 200.0)
    noise = torch.randn(n, generator=gen, device="cuda",
                        dtype=torch.complex64)
    if kind == "tone":
        k = torch.arange(n, device="cuda", dtype=torch.float64)
        x = (1036.0 * torch.exp(2j * torch.pi * 1000.0 * k / 62_500.0)
             ).to(torch.complex64) + noise
    else:
        env = 10.0 ** (1 + 3 * torch.rand(n // 512, generator=gen,
                                          device="cuda"))
        x = noise * env.repeat_interleave(512)
    c = agc.init_carry(cfg, "cuda")
    peak = agc._prefix(cfg, c, x)[2]
    return lambda: agc._two_rate_parallel(
        p.attack_rise_alpha, p.attack_fall_alpha, c.attack_ave, peak,
        agc.GUESS_ITERS, True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
    root = os.path.abspath(args.get("--root",
                                    os.path.dirname(os.path.abspath(__file__))))
    only = tuple(args["--only"].split(",")) if "--only" in args else ("",)
    sys.path.insert(0, root)
    from cutesdr_tpu_torch.design.decimation_plan import plan_decimation
    from cutesdr_tpu_torch.design.fastfir_design import design_fastfir
    from cutesdr_tpu_torch.kernels import _build, fastfir, mixdec, resamp
    from cutesdr_tpu_torch.ops import agc, nco, resampler
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    _build.library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    md = lambda *a: mixdec_case(mixdec, plan_decimation, nco, gen, *a)
    ff = lambda *a: fastfir_case(fastfir, design_fastfir, gen, *a)
    rs = lambda *a: resamp_case(resampler, resamp, gen, *a)
    flagship = 62_500.0 / 48_000.0
    cases = [
        ("mixdec flagship (1 x 8,388,608, D=32)", md(2e6, N_IN, 0, True)),
        ("mixdec session block (1 x 32,768, D=32)", md(2e6, 32_768, 0, True)),
        ("mixdec bank 64 ch shared (131,072, D=128)",
         md(10e6, 131_072, 64, True)),
        ("mixdec stacked 2 ch (2 x 8,388,608, D=32)", md(2e6, N_IN, 2, False)),
        ("mixdec 20 MSPS (1 x 8,388,608, D=256)", md(20e6, N_IN, 0, True)),
        ("fastfir 256 frames", ff(0, 256)),
        ("fastfir 1 frame", ff(0, 1)),
        ("fastfir_batch 64 x 1", ff(64, 1)),
        ("fastfir_batch 4 x 256", ff(4, 256)),
        ("resamp 1 x 262,144 rate-locked",
         rs(1, 262_144, flagship * (1 + 50e-6), flagship, False)),
        ("resamp 1 x 1,024 session block",
         rs(1, 1024, flagship, flagship, False)),
        ("resamp 64 x 1,024 bank",
         rs(64, 1024, 78_125.0 / 48_000.0, 78_125.0 / 48_000.0, False)),
        ("resamp 4 x 32,768 complex",
         rs(4, 32_768, 31_250.0 / 48_000.0 * (1 + 1e-4),
            31_250.0 / 48_000.0, True)),
        ("agc solve 262,144 tone", agc_case(agc, gen, 262_144, "tone")),
        ("agc solve 262,144 envelope",
         agc_case(agc, gen, 262_144, "envelope")),
    ]
    for label, fn in cases:
        if not label.startswith(only):
            continue
        warm_up(fn)
        dev, dev_by = device_ms(fn)
        clock = sm_clock_mhz()
        print(json.dumps({"case": label, "device_ms": dev,
                          "device_by": dev_by, "ms": call_ms(fn),
                          "sm_clock": clock,
                          "root": root, "gpu": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
