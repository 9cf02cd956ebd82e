"""Device time of the mixdec (K1), fastfir (K2, K6) and banded resampler
(K9) kernels, of the AGC's guess-verify solve (K4), of the affine scan
(K3), the S-meter (K5), the AGC's sequential fallback (N1) and the PLL
loops (K7, K8) on one NVIDIA GPU, at the main paths' shapes, and of the
call sites that route their recurrences through K3/K5 or FM's PLL tier
through K7 (``route`` cases, with their launches and host reads a call).

    python3 chip_kernel_times.py [--root DIR] [--only PREFIX,...]

Imports ``cutesdr_tpu_torch`` from DIR (default: this file's directory),
so that an unpacked ``git archive`` of another commit, which builds its
own kernels into its own ``build/``, can be timed in the same call on the
same card (``--only`` keeps the cases whose label starts with one of the
prefixes): run it for each tree in turn (a, b, b, a) and compare.  Uses
only the wrappers' public calls and long-standing module functions
(``resampler._times``, ``agc._prefix``, ``agc._two_rate_parallel``,
``smeter.process``, ``fm._dc_track``, ``am.dc_block``), which every
version of the port since the resampler kernel has; a case that a tree
cannot run (a shape its kernel refuses, a module it lacks) prints
``unsupported`` with the reason.  A ``route`` case times the call site
as that tree routes it, all of its device work by queued CUDA events
(``queued_ms``: the parent's plain torch route has no kernel of its own
for the profiler to pick out).  The AGC
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

import inspect
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
    # trees before the bank's solve kernel choose the kernel with ``fast``
    fast = ({"fast": True} if "fast" in inspect.signature(
        agc._two_rate_parallel).parameters else {})
    return lambda: agc._two_rate_parallel(
        p.attack_rise_alpha, p.attack_fall_alpha, c.attack_ave, peak,
        agc.GUESS_ITERS, **fast)


def scan_cases(gen, scan, fm, am, smeter, agcseq_mod):
    """K3/K5/N1 kernel cases and the route cases of their call sites:
    (label, fn, kind); the parent's kernels take only the 262,144 shapes,
    its call sites route to plain torch below the JAX gates."""
    import numpy as np
    n = 262_144
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    a = 0.99 + 0.005 * torch.rand(n, generator=gen, device="cuda")
    b, x0 = r(n) * 0.01, torch.tensor(-3.0, device="cuda")
    mag = r(n) * 10.0 - 60.0
    aa, ad = np.float32(1 / 625.0), np.float32(1 / 31250.0)
    sm_p, sm_c = smeter.init(62_500.0, "cuda")
    x1 = torch.randn(1024, generator=gen, device="cuda",
                     dtype=torch.complex64) * 300.0
    x64 = torch.randn(64, 1024, generator=gen, device="cuda",
                      dtype=torch.complex64) * 300.0
    sm_c64 = type(sm_c)(*(torch.stack([v] * 64) for v in sm_c))
    fm_p, _ = fm.init(62_500.0, "cuda")
    freqs, dc0 = r(n) * 0.05, torch.tensor(0.01, device="cuda")
    z1, u = r(8), r(8, 256)
    cases = [
        ("scan 1 x 262,144 per-sample a",
         lambda: scan.first_order_scan(a, b, x0), "kernel"),
        ("scan 1 x 262,144 scalar a (scan.ema)",
         lambda: scan.ema(fm_p.dc_alpha, freqs, dc0), "kernel"),
        ("scan 8 x 256 scalar a, per-row x0",
         lambda: scan.first_order_scan(0.99, u, z1), "kernel"),
        ("smeter 1 x 262,144", lambda: scan.smeter_last(mag, aa, ad, x0, x0),
         "kernel"),
        ("smeter 64 x 1,024",
         lambda: scan.smeter_last(mag[:65_536].reshape(64, 1024), aa, ad,
                                  sm_c64.attack_ave, sm_c64.decay_ave),
         "kernel"),
        ("smeter 1 x 262,143",
         lambda: scan.smeter_last(mag[:-1], aa, ad, x0, x0), "kernel"),
        ("smeter 1 x 1,024",
         lambda: scan.smeter_last(mag[:1024], aa, ad, x0, x0), "kernel"),
        ("smeter route 1 x 1,024 (smeter.process)",
         lambda: smeter.process(sm_p, sm_c, x1), "route"),
        ("smeter route 64 x 1,024 (smeter.process bank)",
         lambda: smeter.process(sm_p, sm_c64, x64), "route"),
        ("scan route ema 1 x 262,144 (fm._dc_track)",
         lambda: fm._dc_track(fm_p, freqs, dc0), "route"),
        ("scan route 8 x 256 (am.dc_block)", lambda: am.dc_block(z1, u),
         "route"),
    ]
    if agcseq_mod is not None:
        pk = r(n) * 0.5 - 3.0
        s0 = torch.tensor(-5.0, device="cuda")
        t0 = torch.tensor(0, dtype=torch.int32, device="cuda")
        for hang in (None, 12_500):
            mode = "hang" if hang else "two-rate"
            cases.append((f"agcseq 1 x 262,144 {mode}",
                          lambda h=hang: agcseq_mod.averager_scan(
                              pk, s0, s0, t0, (0.008, 0.0032),
                              (0.0053, 0.00032), h), "kernel"))
    return cases


def seqloop_cases(gen, seqloop, fm, sam):
    """K7/K8 kernel cases (label, fn, kind) at the full width (262,144), a
    bank of four, a 3 Hz tone 32,768 long (FM's chunks almost never
    bit-sync: K7's walker runs end to end) and the idle monitor's block
    (256 + 256 chained from the first call's state); and FM's PLL tier as
    the demod routes a noise block that leaves the linear tier
    (``fm._pll``: the parent's torch chunked scan, or one K7 launch)."""
    import numpy as np
    n = 262_144
    noise = lambda *shape: (torch.rand(*shape, generator=gen, device="cuda")
                            * 2 - 1) * np.pi
    k = torch.arange(32_768, dtype=torch.float64, device="cuda")
    tone = (torch.remainder(k * (2 * np.pi * 3.0 / 62_500.0) + 0.3 + np.pi,
                            2 * np.pi) - np.pi).float()
    fm_p, fm_c = fm.init(62_500.0, "cuda")
    sam_p, _ = sam.init(31_250.0, "cuda")
    s0 = (torch.tensor(0.5, device="cuda"), torch.tensor(0.0, device="cuda"))
    fa = (fm_p.pll_alpha, fm_p.pll_beta, fm_p.nco_limit, *s0)
    sa = (sam_p.pll_alpha, sam_p.pll_beta, sam_p.nco_limit, *s0)
    th_fm, th_sam, th4, th512 = noise(n), noise(n), noise(4, n), noise(512)
    x = torch.randn(n, generator=gen, device="cuda",
                    dtype=torch.complex64) * 1000.0

    def chained(fn, a):
        first = fn(*a, th512[:256])
        return fn(*a[:3], first[0], first[1], th512[256:])

    return [
        ("seqloop_fm 1 x 262,144 noise",
         lambda: seqloop.fm_pll_scan(*fa, th_fm), "kernel"),
        ("seqloop_fm 1 x 32,768 3 Hz tone",
         lambda: seqloop.fm_pll_scan(*fa, tone), "kernel"),
        ("seqloop_fm 256 + 256 chained",
         lambda: chained(seqloop.fm_pll_scan, fa), "kernel"),
        ("seqloop_sam 1 x 262,144 noise",
         lambda: seqloop.sam_pll_scan(*sa, th_sam), "kernel"),
        ("seqloop_sam 4 x 262,144 noise",
         lambda: seqloop.sam_pll_scan(*sa, th4), "kernel"),
        ("seqloop_sam 256 + 256 chained",
         lambda: chained(seqloop.sam_pll_scan, sa), "kernel"),
        ("seqloop route fm tier 1 x 262,144 noise (fm._pll)",
         lambda: fm._pll(fm_p, fm_c, x), "route"),
    ]


def event_counts(events, steps: int = 1) -> tuple[float, float]:
    """(kernel launches, host reads) a step of a profiled window of
    ``steps`` steps (``events``: its ``prof.key_averages()``): the
    cudaLaunchKernel and aten::_local_scalar_dense (``.item()``, ``bool``
    of a device tensor) events."""
    count = {e.key: e.count for e in events}
    return (count.get("cudaLaunchKernel", 0) / steps,
            count.get("aten::_local_scalar_dense", 0) / steps)


def call_counts(fn) -> tuple[float, float]:
    """(kernel launches, host reads) of one call of fn()."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return event_counts(prof.key_averages())


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
    from cutesdr_tpu_torch.demod import am, fm, sam
    from cutesdr_tpu_torch.kernels import (_build, fastfir, mixdec, resamp,
                                           scan, seqloop)
    from cutesdr_tpu_torch.ops import agc, nco, resampler, smeter
    try:
        from cutesdr_tpu_torch.kernels import agcseq
    except ImportError:
        agcseq = None
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
    cases = [(label, fn, "kernel") for label, fn in cases]
    cases += scan_cases(gen, scan, fm, am, smeter, agcseq)
    cases += seqloop_cases(gen, seqloop, fm, sam)
    for label, fn, kind in cases:
        if not label.startswith(only):
            continue
        try:
            fn()
        except (ValueError, RuntimeError, TypeError, AttributeError) as e:
            print(json.dumps({"case": label, "unsupported": str(e)[:200],
                              "root": root, "gpu": smi}), flush=True)
            continue
        warm_up(fn)
        extra = {}
        if kind == "route":
            dev, dev_by = queued_ms(fn), "queued events (all device work)"
            extra = dict(zip(("launches", "host_reads"), call_counts(fn)))
        else:
            dev, dev_by = device_ms(fn)
        clock = sm_clock_mhz()
        print(json.dumps({"case": label, "device_ms": dev,
                          "device_by": dev_by, "ms": call_ms(fn),
                          "sm_clock": clock, **extra,
                          "root": root, "gpu": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
