"""Runs one cell of the benchmark once and prints its result.

    python3 -m sdrbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell's configuration, traffic and
metrics are found by name (``sdrbench/spec.py``).  A run

1. makes the cell's capture on the card from the seed (int16 wire
   planes, ``sdrbench/capture.py``), builds the program's entry
   (``Receiver`` or ``ChannelBank`` of ``cutesdr_tpu_torch``), and runs a
   few blocks through the loop below, which captures the entry's CUDA
   graph: all of it, from the start of the process, is ``setup_s``;
2. runs the loop for ``--seconds``: submit block i through the entry's
   ``process_planes`` (its planes are views of the capture, replayed in
   order without end, the state carried), queue its audio and S-meters to
   pinned host memory on a copy stream behind an event, then wait for
   block i-1's event, take its time and check it is finite.  At most two
   blocks are in flight.  ``msps`` is the input samples of every block
   over the window's seconds, ``block_p95_ms`` the 95th percentile over
   every block of the time from the call that submitted it to the host
   holding its outputs;
3. with ``--trace 1`` profiles the first ``TRACE_S`` seconds of the
   window, then brackets each later block's work on the card with timed
   CUDA events (the compute stream's idle share, unpaced by the
   profiler), and reports the per-layer metrics (``sdrbench/metrics/``)
   instead of the end-to-end ones;
4. after the window, frees the program and holds a sample of the window's
   blocks, drawn from the seed with the last among them, against the plain
   reference (``sdrbench/reference``): ``correct``.

The last line of standard output is the result; the line before it the
run's work counts.  The numbers compared, each beside its limit, are the
last lines of standard error and the last key of the result.  Without a
CUDA device, with fewer than the cell asks for, or with JAX or the JAX
package loaded once the window has closed, nothing is printed and the
exit code is not 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from sdrbench import spec  # noqa: E402

WARM_BLOCKS = 4          # blocks through the loop before the window, and
WARM_S = 1.0             # at least this long (the card's clocks come up)
TRACE_S = 0.5            # seconds of the window a traced run profiles
SAMPLE_BLOCKS = 2        # blocks drawn from the window beside its last,
                         # unless the traffic says (``check_blocks``)
IN_FLIGHT = 2            # blocks submitted and not yet collected
RING = IN_FLIGHT + 1     # pinned output buffers
FORBIDDEN = ("jax", "jaxlib", "flax", "cutesdr_tpu")


def cache_dirs(repo: Path) -> None:
    """Fixed build and kernel-cache directories inside the checkout, and
    single-threaded CPU libraries (set before torch is imported)."""
    base = repo / "build" / "sdrbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")         # one process, few threads


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (names compared whole)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


# ------------------------------------------------------------------ entry

def receiver_config(config: dict, traffic: dict):
    """The ``ReceiverConfig`` of a configuration under a traffic (whose
    block sets ``frames_per_block``)."""
    from cutesdr_tpu_torch.pipeline.receiver import ReceiverConfig
    one = ReceiverConfig(**config["receiver"], frames_per_block=1)
    block = int(traffic["block_samples"])
    if block % one.block_size:
        raise ValueError(f"block {block} is not whole frames of "
                         f"{one.block_size} input samples")
    return ReceiverConfig(**config["receiver"],
                          frames_per_block=block // one.block_size)


def make_entry(config: dict, cfg, device):
    """The program's entry of a configuration: a ``Receiver`` or a
    ``ChannelBank``, with the configuration's DC cal."""
    from sdrbench.reference.chain import channel_freqs
    if config.get("entry") == "channel_bank":
        from cutesdr_tpu_torch.shard.channels import ChannelBank
        entry = ChannelBank(cfg, channel_freqs(config), device)
    else:
        from cutesdr_tpu_torch.pipeline.receiver import Receiver
        entry = Receiver(cfg, device)
        if "dc_cal" in config:
            entry.set_dc_offset(*config["dc_cal"])
    return entry


# ------------------------------------------------------------------- loop

class Loop:
    """Submits blocks through an entry, ``IN_FLIGHT`` in flight, and
    collects each one's outputs on the host (module notes, step 2).

    The harness's own host work a block is kept to a few calls, so that
    the card and the entry's call, not the harness, set the pace: the
    capture's block views are made once; the entry's outputs are fresh
    tensors (it clones them), so the audio goes to pinned memory as it
    is, and n_audio, the S-meter's average and peak and the audio's sum
    (finite where every sample is) in one small stack, both copies on a
    copy stream behind one event."""

    def __init__(self, entry, capture, block: int, channels: int, cap: int,
                 seed: int, device, sample: int):
        import torch
        self.torch = torch
        self.span = contextlib.nullcontext      # record_function when traced
        self.sample = sample
        self.entry = entry
        n_cap = capture[0].shape[0] // block
        self.views = [(capture[0][k * block:(k + 1) * block],
                       capture[1][k * block:(k + 1) * block])
                      for k in range(n_cap)]
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.compute = (torch.cuda.current_stream(self.device)
                        if self.cuda else None)
        self.slots = [self._slot(channels, cap) for _ in range(RING)]
        self.shaped = None                # the slots' views, output shapes
        self.timing = None                # (start, end) event pairs a slot
        self.idle_s = self.timed_s = 0.0  # compute stream, timed blocks
        self.prev_end = None
        self.inflight = collections.deque()
        self.next = 0                     # stream block index
        self.cum = np.zeros(channels, np.int64)
        self.latencies: list = []
        self.submit_s: list = []
        self.wait_s = 0.0                 # host seconds waiting for blocks
        self.failed = 0
        self.rng = np.random.default_rng(seed)
        self.draws: list = []
        self.kept: list = []              # (seen index, block record)
        self.seen = 0
        self.last = None

    def _slot(self, channels: int, cap: int):
        """A ring slot: pinned audio [C, cap] and the small rows [4, C]
        (n_audio's int32 bits, S-meter average and peak, the audio's sum),
        their numpy views, and the event the copies end with."""
        torch = self.torch
        audio = torch.empty((channels, cap), pin_memory=self.cuda)
        small = torch.empty((4, channels), pin_memory=self.cuda)
        return (audio, small, audio.numpy(), small.numpy(),
                torch.cuda.Event() if self.cuda else None)

    def submit(self) -> None:
        torch = self.torch
        i = self.next
        re, im = self.views[i % len(self.views)]
        marks = None if self.timing is None else self.timing[i % RING]
        if marks is not None:
            marks[0].record()
        t = time.perf_counter()
        with self.span("submit"):
            out = self.entry.process_planes(re, im)
        self.submit_s.append(time.perf_counter() - t)
        # n_audio rides as its int32 bits (no cast on the card)
        small = torch.stack((out.n_audio.view(torch.float32),
                             out.smeter_ave_db, out.smeter_peak_db,
                             out.audio.sum(-1)))
        if marks is not None:
            marks[1].record()
        if self.shaped is None:
            self.shaped = [(a.view(out.audio.shape), b.view(small.shape))
                           for a, b, *_ in self.slots]
        audio_h, small_h = self.shaped[i % RING]
        if self.stream is not None:
            self.stream.wait_stream(self.compute)
            with torch.cuda.stream(self.stream):
                audio_h.copy_(out.audio, non_blocking=True)
                small_h.copy_(small, non_blocking=True)
                self.slots[i % RING][4].record()
        else:
            audio_h.copy_(out.audio)
            small_h.copy_(small)
        # the outputs stay referenced until their copies are done
        self.inflight.append((i, t, out.audio, small, marks))
        self.next += 1

    def collect(self, window: bool) -> None:
        i, t, _, _, marks = self.inflight.popleft()
        _, _, audio, small, ev = self.slots[i % RING]
        t_wait = time.perf_counter()
        with self.span("collect"):
            if ev is not None:
                ev.synchronize()
        done = time.perf_counter()
        self.wait_s += done - t_wait
        if marks is not None:
            # the copy waited for the compute stream: both marks are done
            if self.prev_end is not None:
                gap = self.prev_end.elapsed_time(marks[0]) * 1e-3
                self.idle_s += gap
                self.timed_s += gap + marks[0].elapsed_time(marks[1]) * 1e-3
            self.prev_end = marks[1]
        if not np.isfinite(small[1:]).all():
            self.failed += window
        n = small[0].view(np.int32)
        self.cum += n
        if not window:
            return
        self.latencies.append(done - t)
        if len(self.kept) < self.sample:
            self.kept.append((self.seen, self._record(i, audio, small, n)))
        else:
            if not self.draws:
                self.draws = self.rng.random(4096).tolist()
            j = int(self.draws.pop() * (self.seen + 1))
            if j < self.sample:
                self.kept[j] = (self.seen, self._record(i, audio, small, n))
        self.seen += 1
        self.last = (i, n.copy())

    def _record(self, i: int, audio: np.ndarray, small: np.ndarray,
                n: np.ndarray):
        """(block index, each channel's outputs before it, audio [C, cap],
        S-meter rows [3, C]) of the block just collected, copied."""
        scal = small[:3].astype(np.float64)
        scal[0] = n
        return (i, self.cum - n, audio.copy(), scal)

    def last_record(self):
        """The record of the last block collected (its buffers are intact
        once the loop has drained)."""
        i, n = self.last
        _, _, audio, small, _ = self.slots[i % RING]
        return self._record(i, audio, small, n)

    def time_blocks(self) -> None:
        """From the next block on, bracket each block's work on the
        compute stream with timed events (on a card)."""
        if self.stream is None:
            return
        ev = self.torch.cuda.Event
        self.timing = [(ev(enable_timing=True), ev(enable_timing=True))
                       for _ in range(RING)]

    def step(self, window: bool) -> None:
        """Submit the next block, then collect the oldest once
        ``IN_FLIGHT`` are in flight."""
        self.submit()
        if len(self.inflight) >= IN_FLIGHT:
            self.collect(window)

    def drain(self, window: bool) -> None:
        while self.inflight:
            self.collect(window)


# -------------------------------------------------------------- the cell

def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", limits: dict | None = None,
             entry_hook=None, root: Path = spec.HERE,
             keep: dict | None = None) -> tuple[dict, dict]:
    """One run of ``cell``: (result line, work counts).  ``entry_hook``
    wraps the entry (the tests break it with it); ``keep``, where given,
    receives the capture and the records judged (the control reads
    them)."""
    import torch

    from cutesdr_tpu_torch import kernels
    from cutesdr_tpu_torch.demod import fm, sam
    from cutesdr_tpu_torch.ops import agc
    from sdrbench import capture, correct, work

    device = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    parts = {"imports": time.perf_counter() - T_START}
    config, traffic = cell.config, cell.traffic
    capture.check(traffic, config["receiver"]["input_rate"])
    cfg = receiver_config(config, traffic)
    shapes = work.shapes(config, traffic)
    cap_planes = capture.make(traffic, seed, device)
    sync()
    if device.type == "cuda":
        # the peak of the capture held on the card and the program, not
        # of the generator's temporaries
        torch.cuda.reset_peak_memory_stats(device)
    parts["capture"] = time.perf_counter() - T_START - sum(parts.values())
    entry = make_entry(config, cfg, device)
    if entry_hook is not None:
        entry = entry_hook(entry)
    loop = Loop(entry, cap_planes, shapes.block, shapes.channels,
                cfg.audio_block_cap, seed, device,
                int(traffic.get("check_blocks", SAMPLE_BLOCKS)))
    loop.submit()                   # the first block captures the graph
    loop.drain(False)
    sync()
    parts["entry"] = time.perf_counter() - T_START - sum(parts.values())
    t_warm = time.perf_counter()
    while loop.next < WARM_BLOCKS or time.perf_counter() < t_warm + WARM_S:
        loop.step(False)
    loop.drain(False)
    sync()
    parts["warm"] = time.perf_counter() - T_START - sum(parts.values())
    kernels.reset_launches()
    loop.wait_s, n_submits = 0.0, len(loop.submit_s)
    for counts in (agc.STATS, fm.STATS, sam.STATS):
        for k in counts:
            counts[k] = 0
    setup_s = time.perf_counter() - T_START
    first = loop.next

    prof, traced_blocks, traced_submits = None, 0, 0
    gc.collect()        # set-up's garbage; the collector runs as it was
    if trace:
        loop.span = torch.profiler.record_function
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        if prof is not None and now >= t0 + TRACE_S:
            loop.drain(True)
            sync()
            prof.stop()
            traced_blocks = loop.next - first
            traced_submits = len(loop.submit_s)
            prof_done = prof
            prof = None
            loop.span = contextlib.nullcontext
            loop.time_blocks()
        loop.step(True)
    loop.drain(True)
    t_end = time.perf_counter()
    if prof is not None:
        sync()
        prof.stop()
        traced_blocks = loop.next - first
        traced_submits = len(loop.submit_s)
        prof_done = prof
    blocks = loop.next - first
    window_s = t_end - t0

    launches = sum(kernels.LAUNCHES.values())
    counts = {"blocks": blocks,
              "agc_fallbacks": int(agc.STATS["scan_fallbacks"]),
              "pll_tiers": {"fm": dict(fm.STATS), "sam": dict(sam.STATS)},
              "launches_per_block": launches / max(blocks, 1),
              "host_ms_per_block": {
                  "submit": 1e3 * sum(loop.submit_s[n_submits:])
                  / max(blocks, 1),
                  "wait": 1e3 * loop.wait_s / max(blocks, 1),
                  "loop": 1e3 * (window_s - loop.wait_s) / max(blocks, 1)},
              "setup_parts": parts}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                                 if device.type == "cuda" else 0)}

    metrics, breakdown = {}, None
    if trace:
        metrics, breakdown, busy, twin = _per_layer(
            cell, prof_done, traced_blocks,
            loop.submit_s[traced_submits:] or loop.submit_s,
            (loop.idle_s, loop.timed_s), shapes, root)
        dev["busy_s"], dev["window_s"] = busy, twin
    else:
        lat = np.asarray(loop.latencies) * 1e3
        metrics = {
            "msps": {"value": blocks * shapes.block / window_s / 1e6,
                     "unit": "Msps"},
            "block_p95_ms": {"value": float(np.percentile(lat, 95)),
                             "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {m["name"]: metrics[m["name"]] for m in cell.end_to_end}

    # the program is done: free it before the reference runs
    failed = loop.failed
    records = [rec for _, rec in sorted(loop.kept, key=lambda kv: kv[0])]
    if loop.last is not None and all(r[0] != loop.last[0] for r in records):
        records.append(loop.last_record())
    del loop, entry
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if keep is not None:
        keep.update(capture=cap_planes, records=records)
    t_ref = time.perf_counter()
    checks = correct.judge(config, traffic, cap_planes, records,
                           limits if limits is not None
                           else correct.limits_for(cell.name, root),
                           device)
    counts["reference_s"] = time.perf_counter() - t_ref
    result = {"correct": correct.passed(checks) and failed == 0
              and blocks > 0,
              "attempted": blocks, "failed": failed, "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, counts


def _per_layer(cell, prof, blocks, submits, idle, shapes, root):
    """The per-layer metrics of a traced window, its breakdown, busy and
    window seconds."""
    from sdrbench import trace
    dev, host = trace.device_events(prof)
    t0 = min([s for _, s, _ in host] + [s for _, s, _ in dev])
    t1 = max([e for _, _, e in host] + [s + d for _, s, d in dev])
    busy, gaps = trace.busy_and_gaps(dev, t0, t1)
    ctx = trace.Context(events=dev, blocks=max(blocks, 1), window_s=t1 - t0,
                        busy_s=busy, spans={"submit": submits},
                        stream_idle=idle, shapes=shapes,
                        layers=spec.load_layers(root))
    metrics = {}
    for m in cell.per_layer:
        reader = spec.load_metric(m["name"], root)
        v = reader.read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return metrics, trace.breakdown(dev, gaps, host), busy, t1 - t0


# ------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m sdrbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    repo = Path.cwd()
    bench = spec.load_benchmark(repo)
    cell = spec.load_cell(args.workload, bench, repo=repo)
    cache_dirs(repo)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"sdrbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, counts = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"sdrbench: modules loaded that the benchmark may not load: "
              f"{bad}", file=sys.stderr)
        return 3
    print(json.dumps({"work": counts}), flush=True)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
