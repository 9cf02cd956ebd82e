"""On the card: the program's spans and K4's count over the flagship's
graphed entry (``cutesdr_tpu_torch.metrics``), and the readers of them
(python3 -m pytest sdrbench/tests -m card, from the repo's root, on a
machine with a CUDA device).

Tracing off, the graphed entry call does nothing of tracing's; on, each
block records ``entry`` and its three parts and a device time of its
input copies that agrees with the profiler's; tracing adds no device
work and no node to the captured graph; K4 runs 2 to 5 rounds a solve on
the flagship; a traced run of the cell prints every reader's metric."""

import ctypes
import functools
import json
import subprocess
import sys
import time

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from sdrbench import capture, run, spec
from sdrbench.tests import small

REPO = small.ROOT.parent
SEED = 3141592653
BLOCKS = 4
pytestmark = pytest.mark.card
NEW = ("entry_self_ms", "entry_input_ms", "entry_replay_ms",
       "entry_outputs_ms", "input_device_ms", "k4_rounds", "setup_graph_s",
       "setup_kernels_s")


@pytest.fixture
def traced(card):
    """The metrics registry, empty with tracing off, and put back so after
    the test."""
    from cutesdr_tpu_torch import metrics

    def clear():
        metrics.tracing(False)
        metrics.reset()
    clear()
    yield metrics
    clear()


def _flagship(card, blocks: int = BLOCKS):
    """The flagship cell's entry (graphed) and ``blocks`` blocks of its
    capture as int16 plane views on the card."""
    cell = spec.load_cell("usb_capture", spec.load_benchmark(REPO),
                          repo=REPO)
    b = int(cell.traffic["block_samples"])
    traffic = dict(cell.traffic, capture_samples=b * blocks)
    cfg = run.receiver_config(cell.config, traffic)
    re, im = capture.make(traffic, SEED, card)
    entry = run.make_entry(cell.config, cfg, card)
    assert entry.graphed
    return entry, [(re[k * b:(k + 1) * b], im[k * b:(k + 1) * b])
                   for k in range(blocks)]


def _device_items(prof) -> list:
    """Names of the device's kernels, copies and sets in a profile (not
    the annotations of host spans)."""
    return sorted(e.name for e in prof.events()
                  if e.device_type.name == "CUDA"
                  and not getattr(e, "is_user_annotation", False)
                  and e.name not in ("entry", "entry.input", "entry.replay",
                                     "entry.outputs"))


def test_tracing_off_graphed_entry(traced, card, monkeypatch):
    """Off, the graphed entry call runs no ``record_function``, makes no
    CUDA event, reads no ``perf_counter_ns`` and writes no ring slot."""
    metrics = traced
    entry, views = _flagship(card)
    entry.process_planes(*views[0])            # the capture, set-up
    metrics.reset()
    calls = dict.fromkeys(("record_function", "Event", "perf_counter_ns",
                           "add"), 0)

    def counting(name, real):
        def wrapped(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return wrapped

    monkeypatch.setattr(autograd_profiler, "record_function",
                        counting("record_function",
                                 autograd_profiler.record_function))
    monkeypatch.setattr(torch.cuda, "Event",
                        counting("Event", torch.cuda.Event))
    monkeypatch.setattr(time, "perf_counter_ns",
                        counting("perf_counter_ns", time.perf_counter_ns))
    monkeypatch.setattr(metrics.Span, "add",
                        counting("add", metrics.Span.add))
    for re, im in views * 2:
        entry.process_planes(re, im)
    torch.cuda.synchronize(card)
    assert calls == dict.fromkeys(calls, 0)
    assert metrics.SPANS == {}


def test_graphed_entry_spans_a_block(traced, card):
    """On, each block records ``entry``, ``entry.input``,
    ``entry.replay`` and ``entry.outputs`` once, with its number, the
    parts inside the entry, and one device time of its input copies."""
    metrics = traced
    entry, views = _flagship(card)
    entry.process_planes(*views[0])            # the capture, set-up
    metrics.reset()
    metrics.tracing(True)
    n = 3 * len(views)
    for k in range(n):
        entry.process_planes(*views[k % len(views)])
    torch.cuda.synchronize(card)
    parts = ("entry.input", "entry.replay", "entry.outputs")
    assert set(metrics.SPANS) == {"entry", *parts}
    whole = metrics.SPANS["entry"].records()
    assert [r[0] for r in whole] == list(range(1, n + 1))
    for name in parts:
        recs = metrics.SPANS[name].records()
        assert len(recs) == n, name
        for (seq, t0, d0), (ws, w0, wd) in zip(recs, whole):
            assert seq == ws and w0 <= t0 and t0 + d0 <= w0 + wd, name
    assert metrics.device_mean_ms("entry.input") > 0.0
    assert metrics.SPANS["entry.input"].device_count == n
    assert metrics.self_ms("entry") > 0.0


def _graph_nodes(graph) -> int:
    """Nodes of a captured graph kept with ``keep_graph``
    (``cuGraphGetNodes``)."""
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    assert err == 0, err
    return count.value


def test_tracing_adds_no_device_work(traced, card, monkeypatch):
    """A graph captured with tracing on has the nodes of one captured
    with it off, and a traced entry call runs on the device exactly what
    the untraced one runs (its timing events are no device work)."""
    metrics = traced
    monkeypatch.setattr(torch.cuda, "CUDAGraph", functools.partial(
        torch.cuda.CUDAGraph, keep_graph=True))
    off, views = _flagship(card)
    off.process_planes(*views[0])
    metrics.tracing(True)
    on, _ = _flagship(card)
    on.process_planes(*views[0])
    nodes = [_graph_nodes(e._graph.step.graph) for e in (off, on)]
    assert nodes[0] == nodes[1] > 0
    items = []
    for traced_call in (False, True):
        torch.cuda.synchronize(card)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for re, im in views:
                if traced_call:
                    on.process_planes(re, im)
                else:       # the same graph: int16 planes take the wire one
                    on._graph_step(on._wire(re, im)).run_planes(re, im)
            torch.cuda.synchronize(card)
        items.append(_device_items(prof))
    assert items[0] == items[1] and items[0]
    print(f"graph nodes {nodes[0]}, device items a block "
          f"{len(items[0]) / len(views)}")


def _descendant_kernels_us(event) -> float:
    """Device microseconds of the kernels launched under a host event's
    descendants."""
    total = 0.0
    for child in event.cpu_children:
        total += sum(k.duration for k in child.kernels)
        total += _descendant_kernels_us(child)
    return total


def test_input_device_ms_matches_the_profiler(traced, card):
    """The device span of the input copies reads within 15% of the
    profiler's own time for the same copies' kernels in the same run
    (each call queued behind a busy kernel, so that the copies run back
    to back as in a card-paced stream)."""
    metrics = traced
    entry, views = _flagship(card)
    entry.process_planes(*views[0])
    metrics.tracing(True)
    entry.process_planes(*views[1])           # the event pool, made
    torch.cuda.synchronize(card)
    metrics.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(2 * len(views)):
            torch.cuda._sleep(2_000_000)
            entry.process_planes(*views[k % len(views)])
        torch.cuda.synchronize(card)
    span = metrics.SPANS["entry.input"]
    assert metrics.device_mean_ms("entry.input") is not None
    assert span.device_count == 2 * len(views)
    prof_us = sum(_descendant_kernels_us(e) for e in prof.events()
                  if e.name == "entry.input"
                  and e.device_type.name == "CPU")
    assert prof_us > 0.0
    ratio = span.device_ms * 1e3 / prof_us
    print(f"input copies: events {span.device_ms:.4f} ms, profiler "
          f"{prof_us / 1e3:.4f} ms over {span.device_count} blocks")
    assert abs(ratio - 1.0) < 0.15, ratio


def test_k4_rounds_on_the_flagship(traced, card):
    """K4 counts its rounds on the card through every replay: 2 to 5
    rounds a solve on the flagship, two solves a block."""
    from cutesdr_tpu_torch.ops import agc
    entry, views = _flagship(card)
    entry.process_planes(*views[0])
    for k in ("solve_rounds", "solves"):
        agc.STATS[k] = 0
    n = 3 * len(views)
    for k in range(n):
        entry.process_planes(*views[k % len(views)])
    torch.cuda.synchronize(card)
    assert agc.STATS["solves"] == 2 * n
    rounds = spec.load_metric("k4_rounds").read(None)
    assert 2.0 <= rounds <= 5.0, rounds


def test_traced_run_reads_the_new_metrics(card):
    """A traced run of the cell at the benchmark's 10 s prints every new
    metric, the entry's parts (means over the blocks traced with no
    profiler running: the window's untraced tail, as ``submit_ms``)
    summing to its ``submit_ms`` within 0.01 ms, and K4's rounds in 2 to
    5."""
    out = subprocess.run([sys.executable, "-m", "sdrbench.run", "--workload",
                          "usb_capture", "--seed", str(SEED), "--seconds",
                          "10", "--trace", "1"], cwd=REPO, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(NEW) <= set(m), sorted(m)
    parts = sum(m[k] for k in ("entry_self_ms", "entry_input_ms",
                               "entry_replay_ms", "entry_outputs_ms"))
    print(json.dumps(m))
    assert abs(parts - m["submit_ms"]) < 0.01, (parts, m["submit_ms"])
    assert 2.0 <= m["k4_rounds"] <= 5.0
