"""The port's spans and counters on the CPU (``cutesdr_tpu_torch.metrics``):
tracing off, an entry call does nothing of tracing's; on (by the
operator's call or under a running ``torch.profiler``) each call records
its ``entry`` span and its parts, nested and numbered by block, on the
profiler's clock too; a session's pump spans; K4's round count on the
plain path; and the benchmark's readers of them (``sdrbench/metrics``)."""

import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from cutesdr_tpu_torch import metrics
from cutesdr_tpu_torch import session as ts
from cutesdr_tpu_torch.kernels import scan
from cutesdr_tpu_torch.ops import agc
from cutesdr_tpu_torch.pipeline import receiver as rx
from cutesdr_tpu_torch.shard import channels
from sdrbench import spec

torch.set_num_threads(1)

KW = dict(input_rate=250_000.0, mode="usb", tune_freq=60_000.0,
          frames_per_block=2)
SOLVE_COUNTS = ("solve_rounds", "solves")


@pytest.fixture(autouse=True)
def fresh_registry():
    """Every test starts and ends with tracing off, no spans and K4's
    counts at 0."""
    def clear():
        metrics.tracing(False)
        metrics.reset()
        for k in SOLVE_COUNTS:
            agc.STATS[k] = 0
    clear()
    yield
    clear()


def _planes(cfg, n_blocks, seed=5):
    """int16 planes of ``n_blocks`` blocks: a tone 1 kHz above the tune
    over noise."""
    rng = np.random.default_rng(seed)
    n = cfg.block_size * n_blocks
    t = np.arange(n) / cfg.input_rate
    x = 3000.0 * np.exp(2j * np.pi * (cfg.tune_freq + 1000.0) * t)
    x += 30.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return (np.round(x.real).astype(np.int16),
            np.round(x.imag).astype(np.int16))


def _blocks(cfg, n_blocks):
    re, im = _planes(cfg, n_blocks)
    bs = cfg.block_size
    return [(re[k * bs:(k + 1) * bs], im[k * bs:(k + 1) * bs])
            for k in range(n_blocks)]


def _entries():
    """(label, entry, call(entry, re, im)) of the entry calls that trace."""
    cfg = rx.ReceiverConfig(**KW)
    bank = channels.ChannelBank(cfg, [59_000.0, 61_000.0], "cpu")
    return [
        ("receiver planes", rx.Receiver(cfg, "cpu"),
         lambda e, re, im: e.process_planes(re, im)),
        ("receiver complex", rx.Receiver(cfg, "cpu"),
         lambda e, re, im: e.process(re.astype(np.float32)
                                     + 1j * im.astype(np.float32))),
        ("bank planes", bank, lambda e, re, im: e.process_planes(re, im)),
    ]


@pytest.mark.parametrize("which", range(3))
def test_tracing_off_does_nothing(monkeypatch, which):
    """Off, N entry calls record no span and call neither
    ``record_function`` nor ``torch.cuda.Event`` nor
    ``time.perf_counter_ns``."""
    label, entry, call = _entries()[which]
    calls = {"record_function": 0, "Event": 0, "perf_counter_ns": 0}

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
    for re, im in _blocks(entry.cfg, 3):
        call(entry, re, im)
    assert calls == {"record_function": 0, "Event": 0,
                     "perf_counter_ns": 0}, label
    assert metrics.SPANS == {} and not metrics.tracing_on, label


def test_tracing_on_records_entry_and_step():
    """``tracing(True)``: one ``entry`` and one ``entry.step`` a call (the
    eager path), both with the block's number, the step inside the
    entry."""
    cfg = rx.ReceiverConfig(**KW)
    r = rx.Receiver(cfg, "cpu")
    metrics.tracing(True)
    for re, im in _blocks(cfg, 3):
        r.process_planes(re, im)
    entry = metrics.SPANS["entry"].records()
    step = metrics.SPANS["entry.step"].records()
    assert set(metrics.SPANS) == {"entry", "entry.step"}
    assert [s for s, _, _ in entry] == [s for s, _, _ in step] == [1, 2, 3]
    for (_, t0, d0), (_, t1, d1) in zip(entry, step):
        assert t0 <= t1 and t1 + d1 <= t0 + d0
    assert metrics.SPANS["entry"].count == 3
    assert 0.0 < metrics.self_ms("entry") < metrics.mean_ms("entry")


def _inside(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_profiler_turns_tracing_on():
    """A running profiler turns tracing on at the next entry call; each
    program span then appears in the profiler's events (its clock),
    ``entry`` inside the caller's span and ``entry.step`` inside
    ``entry``; tracing stays on once the profiler has stopped, and the
    means read only the records made with no profiler running."""
    cfg = rx.ReceiverConfig(**KW)
    r = rx.Receiver(cfg, "cpu")
    blocks = _blocks(cfg, 3)
    r.process_planes(*blocks[0])
    assert not metrics.tracing_on and metrics.SPANS == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for re, im in blocks[1:]:
            with record_function("submit"):
                r.process_planes(re, im)
    assert metrics.tracing_on
    assert metrics.SPANS["entry"].count == 2
    events = [e for e in prof.events() if e.device_type.name == "CPU"]
    by = {n: [e for e in events if e.name == n]
          for n in ("submit", "entry", "entry.step")}
    assert [len(v) for v in by.values()] == [2, 2, 2]
    for sub, ent, st in zip(*by.values()):
        assert _inside(ent, sub) and _inside(st, ent)
    assert metrics.mean_ms("entry") is None      # no quiet record yet
    r.process_planes(*blocks[0])
    entry = metrics.SPANS["entry"]
    assert entry.count == 3 and entry.quiet_count == 1
    assert metrics.mean_ms("entry") == pytest.approx(
        1e-6 * entry.records()[-1][2])


def test_plain_solve_counts_its_rounds(monkeypatch):
    """On the plain path K4's counts in ``agc.STATS`` are the rounds and
    the solves that ``guess_verify_solve_plain`` returns, over a few
    blocks."""
    seen = []
    plain = scan.guess_verify_solve_plain

    def recorded(*a):
        out = plain(*a)
        seen.append(out[2])
        return out

    monkeypatch.setattr(scan, "guess_verify_solve_plain", recorded)
    cfg = rx.ReceiverConfig(**KW)
    r = rx.Receiver(cfg, "cpu")
    for re, im in _blocks(cfg, 3):
        r.process_planes(re, im)
    assert len(seen) == 6                       # two averagers a block
    assert agc.STATS["solves"] == len(seen)
    assert agc.STATS["solve_rounds"] == sum(seen) >= len(seen)


def test_session_pump_spans(monkeypatch):
    """One ``ReceiverSession`` pump a block with tracing on: each
    ``pump.*`` span once a block, nested in its ``pump`` with the block's
    number, the entry inside ``pump.step``; the metrics report the
    spans' means and the status line the pump's.  Off, the status line
    is the counts' alone, as it was."""
    monkeypatch.setattr(metrics.StreamMetrics, "elapsed",
                        property(lambda self: 2.0))
    cfg = rx.ReceiverConfig(**KW)
    sess = ts.ReceiverSession(cfg, device="cpu")
    sess.start()
    re, im = _planes(cfg, 4)
    x = (re.astype(np.float32) + 1j * im.astype(np.float32)).astype(
        np.complex64)
    bs = cfg.block_size
    sess.pump(x[:bs])
    assert metrics.SPANS == {}
    assert "spans_ms" not in sess.metrics.as_dict()
    metrics.tracing(True)
    for k in range(1, 4):
        assert sess.pump(x[k * bs:(k + 1) * bs]) == 1
    names = ("pump.reblock", "pump.display", "pump.step", "pump.audio",
             "entry")
    pump = metrics.SPANS["pump"].records()
    assert len(pump) == 3
    for name in names:
        recs = metrics.SPANS[name].records()
        assert len(recs) == 3, name
        for (seq, t0, d0), (ps, p0, pd) in zip(recs, pump):
            assert seq == ps and p0 <= t0 and t0 + d0 <= p0 + pd, name
    for (_, t0, d0), (_, s0, sd) in zip(metrics.SPANS["entry"].records(),
                                        metrics.SPANS["pump.step"].records()):
        assert s0 <= t0 and t0 + d0 <= s0 + sd
    assert set(sess.metrics.as_dict()["spans_ms"]) == {"pump", *names,
                                                        "entry.step"}
    m = sess.metrics
    counts = (f"{m.samples_in / 2.0 / 1e6:6.2f} Msps | "
              f"S {m.smeter_ave_db:6.1f} dB | "
              f"gap {m.missed_packets} | ppm {m.ppm_error:+d} | "
              f"{'OVR ' if m.overload else ''}"
              f"{'SQ' if not m.squelch_open else ''}")
    assert sess.status_line() == counts + (
        f" | pump {metrics.mean_ms('pump'):.3f} ms, "
        f"step {metrics.mean_ms('pump.step'):.3f}")
    metrics.tracing(False)
    assert sess.status_line() == counts
    sess.stop()


# ----------------------------------------------------------- the readers --

READERS = ("entry_self_ms", "entry_input_ms", "entry_replay_ms",
           "entry_outputs_ms", "input_device_ms", "k4_rounds",
           "setup_graph_s", "setup_kernels_s")


def _fill() -> None:
    """Two blocks of entry spans, two timed input copies, set-up spans
    and K4's counts, with known means."""
    ms = 1_000_000
    for seq, (entry, parts) in enumerate(((10, (1, 3, 1)), (20, (2, 4, 1))),
                                         start=1):
        metrics._span("entry").add(seq, 0, entry * ms)
        for name, d in zip(("input", "replay", "outputs"), parts):
            metrics._span("entry." + name).add(seq, 0, d * ms)
    metrics._span("entry.input").add_device(0.1)
    metrics._span("entry.input").add_device(0.3)
    metrics._span("setup.warmup").add(0, 0, 200 * ms)
    metrics._span("setup.capture").add(0, 0, 100 * ms)
    metrics._span("setup.kernels").add(0, 0, 50 * ms)
    agc.STATS["solve_rounds"] = 6
    agc.STATS["solves"] = 2


WANT = {"entry_self_ms": 9.0, "entry_input_ms": 1.5, "entry_replay_ms": 3.5,
        "entry_outputs_ms": 1.0, "input_device_ms": 0.2, "k4_rounds": 3.0,
        "setup_graph_s": 0.3, "setup_kernels_s": 0.05}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_registry(name):
    """Each new reader returns None on an empty registry and the mean of
    what was recorded on a filled one."""
    reader = spec.load_metric(name)
    assert reader.read(None) is None
    _fill()
    assert reader.read(None) == pytest.approx(WANT[name], rel=1e-12)


def test_ring_keeps_the_newest():
    """A span's ring keeps its newest ``RING`` records, oldest first; its
    count, total and maximum cover every record."""
    s = metrics._span("x")
    for k in range(metrics.RING + 5):
        s.add(k, k, k)
    recs = s.records()
    assert len(recs) == metrics.RING and recs[0][0] == 5
    assert recs[-1][0] == metrics.RING + 4
    assert s.count == metrics.RING + 5 and s.max_ns == metrics.RING + 4
