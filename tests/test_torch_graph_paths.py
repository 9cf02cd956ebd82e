"""The graphed paths beyond the single receiver and the banks, on the CPU:
probes (a ``Receiver``'s taps and a session's ``set_probe`` switch), the
diversity receiver (2 and 4 branches), the one-card time shard and the
one-card pipeline.

A CUDA graph needs the card, so ``StepGraph`` is stood in for by
``_StaticGraph``: the eager step over static buffers that, like a real
graph, writes its outputs into the same buffers on every run (those made
at the capture), so that a caller holding a static output sees it
overwritten as it would on the card (the pipeline's ping-pong is what
keeps its staged block from being overwritten before the back stage
reads it).  Each path
runs six blocks through its graph path, bitwise against its eager step,
with one capture across the changes made in place.  The card's captures
are held to the eager steps by chip_smoke.py (``check_graph``).
"""

import numpy as np
import pytest
import torch

from cutesdr_tpu_torch.pipeline import receiver as rx
from cutesdr_tpu_torch.pipeline import stepgraph
from cutesdr_tpu_torch.session import ReceiverSession
from cutesdr_tpu_torch.shard import (PipelinedReceiver, ShardedReceiver,
                                     make_mesh)
from cutesdr_tpu_torch.shard import coherent
from cutesdr_tpu_torch.types import CDTYPE

torch.set_num_threads(1)

FIELDS = ("audio", "n_audio", "smeter_ave_db", "smeter_peak_db")
SMALL = dict(input_rate=250_000.0, tune_freq=60_000.0, frames_per_block=2)
N_BLOCKS = 6


class _StaticGraph:
    """``StepGraph``'s interface over the eager step with a graph's memory:
    static input, state and outputs; every replay writes its outputs into
    the buffers made at the capture; ``run`` clones them, as the real one
    does."""

    made = []
    _fits = stepgraph.StepGraph._fits
    _planes = stepgraph.StepGraph._planes
    _copy_planes = stepgraph.StepGraph._copy_planes
    wire = stepgraph.StepGraph.wire

    def __init__(self, step, params, state, block, device, planes=True,
                 share=None, wire=False):
        self.step, self.params, self.planes = step, params, planes
        if isinstance(block, torch.Tensor):
            self.iq = block
        elif share is not None:
            self.iq = share.iq
        elif wire:
            self.iq = torch.zeros((2, *block), dtype=torch.int16)
        else:
            self.iq = torch.zeros(block, dtype=CDTYPE)
        self.state = stepgraph.clone(state) if share is None else share.state
        self._dst = self._planes() if planes else None
        # the capture's outputs: allocated once (here by a run on a copy of
        # the state), rewritten by every replay
        self.out = stepgraph.clone(step(params, stepgraph.clone(self.state),
                                        *self._input())[1])
        _StaticGraph.made.append(self)

    def _input(self):
        return self._planes() if self.planes else (self.iq,)

    def run(self, iq):
        self._fits(iq)
        self.iq.copy_(iq)
        return stepgraph.clone(self.replay())

    def run_planes(self, re, im):
        self._fits(re, im)
        self._copy_planes(re, im)
        return stepgraph.clone(self.replay())

    def replay(self):
        new, out = self.step(self.params, self.state, *self._input())
        stepgraph._copy_into(self.state, new)
        stepgraph._copy_into(self.out, out)
        return self.out

    def load_state(self, state):
        stepgraph._copy_into(self.state, state)


@pytest.fixture
def static_graphs(monkeypatch):
    monkeypatch.setattr(stepgraph, "StepGraph", _StaticGraph)
    _StaticGraph.made = []
    return _StaticGraph.made


def _bits_equal(a, b) -> bool:
    view = lambda t: (torch.view_as_real(t) if t.is_complex() else t
                      ).contiguous().reshape(-1).view(torch.uint8)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        view(a), view(b))


def _same_outputs(got, want, label) -> None:
    for f in FIELDS:
        assert _bits_equal(getattr(got, f), getattr(want, f)), (label, f)
    if want.probes is not None:
        assert got.probes.keys() == want.probes.keys(), label
        for k, v in want.probes.items():
            assert _bits_equal(got.probes[k], v), (label, k)


def _same_trees(a, b, label) -> None:
    for (p, x), (_, y) in zip(stepgraph.walk(a), stepgraph.walk(b)):
        if isinstance(x, torch.Tensor):
            assert _bits_equal(x, y), (label, p)


def _cplx(rng, shape, scale=500.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _tone_stack(cfg, rng, b: int, gains) -> np.ndarray:
    """Coherent branches: gains[i] x a tone 1 kHz above the tune, plus
    independent noise."""
    n = cfg.block_size
    t = (np.arange(n) + b * n) / cfg.input_rate
    s = 3000.0 * np.exp(2j * np.pi * (cfg.tune_freq + 1000.0) * t)
    return np.stack([g * s for g in gains]).astype(np.complex64) + _cplx(
        rng, (len(gains), n), 30.0)


# ------------------------------------------------------------- probes ---

@pytest.mark.parametrize("mode", ["fm", "usb"])
def test_probes_graph_path_matches_eager(monkeypatch, static_graphs, mode):
    """A ``Receiver`` with probes through its graph path (the rule admits
    probes): six blocks bitwise the eager step, every tap (FM's p6 and
    ``pll_tier`` too) an output of the graph, cloned: a block's taps stay
    as they were after the next block; a retune on block 3 lands in
    place (one capture)."""
    cfg = rx.ReceiverConfig(mode=mode, probes=True, **SMALL)
    monkeypatch.setattr(rx, "graph_rule", lambda cfg, device: True)
    g = rx.Receiver(cfg, "cpu")
    params, state = stepgraph.clone(g.params), g.state
    rng = np.random.default_rng(21)
    kept = []
    for i in range(N_BLOCKS):
        if i == 3:
            g.set_tune_freq(cfg.tune_freq + 40.0)
            params = rx.tune_params(cfg, params, cfg.tune_freq + 40.0)
        x = torch.from_numpy(_cplx(rng, cfg.block_size))
        got = g.process(x)
        state, want = rx.receiver_step(cfg, params, state, x)
        _same_outputs(got, want, i)
        kept.append((got, stepgraph.clone(got)))
    want_taps = {"p1_downconvert", "p2_fastfir", "p3_agc", "p4_demod",
                 "p5_resampled"} | ({"p6_pll", "pll_tier"} if mode == "fm"
                                    else set())
    assert set(kept[0][0].probes) == want_taps
    if mode == "fm":
        tier = kept[-1][0].probes["pll_tier"]
        assert tier.dtype == torch.int32 and tier.dim() == 0
    for got, copy in kept:
        _same_outputs(got, copy, "kept")
    assert len(static_graphs) == 1
    _same_trees(g.state, state, "state")


def _session_run(cfg, blocks):
    """A session over ``blocks``: two blocks, ``set_probe("p2")`` (the
    spectrum view), two blocks, probes off, two blocks; returns the queued
    audio, the probe frame taken with p2 on, the S-meter and the
    session."""
    sess = ReceiverSession(cfg, device="cpu")
    sess.start()
    frames = []
    for i, x in enumerate(blocks):
        if i == 2:
            sess.set_probe("p2")
        if i == 4:
            frames.append(sess.probe_frame())
            sess.set_probe("off")
        sess.pump(x)
    sess.flush()
    q = sess.audio_queue
    idx = (q._tail + np.arange(q.level)) & (q.size - 1)
    return q._buf[idx].copy(), frames[0], sess.metrics.smeter_ave_db, sess


def test_session_set_probe_recaptures_and_keeps_state(monkeypatch,
                                                      static_graphs):
    """``ReceiverSession.set_probe`` switches to the receiver with probes
    on and back, each graphed: the switch on captures the probes
    receiver's graph (one more capture), the stream state migrates into
    it, and the queued audio, the p2 frame and the S-meter equal the
    eager session's, bitwise."""
    cfg = rx.ReceiverConfig(mode="usb", **SMALL)
    rng = np.random.default_rng(8)
    blocks = [_cplx(rng, cfg.block_size) for _ in range(N_BLOCKS)]
    want = _session_run(cfg, blocks)
    assert not want[3].receiver.graphed
    monkeypatch.setattr(rx, "graph_rule", lambda cfg, device: True)
    got = _session_run(cfg, blocks)
    assert got[3].receiver.graphed and not got[3].cfg.probes
    # the first receiver's graph, then the probes receiver's (captured
    # when it was warmed: a zero block, its state put back)
    assert len(static_graphs) == 2
    assert [g.iq.shape for g in static_graphs] == [(cfg.block_size,)] * 2
    assert np.array_equal(got[0], want[0]) and len(got[0]) > 0
    assert got[1] == want[1] and got[1]["tap"] == "p2_fastfir"
    assert got[2] == want[2]


# ---------------------------------------------------------- diversity ---

@pytest.mark.parametrize("n_branches", [2, 4])
def test_diversity_graph_path_matches_eager(monkeypatch, static_graphs,
                                            n_branches):
    """``DiversityReceiver`` through its graph path: the combine and the
    receiver step one captured step over the [n_branches, block_size]
    block; six blocks bitwise the eager combine and step, with a retune
    (and, pairwise, steering fixed) on block 2 and steering back to
    tracking on block 4, in place: one capture.  ``last_gain(s)`` read
    the static carry; the eager step with the device flag is bitwise the
    host-bool combine in both settings."""
    cfg = rx.ReceiverConfig(mode="usb", **SMALL)
    gains = (1.0, 0.8 * np.exp(0.7j), 0.6 * np.exp(-1.0j),
             0.3 * np.exp(2.0j))[:n_branches]
    monkeypatch.setattr(rx, "graph_rule", lambda cfg, device: True)
    g = coherent.DiversityReceiver(cfg, 2.0, n_branches, "cpu")
    assert g.graphed
    params, state = stepgraph.clone(g.params), g.state
    if n_branches == 2:
        cp, cc = coherent.init(2.0, "cpu")
        combine = coherent.process
    else:
        cp, cc = coherent.array_init(n_branches, 2.0, "cpu")
        combine = coherent.array_process
    steer = 0.6 - 0.3j
    rng = np.random.default_rng(33)
    for i in range(N_BLOCKS):
        if i == 2:
            g.set_tune_freq(cfg.tune_freq + 25.0)
            params = rx.tune_params(cfg, params, cfg.tune_freq + 25.0)
            if n_branches == 2:
                g.set_steering(steer)
                cp = cp._replace(manual=True, fixed_gain=torch.tensor(
                    complex(np.complex64(steer)), dtype=CDTYPE))
        if i == 4 and n_branches == 2:
            g.set_steering(None)
            cp = cp._replace(manual=False)
        x = torch.from_numpy(_tone_stack(cfg, rng, i, gains))
        got = g.process(x)
        cc, y = combine(cp, cc, x)
        state, want = rx.receiver_step(cfg, params, state, y)
        _same_outputs(got, want, i)
        live = g._live_carry()[1]
        _same_trees(live, cc, ("carry", i))
        if n_branches == 2:
            assert g.last_gain == complex(cc.gain.item())
        else:
            assert g.last_gains == [complex(v) for v in cc.gains.numpy()]
    assert len(static_graphs) == 1
    assert static_graphs[0].iq.shape == (n_branches, cfg.block_size)
    _same_trees(g.state, state, "state")
    with pytest.raises(ValueError, match="graphed step"):
        g.process(np.zeros((n_branches, cfg.block_size + 1), np.complex64))


@pytest.mark.parametrize("manual", [False, True])
def test_steering_flag_bitwise_host_bool(manual):
    """The combine with the steering switch as a 0-dim bool tensor
    (selected on the device) gives the host bool's bits: the output and
    the carried gain."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_cplx(rng, (2, 4096)))
    p, c = coherent.init(4.0, "cpu", manual=manual, fixed_gain=0.6 - 0.3j)
    c = c._replace(gain=torch.tensor(0.9 + 0.1j, dtype=CDTYPE))
    want_c, want_y = coherent.process(p, c, x)
    dev = p._replace(manual=torch.tensor(manual))
    got_c, got_y = coherent.process(dev, c, x)
    assert _bits_equal(got_y, want_y) and _bits_equal(got_c.gain,
                                                      want_c.gain)


# --------------------------------------------------------- time shard ---

def test_timeshard_graph_path_matches_eager(static_graphs):
    """``ShardedReceiver`` over four shards of one device through its
    graph path (the whole superblock one captured step) against the
    eager sharded step: six superblocks bitwise, a retune on superblock 3
    in place (one capture), the phase base advanced by the device value
    of the new increment; ``state`` and ``ts_carry`` read the static
    carry."""
    cfg = rx.ReceiverConfig(mode="usb", **SMALL)
    mesh = make_mesh(time=4, devices=["cpu"] * 4)
    g, e = ShardedReceiver(cfg, mesh), ShardedReceiver(cfg, mesh)
    assert not g.graphed
    g._one_card = True                     # one "card": the CPU
    rng = np.random.default_rng(17)
    for i in range(N_BLOCKS):
        if i == 3:
            for r in (g, e):
                r.params = rx.tune_params(cfg, r.params,
                                          cfg.tune_freq + 40.0)
        x = _tone_stack(cfg, rng, i, (1.0,))[0]
        x = np.concatenate([x] + [_cplx(rng, cfg.block_size, 30.0)
                                  for _ in range(3)])
        _same_outputs(g.process(x), e.process(x), i)
    assert len(static_graphs) == 1
    assert static_graphs[0].iq.shape == (g.superblock_size,)
    _same_trees(g.ts_carry, e.ts_carry, "ts_carry")
    _same_trees(g.state, e.state, "state")
    inc = g.params.dec.phase_inc
    assert int(static_graphs[0].params.dec.phase_inc) == inc
    # the carry's phase base after the retune: the new increment's
    moved = int(e.ts_carry.nco_base)
    g.process(np.zeros(g.superblock_size, np.complex64))
    assert int(g.ts_carry.nco_base) == (moved + g.superblock_size * inc
                                        ) & 0xFFFFFFFF


@pytest.mark.parametrize("nb_on", [False, True])
@pytest.mark.parametrize("graphed", [False, True])
def test_timeshard_int16_planes_match_cast(static_graphs, graphed, nb_on):
    """A superblock's int16 planes through ``ShardedReceiver.
    process_planes``, graphed (an int16 static superblock) or eager, each
    shard's K1 fed its int16 slice (the blanker, where on, their float32
    cast), against ``process`` of the same values as a complex64
    superblock: three superblocks bitwise, carries included."""
    cfg = rx.ReceiverConfig(mode="usb", nb_on=nb_on, **SMALL)
    mesh = make_mesh(time=4, devices=["cpu"] * 4)
    g, e = ShardedReceiver(cfg, mesh), ShardedReceiver(cfg, mesh)
    g._one_card = graphed
    rng = np.random.default_rng(29)
    for i in range(3):
        x = (np.round(_cplx(rng, g.superblock_size)) + 0.0).astype(
            np.complex64)
        re, im = (p.astype(np.int16) for p in (x.real, x.imag))
        _same_outputs(g.process_planes(re, im), e.process(x), i)
    assert [m.wire for m in static_graphs] == ([True] if graphed else [])
    _same_trees(g.ts_carry, e.ts_carry, "ts_carry")
    _same_trees(g.state, e.state, "state")


# ----------------------------------------------------------- pipeline ---

def test_pipeline_graph_path_one_block_late(monkeypatch, static_graphs):
    """``PipelinedReceiver`` through its graph path on one "card": two
    front captures writing two static blocks in turn and two back
    captures reading one each, sharing each stage's static state; six
    blocks and a flush bitwise the single receiver's one block late.  A
    capture whose static block the next front overwrote before the back
    read it would fail here, since the stand-in's outputs are static.  A
    retune and a volume change reach the graphs in place (the front's
    params with block 2, the back's with block 3, whose back stage runs
    then); an AGC knee, a new key, captures the four anew, the staged
    block carried over (the front's with block 4, the back's with 5)."""
    monkeypatch.setattr(PipelinedReceiver, "graphed",
                        property(lambda self: True))
    cfg = rx.ReceiverConfig(mode="usb", **SMALL)
    pp = PipelinedReceiver(cfg, "cpu", "cpu")
    single = rx.Receiver(cfg, "cpu")
    rng = np.random.default_rng(29)
    blocks = [_tone_stack(cfg, rng, i, (1.0,))[0] for i in range(N_BLOCKS)]
    moved = rx.volume_params(rx.tune_params(cfg, pp.params,
                                            cfg.tune_freq + 40.0), 72)
    kneed = moved._replace(agc=moved.agc._replace(knee=np.float32(-4.0)))
    outs, want, made = [], [], []
    for i, b in enumerate(blocks):
        if i in (2, 4):
            pp.params = single.params = moved if i == 2 else kneed
        if i in (3, 5):
            pp.back_params = pp.params
        outs.append(pp.process(b))
        want.append(single.process(b))
        made.append(len(static_graphs))
    outs = outs[1:] + [pp.flush()]
    assert pp.flush() is None
    assert made == [4, 4, 4, 4, 8, 12]
    fronts, backs = static_graphs[-4:-2], static_graphs[-2:]
    assert fronts[0].state is fronts[1].state and fronts[0].iq is fronts[1].iq
    assert backs[0].state is backs[1].state
    assert [b.iq for b in backs] == [f.out for f in fronts]
    assert fronts[1].params is fronts[0].params
    assert backs[1].params is backs[0].params
    assert float(fronts[0].params.audio_gain) == moved.audio_gain
    assert int(static_graphs[0].params.dec.phase_inc) == \
        moved.dec.phase_inc
    assert float(backs[0].params.agc.knee) == -4.0
    for i, (out, w) in enumerate(zip(outs, want)):
        _same_outputs(out, w, i)
    # the stages' carries read the static state
    _same_trees(tuple(pp.back_state.values()),
                tuple(getattr(single.state, k) for k in
                      ("agc", "smeter", "demod", "resamp")), "back")
    front_carry = tuple(pp.front_state.values())
    _same_trees(front_carry, tuple(getattr(single.state, k) for k in
                                   ("blanker", "dec", "chan_filter")),
                "front")
