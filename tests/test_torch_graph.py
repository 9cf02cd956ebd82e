"""The single-stream step's device-decided choices and its CUDA-graph
bookkeeping, on the CPU.

* The merge of the AGC's exact averagers over the parallel ones
  (``ops/agc._fallback``, N1's plain form with ``skip``/``out``) and the
  PLL tiers' selection (``demod/fm._exact_over``, ``_tier``,
  ``demod/sam._exact_over``, K7's and K8's plain forms), with the flags
  true and false, against the eager results.
* The AGC on an input that falls back and one that does not, FM and SAM
  on a locked tone, noise and a never-syncing tone, each held against the
  JAX package (jitted on the CPU), the tiers and fallback counts equal.
* The graph rule (``pipeline/receiver.graph_rule``) over every mode, AGC,
  blanker and probes setting on "cuda" and "cpu" configurations, without
  a card (probes are graphed too).
* ``Receiver``'s graph path with ``StepGraph`` stood in for by the eager
  step on static buffers (a capture needs the card): params changed
  between blocks reach the captured params in place, a change of host
  value captures a new graph, ``state`` reads and assigns, outputs
  outlive the next block, and every block equals the eager receiver's
  bit for bit.  The card's capture and replay are held to the eager
  step by chip_smoke.py (``check_graph``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesdr_tpu.demod import fm as j_fm
from cutesdr_tpu.demod import sam as j_sam
from cutesdr_tpu.ops import agc as j_agc
from cutesdr_tpu_torch import kernels
from cutesdr_tpu_torch.demod import fm as t_fm
from cutesdr_tpu_torch.demod import sam as t_sam
from cutesdr_tpu_torch.kernels import agcseq, scan, seqloop
from cutesdr_tpu_torch.ops import agc as t_agc
from cutesdr_tpu_torch.ops import resampler
from cutesdr_tpu_torch.pipeline import receiver as rx
from cutesdr_tpu_torch.pipeline import stepgraph

torch.set_num_threads(1)

FS = 62_500.0
N = 2048


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cplx(rng, n, scale=1.0):
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * scale).astype(np.complex64)


def _tone(n, f_hz, start=0, phase=0.3, amp=3000.0, fs=FS):
    t = (np.arange(n) + start) / fs
    return (amp * np.exp(1j * (2 * np.pi * f_hz * t + phase))).astype(
        np.complex64)


def _bits_equal(a, b) -> bool:
    view = lambda t: (torch.view_as_real(t) if t.is_complex() else t
                      ).reshape(-1).view(torch.uint8)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        view(a), view(b))


def _agc_case(n=4096, seed=5):
    rng = np.random.default_rng(seed)
    cfg = t_agc.AgcConfig(True, False, 15_625.0)
    p = t_agc.make_params(cfg, -100.0, 30.0, 0.0, 200.0)
    c = t_agc.init_carry(cfg, "cpu")
    env = np.repeat(10.0 ** rng.uniform(1, 4, n // 256), 256)
    x = _t((_cplx(rng, n) * env).astype(np.complex64))
    return cfg, p, c, t_agc._prefix(cfg, c, x)[2]


# --------------------------------------------- the merges and selections --

@pytest.mark.parametrize("ok", [True, False])
def test_agc_fallback_merge(ok):
    """N1's plain form with ``skip``: ``out`` itself (no loop, no count)
    where the flag holds, else the exact recurrence, counted once; the
    AGC's ``_fallback`` gives the same for a 0-dim flag and a host bool."""
    cfg, p, c, peak = _agc_case()
    levels, _ = t_agc._averager_parallel(cfg, p, c, peak)
    exact = t_agc._averager_scan(cfg, p, c, peak)
    count = torch.zeros((), dtype=torch.int32)
    got = t_agc._averager_scan(cfg, p, c, peak, levels, torch.tensor(ok),
                               count)
    want = levels if ok else exact
    assert all(_bits_equal(g, w) for g, w in zip(got, want))
    assert (got is levels) == ok and int(count) == (not ok)
    for flag in (torch.tensor(ok), ok):
        before = t_agc.STATS["scan_fallbacks"]
        got = t_agc._fallback(cfg, p, c, peak, levels, flag)
        assert all(_bits_equal(g, w) for g, w in zip(got, want))
        assert t_agc.STATS["scan_fallbacks"] - before == (not ok)


@pytest.mark.parametrize("stim", ["tone", "noise", "short noise"])
def test_fm_tier_selection(stim):
    """FM's ``_exact_over``: the linear tier's outputs, untouched and with
    K7's flag False, where the linear tier held; else K7's outputs (the
    sequential loop's bits) and flag; ``_tier`` labels the three tiers as
    the eager tiers did (chunked only on a chunkable block whose every
    boundary held)."""
    rng = np.random.default_rng(3)
    n = 1000 if stim == "short noise" else N
    x = _t(_tone(n, 150.0) if stim == "tone" else _cplx(rng, n, 3000.0))
    p, c = t_fm.init(FS, "cpu")
    theta = torch.atan2(x.imag, x.real)
    valid, linear = t_fm._linear_solve(p, c, theta)
    ok = valid.all()
    flag, loop = t_fm._exact_over(p, c, theta, linear, ok)
    args = (p.pll_alpha, p.pll_beta, p.nco_limit, c.nco_phase, c.nco_freq,
            theta)
    if bool(ok):
        assert loop is linear and not bool(flag)
    else:
        want = seqloop.fm_pll_chunked(*args)
        assert _bits_equal(flag, want[0])
        assert all(_bits_equal(g, w) for g, w in zip(loop, want[1:]))
    tier = t_fm._tier(ok, flag, n)
    assert tier.dtype == torch.int32 and tier.dim() == 0
    want_tier = {"tone": 0, "noise": 1, "short noise": 2}[stim]
    assert int(tier) == want_tier
    # the plain form of K7 with skip: (False, *out) where the flag holds
    skipped = seqloop.fm_pll_chunked_plain(*args, skip=torch.tensor(True),
                                           out=linear)
    assert not bool(skipped[0]) and all(
        a is b for a, b in zip(skipped[1:], linear))
    for t, tier_ in ((torch.tensor(True), 0), (torch.tensor(False), 2)):
        assert int(t_fm._tier(t, torch.tensor([False]), N)) == tier_
    assert int(t_fm._tier(torch.tensor(False), torch.tensor([True]), N)) == 1
    assert int(t_fm._tier(torch.tensor(False), torch.tensor([True]),
                          1000)) == 2


@pytest.mark.parametrize("stim", ["tone", "noise"])
def test_sam_tier_selection(stim):
    """SAM's ``_exact_over``: the linear tier's (phase', freq', prev)
    untouched where it held, else K8's plain loop's bits; K8's plain form
    with ``skip`` returns ``out`` where the flag holds."""
    rng = np.random.default_rng(4)
    x = _t(_tone(N, 10.0) if stim == "tone" else _cplx(rng, N, 3000.0))
    p, c = t_sam.init(FS, "cpu")
    theta = torch.atan2(x.imag, x.real)
    valid, linear = t_sam._pll_linear(p, c, theta)
    ok = valid.all()
    assert bool(ok) == (stim == "tone")
    got = t_sam._exact_over(p, c, theta, linear, ok)
    args = (p.pll_alpha, p.pll_beta, p.nco_limit, c.nco_phase, c.nco_freq,
            theta)
    want = linear if bool(ok) else seqloop.sam_pll_scan(*args)
    assert all(_bits_equal(g, w) for g, w in zip(got, want))
    skipped = seqloop.sam_pll_scan_plain(*args, skip=torch.tensor(True),
                                         out=linear)
    assert all(a is b for a, b in zip(skipped, linear))
    with pytest.raises(ValueError, match="skip needs out"):
        seqloop.sam_pll_scan_plain(*args, skip=torch.tensor(True))


# ---------------------------------------------------- against the JAX ---

@pytest.mark.parametrize("falls_back", [False, True])
def test_agc_fallbacks_match_jax(monkeypatch, falls_back):
    """The port's single-stream AGC over three chained blocks against
    JAX's jitted ``process``: output within 1e-4 of its scale, the
    averages within 1e-5 decades, and the fallback count JAX's (a block
    falls back where JAX's parallel averagers did not converge); one
    guess-verify round allowed forces the fallback."""
    if falls_back:
        monkeypatch.setattr(j_agc, "GUESS_ITERS", 1)
        monkeypatch.setattr(t_agc, "GUESS_ITERS", 1)
    rng = np.random.default_rng(61)
    fs = 15_625.0
    jcfg, tcfg = j_agc.AgcConfig(True, False, fs), t_agc.AgcConfig(
        True, False, fs)
    jp = j_agc.make_params(jcfg, -100.0, 30.0, 0.0, 200.0)
    tp = t_agc.make_params(tcfg, -100.0, 30.0, 0.0, 200.0)
    jc, tc = j_agc.init_carry(jcfg, True), t_agc.init_carry(tcfg, "cpu")
    j_step = jax.jit(lambda c, x: j_agc.process(jcfg, jp, c, x))

    @jax.jit
    def j_converged(c, x):
        peak = j_agc._prefix(jcfg, c, x)[2]
        return j_agc._averager_parallel(jcfg, jp, c, peak)[1]

    before = t_agc.STATS["scan_fallbacks"]
    jax_fallbacks = 0
    for b in range(3):
        if falls_back:
            env = np.repeat(10.0 ** rng.uniform(1, 4, 8), 512)
            x = (_cplx(rng, 4096) * env).astype(np.complex64)
        else:
            x = _tone(4096, 300.0, start=b * 4096, fs=fs)
        jax_fallbacks += not bool(j_converged(jc, jnp.asarray(x)))
        jc, jy = j_step(jc, jnp.asarray(x))
        tc, ty = t_agc.process(tcfg, tp, tc, _t(x))
        want = np.asarray(jy)
        np.testing.assert_allclose(ty.numpy(), want,
                                   atol=1e-4 * np.abs(want).max())
        for f in ("attack_ave", "decay_ave"):
            np.testing.assert_allclose(getattr(tc, f).numpy(),
                                       np.asarray(getattr(jc, f)), atol=1e-5)
    fell_back = t_agc.STATS["scan_fallbacks"] - before
    assert fell_back == jax_fallbacks
    assert (fell_back > 0) == falls_back


def _demod_stim(mode, stim, b, rng):
    from tests.test_torch_demods import _am_tone
    if stim == "noise":
        return _cplx(rng, N, 3000.0)
    if stim == "never-syncing":
        # FM: a clean carrier 3 Hz off, 2.8 rad from the loop's start: the
        # first block acquires through the exact loop, whose chunks
        # almost never bit-sync; SAM: a carrier 1.5 kHz off, past the
        # loop's 1 kHz clamp, which it never locks to
        return (_tone(N, 3.0, start=b * N, phase=2.8) if mode == "fm"
                else _tone(N, 1500.0, start=b * N))
    return (_tone(N, 150.0, start=b * N) if mode == "fm"
            else _am_tone(N, start=b * N))


@pytest.mark.parametrize("mode", ["fm", "sam"])
@pytest.mark.parametrize("stim", ["locked", "noise", "never-syncing"])
def test_demod_tiers_match_jax(mode, stim):
    """FM and SAM over three chained blocks against JAX's jitted
    ``process_probed``: the tier of every block JAX's, ``STATS`` counting
    exactly those tiers, the audio finite; locked and on noise, over the
    first two, the audio within the bounds of
    ``test_torch_demods.test_demod_tier_parity`` (FM 1e-5 of its scale,
    SAM 1e-6 of the DC block's scale)."""
    from tests.test_torch_demods import _dc_err, _rel
    rng = np.random.default_rng(90)
    jm, tm = (j_fm, t_fm) if mode == "fm" else (j_sam, t_sam)
    jp, jc = jm.init(FS)
    tp, tc = tm.init(FS, "cpu")
    j_probed = jax.jit(jm.process_probed)
    tm.STATS.update(dict.fromkeys(tm.STATS, 0))
    tiers = []
    for b in range(3):
        x = _demod_stim(mode, stim, b, rng)
        jc, jy, _, jtier = j_probed(jp, jc, jnp.asarray(x))
        tc, ty, _, ttier = tm.process_probed(tp, tc, _t(x))
        assert ttier == int(jtier), (b, ttier, int(jtier))
        tiers.append(ttier)
        assert torch.isfinite(ty).all()
        if stim == "never-syncing" or b == 2:
            continue              # acquisition: FMA rounding moves a wrap
        if mode == "sam":
            assert _dc_err(ty.numpy(), jy, x) < 1e-6
        elif np.abs(np.asarray(jy)).max() > 0:
            assert _rel(ty.numpy(), jy) < 1e-5
    assert tm.STATS == {name: tiers.count(t)
                        for t, name in tm.TIER_NAMES.items()}
    if stim == "never-syncing":
        assert tiers[0] != tm.TIER_LINEAR


# ------------------------------------------------------------ the rule ---

@pytest.mark.parametrize("mode", rx.PORTED_MODES)
def test_graph_rule(mode):
    """Graphed: a single stream or a bank on a CUDA device in every mode,
    mono and stereo, with the two-rate or the hang-mode AGC or the AGC
    off, with or without the blanker, with or without probes.  Eager:
    every CPU receiver; the rules are functions of (cfg, device)
    alone."""
    for device in ("cuda", "cuda:0", "cpu"):
        for stereo in (False, True):
            for agc_on, hang in ((True, False), (True, True), (False, False),
                                 (False, True)):
                for nb_on in (False, True):
                    for probes in (False, True):
                        cfg = rx.ReceiverConfig(
                            mode=mode, stereo=stereo, agc_on=agc_on,
                            agc_hang=hang, nb_on=nb_on, probes=probes)
                        want = device != "cpu"
                        assert rx.graph_rule(cfg, device) == want, cfg
                        assert rx.bank_graph_rule(cfg, device) == want, cfg


# ------------------------------------------------- the Receiver's graphs --

class _EagerGraph:
    """``StepGraph``'s interface over the eager step on static buffers (no
    capture): the params referenced as the real one references them, the
    state copied into static buffers, the outputs cloned."""

    made = []

    def __init__(self, step, params, state, block, device, planes=True,
                 wire=False):
        self.step, self.params, self.wire = step, params, wire
        self.state = stepgraph.clone(state)
        _EagerGraph.made.append(self)

    def run(self, iq):
        return self.run_planes(iq.real, iq.imag)

    def run_planes(self, re, im):
        # a wire graph's static block holds the int16 planes as they are,
        # a complex one their float32 cast
        assert self.wire == (re.dtype == torch.int16)
        if not self.wire:
            re, im = re.float(), im.float()
        new, out = self.step(self.params, self.state, re, im)
        stepgraph._copy_into(self.state, new)
        return stepgraph.clone(out)

    def load_state(self, state):
        stepgraph._copy_into(self.state, state)


@pytest.fixture
def graphed_cpu(monkeypatch):
    monkeypatch.setattr(rx, "graph_rule", lambda cfg, device: True)
    monkeypatch.setattr(stepgraph, "StepGraph", _EagerGraph)
    _EagerGraph.made = []
    return _EagerGraph.made


def _wire_block(rng, n, scale):
    """A complex64 block of whole int16 values (no -0.0, which no int16
    casts to)."""
    return (np.round(_cplx(rng, n, scale)) + 0.0).astype(np.complex64)


def _feed(r, x, fmt):
    """``x`` into a receiver as ``fmt``: the complex block, its float32
    planes or its int16 planes."""
    if fmt == "complex64":
        return r.process(x)
    dtype = np.float32 if fmt == "float32" else np.int16
    return r.process_planes(x.real.astype(dtype), x.imag.astype(dtype))


_GRAPH_MODES = [("usb", {}), ("fm", {}),
                ("sam", dict(stereo=True, nb_on=True)),
                ("am", dict(audio_rate=None))]


@pytest.mark.parametrize("mode,kw,fmt", [
    pytest.param(mode, kw, fmt, id=f"{mode}-kw{i}" + (
        "" if fmt == "complex64" else f"-{fmt}"))
    for i, (mode, kw) in enumerate(_GRAPH_MODES)
    for fmt in ("complex64", "float32", "int16")])
def test_receiver_graph_path_matches_eager(graphed_cpu, mode, kw, fmt):
    """Six blocks through ``Receiver``'s graph path, fed as a complex
    block, float32 planes or int16 planes (the blanker on in SAM), against
    an eager receiver on the same values as a complex64 block, bit for
    bit: a retune, a volume change, a new filter, a new DC cal and a ratio
    change on block 3 reach the captured params in place (one capture);
    an AGC change on block 5 captures a second one; outputs stay valid
    after the next block; ``state`` reads the static buffers' values, and
    assigning it restarts the stream."""
    cfg = rx.ReceiverConfig(mode=mode, frames_per_block=2, **kw)
    g, e = rx.Receiver(cfg, "cpu"), rx.Receiver(cfg, "cpu")
    monkey_rule = rx.graph_rule
    assert g.graphed and monkey_rule(cfg, "cpu")
    rng = np.random.default_rng(12)
    block = _wire_block if fmt == "int16" else _cplx
    blocks = [block(rng, cfg.block_size, 500.0) for _ in range(6)]
    fresh = g.state
    outs, kept = [], []
    for i, x in enumerate(blocks):
        for r in (g, e):
            if i == 3:
                r.set_tune_freq(cfg.tune_freq + 40.0)
                r.set_volume(61)
                r.set_filter(cfg.low_cut + 10.0, cfg.hi_cut - 10.0)
                r.set_dc_offset(0.5, -0.25)
                r.set_resample_ratio(cfg.output_rate / 48000.0 * 1.0001)
            if i == 5:
                r.set_agc(thresh_db=-90.0)
        og = _feed(g, x, fmt)
        oe = rx.receiver_step(cfg, e.params, e.state, _t(x))
        e.state = oe[0]
        oe = oe[1]
        outs.append(og)
        kept.append(og.audio.clone())
        for f in ("audio", "n_audio", "smeter_ave_db", "smeter_peak_db"):
            assert _bits_equal(getattr(og, f), getattr(oe, f)), (i, f)
    assert all(torch.equal(o.audio, k) for o, k in zip(outs, kept))
    assert len(graphed_cpu) == 2          # the AGC change: a second graph
    assert all(m.wire == (fmt == "int16") for m in graphed_cpu)
    for (p, a), (_, b) in zip(stepgraph.walk(g.state),
                              stepgraph.walk(e.state)):
        if isinstance(a, torch.Tensor):
            assert _bits_equal(a, b), p
    g.state = fresh
    again = _feed(g, blocks[0], fmt)
    first = rx.receiver_step(cfg, g.params, fresh, _t(blocks[0]))[1]
    assert _bits_equal(again.audio, first.audio)


@pytest.mark.parametrize("mode,kw", [("usb", {}),
                                     ("am", dict(nb_on=True))])
def test_graph_input_kind_switch_captures_anew(graphed_cpu, mode, kw):
    """A receiver fed int16 planes, then float32 planes, then int16
    again captures a graph at each switch (an int16 static block, then a
    complex one), carries the state over each time, and stays bit for
    bit the eager receiver; float32 planes and a complex block share one
    graph."""
    cfg = rx.ReceiverConfig(mode=mode, frames_per_block=2, **kw)
    g, e = rx.Receiver(cfg, "cpu"), rx.Receiver(cfg, "cpu")
    rng = np.random.default_rng(23)
    fmts = ["int16", "int16", "float32", "complex64", "int16", "int16"]
    for fmt in fmts:
        x = _wire_block(rng, cfg.block_size, 500.0)
        og = _feed(g, x, fmt)
        e.state, oe = rx.receiver_step(cfg, e.params, e.state, _t(x))
        for f in ("audio", "n_audio", "smeter_ave_db", "smeter_peak_db"):
            assert _bits_equal(getattr(og, f), getattr(oe, f)), (fmt, f)
    assert [m.wire for m in graphed_cpu] == [True, False, True]
    for (p, a), (_, b) in zip(stepgraph.walk(g.state),
                              stepgraph.walk(e.state)):
        if isinstance(a, torch.Tensor):
            assert _bits_equal(a, b), p


def test_graph_params_follow_a_key_round_trip(graphed_cpu):
    """Between two blocks the AGC threshold moves the key off the captured
    one, a retune and a new filter land while it is off, and the AGC comes
    back to the captured key: no capture, and the graph's params take the
    retune and the filter (diffed against what the graph holds, not
    against the params set last), bit for bit the eager receiver."""
    cfg = rx.ReceiverConfig(mode="usb", frames_per_block=2)
    g, e = rx.Receiver(cfg, "cpu"), rx.Receiver(cfg, "cpu")
    rng = np.random.default_rng(31)
    for i in range(3):
        x = _cplx(rng, cfg.block_size, 500.0)
        for r in (g, e):
            if i == 1:
                r.set_agc(thresh_db=-90.0)
                r.set_tune_freq(cfg.tune_freq + 60.0)
                r.set_filter(cfg.low_cut + 20.0, cfg.hi_cut - 20.0)
                r.set_agc()
        og = g.process(x)
        e.state, oe = rx.receiver_step(cfg, e.params, e.state, _t(x))
        for f in ("audio", "n_audio", "smeter_ave_db", "smeter_peak_db"):
            assert _bits_equal(getattr(og, f), getattr(oe, f)), (i, f)
    assert len(graphed_cpu) == 1
    held = graphed_cpu[0].params
    assert int(held.dec.phase_inc) == g.params.dec.phase_inc
    assert torch.equal(held.chan_filter.h_freq, g.params.chan_filter.h_freq)


def test_reconfigure_drops_the_graph_and_its_key(graphed_cpu):
    """``reconfigure`` drops the graph and the key cached for the old
    configuration: the new configuration captures once, under its own
    key, and a volume change after it lands in place."""
    import dataclasses
    cfg = rx.ReceiverConfig(mode="usb", frames_per_block=2)
    g = rx.Receiver(cfg, "cpu")
    rng = np.random.default_rng(41)
    g.process(_cplx(rng, cfg.block_size, 500.0))
    g.reconfigure(dataclasses.replace(cfg, mode="am"))
    g.process(_cplx(rng, cfg.block_size, 500.0))
    g.set_volume(50)
    g.process(_cplx(rng, cfg.block_size, 500.0))
    assert len(graphed_cpu) == 2
    assert g._graph.key == rx.graph_key(g.cfg, g.params)
    assert float(g._graph.params.audio_gain) == g.params.audio_gain

@pytest.mark.parametrize("hang", [False, True])
def test_hang_mode_reads_its_flag_on_the_host(monkeypatch, hang):
    """On the CPU the plain rounds read their flag on the host, hang
    mode's too: a converged solve hands back True, read.  On the card
    every solve (the two-rate averagers' K4, hang mode's N3h) leaves its
    flag on the device, and the AGC hands ``_fallback`` the 0-dim flag of
    both averagers (N1 reads it) in hang mode as in two-rate mode: no
    host read.  The card's solves are stood in for by their plain
    versions with the flag made a 0-dim tensor, as the kernels leave
    it."""
    cfg = t_agc.AgcConfig(True, hang, 15_625.0)
    p = t_agc.make_params(cfg, -100.0, 30.0, 0.0, 200.0)
    x = _t(_tone(4096, 300.0, fs=15_625.0))
    c = t_agc.init_carry(cfg, "cpu")
    peak = t_agc._prefix(cfg, c, x)[2]
    if hang:
        _, _, ok = scan.hang_solve(peak, c.decay_ave, c.hang_timer,
                                   p.decay_rise_alpha, p.decay_fall_alpha,
                                   p.hang_time, t_agc.GUESS_ITERS)
    else:
        _, ok, _ = scan.guess_verify_solve(peak, c.attack_ave,
                                           p.attack_rise_alpha,
                                           p.attack_fall_alpha,
                                           t_agc.GUESS_ITERS)
    assert ok is True
    seen = []
    merge = t_agc._fallback
    solve, hang_solve = scan.guess_verify_solve, scan.hang_solve
    monkeypatch.setattr(scan, "guess_verify_solve", lambda *a, **k: (
        lambda x, ok, rounds: (x, torch.tensor(ok), rounds))(*solve(*a, **k)))
    monkeypatch.setattr(scan, "hang_solve", lambda *a: (
        lambda d, timer, ok: (d, timer, torch.tensor(ok)))(*hang_solve(*a)))
    monkeypatch.setattr(t_agc, "_fallback",
                        lambda *a: seen.append(a[-1]) or merge(*a))
    t_agc.process(cfg, p, c, x)
    assert len(seen) == 1
    assert isinstance(seen[0], torch.Tensor) and seen[0].dim() == 0


def test_graph_keys_and_device_params():
    """The graph key bakes in host values and shapes, not the tune, the
    volume or a banded ratio, which ``device_params`` holds as 0-dim
    tensors that ``_update_params`` fills in place; the ratio leaving the
    nominal p/q moves the resampler off the rational route (a new key),
    and a ratio held on the device never takes it."""
    cfg = rx.ReceiverConfig(mode="usb", frames_per_block=128)
    p, _ = rx.init(cfg, "cpu")
    assert rx.rational_tail(cfg, p)
    key = rx.graph_key(cfg, p)
    moved = rx.ratio_params(p, cfg.output_rate / 48000.0 * 1.00005)
    assert not rx.rational_tail(cfg, moved)
    assert rx.graph_key(cfg, moved) != key
    assert rx.graph_key(cfg, rx.tune_params(cfg, p, 12_345.0)) == key
    assert rx.graph_key(cfg, rx.volume_params(p, 40)) == key
    assert rx.graph_key(cfg, p._replace(agc=p.agc._replace(
        knee=np.float32(-4.0)))) != key
    dev = rx.device_params(cfg, moved, "cpu")
    assert isinstance(dev.resamp.dt_hi, torch.Tensor)
    assert isinstance(dev.dec.phase_inc, torch.Tensor)
    assert not resampler.rational_route(
        dev.resamp, (125, 96), 131072, cfg.audio_block_cap, 28)
    again = rx.ratio_params(moved, cfg.output_rate / 48000.0 * 1.0002)
    again = rx.volume_params(rx.tune_params(cfg, again, 999.0), 33)
    assert rx.graph_key(cfg, again) == rx.graph_key(cfg, moved)
    rx._update_params(dev, moved, again)
    assert float(dev.resamp.dt_lo) == float(again.resamp.dt_lo)
    assert float(dev.audio_gain) == again.audio_gain
    assert int(dev.dec.phase_inc) == again.dec.phase_inc
    assert dev.chan_filter.h_freq is not p.chan_filter.h_freq   # its own


def test_output_clones_and_state_copies():
    """The outputs a replay returns are fresh tensors of the same dtypes,
    shapes and bits (complex, int32, float32, None kept); a state copy
    whose source shares a buffer of the destination reads it before it is
    overwritten."""
    out = rx.StepOutput(audio=torch.arange(6, dtype=torch.float32).view(
        torch.complex64), n_audio=torch.tensor(3, dtype=torch.int32),
        smeter_ave_db=torch.tensor(-1.5), smeter_peak_db=torch.tensor(2.0),
        probes=None)
    back = stepgraph.clone(out)
    assert type(back) is rx.StepOutput and back.probes is None
    assert all(_bits_equal(a, b) and a.data_ptr() != b.data_ptr()
               for a, b in zip(out[:4], back[:4]))
    dst = (torch.arange(4.0), torch.arange(4.0) + 10)
    src = (dst[1], dst[0])                   # a swap
    stepgraph._copy_into(dst, src)
    assert dst[0].tolist() == [10, 11, 12, 13] and dst[1].tolist() == [
        0, 1, 2, 3]


def _out_tree(kind: str):
    out = rx.StepOutput(audio=torch.arange(6, dtype=torch.float32),
                        n_audio=torch.tensor(3, dtype=torch.int32),
                        smeter_ave_db=torch.tensor(-1.5),
                        smeter_peak_db=torch.tensor(2.0), probes=None)
    if kind == "probes":
        return out._replace(probes={"p6": torch.ones(2, 3).t(),
                                    "taps": {"tier": torch.tensor(1),
                                             "on": torch.tensor(True),
                                             "rate": 48000.0}})
    if kind == "tuple":
        stereo = torch.arange(10, dtype=torch.float32).view(torch.complex64)
        return (stereo[::2], stereo.real, None, (torch.ones(0),))
    if kind == "tensor":
        return torch.arange(4.0)
    return out


@pytest.mark.parametrize("kind", ["step_output", "probes", "tuple",
                                  "tensor"])
def test_packed_outputs_rebuild_the_tree(kind):
    """A replay's outputs come back as the captured tree built anew over
    one clone of the packed buffer (``Packed``, ``unflatten`` walked once
    at the capture): the same types, keys, dtypes, shapes and bits, dense,
    in memory of their own, the non-tensor leaves kept; the static tree
    lies in the buffer, each tensor at an ``ALIGN``-byte offset."""
    out = _out_tree(kind)
    packed = stepgraph.Packed(out, torch.device("cpu"))
    base = packed.buf.data_ptr()
    first, second = packed.fresh(), packed.fresh()
    walked = list(stepgraph.walk(out))
    for tree in (packed.static, first, second):
        again = list(stepgraph.walk(tree))
        assert type(tree) is type(out)
        assert [p for p, _ in walked] == [p for p, _ in again]
        for (_, a), (_, b) in zip(walked, again):
            if isinstance(a, torch.Tensor):
                assert _bits_equal(a.contiguous(), b) and b.is_contiguous()
            else:
                assert a is b
    static = stepgraph.tensors(packed.static)
    assert all(t.untyped_storage().data_ptr() == base
               and (t.data_ptr() - base) % stepgraph.ALIGN == 0
               for t in static)
    ptrs = [{t.untyped_storage().data_ptr() for t in stepgraph.tensors(x)}
            for x in (first, second)]
    assert all(len(p) == 1 and base not in p for p in ptrs)
    assert ptrs[0] != ptrs[1]


@pytest.mark.parametrize("mine,theirs,here", [
    ("cpu", "cpu", True), ("cuda", "cpu", False), ("cuda:1", "cuda:1", True),
    ("cuda:0", "cuda:1", False), ("cpu", "cuda:0", False)])
def test_input_already_on_the_device_passes_as_is(mine, theirs, here):
    """An entry's input already where ``.to(device)`` would put it is
    taken as it is (the same tensor, as ``.to`` returns it), anything else
    goes through ``.to``; the device test needs no card where the
    entry's device has an index or the types differ."""
    g = object.__new__(rx.GraphedStepper)
    g.device = torch.device(mine)
    assert g._here(torch.device(theirs)) == here
    if mine == "cpu":
        x = torch.arange(4, dtype=torch.int16)
        assert g._to_device(x) is x and g._to_device(x, torch.int16) is x
        cast = g._to_device(x, torch.float32)
        assert cast.dtype == torch.float32 and torch.equal(cast, x.float())
        assert g._to_device(np.arange(3)).device == torch.device("cpu")


def test_device_counts_and_lookback():
    """Counts kept in a device slot: added by index without a read,
    summed with the assigned value, reset by assignment, put back by
    ``uncounted``; the look-back memory zeroes a call's words and ticket
    at each claim."""
    c = kernels.DeviceCounts("a", "b")
    c.add(torch.tensor(1, dtype=torch.int32))
    c.counter("cpu", "a").add_(2)
    assert dict(c) == {"a": 2, "b": 1}
    c["a"] = 5
    assert c["a"] == 5 and c["b"] == 1
    launches = dict(kernels.LAUNCHES)
    with kernels.uncounted(c):
        c.add(torch.tensor(0))
        kernels.LAUNCHES["mixdec"] += 7
    assert dict(c) == {"a": 5, "b": 1} and kernels.LAUNCHES == launches
    c.update(dict.fromkeys(c, 0))
    assert c == {"a": 0, "b": 0}
    lb = scan.Lookback(torch.device("cpu"))
    lb.claim(5)
    lb.words.fill_(9)
    lb.claim(3)
    assert lb.words[:4].tolist() == [0, 0, 0, 0] and lb.words[4] == 9
    lb.claim(40)
    assert lb.slots >= 40 and lb.words[:41].eq(0).all()


def test_failed_capture_raises(monkeypatch):
    """Where the rule says graph and the capture fails (here: no CUDA on
    this machine), ``process`` raises; nothing runs the eager step in its
    place."""
    monkeypatch.setattr(rx, "graph_rule", lambda cfg, device: True)
    calls = []
    step = rx.receiver_step_planes
    monkeypatch.setattr(rx, "receiver_step_planes",
                        lambda *a: calls.append(1) or step(*a))
    cfg = rx.ReceiverConfig(mode="usb", frames_per_block=1)
    r = rx.Receiver(cfg, "cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        r.process(np.zeros(cfg.block_size, np.complex64))
    assert len(calls) == 1            # the warm-up, before the capture
    assert r._graph is None
