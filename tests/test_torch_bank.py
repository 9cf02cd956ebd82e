"""The PyTorch port's channel bank on the CPU against the JAX package: the
batched channel filter (K6) and mixdec plain forms, the bank AGC (frozen
channels, the bank-wide fallback vote, hang mode), the FM and SAM bank
tier votes, ``ChannelBank`` / ``StackedReceiver`` end to end, and carrying
a JAX bank into the port.  Inputs are made with numpy from a seed and fed
to both packages; each test states its tolerance."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesdr_tpu.demod import fm as j_fm
from cutesdr_tpu.demod import sam as j_sam
from cutesdr_tpu.design.decimation_plan import plan_decimation
from cutesdr_tpu.kernels.fastfir4 import FastFir4Params, FastFirFourStep
from cutesdr_tpu.ops import agc as j_agc
from cutesdr_tpu.pipeline import receiver as jrx
from cutesdr_tpu.shard import channels as j_ch
from cutesdr_tpu_torch import convert, kernels
from cutesdr_tpu_torch.demod import fm as t_fm
from cutesdr_tpu_torch.demod import sam as t_sam
from cutesdr_tpu_torch.kernels import fastfir, mixdec
from cutesdr_tpu_torch.kernels import scan as t_scan
from cutesdr_tpu_torch.ops import agc as t_agc
from cutesdr_tpu_torch.ops import fastfir as ff_ops
from cutesdr_tpu_torch.pipeline import receiver as trx
from cutesdr_tpu_torch.shard import channels as t_ch

torch.set_num_threads(1)

HEAD = 4096     # audio samples of the first blocks left out of the SNR


def _cplx(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bcast(tree, n):
    """A JAX bank's params: every leaf with a leading channel axis."""
    return jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(jnp.asarray(a), (n,) + jnp.shape(a)), tree)


def _snr_db(want, got):
    err = got - want
    return 10 * np.log10(np.sum(np.abs(want) ** 2)
                         / max(np.sum(np.abs(err) ** 2), 1e-30))


# ---------------------------------------------------------------- kernels --

def test_fastfir_batch_plain_matches_pallas():
    """K6's plain form (the batched torch.fft overlap-save) against the
    JAX grid-batched kernel in interpret mode, three channels with
    distinct H, two chained calls: within 5e-5 of the output scale (K2's
    tolerance), tails equal."""
    rng = np.random.default_rng(40)
    fs = 62_500.0
    edges = [(100.0 * (i + 1), 2800.0 - 300.0 * i) for i in range(3)]
    ks = [FastFirFourStep(lo, hi, 0.0, fs, interpret=True)
          for lo, hi in edges]
    jparams = FastFir4Params(h2=jnp.stack([k.params.h2 for k in ks]))
    jc = jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                *[k.init_carry() for k in ks])
    tp = ff_ops.FastFirParams(h_freq=torch.stack(
        [ff_ops.init(lo, hi, 0.0, fs, "cpu")[0].h_freq for lo, hi in edges]))
    tc = ff_ops.FastFirCarry(tail=torch.zeros(3, 1024, dtype=torch.complex64))
    kernels.reset_launches()
    for _ in range(2):
        x = _cplx(rng, (3, 2048), 50.0)
        jc, jy = ks[0].batch_call(jparams, jc, jnp.asarray(x))
        tc, ty = fastfir.batch_call(tp, tc, _t(x))
        want = np.asarray(jy)
        np.testing.assert_allclose(ty.numpy(), want,
                                   atol=5e-5 * np.abs(want).max())
        np.testing.assert_array_equal(tc.tail.numpy(), np.asarray(jc.tail))
    assert not any(kernels.LAUNCHES.values())       # CPU: plain version


@pytest.mark.parametrize("shared", [True, False])
def test_mixdec_batch_plain_matches_per_channel(shared):
    """The batched mixdec plain form (per-channel increment, phase, raw
    tail and DC cal; one shared block or one row per channel) against
    single-stream plain calls channel by channel, over two chained blocks
    and a phase wrap: within 1e-6 of the output scale (the batched and
    per-row convolutions may sum in another order), carries equal."""
    rng = np.random.default_rng(41)
    plan = plan_decimation(2e6, 20_000.0)
    tunes = [123_456.7, -400_000.0, 610_000.0]
    singles = [mixdec.init(plan, f, "cpu") for f in tunes]
    singles = [(p, c._replace(phase=torch.tensor(2**32 - 1000 * (i + 1)),
                              raw_tail=_t(_cplx(rng, c.raw_tail.shape, 50.))))
               for i, (p, c) in enumerate(singles)]
    dcs = [complex(0.3 * i, -0.2 * i) for i in range(3)]
    bp = singles[0][0]._replace(
        phase_inc=torch.tensor([p.phase_inc for p, _ in singles]))
    bc = t_ch.stack_state([c for _, c in singles])
    bdc = torch.tensor(dcs, dtype=torch.complex64)
    for _ in range(2):
        x = _cplx(rng, (plan.decimation * 96,) if shared
                  else (3, plan.decimation * 96), 100.0)
        xt = _t(x)
        bc, by = mixdec.process_planes(plan, bp, bc, xt.real, xt.imag, bdc)
        for i, (p, c) in enumerate(singles):
            xi = xt if shared else xt[i]
            c, y = mixdec.process_planes(plan, p, c, xi.real, xi.imag,
                                         torch.tensor(dcs[i]))
            singles[i] = (p, c)
            scale = float(y.abs().max())
            assert float((by[i] - y).abs().max()) <= 1e-6 * scale
            assert torch.equal(bc.raw_tail[i], c.raw_tail)
            assert int(bc.phase[i]) == int(c.phase)


# -------------------------------------------------------------------- AGC --

def _agc_pair(hang, n_ch):
    fs = 31_250.0
    jcfg = j_agc.AgcConfig(True, hang, fs)
    tcfg = t_agc.AgcConfig(True, hang, fs)
    args = (-100.0, 30.0, 0.0, 200.0)
    jp, tp = j_agc.make_params(jcfg, *args), t_agc.make_params(tcfg, *args)
    for f in tp._fields:
        assert getattr(tp, f) == np.asarray(getattr(jp, f)), f
    jc = j_agc.init_carry(jcfg, complex_input=True)
    tc = t_agc.init_carry(tcfg, "cpu")
    return (jcfg, jp, jc), (tcfg, tp, tc)


def _envelopes(rng, n_ch, n, start):
    """Channel 0 a steady tone; the others keyed on and off at their own
    rates (choppy envelopes that take more guess-verify rounds)."""
    k = np.arange(n) + start
    amp = np.ones((n_ch, n))
    for c in range(1, n_ch):
        amp[c] = np.where((k // (97 * c + 50)) % 2 == 0, 1.0, 0.01)
    tone = np.exp(2j * np.pi * 0.01 * k)
    return (300.0 * amp * tone + _cplx(rng, (n_ch, n), 0.3)).astype(
        np.complex64)


def _agc_blocks(hang, blocks, count_rounds=False):
    """The port's process_batch against JAX's and against its own single
    stream channel by channel.  Returns the per-channel guess-verify
    rounds of the single streams' first block if ``count_rounds``."""
    n_ch = blocks[0].shape[0]
    (jcfg, jp, jc), (tcfg, tp, tc) = _agc_pair(hang, n_ch)
    jpb, jcb = _bcast(jp, n_ch), _bcast(jc, n_ch)
    tcb = t_ch.stack_state([tc] * n_ch)
    singles = [tc] * n_ch
    j_batch = jax.jit(lambda p, c, x: j_agc.process_batch(jcfg, p, c, x))
    rounds = []
    for b, x in enumerate(blocks):
        jcb, jy = j_batch(jpb, jcb, jnp.asarray(x))
        tcb, ty = t_agc.process_batch(tcfg, tp, tcb, _t(x))
        want = np.asarray(jy)
        # float32 prefix trees that associate differently, through the
        # gain law's 10^x: 1e-4 of the output scale
        np.testing.assert_allclose(ty.numpy(), want,
                                   atol=1e-4 * np.abs(want).max())
        np.testing.assert_allclose(tcb.attack_ave.numpy(),
                                   np.asarray(jcb.attack_ave), atol=1e-4)
        np.testing.assert_allclose(tcb.decay_ave.numpy(),
                                   np.asarray(jcb.decay_ave), atol=1e-4)
        np.testing.assert_array_equal(tcb.hang_timer.numpy(),
                                      np.asarray(jcb.hang_timer))
        for c in range(n_ch):
            calls = []
            if count_rounds and b == 0:
                real = t_scan.guess_round_plain
                t_scan.guess_round_plain = \
                    lambda *a: calls.append(1) or real(*a)
            try:
                singles[c], y = t_agc.process(tcfg, tp, singles[c],
                                              _t(x[c]))
            finally:
                if calls:
                    t_scan.guess_round_plain = real
            rounds.append(len(calls))
            # a frozen channel's result is its own single-stream solve
            assert torch.equal(ty[c], y), (b, c)
            assert torch.equal(tcb.hang_timer[c], singles[c].hang_timer)
    return rounds


def test_agc_batch_freezes_converged_channels():
    """Channels that converge in different rounds: each channel of the
    bank equals, bitwise, its own single-stream solve (a converged channel
    is not run again), and the bank is within 1e-4 of JAX's vmapped
    process_batch."""
    rng = np.random.default_rng(42)
    blocks = [_envelopes(rng, 3, 2048, b * 2048) for b in range(2)]
    before = t_agc.STATS["scan_fallbacks"]
    rounds = _agc_blocks(False, blocks, count_rounds=True)
    assert len(set(rounds[:3])) > 1, rounds       # different round counts
    assert t_agc.STATS["scan_fallbacks"] == before


def test_agc_batch_fallback_is_voted_bank_wide(monkeypatch):
    """With one guess-verify round allowed, channels 0 and 1 cannot
    converge: the whole bank, channel 2 included (which converges alone),
    takes the per-sample loop (one fallback for the bank), as JAX's
    bank-wide vote does; within 1e-4 of JAX."""
    monkeypatch.setattr(t_agc, "GUESS_ITERS", 1)
    monkeypatch.setattr(j_agc, "GUESS_ITERS", 1)
    rng = np.random.default_rng(43)
    x = _envelopes(rng, 3, 2048, 0)
    (jcfg, jp, jc), (tcfg, tp, tc) = _agc_pair(False, 3)
    before = t_agc.STATS["scan_fallbacks"]
    tcb, ty = t_agc.process_batch(tcfg, tp, t_ch.stack_state([tc] * 3),
                                  _t(x))
    assert t_agc.STATS["scan_fallbacks"] == before + 1
    jcb, jy = jax.jit(lambda p, c, x: j_agc.process_batch(jcfg, p, c, x))(
        _bcast(jp, 3), _bcast(jc, 3), jnp.asarray(x))
    want = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), want,
                               atol=1e-4 * np.abs(want).max())
    oks = [t_agc._averager_parallel(
        tcfg, tp, tc, t_agc._prefix(tcfg, tc, _t(x[c]))[2])[1]
        for c in range(3)]
    assert oks == [False, False, True]


def test_agc_hang_batch_and_single_match_jax():
    """Hang mode: the bank against JAX's process_batch and each channel
    against its single stream (bitwise), over three blocks; then the
    single stream at 65,536 samples (the K3 scan kernel's gate: its plain
    version on the CPU) against JAX's process, within 1e-4."""
    rng = np.random.default_rng(44)
    _agc_blocks(True, [_envelopes(rng, 2, 2048, b * 2048) for b in range(3)])
    (jcfg, jp, jc), (tcfg, tp, tc) = _agc_pair(True, 1)
    x = _envelopes(rng, 2, 65536, 0)[1]
    assert x.shape[-1] >= t_scan.MIN_KERNEL_N
    jc, jy = jax.jit(lambda c, x: j_agc.process(jcfg, jp, c, x))(
        jc, jnp.asarray(x))
    tc, ty = t_agc.process(tcfg, tp, tc, _t(x))
    want = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), want,
                               atol=1e-4 * np.abs(want).max())
    assert int(tc.hang_timer) == int(jc.hang_timer)


# ---------------------------------------------------------------- FM, SAM --

FS = 62_500.0


def _pll_bank(mode, kind, n, rng, start):
    """Three channels: locked carriers (FM: 150 Hz off, frequency-modulated
    by a tone of its own; SAM: 50 % AM on a carrier 20*c Hz off); for
    ``kind == 'mixed'`` channel 2 is noise, for 'noise' every channel."""
    t = (np.arange(n) + start) / FS
    rows = []
    for c in range(3):
        if kind == "noise" or (kind == "mixed" and c == 2):
            rows.append(_cplx(rng, n, 3000.0))
        elif mode == "fm":
            ph = 2 * np.pi * 150.0 * t + 0.3 * c \
                + 0.5 * c * np.sin(2 * np.pi * (200.0 + 100.0 * c) * t)
            rows.append((3000.0 * np.exp(1j * ph)).astype(np.complex64))
        else:
            env = 1.0 + 0.5 * np.cos(2 * np.pi * 400.0 * t)
            rows.append((2000.0 * env * np.exp(1j * (2 * np.pi * 20.0 * c * t
                                                     + 0.3))).astype(
                np.complex64))
    return np.stack(rows)


@functools.cache
def _flags(tier_fn):
    """A JAX tier's vmapped validity flags, jitted once per tier."""
    return jax.jit(lambda p, c, th: jax.vmap(tier_fn)(p, c, th)[0])


def _jax_vote(jm, jp, jc, x):
    """The tier JAX's process_batch takes, recomputed from its vmapped
    tiers' validity flags."""
    theta = jnp.arctan2(x.imag, x.real)
    if bool(jnp.all(_flags(jm._pll_linear)(jp, jc, theta))):
        return "linear"
    if jm is j_fm and j_fm._chunkable(x.shape[-1]) and bool(jnp.all(
            _flags(j_fm._pll_chunked)(jp, jc, theta))):
        return "chunked"
    return "scan"


PLL_CASES = [
    # mode, bank, block length, stereo, tier of both blocks.  A mixed FM
    # bank of chunkable blocks takes the scan too: the locked channels
    # fail the chunked tier's bitwise check (a clean loop converges only
    # asymptotically), the noise channel the linear one.
    ("fm", "locked", 2048, False, "linear"),
    ("fm", "noise", 2048, True, "chunked"),
    ("fm", "mixed", 1000, False, "scan"),
    ("sam", "locked", 2048, True, "linear"),
    ("sam", "mixed", 2048, False, "scan"),
]


@pytest.mark.parametrize("mode,kind,n,stereo,tier", PLL_CASES)
def test_pll_bank_vote_matches_jax(mode, kind, n, stereo, tier):
    """process_batch(_stereo) of a 3-channel bank over two chained blocks:
    the tier in STATS is JAX's bank vote.  FM audio within 2e-5 of the
    largest audio of its channel so far: FMA rounding in the loops, the
    two FFT libraries, and the DC tracker's float32 state, whose roundoff
    stays at the scale of the carrier's offset while the audio falls as
    the DC is removed.  SAM within 1e-6 of the DC block's state scale;
    PLL states within 1e-5 rad and 1e-6 rad/sample.  In a mixed bank the
    locked channels take the fallback tier with the noise channel."""
    rng = np.random.default_rng(45 + n)
    jm, tm = (j_fm, t_fm) if mode == "fm" else (j_sam, t_sam)
    jp, jc = jm.init(FS)
    tp, tc = tm.init(FS, "cpu")
    jp, jc = _bcast(jp, 3), _bcast(jc, 3)
    tc = t_ch.stack_state([tc] * 3)
    j_step = jax.jit(jm.process_batch_stereo if stereo else jm.process_batch)
    t_step = tm.process_batch_stereo if stereo else tm.process_batch
    scale = np.full((3, 1), 1e-30)
    for b in range(2):
        x = _pll_bank(mode, kind, n, rng, b * n)
        want_tier = _jax_vote(jm, jp, jc, jnp.asarray(x))
        before = dict(tm.STATS)
        jc, jy = j_step(jp, jc, jnp.asarray(x))
        tc, ty = t_step(tp, tc, _t(x))
        taken = [k for k, v in tm.STATS.items() if v != before[k]]
        assert taken == [want_tier] == [tier], (b, taken, want_tier)
        jy = np.asarray(jy)
        if stereo:
            assert ty.dtype == torch.complex64
        if mode == "fm":
            scale = np.maximum(scale, np.abs(jy).max(-1, keepdims=True))
            assert np.all(np.abs(ty.numpy() - jy) <= 2e-5 * scale)
        else:
            dc_scale = float(np.abs(x).max()) / (1.0 - 0.99)
            assert float(np.abs(ty.numpy() - jy).max()) < 1e-6 * dc_scale
        d = np.asarray(tc.nco_phase, np.float64) - np.asarray(jc.nco_phase)
        assert float(np.abs((d + np.pi) % (2 * np.pi) - np.pi).max()) < 1e-5
        assert float(np.abs(tc.nco_freq.numpy()
                            - np.asarray(jc.nco_freq)).max()) < 1e-6


# ------------------------------------------------------- receivers, banks --

def _carriers(cfg, freqs, n_blocks, rng, offset=1000.0, noise_db=-90.0):
    """A carrier per channel at tune + ``offset`` (-30 dBFS), modulated
    for the mode (AM/SAM: 400 Hz at 50 %; FM: 1 kHz at +-3 kHz), plus
    seeded noise; phase continuous across blocks."""
    n = cfg.block_size
    amp = 32767.0 * 10 ** (-30 / 20)
    out = []
    for b in range(n_blocks):
        t = (np.arange(n) + b * n) / cfg.input_rate
        x = _cplx(rng, n, 32767.0 * 10 ** (noise_db / 20)).astype(
            np.complex128)
        for i, f in enumerate(freqs):
            ph = 2 * np.pi * (f + offset) * t + 0.7 * i
            if cfg.mode == "fm":
                x += amp * np.exp(1j * (ph + 3.0 * np.sin(2e3 * np.pi * t)))
            elif cfg.mode in ("am", "sam"):
                x += amp * (1 + 0.5 * np.cos(2 * np.pi * 400 * t)) \
                    * np.exp(1j * ph)
            else:
                x += amp * np.exp(1j * ph)
        out.append(x.astype(np.complex64))
    return out


def _match_banks(jouts, touts, skip=HEAD, min_snr=90.0):
    """n_audio equal block by block; per channel, the audio from ``skip``
    on at >= ``min_snr`` dB; S-meters within 0.01 dB."""
    want, got = [], []
    for jo, to in zip(jouts, touts):
        n = np.asarray(jo.n_audio)
        np.testing.assert_array_equal(to.n_audio.numpy(), n)
        want.append([np.asarray(jo.audio)[c, :n[c]] for c in range(len(n))])
        got.append([to.audio[c, :n[c]].numpy() for c in range(len(n))])
        np.testing.assert_allclose(to.smeter_ave_db.numpy(),
                                   np.asarray(jo.smeter_ave_db), atol=0.01)
        np.testing.assert_allclose(to.smeter_peak_db.numpy(),
                                   np.asarray(jo.smeter_peak_db), atol=0.01)
    snrs = []
    for c in range(len(want[0])):
        w = np.concatenate([blk[c] for blk in want])[skip:]
        g = np.concatenate([blk[c] for blk in got])[skip:]
        snrs.append(_snr_db(w.astype(np.complex128), g.astype(np.complex128)))
    assert min(snrs) >= min_snr, snrs
    return snrs


def _run_banks(jbank, tbank, blocks):
    kernels.reset_launches()
    jouts, touts = [], []
    for x in blocks:
        jouts.append(jbank.process(jnp.asarray(x)))
        touts.append(tbank.process(x))
    assert not any(kernels.LAUNCHES.values())       # CPU: plain versions
    return jouts, touts


def test_channel_bank_config4_usb():
    """BASELINE config 4's grid (10 MSPS USB, channels at -4.5 MHz +
    140 kHz * i), four of its 64 channels, three blocks with a tone 1 kHz
    above each channel over -60 dBFS noise: >= 90 dB per channel after the
    first block (which the AGC delay line holds at zero)."""
    kw = dict(input_rate=10e6, mode="usb")
    freqs = [-4.5e6 + 140e3 * i for i in (0, 1, 37, 63)]
    rng = np.random.default_rng(46)
    tbank = t_ch.ChannelBank(trx.ReceiverConfig(**kw), freqs, "cpu")
    blocks = _carriers(tbank.cfg, freqs, 3, rng, noise_db=-60.0)
    jouts, touts = _run_banks(j_ch.ChannelBank(jrx.ReceiverConfig(**kw),
                                               freqs), tbank, blocks)
    assert touts[0].audio.shape == (4, tbank.cfg.audio_block_cap)
    _match_banks(jouts, touts, skip=int(touts[0].n_audio[0]))


@pytest.mark.parametrize("mode,stereo", [("am", False), ("fm", False),
                                         ("sam", True)])
def test_channel_bank_demods(mode, stereo):
    """Three channels of AM, FM or stereo SAM at 250 kSPS, two frames per
    block, over five blocks: >= 90 dB per channel after the first HEAD
    audio samples (acquisition through the sequential loop or the chunked
    tier, where the FMA rounding of JAX's loop against the port's flips a
    wrap now and then; tests/test_torch_receiver.py says more)."""
    kw = dict(input_rate=250e3, mode=mode, frames_per_block=2, stereo=stereo)
    freqs = [40e3, 60e3, -30e3]
    rng = np.random.default_rng(47)
    tbank = t_ch.ChannelBank(trx.ReceiverConfig(**kw), freqs, "cpu")
    blocks = _carriers(tbank.cfg, freqs, 5, rng, offset=20.0)
    jouts, touts = _run_banks(j_ch.ChannelBank(jrx.ReceiverConfig(**kw),
                                               freqs), tbank, blocks)
    if stereo:
        assert touts[0].audio.dtype == torch.complex64
    _match_banks(jouts, touts)


def test_stacked_receiver_matches_jax():
    """Two separate 2 MSPS streams (a dual-ADC radio) through a USB
    StackedReceiver, as int16 wire planes: >= 90 dB per stream after the
    first block."""
    kw = dict(input_rate=2e6, mode="usb", frames_per_block=2)
    freqs = [100e3, -250e3]
    rng = np.random.default_rng(48)
    tst = t_ch.StackedReceiver(trx.ReceiverConfig(**kw), freqs, "cpu")
    jst = j_ch.StackedReceiver(jrx.ReceiverConfig(**kw), freqs)
    streams = [_carriers(tst.cfg, [f], 3, rng, noise_db=-70.0)
               for f in freqs]
    jouts, touts = [], []
    for b in range(3):
        x = np.stack([s[b] for s in streams])
        qr, qi = (np.round(p).astype(np.int16) for p in (x.real, x.imag))
        jouts.append(jst.process(jnp.asarray(qr.astype(np.float32)
                                             + 1j * qi.astype(np.float32))))
        touts.append(tst.process_planes(qr, qi))
    _match_banks(jouts, touts, skip=int(touts[0].n_audio[0]))


def test_from_jax_bank_mid_stream():
    """A JAX AM bank (per-channel demod FIR tails and DC states) converted
    after three blocks continues on the port for two more (>= 90 dB per
    channel); a JAX bank whose channels hold differing values in a param
    the port shares is refused."""
    kw = dict(input_rate=250e3, mode="am", frames_per_block=2)
    freqs = [40e3, -60e3]
    rng = np.random.default_rng(49)
    tcfg = trx.ReceiverConfig(**kw)
    jbank = j_ch.ChannelBank(jrx.ReceiverConfig(**kw), freqs)
    blocks = _carriers(tcfg, freqs, 5, rng, offset=20.0)
    for x in blocks[:3]:
        jbank.process(jnp.asarray(x))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    params, state = convert.from_jax_bank(tcfg, to_np(jbank.params),
                                          to_np(jbank.state), "cpu")
    assert params.dec.phase_inc.shape == (2,)
    jouts, touts = [], []
    for x in blocks[3:]:
        jouts.append(jbank.process(jnp.asarray(x)))
        state, out = trx.bank_receiver_step(tcfg, params, state, _t(x))
        touts.append(out)
    _match_banks(jouts, touts, skip=0)

    bad = to_np(jbank.params)
    bad = bad._replace(audio_gain=np.array([1.0, 0.5], np.float32))
    with pytest.raises(ValueError, match="audio_gain"):
        convert.from_jax_bank(tcfg, bad, to_np(jbank.state), "cpu")
