"""The PyTorch port's receiver on the CPU: the golden and reference-binary
fixtures at their pinned bounds (SSB/CW, AM, SAM mono and stereo, FM),
parity with the JAX Receiver, the live setters, and carrying a JAX stream
into the port."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesdr_tpu.pipeline import receiver as jrx
from cutesdr_tpu.testbench.generators import GenConfig, SignalGenerator
from cutesdr_tpu_torch import convert, kernels
from cutesdr_tpu_torch.demod import fm as tfm
from cutesdr_tpu_torch.demod import sam as tsam
from cutesdr_tpu_torch.ops import agc
from cutesdr_tpu_torch.pipeline import receiver as trx

torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
SLICE = ("usb", "lsb", "cwu", "usb2m", "am", "sam", "fm")
HEAD = 4096     # audio samples of a first block left out of the parity SNR


def _snr_db(want, got, skip):
    n = min(len(want), len(got))
    err = got[skip:n] - want[skip:n]
    return 10 * np.log10(np.mean(want[skip:n] ** 2)
                         / max(np.mean(err ** 2), 1e-30))


@pytest.mark.parametrize("kind", ["golden", "refgold"])
@pytest.mark.parametrize("name", SLICE)
def test_fixture_through_port(name, kind):
    """Driven as tests/test_golden_fixtures.py and
    tests/test_refgold_fixtures.py drive the JAX receiver."""
    gold = np.load(os.path.join(FIXDIR, f"golden_{name}.npz"))
    meta = json.loads(str(gold["meta"]))
    cfg = trx.ReceiverConfig(input_rate=meta["input_rate"], mode=meta["mode"],
                             tune_freq=meta["tune_freq"],
                             cw_offset=meta["cw_offset"], audio_rate=None,
                             agc_on=True, agc_thresh_db=-90.0)
    rx = trx.Receiver(cfg, "cpu")
    got = []
    for b in range(meta["n_blocks"]):
        sl = slice(b * cfg.block_size, (b + 1) * cfg.block_size)
        out = rx.process(gold["iq_re"][sl] + 1j * gold["iq_im"][sl])
        got.append(out.audio.double().numpy())
    got = np.concatenate(got)
    if kind == "golden":
        assert got.shape == gold["audio"].shape
        snr = _snr_db(gold["audio"], got, int(meta["skip"]))
        assert snr > meta["min_snr_db"], snr
    else:
        ref = np.load(os.path.join(FIXDIR, f"refgold_{name}.npz"))
        rmeta = json.loads(str(ref["meta"]))
        snr = _snr_db(ref["audio"], got, rmeta["skip"])
        assert snr > rmeta["min_snr_prod_db"], snr


def test_stereo_sam_fixture_through_port():
    """Driven as tests/test_refgold_fixtures.py drives the JAX receiver:
    complex audio (left = real, right = imag) against the reference
    binary's stereo output at the pinned bound."""
    d = np.load(os.path.join(FIXDIR, "refgold_sam_stereo.npz"))
    meta = json.loads(str(d["meta"]))
    cfg = trx.ReceiverConfig(input_rate=meta["input_rate"], mode="sam",
                             tune_freq=meta["tune_freq"], audio_rate=None,
                             stereo=True, agc_on=True, agc_thresh_db=-90.0)
    rx = trx.Receiver(cfg, "cpu")
    got = []
    for b in range(meta["n_blocks"]):
        sl = slice(b * cfg.block_size, (b + 1) * cfg.block_size)
        a = rx.process(d["iq_re"][sl] + 1j * d["iq_im"][sl]).audio
        assert a.dtype == torch.complex64
        got.append(torch.stack([a.real, a.imag], -1).double().numpy())
    got = np.concatenate(got)
    assert _snr_db(d["audio"], got, meta["skip"]) > meta["min_snr_prod_db"]


def _blocks(cfg, n_blocks, seed=7, power_db=-30.0, offset_hz=1000.0):
    """An in-band tone at tune + offset plus -90 dBFS noise."""
    gen = SignalGenerator(GenConfig(
        sample_rate=cfg.input_rate, sweep_start_hz=cfg.tune_freq + offset_hz,
        signal_power_db=power_db, noise_power_db=-90.0, seed=seed))
    return [gen.next_block(cfg.block_size).astype(np.complex64)
            for _ in range(n_blocks)]


def _match(jout, tout, min_snr=90.0, skip=0):
    """Equal n_audio, S-meter within 0.01 dB, audio SNR from ``skip`` on;
    returns the two audio series."""
    n = int(jout.n_audio)
    assert int(tout.n_audio) == n
    want = np.asarray(jout.audio)[:n].astype(np.float64)
    got = tout.audio[:n].double().numpy()
    assert _snr_db(want, got, skip) >= min_snr
    assert abs(float(tout.smeter_ave_db) - float(jout.smeter_ave_db)) < 0.01
    assert abs(float(tout.smeter_peak_db)
               - float(jout.smeter_peak_db)) < 0.01
    return want, got


def test_port_matches_jax_receiver_rational_path():
    """frames_per_block=128: 131,072 demodulated samples per block, so the
    exact-rational resampler and the scan kernels' paths (n >= 65536) are
    taken — on the CPU through their plain versions."""
    kw = dict(input_rate=2_000_000.0, mode="usb", tune_freq=100_000.0,
              frames_per_block=128)
    jr = jrx.Receiver(jrx.ReceiverConfig(**kw))
    tr = trx.Receiver(trx.ReceiverConfig(**kw), "cpu")
    kernels.reset_launches()
    for x in _blocks(tr.cfg, 2):
        _match(jr.process(jnp.asarray(x)), tr.process(x))
    assert not any(kernels.LAUNCHES.values())     # CPU: plain versions only


def _modulated(cfg, n_blocks, seed, noise=True):
    """The mode's own stimulus at -30 dBFS, with -90 dBFS noise if
    ``noise``, phase continuous across blocks: AM and SAM a carrier at
    tune + 20 Hz with 400 Hz AM at 50 % depth, FM a 1 kHz tone at +-3 kHz
    deviation."""
    rng = np.random.default_rng(seed)
    amp = 32767.0 * 10 ** (-30 / 20)
    noise_amp = 32767.0 * 10 ** (-90 / 20) if noise else 0.0
    out = []
    for b in range(n_blocks):
        t = (np.arange(cfg.block_size) + b * cfg.block_size) / cfg.input_rate
        if cfg.mode == "fm":
            sig = amp * np.exp(1j * (2 * np.pi * cfg.tune_freq * t
                                     + 3.0 * np.sin(2 * np.pi * 1e3 * t)))
        else:
            env = 1.0 + 0.5 * np.cos(2 * np.pi * 400.0 * t)
            sig = amp * env * np.exp(2j * np.pi * (cfg.tune_freq + 20.0) * t)
        sig += noise_amp * _cnoise(rng, cfg.block_size)
        out.append(sig.astype(np.complex64))
    return out


def _cnoise(rng, n):
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


@pytest.mark.parametrize("mode", ["am", "sam", "fm"])
def test_port_matches_jax_receiver_demods(mode):
    """131,072 demodulated samples per block (frames_per_block=128 at
    250 kSPS), so the rational resampler and the scan kernels' paths are
    taken, on the CPU through their plain versions.  Two chained blocks:
    the first acquires (SAM through the sequential loop, FM through the
    chunked tier), the second runs locked (the linear tier), as in JAX.
    The stimulus is noise-free, so that the AGC's guess-verify converges
    and the test stays short (with -90 dBFS noise the FM chain's second
    block takes the AGC's per-sample fallback, in both packages).

    The first block's first HEAD = 4,096 audio samples are left out of
    the SNR.  They hold the resampler's delay (~512 zeros), the channel
    filter's fill ((ntaps - 1) = 1,024 demodulated samples: 786 audio
    samples for FM, 1,573 for AM and SAM), where the PLL acquires on a
    near-silent transient and the FMA rounding of JAX's loop against the
    port's flips a phase wrap now and then, and, for FM, the decay of
    that difference through the DC tracker and the de-emphasis (about
    9 dB per 512 samples, 90 dB by ~3,600).  FM reads 32 dB with them,
    118.9 dB without.  Two checks keep the head honest: each block takes
    the same PLL tier as JAX's (its ``pll_tier`` probe), and the next HEAD
    samples alone already reach 90 dB, so the difference is confined to
    the head.  The lowest is SAM's 92.1 dB, set by the float32 DC block,
    whose output y = z0[n] - z0[n-1] cancels two values near
    |x|/(1 - 0.99) that the two packages round differently."""
    kw = dict(input_rate=250_000.0, mode=mode, tune_freq=60_000.0,
              frames_per_block=128)
    jr = jrx.Receiver(jrx.ReceiverConfig(**kw, probes=True))
    tr = trx.Receiver(trx.ReceiverConfig(**kw), "cpu")
    assert tr.cfg.fastfir_valid * tr.cfg.frames_per_block == 131_072
    demod = {"fm": tfm, "sam": tsam}.get(mode)
    for b, x in enumerate(_modulated(tr.cfg, 2, seed=8, noise=False)):
        before = dict(demod.STATS) if demod else {}
        jout, tout = jr.process(jnp.asarray(x)), tr.process(x)
        if demod:
            taken = [k for k, v in demod.STATS.items() if v != before[k]]
            assert taken == [demod.TIER_NAMES[int(jout.probes["pll_tier"])]]
        want, got = _match(jout, tout, skip=HEAD if b == 0 else 0)
        if b == 0:
            assert _snr_db(want[:2 * HEAD], got[:2 * HEAD], HEAD) >= 90.0


def test_live_setters_match_jax_receiver():
    """Tune, filter, AGC, volume, DC cal and resample-ratio updates between
    blocks (banded resampler path), and int16 wire planes.  The JAX side
    runs its Pallas mixdec (interpreted): like the port it carries the raw
    input tail, so a retune or a new DC cal re-mixes the history the same
    way (the fused XLA path keeps the already-mixed history)."""
    kw = dict(input_rate=250_000.0, mode="cwu", tune_freq=60_000.0,
              cw_offset=600.0, frames_per_block=2)
    jr = jrx.Receiver(jrx.ReceiverConfig(**kw, decimator_impl="pallas",
                                         pallas_interpret=True))
    tr = trx.Receiver(trx.ReceiverConfig(**kw), "cpu")
    blocks = _blocks(tr.cfg, 3, seed=9, power_db=-50.0, offset_hz=100.0)
    setters = [
        lambda r: None,
        lambda r: (r.set_tune_freq(60_150.0), r.set_filter(-300.0, 200.0),
                   r.set_agc(thresh_db=-80.0, decay_ms=300.0),
                   r.set_volume(80), r.set_dc_offset(3.0, -2.0),
                   r.set_resample_ratio(15_625.0 / 48_000.0 * 1.001)),
        lambda r: r.set_agc(),
    ]
    for x, setter in zip(blocks, setters):
        setter(jr)
        setter(tr)
        qr, qi = (np.round(p).astype(np.int16) for p in (x.real, x.imag))
        jout = jr.process_planes(jnp.asarray(qr), jnp.asarray(qi))
        tout = tr.process_planes(qr, qi)
        _match(jout, tout)


@pytest.mark.parametrize("layout", ["fused", "pallas"])
def test_from_jax_mid_stream(layout):
    """Convert the JAX receiver's state after block 2, then run both for
    two more blocks: the port continues the JAX stream.  'fused' is the
    JAX CPU layout (NCO carry + mixed tail), 'pallas' the TPU kernels'
    (raw tail + phase base, pre-permuted H)."""
    kw = dict(input_rate=500_000.0, mode="usb", tune_freq=20_000.0,
              frames_per_block=2)
    extra = {} if layout == "fused" else dict(
        decimator_impl="pallas", fastfir_impl="pallas", pallas_interpret=True)
    jr = jrx.Receiver(jrx.ReceiverConfig(**kw, **extra))
    jr.set_dc_offset(1.5, -0.5)
    jr.set_tune_freq(20_050.0)
    tcfg = trx.ReceiverConfig(**kw)
    blocks = _blocks(tcfg, 4, seed=11, power_db=-40.0)
    for x in blocks[:2]:
        jr.process(jnp.asarray(x))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    params, state = convert.from_jax(tcfg, to_np(jr.params), to_np(jr.state),
                                     "cpu")
    for x in blocks[2:]:
        jout = jr.process(jnp.asarray(x))
        state, tout = trx.receiver_step(tcfg, params, state, torch.from_numpy(x))
        _match(jout, tout)


@pytest.mark.parametrize("mode,stereo", [("fm", False), ("sam", True)])
def test_from_jax_mid_stream_demods(mode, stereo):
    """The demodulator's params and carry (PLL state, FIR tails, IIR and
    DC states, squelch flag, de-emphasis) and a complex stereo resampler
    tail carried across after block 2: the port continues the JAX stream."""
    kw = dict(input_rate=250_000.0, mode=mode, tune_freq=60_000.0,
              frames_per_block=2, stereo=stereo)
    jr = jrx.Receiver(jrx.ReceiverConfig(**kw))
    tcfg = trx.ReceiverConfig(**kw)
    blocks = _modulated(tcfg, 4, seed=12)
    for x in blocks[:2]:
        jr.process(jnp.asarray(x))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    params, state = convert.from_jax(tcfg, to_np(jr.params), to_np(jr.state),
                                     "cpu")
    assert state.resamp.tail.is_complex() == stereo
    for x in blocks[2:]:
        jout = jr.process(jnp.asarray(x))
        state, tout = trx.receiver_step(tcfg, params, state,
                                        torch.from_numpy(x))
        if stereo:
            for part in ("real", "imag"):
                _match(jout._replace(audio=getattr(np.asarray(jout.audio),
                                                   part)),
                       tout._replace(audio=getattr(tout.audio, part)))
        else:
            _match(jout, tout)


def test_port_matches_jax_receiver_hang_agc():
    """Hang-mode AGC through the whole USB receiver, three chained blocks
    against the JAX Receiver: a keyed carrier (on 60 % of each block) so
    the decay averager rises, holds through the gaps and releases."""
    kw = dict(input_rate=250_000.0, mode="usb", tune_freq=60_000.0,
              frames_per_block=4, agc_hang=True, agc_decay_ms=20.0)
    jr = jrx.Receiver(jrx.ReceiverConfig(**kw))
    tr = trx.Receiver(trx.ReceiverConfig(**kw), "cpu")
    assert tr.params.agc == type(tr.params.agc)(*(
        np.asarray(v).item() for v in jr.params.agc))
    n = tr.cfg.block_size
    key = (np.arange(n) % (n // 2)) < 0.6 * (n // 2)
    before = agc.STATS["scan_fallbacks"]
    for b, x in enumerate(_blocks(tr.cfg, 3, seed=13, power_db=-40.0)):
        x = np.where(key, x, x * np.float32(1e-3)).astype(np.complex64)
        jout, tout = jr.process(jnp.asarray(x)), tr.process(x)
        _match(jout, tout)
        assert int(tr.state.agc.hang_timer) == int(jr.state.agc.hang_timer)
    assert agc.STATS["scan_fallbacks"] == before


def test_config_geometry_matches_jax():
    assert set(trx.PORTED_MODES) == set(jrx.MODE_LIMITS)
    for kw in (dict(), dict(mode="lsb", input_rate=250_000.0),
               dict(mode="am"), dict(mode="fm", frames_per_block=256),
               dict(mode="sam", stereo=True),
               dict(mode="cwl", input_rate=20_000_000.0, frames_per_block=4),
               dict(audio_rate=None, frames_per_block=256)):
        j, t = jrx.ReceiverConfig(**kw), trx.ReceiverConfig(**kw)
        assert dataclasses.astuple(t.plan) == dataclasses.astuple(j.plan)
        np.testing.assert_array_equal(t.plan.composed_taps(),
                                      j.plan.composed_taps())
        assert (t.block_size, t.output_rate, t.audio_block_cap,
                t.low_cut, t.hi_cut, t.mode_id) == \
            (j.block_size, j.output_rate, j.audio_block_cap,
             j.low_cut, j.hi_cut, j.mode_id)
    assert agc.STATS["scan_fallbacks"] >= 0
