"""The port's probe taps on the CPU: every tap of the single receiver
(USB, USB with the noise blanker, mono SAM and FM) against the JAX
package's (a bank's taps: tests/test_torch_banksession.py), the audio with probes on against the audio
with probes off, the taps against the float64 oracle stages, the probe
instruments against the JAX package's, and the session's probe scope
against the JAX session's.  Inputs are made with numpy from a seed and
fed to both."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from cutesdr_tpu import session as js
from cutesdr_tpu.demod import fm as j_fm
from cutesdr_tpu.demod import sam as j_sam
from cutesdr_tpu.design.fastfir_design import design_fastfir
from cutesdr_tpu.ops import agc as j_agc
from cutesdr_tpu.pipeline import receiver as jrx
from cutesdr_tpu.testbench import probes as jp
from cutesdr_tpu_torch import kernels
from cutesdr_tpu_torch import session as ts
from cutesdr_tpu_torch.pipeline import receiver as trx
from cutesdr_tpu_torch.testbench import probes as tp

torch.set_num_threads(1)

FS = 250_000.0
BASE = dict(input_rate=FS, tune_freq=60_000.0, frames_per_block=2)
CONFIGS = {"usb": dict(mode="usb"), "usb_nb": dict(mode="usb", nb_on=True),
           "sam": dict(mode="sam"), "fm": dict(mode="fm")}


def _signal(mode, n, seed, start=0, impulses=True):
    """A -30 dBFS carrier 100 Hz above the tune (AM 400 Hz for SAM, FM
    1 kHz / 2 kHz deviation for FM, plain for USB), -80 dBFS noise, and
    with ``impulses`` a near full-scale impulse every 10 ms."""
    rng = np.random.default_rng(seed)
    t = (start + np.arange(n)) / FS
    amp = 32767 * 10 ** (-30 / 20)
    ph = 2 * np.pi * 60_100.0 * t
    env = amp
    if mode == "sam":
        env = amp * (1 + 0.5 * np.cos(2 * np.pi * 400.0 * t))
    elif mode == "fm":
        ph = ph + 2.0 * np.sin(2 * np.pi * 1000.0 * t)
    x = env * np.exp(1j * ph)
    x += 3.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    if impulses:
        x[(start + np.arange(n)) % 2500 == 0] += 20000.0
    return x.astype(np.complex64)


def _snr_db(want, got):
    want = np.asarray(want, np.complex128)
    err = np.asarray(got, np.complex128) - want
    return 10 * np.log10(np.sum(np.abs(want) ** 2)
                         / max(np.sum(np.abs(err) ** 2), 1e-30))


def _to_jax(template, value):
    """A port NamedTuple of tensors as the JAX package's of the same field
    names (``template``: the JAX value, for the structure and dtypes)."""
    if isinstance(template, tuple):
        return type(template)(*(_to_jax(t, getattr(value, f))
                                for f, t in zip(template._fields, template)))
    v = value.numpy() if isinstance(value, torch.Tensor) else value
    return jnp.asarray(np.asarray(v), dtype=template.dtype)


def _probes_np(probes):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in probes.items()}


# The first block from which each demodulator's taps p4 and p5 are held to
# 90 dB; before it SAM and FM acquire (the taps before the demodulator,
# p1-p3 and p7, are held on every block).
ACQUIRED = {"usb": 0, "usb_nb": 0, "sam": 1, "fm": 3}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_taps_match_jax(name):
    """Four chained blocks: every block the same tap names, shapes and
    dtypes as JAX's and the same PLL tier, and p6 within 1e-4 of the JAX
    demod's (x100 of the FMA rounding of the PLL loops) run on the same
    input: the port's p3 tap and demod carry.  Every other tap >= 90 dB
    SNR against the JAX receiver's (the bar the audio is held to; a locked
    loop's p6 is near zero, so its SNR says nothing of the tap): on every
    block for USB and USB with the blanker, and for p1-p3 of SAM and FM.
    SAM's and FM's p4 and p5 are held from ``ACQUIRED`` on: before it the
    loops acquire on the channel filter's near-silent fill, the two
    packages' PLL roundings flip a phase wrap now and then, and FM's DC
    tracker carries that into the next blocks.  The readings there
    (p4/p5, dB): SAM block 0 72.3/72.2; FM blocks 0-2 25.9/25.9,
    59.3/59.1, 87.4/87.3; from ``ACQUIRED`` on SAM reads 92.0-92.6 and FM
    106.7-106.8.  The impulses go to the blanker's configuration alone."""
    kw = dict(BASE, probes=True, **CONFIGS[name])
    jr = jrx.Receiver(jrx.ReceiverConfig(**kw))
    tr = trx.Receiver(trx.ReceiverConfig(**kw), "cpu")
    demod = {"fm": j_fm, "sam": j_sam}.get(kw["mode"])
    probed = jax.jit(demod.process_probed) if demod else None
    n = tr.cfg.block_size
    for b in range(4):
        x = _signal(kw["mode"], n, seed=b, start=b * n,
                    impulses=kw.get("nb_on", False))
        carry = tr.state.demod
        jo = jr.process(jnp.asarray(x))
        to = tr.process(x)
        want = {k: np.asarray(v) for k, v in jo.probes.items()}
        got = _probes_np(to.probes)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            if k == "pll_tier":
                assert got[k] == int(w)
                continue
            assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
            held = (k not in ("p4_demod", "p5_resampled")
                    or b >= ACQUIRED[name])
            if held and k != "p6_pll":
                assert _snr_db(w, got[k]) >= 90.0, (k, b, _snr_db(w, got[k]))
        if probed is not None:
            _, _, p6, tier = probed(jr.params.demod,
                                    _to_jax(jr.state.demod, carry),
                                    jnp.asarray(got["p3_agc"]))
            assert int(tier) == got["pll_tier"]
            assert np.abs(got["p6_pll"] - np.asarray(p6)).max() < 1e-4


@pytest.mark.parametrize("kw", [dict(mode="usb"), dict(mode="usb",
                                                       nb_on=True),
                                dict(mode="sam"), dict(mode="fm"),
                                dict(mode="am", stereo=True)])
def test_probes_leave_audio_bitwise(kw):
    """With probes on, the audio, n_audio and S-meters are the bits of the
    step without probes over three chained blocks (no tap is copied or
    written after it is taken), and the CPU launches no kernel either
    way."""
    cfg = trx.ReceiverConfig(**BASE, **kw)
    off = trx.Receiver(cfg, "cpu")
    on = trx.Receiver(dataclasses.replace(cfg, probes=True), "cpu")
    kernels.reset_launches()
    for b in range(3):
        x = _signal(kw["mode"], cfg.block_size, seed=10 + b,
                    start=b * cfg.block_size)
        a, p = off.process(x), on.process(x)
        assert a.probes is None and p.probes
        for f in ("audio", "n_audio", "smeter_ave_db", "smeter_peak_db"):
            assert torch.equal(getattr(a, f), getattr(p, f)), f
    assert not any(kernels.LAUNCHES.values())


def test_probe_taps_match_oracle_stages():
    """tests/test_probes_golden.py's oracle check on the port: p1, p2 and
    p3 against the float64 oracle chain stage by stage, at its
    tolerances."""
    from cutesdr_tpu.testbench.generators import GenConfig, SignalGenerator
    cfg = trx.ReceiverConfig(input_rate=500_000.0, mode="usb",
                             tune_freq=100_000.0, audio_rate=None,
                             probes=True, agc_thresh_db=-90.0)
    gen = SignalGenerator(GenConfig(
        sample_rate=cfg.input_rate, sweep_start_hz=100_800.0,
        sweep_stop_hz=100_800.0, signal_power_db=-25.0,
        noise_power_db=-65.0))
    n_blocks = 4
    x = gen.next_block(cfg.block_size * n_blocks)

    n = np.arange(len(x))
    inc = np.round(-(cfg.tune_freq) / cfg.input_rate * 2.0 ** 32) / 2.0 ** 32
    mixed = x * np.exp(1j * 2 * np.pi * inc * n)
    o_p1 = oracles.CascadeOracle(cfg.plan)(mixed)
    h = design_fastfir(cfg.low_cut, cfg.hi_cut, 0.0, cfg.output_rate)
    o_p2 = oracles.FastFirOracle(h)(o_p1)
    acfg = j_agc.AgcConfig(True, False, cfg.output_rate)
    o_p3 = oracles.AgcOracle(acfg, cfg.agc_thresh_db, cfg.agc_manual_gain_db,
                             cfg.agc_slope, cfg.agc_decay_ms)(o_p2)

    rx = trx.Receiver(cfg, "cpu")
    taps = {"p1_downconvert": [], "p2_fastfir": [], "p3_agc": []}
    for b in np.split(x, n_blocks):
        out = rx.process(b.astype(np.complex64))
        for k, v in taps.items():
            v.append(out.probes[k].numpy())
    for (name, got), want, tol in zip(taps.items(), (o_p1, o_p2, o_p3),
                                      (2e-5, 5e-5, 2e-3)):
        got = np.concatenate(got)
        assert got.shape == want.shape, name
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-9)
        assert err < tol, (name, err)


def test_p6_pll_internal_probe():
    """tests/test_probes_golden.py's P6 check on the port: SAM on an AM
    carrier 100 Hz off pulls in (the phase error x100 settles inside
    +-40 after a transient), and the session takes p6 in SAM only."""
    cfg = trx.ReceiverConfig(input_rate=FS, mode="sam", tune_freq=60_000.0,
                             audio_rate=None, probes=True)
    n = cfg.block_size * 6
    t = np.arange(n) / FS
    x = (2000.0 * (1.0 + 0.4 * np.cos(2 * np.pi * 400.0 * t))
         * np.exp(2j * np.pi * 60_100.0 * t)).astype(np.complex64)
    rx = trx.Receiver(cfg, "cpu")
    p6 = np.concatenate([rx.process(b).probes["p6_pll"].numpy()
                         for b in np.split(x, 6)])
    assert p6.shape == (n // cfg.plan.decimation,)
    assert np.abs(p6[len(p6) // 2:]).max() < 40.0
    assert np.abs(p6[:len(p6) // 2]).max() > 1.0

    sess = ts.ReceiverSession(dataclasses.replace(cfg, probes=False),
                              device="cpu")
    sess.start()
    assert sess.set_probe("p6") == "p6_pll"
    sess.pump(x[:cfg.block_size])
    sess.flush()
    assert sess.probe_frame()["tap"] == "p6_pll"
    assert sum(sess.metrics.pll_tier_blocks) == 1
    usb = ts.ReceiverSession(trx.ReceiverConfig(input_rate=FS, mode="usb"),
                             device="cpu")
    with pytest.raises(ValueError, match="PLL mode"):
        usb.set_probe("p6")
    with pytest.raises(ValueError, match="noise blanker"):
        usb.set_probe("p7")


@pytest.mark.parametrize("mode", list(jp.TriggerMode))
def test_triggered_capture_matches_jax(mode):
    """The port's TriggeredCapture and the JAX package's over the same
    pulsed noise in uneven blocks: the same records, exactly."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(6000) * 0.2
    x[1000:1200] += 1.0
    x[3000:3100] += 1.0
    x[4500:4600] -= 1.5
    kw = dict(length=256, pre_samples=64, level=0.5, hysteresis=0.1)
    j = jp.TriggeredCapture(mode=mode, **kw)
    t = tp.TriggeredCapture(mode=tp.TriggerMode(mode.value), **kw)
    pos = 0
    for size in (700, 1300, 50, 2000, 1950):
        blk = x[pos:pos + size]
        assert t.feed(blk) == j.feed(blk)
        if j.record is None:
            assert t.record is None
        else:
            np.testing.assert_array_equal(t.record, j.record)
        pos += size


def test_probe_spectrum_matches_jax():
    """ProbeSpectrum over the same complex and real input in uneven
    pieces (several frames, a remainder carried across feeds): the
    spectrum within 0.1 dB of the JAX package's."""
    rng = np.random.default_rng(6)
    n = 2048 * 9 + 300
    t = np.arange(n) / 48_000.0
    x = (10000.0 * np.exp(2j * np.pi * 6000.0 * t)
         + 30.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    for sig in (x.astype(np.complex64), x.real.astype(np.float32)):
        j = jp.ProbeSpectrum(sample_rate=48_000.0)
        t_ = tp.ProbeSpectrum(sample_rate=48_000.0, device="cpu")
        for piece in np.split(sig, [1000, 6000, 6001, 15000]):
            j.feed(piece)
            t_.feed(torch.from_numpy(piece))
        want, got = j.spectrum_db(), t_.spectrum_db()
        assert got.shape == want.shape == (2048,)
        assert np.abs(got - want).max() < 0.1


def test_session_probe_scope_matches_jax():
    """ReceiverSession.set_probe / probe_frame against the JAX session on
    the same pumped input: the applied tap names and frame keys, the p7
    spectrum within 0.1 dB, a p2 record on a positive trigger, p6 with
    the PLL tier counts equal, off, and the same ValueErrors.  SAM with the
    blanker, so that every tap is there."""
    kw = dict(BASE, mode="sam", nb_on=True)
    j = js.ReceiverSession(jrx.ReceiverConfig(**kw))
    t = ts.ReceiverSession(trx.ReceiverConfig(**kw), device="cpu")
    n = t.cfg.block_size
    x = _signal("sam", 8 * n, seed=30)
    for s in (j, t):
        s.start()

    def both(fn):
        a, b = fn(j), fn(t)
        assert a == b
        return a

    def pump(lo, hi):
        for s in (j, t):
            for piece in np.array_split(x[lo * n:hi * n], 3):
                s.pump(piece)
            s.flush()

    assert both(lambda s: s.set_probe("p7")) == "p7_blanker"
    pump(0, 3)
    fj, ft = j.probe_frame(), t.probe_frame()
    assert list(ft) == list(fj) and ft["sample_rate"] == fj["sample_rate"]
    assert np.abs(t._probe_inst.spectrum_db()
                  - j._probe_inst.spectrum_db()).max() < 0.1
    assert both(lambda s: s.set_probe("p2", view="scope",
                                      trigger_mode="pos",
                                      trigger_level=50.0)) == "p2_fastfir"
    pump(3, 5)
    fj, ft = j.probe_frame(), t.probe_frame()
    assert list(ft) == list(fj) and ft["record"] is not None
    assert fj["record"] is not None and len(ft["record"]) == 1024
    assert both(lambda s: s.set_probe("p6")) == "p6_pll"
    pump(5, 7)
    assert t.metrics.pll_tier_blocks == j.metrics.pll_tier_blocks
    assert sum(t.metrics.pll_tier_blocks) == 7
    for tap, msg in (("p9", "unknown probe tap"), ("p3", "trigger mode")):
        for s in (j, t):
            with pytest.raises(ValueError, match=msg):
                s.set_probe(tap, view="scope", trigger_mode="bogus")
    assert both(lambda s: s.set_probe("off")) is None
    assert both(lambda s: s.probe_frame()) is None
    assert not t.cfg.probes and not j.cfg.probes
    pump(7, 8)
    assert t.metrics.samples_in == j.metrics.samples_in == 8 * n
