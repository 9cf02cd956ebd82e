"""The port's multi-device layer on the CPU: ``make_mesh``, the
time-sharded receiver (halo exchange, the blanker's stateless form, probe
taps, carries across superblocks) against the port's single receiver and
against JAX's ``ShardedReceiver`` on conftest's 8-device CPU mesh, the
channel axis over devices, and ``convert.from_jax_timeshard``.  A mesh of
repeated "cpu" entries stands for several devices.  Inputs are made with
numpy from a seed; each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesdr_tpu.ops import noiseblanker as j_nb
from cutesdr_tpu.pipeline import receiver as jrx
from cutesdr_tpu.shard import make_mesh as j_make_mesh
from cutesdr_tpu.shard.timeshard import ShardedReceiver as JShardedReceiver
from cutesdr_tpu_torch import convert
from cutesdr_tpu_torch.ops import noiseblanker as t_nb
from cutesdr_tpu_torch.pipeline import receiver as trx
from cutesdr_tpu_torch.shard import (ChannelBank, ShardedReceiver,
                                     StackedReceiver, make_mesh)
from cutesdr_tpu_torch.shard import timeshard
from cutesdr_tpu_torch.testbench.generators import (GenConfig,
                                                    SignalGenerator, tone)

torch.set_num_threads(1)

USB = dict(input_rate=500_000.0, mode="usb", tune_freq=20_000.0)
AUDIO_TOL = 5e-4      # x the reference's peak (JAX tests/test_shard.py)
SMETER_TOL = 0.1      # dB


def _snr_db(want, got):
    err = np.abs(np.asarray(got) - np.asarray(want))
    return 10 * np.log10(np.mean(np.abs(np.asarray(want)) ** 2)
                         / max(np.mean(err ** 2), 1e-30))


def _stream(cfg, n_superblocks, n_dev):
    """JAX tests/test_shard.py's sweep: -20 dBFS through 19-22 kHz over
    -50 dBFS noise."""
    gen = SignalGenerator(GenConfig(sample_rate=cfg.input_rate,
                                    sweep_start_hz=19_000.0,
                                    sweep_stop_hz=22_000.0,
                                    sweep_rate_hz_per_sec=1e4,
                                    signal_power_db=-20.0,
                                    noise_power_db=-50.0))
    return gen.next_block(cfg.block_size * n_dev * n_superblocks)


def _audio(out):
    return out.audio[:int(out.n_audio)].numpy()


def _run_both(cfg, x, n_dev, n_sb):
    """The sharded receiver over ``n_sb`` superblocks and the single one
    over the same blocks: [(sharded output, single outputs)] a superblock."""
    srx = ShardedReceiver(cfg, make_mesh(time=n_dev, devices=["cpu"] * 8))
    single = trx.Receiver(cfg, "cpu")
    bs = cfg.block_size
    runs = []
    for sb in range(n_sb):
        xs = x[sb * srx.superblock_size:(sb + 1) * srx.superblock_size]
        out = srx.process(xs)
        ref = [single.process(xs[b * bs:(b + 1) * bs]) for b in range(n_dev)]
        runs.append((out, ref))
    return srx, runs


def _hold(out, ref, tol=AUDIO_TOL):
    want = np.concatenate([_audio(o) for o in ref])
    got = _audio(out)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got, want, atol=tol * scale)
    assert abs(float(out.smeter_ave_db)
               - float(ref[-1].smeter_ave_db)) < SMETER_TOL


@pytest.mark.parametrize("n_dev", [2, 4])
def test_timeshard_matches_single_receiver(n_dev):
    """Two superblocks of the sweep through 2 and 4 shards: the audio
    within 5e-4 of the single receiver's peak, the S-meter within 0.1 dB
    (the back end runs once over the superblock, where the single
    receiver runs it once a block)."""
    cfg = trx.ReceiverConfig(**USB, audio_rate=48000.0)
    _, runs = _run_both(cfg, _stream(cfg, 2, n_dev), n_dev, 2)
    for out, ref in runs:
        _hold(out, ref)


def test_timeshard_stateful_across_superblocks():
    """AM without AGC or resampler over three superblocks of 4 shards: the
    carries (tails, phase base) hand over with no seam, 5e-4 x peak."""
    cfg = trx.ReceiverConfig(input_rate=500_000.0, mode="am",
                             tune_freq=100_000.0, audio_rate=None,
                             agc_on=False)
    n = cfg.block_size * 4 * 3
    t = np.arange(n) / cfg.input_rate
    x = (3000.0 * (1.0 + 0.5 * np.cos(2 * np.pi * 400.0 * t))
         * np.exp(2j * np.pi * 100_000.0 * t)).astype(np.complex64)
    srx, runs = _run_both(cfg, x, 4, 3)
    for out, ref in runs:
        _hold(out, ref)
    assert int(srx.ts_carry.nco_base) == (
        3 * srx.superblock_size * srx.params.dec.phase_inc) & 0xFFFFFFFF


def test_timeshard_with_noise_blanker():
    """The blanker on: each shard runs ``process_with_history`` over its
    left neighbour's raw tail, and the impulses (one across a shard
    boundary) are blanked as the single receiver blanks them."""
    cfg = trx.ReceiverConfig(input_rate=500_000.0, mode="usb",
                             tune_freq=50_000.0, audio_rate=None,
                             agc_on=False, nb_on=True, nb_threshold=40.0,
                             nb_width_us=20.0)
    rng = np.random.default_rng(42)
    n = cfg.block_size * 4 * 2
    x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 50
         ).astype(np.complex64)
    x[10_000] = 500_000.0
    x[25_000] = -400_000.0j
    x[cfg.block_size * 4 - 3] = 300_000.0 + 300_000.0j   # at a boundary
    _, runs = _run_both(cfg, x, 4, 2)
    for out, ref in runs:
        _hold(out, ref)


def test_timeshard_probes_match_single_receiver():
    """p1 (decimated), p2 (filtered) and p7 (blanked) gathered whole over
    4 shards equal the single receiver's taps block for block, within
    5e-4 of their peaks."""
    cfg = trx.ReceiverConfig(**USB, audio_rate=None, agc_on=False,
                             nb_on=True, probes=True)
    _, runs = _run_both(cfg, _stream(cfg, 1, 4), 4, 1)
    out, ref = runs[0]
    for key in ("p7_blanker", "p1_downconvert", "p2_fastfir"):
        want = np.concatenate([o.probes[key].numpy() for o in ref])
        got = out.probes[key].numpy()
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want,
                                   atol=AUDIO_TOL * np.abs(want).max(),
                                   err_msg=key)


def test_blanker_with_history_matches_jax():
    """``noiseblanker.process_with_history`` on an impulsive block with
    its history: the same samples blanked as JAX's, and >= 140 dB."""
    nb = dict(on=True, threshold=40.0, width_usec=20.0, sample_rate=500e3)
    tcfg, jcfg = t_nb.BlankerConfig(**nb), j_nb.BlankerConfig(**nb)
    h, n = t_nb.history_len(tcfg), 8192
    assert h == j_nb.history_len(jcfg)
    rng = np.random.default_rng(70)
    z = ((rng.standard_normal(h + n) + 1j * rng.standard_normal(h + n))
         * 50).astype(np.complex64)
    for k in (h - 2, h + 500, h + 4000, h + n - 1):
        z[k] = 400_000.0 - 300_000.0j
    want = np.asarray(j_nb.process_with_history(jcfg, jnp.asarray(z), n))
    got = t_nb.process_with_history(tcfg, torch.from_numpy(z), n).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (got == 0).sum() > 0
    assert _snr_db(want, got) >= 140.0


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's ShardedReceiver (its raw-halo Pallas mixdec, interpreted) over
    two superblocks of 4 shards, compiled once for the tests below: its
    outputs, and its carry and state after the first superblock."""
    kw = dict(USB, audio_rate=48000.0)
    cfg = jrx.ReceiverConfig(**kw, decimator_impl="pallas",
                             pallas_interpret=True)
    jsrx = JShardedReceiver(cfg, j_make_mesh(time=4))
    tcfg = trx.ReceiverConfig(**kw)
    x = _stream(tcfg, 2, 4).astype(np.complex64)
    sb = jsrx.superblock_size
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    outs, after_first = [], None
    for i in range(2):
        outs.append(jsrx.process(jnp.asarray(x[i * sb:(i + 1) * sb])))
        if i == 0:
            after_first = (to_np(jsrx.params), to_np(jsrx.state),
                           to_np(jsrx.ts_carry))
    return tcfg, x, outs, after_first


def _match(jout, tout, min_snr=90.0):
    n = int(jout.n_audio)
    assert int(tout.n_audio) == n
    assert _snr_db(np.asarray(jout.audio)[:n], tout.audio[:n].numpy()
                   ) >= min_snr
    assert abs(float(tout.smeter_ave_db) - float(jout.smeter_ave_db)) < 0.01


def test_timeshard_matches_jax(jax_sharded):
    """The port's ShardedReceiver over 4 "cpu" shards against JAX's over 4
    CPU devices, two superblocks: >= 90 dB, the S-meter within 0.01 dB."""
    cfg, x, jouts, _ = jax_sharded
    srx = ShardedReceiver(cfg, make_mesh(time=4, devices=["cpu"] * 4))
    sb = srx.superblock_size
    for i, jout in enumerate(jouts):
        _match(jout, srx.process(x[i * sb:(i + 1) * sb]))


def test_from_jax_timeshard_continues_jax(jax_sharded):
    """JAX's carry and state after the first superblock, carried into the
    port (``convert.from_jax_timeshard``, ``convert.from_jax``): the
    second superblock matches JAX's at >= 90 dB and 0.01 dB."""
    cfg, x, jouts, (params, state, carry) = jax_sharded
    srx = ShardedReceiver(cfg, make_mesh(time=4, devices=["cpu"] * 4))
    srx.params, srx.state = convert.from_jax(cfg, params, state, "cpu")
    srx.ts_carry = convert.from_jax_timeshard(carry, "cpu")
    assert int(srx.ts_carry.nco_base) == int(carry.nco_base)
    assert srx.ts_carry.nb_tail is None
    sb = srx.superblock_size
    _match(jouts[1], srx.process(x[sb:2 * sb]))


@pytest.mark.parametrize("kind", ["bank", "stacked"])
def test_bank_over_channel_mesh_matches_unsharded(kind):
    """8 AM channels (a ChannelBank over one block, or a StackedReceiver
    over 8 streams) split over a 4-device "ch" axis: every output field
    and probe tap equal to the unsharded bank's, two blocks."""
    cfg = trx.ReceiverConfig(input_rate=250_000.0, mode="am",
                             audio_rate=None, agc_on=False, probes=True)
    freqs = [5_000.0 * (i + 1) for i in range(8)]
    mesh = make_mesh(channels=4, devices=["cpu"] * 4)
    cls = ChannelBank if kind == "bank" else StackedReceiver
    sharded, whole = cls(cfg, freqs, mesh=mesh), cls(cfg, freqs, "cpu")
    assert len(sharded.parts) == 4 and sharded.n_channels == 8
    n = cfg.block_size
    x = tone(2 * n, 20_000.0, cfg.input_rate, -20.0).astype(np.complex64)
    for b in range(2):
        blk = x[b * n:(b + 1) * n]
        if kind == "stacked":
            blk = np.stack([np.roll(blk, 17 * c) for c in range(8)])
        got, want = sharded.process(blk), whole.process(blk)
        for f in ("audio", "n_audio", "smeter_ave_db", "smeter_peak_db"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert got.probes.keys() == want.probes.keys()
        for k in want.probes:
            assert torch.equal(got.probes[k], want.probes[k]), k


def test_mesh_errors():
    """A mesh that needs more devices than it has, and channels that do
    not split evenly over the "ch" axis, raise as in JAX."""
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh(time=2, channels=4, devices=["cpu"] * 4)
    mesh = make_mesh(time=2, channels=3, devices=["cpu"] * 6)
    assert mesh.shape == {"t": 2, "ch": 3}
    cfg = trx.ReceiverConfig(input_rate=250_000.0, mode="usb")
    with pytest.raises(ValueError, match="not divisible"):
        ChannelBank(cfg, [1e3, 2e3, 3e3, 4e3], mesh=mesh)


def test_mesh_rejects_unknown_axis():
    """An axis that is not "t" or "ch" raises; it never falls back to the
    channel axis."""
    mesh = make_mesh(time=2, channels=2, devices=["cpu"] * 4)
    assert mesh.axis_names == ("t", "ch")
    assert mesh.axis_ranks("ch") is None
    cfg = trx.ReceiverConfig(**USB)
    for bad in ("time", "c", "T"):
        with pytest.raises(ValueError):
            mesh.axis_devices(bad)
        with pytest.raises(ValueError):
            mesh.axis_ranks(bad)
        with pytest.raises(ValueError):
            ShardedReceiver(cfg, mesh, axis=bad)
        with pytest.raises(ValueError):
            ChannelBank(cfg, [1e3, 2e3], mesh=mesh, axis=bad)


def test_timeshard_places_params_once(monkeypatch):
    """The params are placed on the axis's devices when they are assigned
    (once a distinct device), and a step copies none; new params reach
    every shard."""
    placed = []
    real = timeshard.tree_to

    def counted(tree, d):
        if isinstance(tree, trx.ReceiverParams):
            placed.append(d)
        return real(tree, d)

    monkeypatch.setattr(timeshard, "tree_to", counted)
    cfg = trx.ReceiverConfig(**USB, audio_rate=None)
    srx = ShardedReceiver(cfg, make_mesh(time=4, devices=["cpu"] * 4))
    assert len(placed) == 1
    x = _stream(cfg, 2, 4)
    sb = srx.superblock_size
    srx.process(x[:sb])
    assert len(placed) == 1
    srx.params = trx.tune_params(cfg, srx.params, 25_000.0)
    assert len(placed) == 2
    assert all(p.dec.phase_inc == srx.params.dec.phase_inc
               for p in srx._shard_params)
    srx.process(x[sb:])
    assert len(placed) == 2
