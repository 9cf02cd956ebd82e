"""The port's two-stage pipeline (``shard.pipeline.PipelinedReceiver``) on
the CPU: equal to the port's single receiver one block late and to JAX's
``PipelinedReceiver``, its stages' state on their devices, and ``flush``
with nothing staged."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cutesdr_tpu.pipeline import receiver as jrx
from cutesdr_tpu.shard.pipeline import PipelinedReceiver as JPipelined
from cutesdr_tpu_torch import convert
from cutesdr_tpu_torch.pipeline import receiver as trx
from cutesdr_tpu_torch.shard import PipelinedReceiver
from cutesdr_tpu_torch.testbench.generators import tone

torch.set_num_threads(1)

KW = dict(input_rate=250_000.0, mode="usb", tune_freq=60_000.0,
          audio_rate=48000.0)
N_BLOCKS = 4
# The first block's audio against JAX: the channel filter's fill, where the
# AGC attacks from silence onto the tone's onset.  Measured 32.0 dB for the
# two pipelines and for the two single receivers alike (the samples before
# the onset are equal); held 1 dB below.
FILL_SNR = 31.0


def _blocks(cfg):
    x = tone(cfg.block_size * N_BLOCKS, 61_000.0, cfg.input_rate, -20.0)
    return np.split(x.astype(np.complex64), N_BLOCKS)


def _audio(out):
    return np.asarray(out.audio)[:int(out.n_audio)]


def _snr_db(want, got):
    err = np.abs(got - want)
    return 10 * np.log10(np.mean(np.abs(want) ** 2)
                         / max(np.mean(err ** 2), 1e-30))


def test_pipelined_equals_single_one_block_late():
    """Four blocks and a flush: the first call returns None, then each
    output is the single receiver's for the block before, bitwise (the
    same operations in the same order); nothing stays staged."""
    cfg = trx.ReceiverConfig(**KW)
    pp = PipelinedReceiver(cfg, "cpu", "cpu")
    single = trx.Receiver(cfg, "cpu")
    got, want = [], []
    for b in _blocks(cfg):
        out = pp.process(b)
        if out is None:
            assert not got
        else:
            got.append(out)
        want.append(single.process(b))
    got.append(pp.flush())
    assert pp._staged is None and pp.flush() is None
    assert len(got) == len(want) == N_BLOCKS
    for g, w in zip(got, want):
        for f in ("audio", "n_audio", "smeter_ave_db", "smeter_peak_db"):
            assert torch.equal(getattr(g, f), getattr(w, f)), f


def test_pipelined_matches_jax():
    """The port's pipeline from JAX's pipeline's params and state
    (``convert.from_jax``) against JAX's over the same blocks, one block
    late in both: the S-meter within 0.01 dB on every output, the audio
    at >= 90 dB after the first and at ``FILL_SNR`` on the first.  The
    first block is the channel filter's fill, where the AGC attacks from
    silence onto the tone's onset (its last ~200 samples): the two single
    receivers differ there too (32.0 dB), and agree at >= 129 dB on every
    later block."""
    jcfg = jrx.ReceiverConfig(**KW, decimator_impl="pallas",
                              pallas_interpret=True)
    devs = jax.devices()
    jp = JPipelined(jcfg, device_front=devs[0], device_back=devs[1])
    cfg = trx.ReceiverConfig(**KW)
    pp = PipelinedReceiver(cfg, "cpu", "cpu")
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    state = jrx.ReceiverState(**to_np(jp.front_state), **to_np(jp.back_state))
    params, st = convert.from_jax(cfg, to_np(jp.params), state, "cpu")
    pp.params = pp.back_params = params
    pp.front_state = {k: getattr(st, k) for k in ("blanker", "dec",
                                                  "chan_filter")}
    pp.back_state = {k: getattr(st, k) for k in ("agc", "smeter", "demod",
                                                 "resamp")}
    outs = []
    for b in _blocks(cfg):
        outs.append((jp.process(jnp.asarray(b)), pp.process(b)))
    outs.append((jp.flush(), pp.flush()))
    assert outs[0] == (None, None)
    for b, (jout, tout) in enumerate(outs[1:]):
        assert int(tout.n_audio) == int(jout.n_audio)
        assert _snr_db(_audio(jout), _audio(tout)) >= (90.0 if b
                                                       else FILL_SNR)
        assert abs(float(tout.smeter_ave_db)
                   - float(jout.smeter_ave_db)) < 0.01


def test_pipelined_stage_placement():
    """The front carries on ``device_front``, the back carries, the staged
    block and the outputs on ``device_back``; ``flush`` before any block
    gives None, and a staged block flushes."""
    cfg = trx.ReceiverConfig(**dict(KW, audio_rate=None))
    pp = PipelinedReceiver(cfg, "cpu", "cpu")
    assert pp.flush() is None
    x = _blocks(cfg)[0]
    assert pp.process(x) is None
    assert pp._staged.device == pp.device_back
    assert pp.front_state["chan_filter"].tail.device == pp.device_front
    assert pp.back_state["agc"].attack_ave.device == pp.device_back
    out = pp.process(x)
    assert out.audio.device == pp.device_back
    assert pp._staged is not None and pp.flush() is not None
