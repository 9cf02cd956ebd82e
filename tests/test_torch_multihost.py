"""The port's time sharding across processes: two gloo processes on the
CPU, each with two local "cpu" shards, form one 4-shard "t" axis
(``shard.multihost``).  The workers import only torch and the port."""

import os
import socket
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HEAD = textwrap.dedent("""
    import os, sys
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from cutesdr_tpu_torch.shard import multihost
    multihost.initialize(f"127.0.0.1:{port}", nproc, pid, device="cpu")
    mesh = multihost.global_time_mesh(["cpu", "cpu"])
    assert mesh.devices.size == 2 * nproc
    assert mesh.ranks.reshape(-1).tolist() == [0, 0, 1, 1]
""")

_NO_JAX = textwrap.dedent("""
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "cutesdr_tpu")]
    assert not bad, bad
""")

_ASSEMBLE = _HEAD + textwrap.dedent("""
    hs = multihost.HostShardedStream(mesh, block_per_device=256)
    # process p holds samples [p*512, (p+1)*512) of the global ramp
    base = pid * hs.local_samples_per_superblock
    local = np.arange(base, base + hs.local_samples_per_superblock)
    shards = hs.assemble(local.astype(np.complex64))
    assert [s.shape[0] for s in shards] == [256, 256]
    mine = torch.stack([s.real.double().sum() for s in shards]).sum()
    torch.distributed.all_reduce(mine)
    n = hs.global_samples_per_superblock
    assert float(mine) == n * (n - 1) / 2, float(mine)
    print(f"proc {pid}: OK sum={float(mine)}")
""") + _NO_JAX

_RECEIVER = _HEAD + textwrap.dedent("""
    from cutesdr_tpu_torch.pipeline.receiver import Receiver, ReceiverConfig
    from cutesdr_tpu_torch.shard.timeshard import ShardedReceiver

    cfg = ReceiverConfig(input_rate=500_000.0, mode="usb",
                         tune_freq=20_000.0, audio_rate=48000.0)
    srx = ShardedReceiver(cfg, mesh)
    hs = srx.host_stream()
    n_sb = 3
    n = srx.superblock_size * n_sb
    t = np.arange(n) / cfg.input_rate
    x = (2000.0 * (1.0 + 0.3 * np.cos(2 * np.pi * 37.0 * t))
         * np.exp(2j * np.pi * 21_500.0 * t)
         + 500.0 * np.exp(2j * np.pi * (80_000.0 * t + 5e3 * t * t)))
    x = x.astype(np.complex64)
    single = Receiver(cfg, "cpu")
    lo = pid * hs.local_samples_per_superblock
    bs = cfg.block_size
    for sb in range(n_sb):
        base = sb * srx.superblock_size
        local = x[base + lo:base + lo + hs.local_samples_per_superblock]
        out = srx.process(hs.assemble(local))
        ref = [single.process(x[base + b * bs:base + (b + 1) * bs])
               for b in range(srx.n_dev)]
        want = np.concatenate([o.audio[:int(o.n_audio)].numpy() for o in ref])
        got = out.audio[:int(out.n_audio)].numpy()
        assert got.shape == want.shape, (got.shape, want.shape)
        np.testing.assert_allclose(got, want, atol=5e-4 * np.abs(want).max())
        assert abs(float(out.smeter_ave_db)
                   - float(ref[-1].smeter_ave_db)) < 0.1
    print(f"proc {pid}: RECEIVER OK over {n_sb} superblocks")
""") + _NO_JAX


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _run_two(src: str, ok: str) -> None:
    """Two worker processes on a free loopback port; each must print
    ``ok``.  A hang fails after 120 s instead of blocking the suite."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", src, str(pid), "2",
                               port], env=env, cwd=ROOT, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert ok in out, out[-3000:]


def test_two_process_assemble():
    """Each process contributes its half of a ramp through
    ``HostShardedStream.assemble``; the sum over both processes is the
    whole ramp's."""
    _run_two(_ASSEMBLE, "OK sum=")


def test_two_process_sharded_receiver():
    """``ShardedReceiver`` over the 2 x 2 mesh, three superblocks: the
    halos across the process boundary go by ``batch_isend_irecv``, the
    carries by broadcast, the filtered stream by ``all_gather``; each
    process's audio within 5e-4 of the single receiver's peak and its
    S-meter within 0.1 dB."""
    _run_two(_RECEIVER, "RECEIVER OK")
