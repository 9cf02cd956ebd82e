"""The noise blanker's int16 route (K10's plain version, ``kernels/
blanker.int16_gate_plain``, through ``ops/noiseblanker.process_int16``) on
the CPU: against the float route (``noiseblanker.process_planes``) where
the float route's float32 sums are exact, against the float64 reference
part of the benchmark where they are not, and the FM receiver with the
blanker fed int16 planes against its float route and the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesdr_tpu.pipeline import receiver as jrx
from cutesdr_tpu_torch import kernels
from cutesdr_tpu_torch.demod import fm as t_fm
from cutesdr_tpu_torch.ops import noiseblanker as t_nb
from cutesdr_tpu_torch.pipeline import receiver as trx
from sdrbench.reference.parts import impulse_blanker
from sdrbench.reference.stage import Rates

torch.set_num_threads(1)

FS = 2e6                  # mag_samples 10,000


def _planes(rng, n, edges, amp=200.0, spike=3000.0, spike_len=5):
    """int16 planes: a tone of ``amp`` counts and 3-count noise, and a
    ``spike_len``-sample impulse of ``spike`` counts straddling each of
    ``edges`` (two samples before it, the rest after) and every 7,001
    samples besides.  Every float32 sum of the float route stays below
    2^24 over a carried block of up to 40,000 samples: exact."""
    t = np.arange(n)
    x = amp * np.exp(2j * np.pi * 0.0123 * t)
    x += 3.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    starts = [e - 2 for e in edges] + list(range(3_000, n - spike_len, 7_001))
    for s in starts:
        x[s:s + spike_len] = spike * (1 - 0.5j)
    return (torch.from_numpy(np.round(x.real).astype(np.int16)),
            torch.from_numpy(np.round(x.imag).astype(np.int16)))


@pytest.mark.parametrize("width_us", [0.5, 20.0, 2048.0])
def test_int16_route_matches_the_float_route(width_us):
    """Widths of 1, 40 and 4,096 samples over carried blocks of uneven
    sizes, with impulses across the block edges: the same blanked masks,
    the same output values (int16 planes against float32 planes) and the
    same carries, block by block."""
    cfg = t_nb.BlankerConfig(True, 40.0, width_us, FS)
    assert cfg.width_samples == {0.5: 1, 20.0: 40, 2048.0: 4096}[width_us]
    sizes = (4096, 1000, 12_288, 37, 40_000)
    edges = np.cumsum(sizes)[:-1]
    re, im = _planes(np.random.default_rng(71), sum(sizes), edges)
    fc = ic = t_nb.init_carry(cfg, "cpu")
    pos, blanked = 0, 0
    for n in sizes:
        r, i = re[pos:pos + n], im[pos:pos + n]
        _, want_re, want_im = t_nb.process_planes(cfg, fc, r.float(),
                                                  i.float())
        fc, keep, _, _ = t_nb._gate(cfg, fc, r.float(), i.float())
        blank, *outs, _, _, _ = kernels.blanker.int16_gate_plain(
            r, i, ic.mag_tail, ic.trig_tail, ic.sig_tail, cfg.mag_samples,
            cfg.width_samples, cfg.ratio)
        assert torch.equal(blank, ~keep)
        ic, out_re, out_im = t_nb.process_int16(cfg, ic, r, i)
        assert out_re.dtype == out_im.dtype == torch.int16
        assert torch.equal(outs[0], out_re) and torch.equal(outs[1], out_im)
        assert torch.equal(out_re.float(), want_re)
        assert torch.equal(out_im.float(), want_im)
        for f in t_nb.BlankerCarry._fields:
            assert torch.equal(getattr(ic, f), getattr(fc, f)), f
        blanked += int(blank.sum())
        pos += n
    assert blanked >= 10 * min(cfg.width_samples, 5)


def test_int16_route_keeps_a_trigger_float32_rounds():
    """A floor of 7,497 counts and, every 12,000 samples, a 30,000-count
    sample whose window sum is one count under its trigger level (the
    floor one count lower 5,000 samples before it): every one triggers in
    exact arithmetic.  Over a 240,000-sample block the float route's
    float32 running sum reaches ~1.8e9, where its step is 128, and it
    loses some of them; the int16 route blanks exactly the float64
    reference part's samples, and its outputs are the reference's."""
    n, floor, spike = 240_000, 7_497, 30_000
    re = np.full(n, floor, np.int16)
    spikes = np.arange(15_000, n, 12_000)
    re[spikes] = spike
    re[spikes - 5_000] = floor - 1
    im = np.zeros(n, np.int16)
    cfg = t_nb.BlankerConfig(True, 50.0, 20.0, FS)
    assert cfg.ratio * spike == 10_000 * floor - 1 + spike + 1

    rx = {"nb_on": True, "nb_threshold": 50.0, "nb_width_us": 20.0}
    part = impulse_blanker.Part(rx, Rates(FS, FS / 32, n, n // 32),
                                "float64", "cpu")
    ref_re, ref_im = part(torch.from_numpy(re).double(),
                          torch.from_numpy(im).double())
    d1 = cfg.delay_samples + 1
    ref_blank = (ref_re == 0) & (torch.from_numpy(re).double().roll(d1) != 0)
    ref_blank[:d1] = ref_re[:d1] == 0

    _, keep, _, _ = t_nb._gate(cfg, t_nb.init_carry(cfg, "cpu"),
                               torch.from_numpy(re).float(),
                               torch.from_numpy(im).float())
    # the float route misses triggers that exact sums keep
    lost = (ref_blank & keep).nonzero().reshape(-1)
    assert len(lost) > 0
    assert set(lost.tolist()) <= {int(s) + k for s in spikes
                                  for k in range(cfg.width_samples)}

    carry, got_re, got_im = t_nb.init_carry(cfg, "cpu"), [], []
    for a, b in ((0, 90_001), (90_001, 200_000), (200_000, n)):
        carry, r, i = t_nb.process_int16(cfg, carry, torch.from_numpy(re[a:b]),
                                         torch.from_numpy(im[a:b]))
        got_re.append(r)
        got_im.append(i)
    got_re, got_im = torch.cat(got_re), torch.cat(got_im)
    assert torch.equal(got_re.double(), ref_re)
    assert torch.equal(got_im.double(), ref_im)
    blank = kernels.blanker.int16_gate_plain(
        torch.from_numpy(re), torch.from_numpy(im),
        *(getattr(t_nb.init_carry(cfg, "cpu"), f)
          for f in t_nb.BlankerCarry._fields),
        cfg.mag_samples, cfg.width_samples, cfg.ratio)[0]
    assert torch.equal(blank, ref_blank)
    assert int(blank[spikes].sum()) == len(spikes)


FM_KW = dict(input_rate=250_000.0, mode="fm", tune_freq=60_000.0,
             frames_per_block=2, nb_on=True, nb_threshold=40.0,
             nb_width_us=20.0)


def _fm_planes(cfg, n_blocks, seed=72):
    """int16 planes of ``n_blocks`` blocks: a -30 dBFS FM carrier at the
    tune (1 kHz at 3 kHz deviation), -80 dBFS noise and a 3-sample
    impulse near full scale every 4 ms."""
    rng = np.random.default_rng(seed)
    n = n_blocks * cfg.block_size
    t = np.arange(n) / cfg.input_rate
    x = 32767.0 * 10 ** (-30 / 20) * np.exp(1j * (
        2 * np.pi * (cfg.tune_freq + 200.0) * t
        + 3.0 * np.sin(2 * np.pi * 1000.0 * t)))
    x += 3.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for s in range(300, n - 3, int(0.004 * cfg.input_rate)):
        x[s:s + 3] = 25000.0 - 20000.0j
    return (np.round(x.real).astype(np.int16),
            np.round(x.imag).astype(np.int16))


def test_fm_receiver_with_the_int16_blanker():
    """The FM receiver with the blanker fed int16 planes (its int16 route)
    against the same receiver fed their float32 cast (the float route,
    whose sums are exact at this size): the same bits, carries included.
    Against the JAX Receiver fed the same samples: the blanker's carry
    equal, the same PLL tier a block, and the audio's agreement rising
    block over block past 60 dB (FM's acquisition head, where the two
    packages' FMA rounding flips a phase wrap, as in
    test_torch_frontend.test_reconfigure_matches_jax)."""
    cfg = trx.ReceiverConfig(**FM_KW)
    re, im = _fm_planes(cfg, 3)
    wire = trx.Receiver(cfg, "cpu")
    flt = trx.Receiver(cfg, "cpu")
    jr = jrx.Receiver(jrx.ReceiverConfig(**FM_KW, probes=True))
    kernels.reset_launches()
    snrs = []
    for blk in range(3):
        sl = slice(blk * cfg.block_size, (blk + 1) * cfg.block_size)
        r, i = torch.from_numpy(re[sl]), torch.from_numpy(im[sl])
        before = dict(t_fm.STATS)
        a = wire.process_planes(r, i)
        taken = [k for k, v in t_fm.STATS.items() if v != before[k]]
        b = flt.process_planes(r.float(), i.float())
        assert torch.equal(a.audio, b.audio)
        assert torch.equal(a.smeter_ave_db, b.smeter_ave_db)
        for x, y in zip(state_leaves(wire.state), state_leaves(flt.state)):
            assert torch.equal(x, y)
        jout = jr.process(jnp.asarray(re[sl].astype(np.float32)
                                      + 1j * im[sl].astype(np.float32)))
        assert taken == [t_fm.TIER_NAMES[int(jout.probes["pll_tier"])]]
        for f in t_nb.BlankerCarry._fields:
            np.testing.assert_array_equal(
                getattr(wire.state.blanker, f).numpy(),
                np.asarray(getattr(jr.state.blanker, f)))
        k = int(jout.n_audio)
        assert int(a.n_audio) == k
        want = np.asarray(jout.audio)[:k].astype(np.float64)
        err = np.abs(a.audio[:k].double().numpy() - want)
        snrs.append(10 * np.log10(np.mean(want ** 2)
                                  / max(np.mean(err ** 2), 1e-30)))
    assert snrs[0] < snrs[1] < snrs[2] and snrs[2] > 60.0, snrs
    assert kernels.LAUNCHES["blanker_int16"] == 0     # CPU: plain version


def state_leaves(state):
    """The tensors of a receiver state, in order."""
    out = []
    for leaf in state:
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif isinstance(leaf, tuple):
            out += state_leaves(leaf)
    return out


def _k10_emulated(re, im, mag_tail, trig_tail, sig_tail, M, W, ratio, tile):
    """One row through ``csrc/blanker.cu``'s work split, tile by tile: the
    staged d[q] = mag[q] - mag[q-M-1] over [a, t1), a = max(t0 - (W-1),
    0), the M + 1 magnitudes before a summed, the in-order scan, the
    triggers over [t0 - (W-1), t1) with the tail's below 0 and their
    running count, blank[i] = C[i] != C[i-W]; the last tile's new tails
    (a trigger as the count's step)."""
    n, H, D1 = re.shape[-1], W - 1, sig_tail.shape[-1]
    r64, i64 = re.to(torch.int64), im.to(torch.int64)
    mt = torch.round(mag_tail).to(torch.int64)

    def mag_at(q):
        out = torch.zeros(q.shape, dtype=torch.int64)
        pos, mid = q >= 0, (q < 0) & (q >= -M)
        out[pos] = torch.maximum(r64[q[pos]].abs(), i64[q[pos]].abs())
        out[mid] = mt[M + q[mid]]
        return out

    out_re = torch.empty(n, dtype=torch.int16)
    out_im = torch.empty(n, dtype=torch.int16)
    for t0 in range(0, n, tile):
        t1 = min(t0 + tile, n)
        a, lo = max(t0 - H, 0), t0 - H
        q = torch.arange(a, t1)
        m = mag_at(q)
        d = m - mag_at(q - M - 1)
        base = int(mag_at(torch.arange(a - M - 1, a)).sum())
        trig = m.double() * ratio > (base + torch.cumsum(d, 0)).double()
        p = torch.arange(lo, t1)
        tr = torch.zeros(len(p), dtype=torch.int64)
        tail = p < a
        tr[tail] = (trig_tail[H + p[tail]] > 0.5).to(torch.int64)
        tr[~tail] = trig[p[~tail] - a].to(torch.int64)
        C = torch.cumsum(tr, 0)
        i = torch.arange(t0, t1)
        u = i - lo
        before = torch.where(u - W >= 0, C[(u - W).clamp(min=0)], 0)
        blank = C[u] != before
        src = i - D1
        vr = torch.where(src >= 0, re[src.clamp(min=0)],
                         torch.round(sig_tail.real[(D1 + src).clamp(
                             max=D1 - 1)]).to(torch.int16))
        vi = torch.where(src >= 0, im[src.clamp(min=0)],
                         torch.round(sig_tail.imag[(D1 + src).clamp(
                             max=D1 - 1)]).to(torch.int16))
        out_re[t0:t1] = torch.where(blank, 0, vr)
        out_im[t0:t1] = torch.where(blank, 0, vi)
        if t1 == n:
            uk = torch.arange(n - H, n) - lo
            new_trig = (C[uk] - torch.where(uk > 0, C[(uk - 1).clamp(min=0)],
                                            0)).float()
            new_mag = mag_at(torch.arange(n - M, n)).float()
            pk = torch.arange(n - D1, n)
            new_sig = torch.where(
                pk >= 0, torch.complex(re[pk.clamp(min=0)].float(),
                                       im[pk.clamp(min=0)].float()),
                sig_tail[(D1 + pk).clamp(max=D1 - 1)])
    return out_re, out_im, new_mag, new_trig, new_sig


@pytest.mark.parametrize("n, tile", [(1000, 64), (37, 16), (5000, 4096),
                                     (300, 100)])
@pytest.mark.parametrize("width", [1, 40, 257])
def test_k10_work_split_emulated(n, tile, width):
    """csrc/blanker.cu's tiles, emulated (``_k10_emulated``), give the plain
    version's outputs and tails over carried blocks, tiles shorter and
    longer than the width, blocks shorter than the width and than the
    magnitude window (M = 50 here), with triggers in the carried tails."""
    M, ratio = 50, 6.0
    rng = np.random.default_rng(73 + n + width)
    zero = lambda k, dt=torch.float32: torch.zeros(k, dtype=dt)
    carry = (zero(M), zero(width - 1), zero(width // 2 + 1, torch.complex64))
    for _ in range(3):
        x = rng.integers(-300, 300, (2, n))
        hits = rng.random(n) < 0.01
        x[:, hits] = rng.integers(-32768, 32767, (2, int(hits.sum())))
        re, im = (torch.from_numpy(v.astype(np.int16)) for v in x)
        want = kernels.blanker.int16_gate_plain(re, im, *carry, M, width,
                                                ratio)
        got = _k10_emulated(re, im, *carry, M, width, ratio, tile)
        for g, w in zip(got, want[1:]):
            assert torch.equal(g, w)
        carry = want[3:]


class _Lib:
    def __init__(self):
        self.calls = []

    def cutesdr_blanker(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("rows", [None, 3])
def test_blanker_launch_arguments(monkeypatch, rows):
    """On the card ``blank_int16`` makes one launch of K10 with the planes'
    pointers, their row stride, the tails, the window sizes, the ratio and
    the tile, and counts it under ``blanker_int16``; stood in for here,
    since the kernel needs the card."""
    from cutesdr_tpu_torch.kernels import _build, blanker
    lib = _Lib()
    monkeypatch.setattr(_build, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(_build, "require", lambda *a, **k: None)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    kernels.reset_launches()
    cfg = t_nb.BlankerConfig(True, 50.0, 20.0, FS)
    lead = () if rows is None else (rows,)
    n = 65_536
    re = torch.zeros(lead + (n,), dtype=torch.int16)
    im = torch.zeros(lead + (n,), dtype=torch.int16)
    carry = t_nb.BlankerCarry(*(t.expand(lead + t.shape).contiguous()
                                for t in t_nb.init_carry(cfg, "cpu")))
    c, out_re, out_im = t_nb.process_int16(cfg, carry, re, im)
    [args] = lib.calls
    assert args[:3] == (re.data_ptr(), im.data_ptr(), 0 if rows is None
                        else n)
    assert args[3:6] == tuple(t.data_ptr() for t in carry)
    assert args[6:13] == (n, rows or 1, 10_000, 40, 21, 2500.0,
                          blanker.TILE)
    assert args[13:18] == (out_re.data_ptr(), out_im.data_ptr(),
                           *(t.data_ptr() for t in c))
    assert out_re.dtype == torch.int16 and out_re.shape == re.shape
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == \
        {"blanker_int16": 1}
    kernels.reset_launches()
