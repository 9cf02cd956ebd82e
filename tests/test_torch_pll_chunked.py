"""FM's chunked PLL tier as the port's K7 kernel computes it, on the CPU.

* ``kernels/seqloop.fm_pll_chunked_plain`` (K7's schedule in torch: pass
  1, pass 2, the first check's flag, the walker's repairs) is bitwise the
  sequential loop ``fm_pll_scan_plain`` on noise, a locked tone, an
  acquisition block, a forced repair, banks and partial tails;
* its flag is the port's ``ops/pll.chunked_scan`` flag and the JAX
  package's chunked-tier ``valid`` on the same inputs;
* FM's tier labels on the CPU still match JAX's;
* ``demod/fm._pll`` makes one ``seqloop.fm_pll_chunked`` call for tiers
  1 and 2 (one K7 launch on the card, its plain version here) with the
  labels and the bits of the torch chunked tier and the loop;
* the kernels' arithmetic (the magic-constant round, the wrap's one
  FMA), emulated in numpy float32, is bitwise the plain loops' and
  ``torch.round``.
The CUDA kernels themselves are held to the plain loops on the card by
chip_smoke.py.  Every check here is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesdr_tpu.demod import fm as j_fm
from cutesdr_tpu_torch import kernels
from cutesdr_tpu_torch.demod import fm as t_fm
from cutesdr_tpu_torch.demod import sam as t_sam
from cutesdr_tpu_torch.kernels import seqloop
from cutesdr_tpu_torch.ops import pll as t_pll

torch.set_num_threads(1)

FS = 62_500.0
F32 = np.float32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 \
        else x


def _theta(kind: str, n: int, rng, fs: float = FS) -> np.ndarray:
    """float32 phases in [-pi, pi]: uniform noise, a tone 150 Hz off the
    NCO (the loop locks; clean chunks bit-sync only now and then), or an
    acquisition block (noise, then the tone from the middle on)."""
    k = np.arange(n)
    tone = np.angle(np.exp(1j * (2 * np.pi * 150.0 / fs * k + 0.3)))
    noise = rng.uniform(-np.pi, np.pi, n)
    if kind == "noise":
        th = noise
    elif kind == "tone":
        th = tone
    else:
        th = np.where(k < n // 2 + 37, noise, tone)
    return th.astype(F32)


def _failed_boundaries(p, phase0, freq0, theta, halo):
    """The flag of the port's torch chunked tier (``demod/fm._pll_chunked``)
    over the whole chunks of ``theta`` with the same halo."""
    _, c = t_fm.init(FS, "cpu")
    c = c._replace(nco_phase=torch.as_tensor(phase0, dtype=torch.float32),
                   nco_freq=torch.as_tensor(freq0, dtype=torch.float32))
    n = theta.shape[-1] // seqloop.CHUNK * seqloop.CHUNK
    return t_fm._pll_chunked(p, c, theta[..., :n].contiguous(), halo)[0]


CASES = [
    # kind, streams (0: one [n] stream), n, halo, sample rate
    ("noise", 0, 2048, 128, FS),
    ("tone", 0, 2048, 128, FS),
    ("acquisition", 0, 2048, 128, FS),
    ("tone", 0, 2048, 1, FS),              # forced repair: a 1-sample halo
    ("noise", 0, 2048, 1, 250_000.0),      # forced repair on noise
    ("noise", 0, 2048, 0, 250_000.0),      # no halo at all
    ("acquisition", 3, 1024, 128, FS),     # a bank, one stream each kind
    ("tone", 0, 1100, 128, FS),            # a 76-sample tail past 8 chunks
    ("noise", 2, 1000, 128, FS),           # 7 chunks and a tail
    ("noise", 0, 500, 128, FS),            # 3 chunks: the walker alone
]


@pytest.mark.parametrize("kind,streams,n,halo,fs", CASES)
def test_chunked_plain_is_the_loop(kind, streams, n, halo, fs):
    """K7's schedule in torch gives the sequential loop's outputs and end
    state to the bit; where the first check failed (repairs ran), its
    flag says so, and it is the torch chunked scan's flag."""
    rng = np.random.default_rng(500 + n + halo)
    p, _ = t_fm.init(fs, "cpu")
    if streams:
        kinds = ("noise", "tone", "acquisition")
        th = np.stack([_theta(kinds[i % 3] if kind == "acquisition"
                              else kind, n, rng, fs) for i in range(streams)])
        phase0 = _t(rng.uniform(-3, 3, streams).astype(F32))
        freq0 = _t((rng.standard_normal(streams) * 0.01).astype(F32))
    else:
        th = _theta(kind, n, rng, fs)
        phase0, freq0 = -0.0, F32(0.004)          # a -0 start phase too
    th = _t(th)
    args = (p.pll_alpha, p.pll_beta, p.nco_limit, phase0, freq0)
    got = seqloop.fm_pll_chunked_plain(*args, th, halo)
    want = seqloop.fm_pll_scan_plain(*args, th)
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got[1:], want))
    valid = got[0]
    assert valid.shape == th.shape[:-1]
    if n // seqloop.CHUNK >= seqloop.MIN_CHUNKS:
        assert torch.equal(valid,
                           _failed_boundaries(p, phase0, freq0, th, halo))
    else:
        assert not valid.any()
    if halo <= 1 or kind == "tone" and streams == 0:
        assert not valid.all()                    # the repair path ran


@pytest.mark.parametrize("kind", ["noise", "tone", "acquisition"])
def test_flag_matches_chunked_scan_and_jax(kind):
    """At a chunkable n the schedule's first-check flag is the port's
    ``ops/pll.chunked_scan`` flag (``demod/fm._pll_chunked``) and JAX's
    ``demod/fm._pll_chunked`` valid, jitted, from the same state."""
    rng = np.random.default_rng(77)
    n = 4096
    th = _theta(kind, n, rng)
    tp, tc = t_fm.init(FS, "cpu")
    jp, jc = j_fm.init(FS)
    phase0, freq0 = F32(1.25), F32(-0.002)
    tc = tc._replace(nco_phase=torch.tensor(phase0),
                     nco_freq=torch.tensor(freq0))
    jc = jc._replace(nco_phase=jnp.float32(phase0),
                     nco_freq=jnp.float32(freq0))
    flag = seqloop.fm_pll_chunked_plain(tp.pll_alpha, tp.pll_beta,
                                        tp.nco_limit, phase0, freq0,
                                        _t(th))[0]
    port_valid = t_fm._pll_chunked(tp, tc, _t(th))[0]
    jax_valid = jax.jit(j_fm._pll_chunked)(jp, jc, jnp.asarray(th))[0]
    assert bool(flag) == bool(port_valid) == bool(jax_valid)
    assert bool(flag) == (kind == "noise")


def test_fm_tier_labels_match_jax_on_cpu():
    """Over the FM cases of the demods' tier-parity table (two chained
    blocks each), the port's CPU route labels every block as JAX does."""
    from tests.test_torch_demods import TIER_CASES, _cplx, _tone

    j_probed = jax.jit(j_fm.process_probed)
    for mode, stim, n, tier in TIER_CASES:
        if mode != "fm":
            continue
        rng = np.random.default_rng(30 + n)
        jp, jc = j_fm.init(FS)
        tp, tc = t_fm.init(FS, "cpu")
        for b in range(2):
            x = _cplx(rng, n, 3000.0) if stim == "noise" else \
                _tone(n, 150.0, start=b * n)
            jc, _, _, jtier = j_probed(jp, jc, jnp.asarray(x))
            tc, _, _, ttier = t_fm.process_probed(tp, tc, _t(x))
            assert ttier == int(jtier), (stim, n, b)
        assert ttier == tier


def _counted(monkeypatch, module, name: str) -> list:
    """Wrap ``module.name`` so that each call appends to the list
    returned."""
    calls = []
    fn = getattr(module, name)

    def counted(*args):
        calls.append(1)
        return fn(*args)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("stim,n,bank", [
    ("noise", 1024, False), ("noise", 1000, False), ("tone", 1024, False),
    ("noise", 1024, True), ("mixed", 1024, True)])
def test_card_route_is_one_k7_call(monkeypatch, stim, n, bank):
    """FM's one route (the card's, taken on every device): a block that
    leaves the linear tier makes one ``seqloop.fm_pll_chunked`` call (K7)
    and never takes the torch chunked tier, and is labelled chunked exactly where the block is
    chunkable and the torch chunked tier (``_pll_chunked``, JAX's
    schedule) validates; its outputs and the carry it leaves are the
    sequential loop's (``fm_pll_scan_plain``, then the DC tracker) bit
    for bit.  A bank is labelled chunked only if every stream's flag
    holds; a mixed bank (noise and a locked tone) takes the scan label."""
    rng = np.random.default_rng(11 + n)
    k = np.arange(2 * n)
    tone = (1000 * np.exp(2j * np.pi * 150.0 / FS * k)).astype(np.complex64)
    noise = ((rng.standard_normal(2 * n) + 1j * rng.standard_normal(2 * n))
             * 3000).astype(np.complex64)
    x = {"noise": noise, "tone": tone}.get(stim, noise)
    if bank:
        x = np.stack([x, tone if stim == "mixed" else noise[::-1].copy(),
                      x * np.complex64(0.5)])
    p, carry = t_fm.init(FS, "cpu")
    if bank:
        carry = type(carry)(*(
            torch.stack([v] * 3) if isinstance(v, torch.Tensor)
            else type(v)(*(torch.stack([u] * 3) for u in v))
            for v in carry))
    calls = _counted(monkeypatch, seqloop, "fm_pll_chunked")   # K7
    torch_tier = _counted(monkeypatch, t_fm, "_pll_chunked")
    t_fm.STATS.update(dict.fromkeys(t_fm.STATS, 0))
    tiers = []
    for blk in (_t(x[..., :n]), _t(x[..., n:])):
        theta = torch.atan2(blk.imag, blk.real)
        linear, want = t_fm._pll_linear(p, carry, theta)
        want_tier = t_fm.TIER_LINEAR
        if not bool(linear.all()):
            phase, freq, freqs, err = seqloop.fm_pll_scan_plain(
                p.pll_alpha, p.pll_beta, p.nco_limit, carry.nco_phase,
                carry.nco_freq, theta)
            audio, dc = t_fm._dc_track(p, freqs, carry.freq_error_dc)
            want = (phase, freq, dc, audio, err)
            held = t_fm._chunkable(n) and bool(
                t_fm._pll_chunked(p, carry, theta)[0].all())
            want_tier = t_fm.TIER_CHUNKED if held else t_fm.TIER_SCAN
        before, torch_before = len(calls), len(torch_tier)
        tier, out = t_fm._pll(p, carry, blk)
        assert tier == want_tier
        assert len(calls) - before == (tier != t_fm.TIER_LINEAR)
        assert len(torch_tier) == torch_before      # never the torch tier
        for g, w in zip(out, want):
            assert torch.equal(_bits(g), _bits(w))
        carry, _ = t_fm._post(p, carry, out)
        tiers.append(tier)
    assert t_fm.STATS == {name: tiers.count(t)
                          for t, name in t_fm.TIER_NAMES.items()}
    if stim == "tone":
        assert tiers == [t_fm.TIER_LINEAR] * 2
    elif stim == "mixed" or n % 128:
        assert tiers == [t_fm.TIER_SCAN] * 2
    else:
        assert tiers == [t_fm.TIER_CHUNKED] * 2
    assert not any(kernels.LAUNCHES.values())


# ----------------------------------------- the kernels' arithmetic, numpy --

MAGIC = F32(12582912.0)           # 1.5 * 2^23
TWO_PI, INV_2PI = F32(t_pll.TWO_PI), F32(t_pll.INV_2PI)


def _magic_round(x: np.ndarray) -> np.ndarray:
    return (x + MAGIC) - MAGIC


def test_magic_round_is_round_half_even():
    """(x + 1.5*2^23) - 1.5*2^23 in float32 is ``torch.round`` (half to
    even) as a value for |x| < 2^22: every half-integer and its float32
    neighbours up to 2^21, and a dense sweep of random floats across the
    whole range (the wrap's argument is below 2^22, csrc/seqloop.cu)."""
    half = np.arange(-2**22, 2**22 + 1, dtype=np.float64) / 2   # k/2
    half = half.astype(F32)
    sweep = [half, np.nextafter(half, F32(np.inf)),
             np.nextafter(half, F32(-np.inf))]
    rng = np.random.default_rng(3)
    for hi in (1.0, 8.0, 2.0**12, 2.0**21, 2.0**22 * 0.999999):
        sweep.append(rng.uniform(-hi, hi, 1 << 20).astype(F32))
    x = np.concatenate(sweep)
    x = x[np.abs(x) < 2**22]
    got = _magic_round(x)
    want = torch.round(_t(x)).numpy()
    assert np.array_equal(got, want)          # -0 == +0: values


def _wrap_plain(e):
    return e - TWO_PI * np.rint(e * INV_2PI).astype(F32)


def _wrap_fast(e):
    """The kernel's fast wrap: the magic round, then fma(-2pi, r, e),
    emulated in float64 (exact there: 2pi*r is exact for |r| <= 2, and
    e - 2pi*r needs few bits where r is not 0)."""
    r = _magic_round(e * INV_2PI)
    assert np.abs(r).max() <= 2
    return (e.astype(np.float64) - np.float64(TWO_PI) * r).astype(F32)


def test_fast_wrap_bits_except_negative_zero():
    """The kernel's fast wrap is the plain wrap bit for bit on every
    argument in its bound (|e| <= 15, csrc/seqloop.cu) but -0, which the
    kernel never passes (theta and the start phase are mapped to +0
    first): a dense sweep with the zeros and the multiples of pi/2 and
    their float32 neighbours."""
    rng = np.random.default_rng(4)
    e = np.concatenate([
        rng.uniform(-15, 15, 1 << 21), rng.uniform(-1e-3, 1e-3, 1 << 16),
        np.arange(-9, 10) * np.pi / 2, [0.0]]).astype(F32)
    e = np.concatenate([e, np.nextafter(e, F32(np.inf)),
                        np.nextafter(e, F32(-np.inf))])
    e = e[np.abs(e) <= 15]
    want = (_t(e) - t_pll.TWO_PI * torch.round(_t(e) * t_pll.INV_2PI)).numpy()
    assert np.array_equal(_wrap_plain(e).view(np.int32), want.view(np.int32))
    assert np.array_equal(_wrap_fast(e).view(np.int32), want.view(np.int32))
    neg0 = np.array([-0.0], F32)
    assert _wrap_plain(neg0).view(np.int32)[0] == 0               # +0
    assert _wrap_fast(neg0 + F32(0.0)).view(np.int32)[0] == 0


def _kernel_loop(fm, alpha, beta, limit, phase0, freq0, theta):
    """csrc/seqloop.cu's pll_step in numpy float32 over [C, n]: theta and
    the start phase + 0, the fast wrap; returns (phase, freq, out0,
    out1)."""
    a, b, lim = F32(alpha), F32(beta), F32(limit)
    phase = phase0.astype(F32) + F32(0.0)
    freq = freq0.astype(F32)
    out0, out1 = [], []
    for th in (theta + F32(0.0)).T:
        w = _wrap_fast(th + phase if fm else th - phase)
        err = -w if fm else w
        a_err = a * err
        before = phase
        freq = np.minimum(np.maximum(freq + b * err, -lim), lim)
        phase = _wrap_fast(phase + freq + a_err)
        out0.append(freq if fm else before)
        out1.append(err)
    return phase, freq, np.stack(out0, -1), np.stack(out1, -1)


@pytest.mark.parametrize("fm,fs", [(True, FS), (False, FS),
                                   (False, 15_625.0)])
def test_kernel_step_emulation_is_the_plain_loop(fm, fs):
    """The kernel's step with the fast wrap, emulated in numpy float32,
    is bitwise the plain loop over noise, a tone, theta holding -0 and +0
    and start phases of -0, +0 and pi, at the rates where the host allows
    the fast wrap (62,500 Hz FM, SAM; at 15,625 Hz FM takes the plain
    wrap); the first pre-update phase of SAM is the start phase as given
    (the kernel writes it back)."""
    rng = np.random.default_rng(9 if fm else 10)
    n = 512
    k = np.arange(n)
    th = np.stack([rng.uniform(-np.pi, np.pi, n),
                   np.angle(np.exp(1j * (2 * np.pi * 150 / fs * k + 0.3))),
                   np.where(k % 3 == 0, -0.0, 0.0),
                   rng.uniform(-np.pi, np.pi, n)]).astype(F32)
    phase0 = np.array([-0.0, 0.0, -0.0, np.pi], F32)
    freq0 = np.array([0.0, -0.0, -0.0, 0.01], F32)
    p, _ = (t_fm if fm else t_sam).init(fs, "cpu")
    args = (p.pll_alpha, p.pll_beta, p.nco_limit)
    assert seqloop._checked_consts(*args, True)[3]      # the fast wrap
    ph, fr, o0, o1 = _kernel_loop(fm, *args, phase0, freq0, th)
    plain = (seqloop.fm_pll_scan_plain if fm else seqloop.sam_pll_scan_plain)(
        *args, _t(phase0), _t(freq0), _t(th))
    if not fm:
        o0[:, 0] = phase0
    ph = torch.remainder(_t(ph), t_pll.TWO_PI).numpy()
    got = [ph, fr, o0] + ([o1] if fm else [])
    for g, w in zip(got, plain):
        assert np.array_equal(np.ascontiguousarray(g).view(np.int32),
                              w.numpy().view(np.int32))
