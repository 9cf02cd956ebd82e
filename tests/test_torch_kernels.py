"""The plain versions behind the port's CUDA kernels against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
tests/test_kernels.py runs them.  On CPU tensors each kernel wrapper takes
its plain version; the CUDA kernels themselves are held against these
plain versions on the card by chip_smoke.py.

Tolerances are the JAX kernel tests': 5e-5 x scale for mixdec and
fastfir, 1e-5 for the scans, 1e-3 dB for the S-meter, 1e-4 for the banded
resampler; for the sequential PLL loops the FMA rounding bounds stated at
their test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesdr_tpu.design.decimation_plan import plan_decimation
from cutesdr_tpu.demod import fm as j_fm
from cutesdr_tpu.demod import sam as j_sam
from cutesdr_tpu.kernels import resamp1, scan1
from cutesdr_tpu.kernels import seqloop as j_seq
from cutesdr_tpu.kernels.fastfir4 import FastFirFourStep
from cutesdr_tpu.kernels.mixdec import MixDecimate
from cutesdr_tpu.ops import resampler as j_rs
from cutesdr_tpu_torch import convert, kernels
from cutesdr_tpu_torch.demod import fm as t_fm
from cutesdr_tpu_torch.demod import sam as t_sam
from cutesdr_tpu_torch.kernels import fastfir, mixdec, resamp, scan
from cutesdr_tpu_torch.kernels import seqloop as t_seq
from cutesdr_tpu_torch.ops import decimator
from cutesdr_tpu_torch.ops import fastfir as ff_ops
from cutesdr_tpu_torch.ops import resampler as t_rs

torch.set_num_threads(1)


def _cplx(rng, n, scale):
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * scale).astype(np.complex64)


def _ang(got, want):
    """Largest wrapped angle difference."""
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return float(np.abs((d + np.pi) % (2 * np.pi) - np.pi).max())


@pytest.mark.parametrize("in_rate,tile_out", [(2_000_000.0, 256),
                                              (16_000_000.0, 64)])
def test_mixdec_plain_matches_pallas(in_rate, tile_out):
    """D = 32 (flagship plan) and D = 256 (CIC front stage, offset d = 1):
    the port's plain mix + decimate on the raw-tail carry equals the
    Pallas plane-native kernel across a carry boundary and a phase wrap,
    with an in-kernel DC cal."""
    rng = np.random.default_rng(10)
    plan = plan_decimation(in_rate, 20_000.0)
    tune = in_rate / 17.0
    md = MixDecimate(plan, tune, tile_out=tile_out, interpret=True)
    n = md.TO4 * md.G * md.lane * 2                 # two tiles per block
    dc = np.complex64(0.37 - 0.21j)
    jc = md.init_carry()._replace(phase_base=jnp.uint32(2**32 - 12345))
    tp, tc = mixdec.init(plan, tune, "cpu")
    tc = tc._replace(phase=torch.tensor(2**32 - 12345))
    assert tc.raw_tail.shape[-1] == md.halo
    assert tp.phase_inc == int(md.params.phase_inc)
    for _ in range(2):
        x = _cplx(rng, n, 100.0)
        xj = jnp.asarray(x)
        jc, jy = md.process_planes(md.params, jc, xj.real, xj.imag,
                                   jnp.asarray(dc))
        xt = torch.from_numpy(x)
        tc, ty = mixdec.process_planes(plan, tp, tc, xt.real, xt.imag,
                                       torch.tensor(dc))
        want = np.asarray(jy)
        np.testing.assert_allclose(ty.numpy(), want,
                                   atol=5e-5 * np.abs(want).max())
        np.testing.assert_array_equal(tc.raw_tail.numpy(),
                                      np.asarray(jc.raw_tail))
        assert int(tc.phase) == int(jc.phase_base)
    assert kernels.LAUNCHES["mixdec"] == 0          # CPU: plain version


def test_fastfir_plain_matches_pallas():
    rng = np.random.default_rng(11)
    fs = 62_500.0
    k = FastFirFourStep(100.0, 2800.0, 0.0, fs, interpret=True)
    tp, tc = ff_ops.init(100.0, 2800.0, 0.0, fs, "cpu")
    # natural-order H recovered from the kernel's pre-permuted planes
    np.testing.assert_array_equal(
        convert.h_from_permuted(k.params.h2).astype(np.complex64),
        tp.h_freq.numpy())
    kc = k.init_carry()
    for _ in range(2):
        x = _cplx(rng, 2048, 100.0)
        kc, jy = k(k.params, kc, jnp.asarray(x))
        tc, ty = fastfir.process(tp, tc, torch.from_numpy(x))
        want = np.asarray(jy)
        np.testing.assert_allclose(ty.numpy(), want,
                                   atol=5e-5 * np.abs(want).max())
        np.testing.assert_array_equal(tc.tail.numpy(), np.asarray(kc.tail))


@pytest.mark.parametrize("n", [65536, 65536 + 1000])
def test_first_order_scan_plain_matches_pallas(n):
    rng = np.random.default_rng(12)
    a = (0.99 + 0.005 * rng.random(n)).astype(np.float32)
    b = (rng.standard_normal(n) * 0.01).astype(np.float32)
    want = scan1.first_order_scan(jnp.asarray(a), jnp.asarray(b), -3.0,
                                  interpret=True)
    got = scan.first_order_scan(torch.from_numpy(a), torch.from_numpy(b),
                                np.float32(-3.0))
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 1e-5


def test_guess_round_plain_matches_pallas():
    rng = np.random.default_rng(13)
    n = 65536
    ra, fa = np.float32(1 / 125.0), np.float32(1 / 312.0)
    pk = (rng.standard_normal(n) * 0.3 - 3).astype(np.float32)
    pat = rng.random(n) > 0.5
    jx, jpat, jcount = scan1.guess_round(
        jnp.asarray(pk), jnp.asarray(pat.astype(np.float32)), np.float32(-3.0),
        ra, fa, interpret=True)
    tx, tpat, tcount = scan.guess_round(torch.from_numpy(pk),
                                        torch.from_numpy(pat),
                                        np.float32(-3.0), ra, fa)
    assert float(np.abs(tx.numpy() - np.asarray(jx)).max()) < 1e-5
    np.testing.assert_array_equal(tpat.numpy(), np.asarray(jpat) > 0.5)
    # the forgiveness predicates are bit-sensitive to x[n-1]; the two
    # prefixes associate differently (as in tests/test_kernels.py)
    assert abs(int(tcount) - int(jcount)) <= 4


def test_smeter_last_plain_matches_pallas():
    rng = np.random.default_rng(14)
    n = 65536
    mag = (rng.standard_normal(n) * 10 - 60).astype(np.float32)
    aa, ad = np.float32(1 / 625.0), np.float32(1 / 31250.0)
    ja, jd = scan1.smeter_last(jnp.asarray(mag), aa, ad, np.float32(-120.0),
                               np.float32(-120.0), interpret=True)
    ta, td = scan.smeter_last(torch.from_numpy(mag), aa, ad,
                              np.float32(-120.0), np.float32(-120.0))
    assert abs(float(ta) - float(ja)) < 1e-3
    assert abs(float(td) - float(jd)) < 1e-3
    assert scan.smeter_supported(n) and not scan.smeter_supported(n + 128)


@pytest.mark.parametrize("mode", ["fm", "sam"])
def test_seqloop_plain_matches_pallas(mode):
    """The K7/K8 plain versions against the Pallas kernels (interpret
    mode) on noise, the worst case, chained over blocks of 1024, 2048 and
    5120.  tests/test_kernels.py holds the Pallas kernels bitwise to the
    XLA scans; the port differs from both by the FMA rounding only:
    FM err within 2e-6 rad, SAM phases within 2e-6 rad (wrapped), and the
    bounds of tests/test_kernels.py on the state and the audio."""
    rng = np.random.default_rng(3 if mode == "fm" else 4)
    jm, tm = (j_fm, t_fm) if mode == "fm" else (j_sam, t_sam)
    jp, jc = jm.init(62_500.0)
    tp, tc = tm.init(62_500.0, "cpu")
    kernels.reset_launches()
    for n in (1024, 2048, 5120):
        x = _cplx(rng, n, 3000.0)
        th = np.arctan2(x.imag, x.real).astype(np.float32)
        args = lambda p, c: (p.pll_alpha, p.pll_beta, p.nco_limit,
                             c.nco_phase, c.nco_freq)
        if mode == "fm":
            jph, jfr, jfreqs, jerr = j_seq.fm_pll_scan(
                *args(jp, jc), jnp.asarray(th), interpret=True)
            tph, tfr, tfreqs, terr = t_seq.fm_pll_scan(*args(tp, tc),
                                                       torch.from_numpy(th))
            assert float(np.abs(terr.numpy() - np.asarray(jerr)).max()) < 2e-6
            jaudio, jdc = jax.jit(j_fm._dc_track)(jp, jfreqs,
                                                  jc.freq_error_dc)
            taudio, tdc = t_fm._dc_track(tp, tfreqs, tc.freq_error_dc)
            jaudio = np.asarray(jaudio)
            assert (float(np.abs(taudio.numpy() - jaudio).max())
                    < 1e-5 * float(np.abs(jaudio).max()))
            jc = jc._replace(nco_phase=jph, nco_freq=jfr, freq_error_dc=jdc)
            tc = tc._replace(nco_phase=tph, nco_freq=tfr, freq_error_dc=tdc)
        else:
            jph, jfr, jprev = j_seq.sam_pll_scan(
                *args(jp, jc), jnp.asarray(th), interpret=True)
            tph, tfr, tprev = t_seq.sam_pll_scan(*args(tp, tc),
                                                 torch.from_numpy(th))
            assert _ang(tprev.numpy(), jprev) < 2e-6
            jc = jc._replace(nco_phase=jph, nco_freq=jfr)
            tc = tc._replace(nco_phase=tph, nco_freq=tfr)
        assert _ang(float(tph), float(jph)) < 1e-5
        assert abs(float(tfr) - float(jfr)) < 1e-6
    assert not any(kernels.LAUNCHES.values())       # CPU: plain versions


@pytest.mark.parametrize("interp", [True, False])
def test_resample_band_plain_matches_pallas(interp):
    """K9's plain version against kernels/resamp1.resample_band in
    interpret mode, as tests/test_kernels.py runs it (complex planes at
    125/96, here n = 4,096 to keep interpret mode short): the output times
    are the same numbers, and the valid outputs agree within 1e-4 (the
    Pallas kernel's own bar against the banded form) in both the
    exact-position and the truncating-table mode."""
    rate = 62500.0 / 48000.0
    rng = np.random.default_rng(0)
    n = 4096
    x = _cplx(rng, n, 1.0)
    p, c = j_rs.init(rate, complex_input=True)
    cap = j_rs.max_out_for(n, rate)
    t_int, t_frac = j_rs._times(p, c.t0, jnp.arange(cap, dtype=jnp.float32))
    z = jnp.concatenate([c.tail, jnp.asarray(x)])
    yr, yi = resamp1.resample_band(z.real, z.imag, t_int, t_frac, cap, 28,
                                   rate, interp, interpret=True)
    want = np.asarray(yr + 1j * yi)

    tp, tc = t_rs.init(rate, "cpu", complex_input=True)
    K, M = t_rs.band_size(n, cap, 28)
    ti, tf = t_rs._times(tp, tc.t0[None, None],
                         torch.arange(K, dtype=torch.float32))
    np.testing.assert_array_equal(ti[0, :cap].numpy(), np.asarray(t_int))
    np.testing.assert_array_equal(tf[0, :cap].numpy(), np.asarray(t_frac))
    kernels.reset_launches()
    zt = torch.cat([tc.tail, torch.from_numpy(x)])[None]
    got = resamp.resample_band(zt, ti, tf, M, 28, interp)[0, :cap].numpy()
    assert kernels.LAUNCHES["resamp"] == 0          # CPU: plain version
    nv = int((ti[0, :cap] < n).sum())
    assert nv > 3000
    assert np.abs(got[:nv] - want[:nv]).max() < 1e-4


def test_resample_band_real_and_bank_rows():
    """A real input takes the same weights as a complex one's real plane,
    and each row of a bank equals its single-stream evaluation, bitwise."""
    rng = np.random.default_rng(1)
    rate = 78125.0 / 48000.0
    n = 2048
    p, _ = t_rs.init(rate, "cpu")
    K, M = t_rs.band_size(n, t_rs.max_out_for(n, rate), 28)
    t0 = torch.tensor([[0.0], [0.7], [1.3]])
    ti, tf = t_rs._times(p, t0, torch.arange(K, dtype=torch.float32))
    z = torch.from_numpy(_cplx(rng, 3 * (n + 28), 100.0).reshape(3, -1))
    yc = resamp.resample_band(z, ti, tf, M, 28, True)
    yr = resamp.resample_band(z.real.contiguous(), ti, tf, M, 28, True)
    assert torch.equal(yr, yc.real)
    for b in range(3):
        assert torch.equal(resamp.resample_band(z[b:b + 1], ti[b:b + 1],
                                                tf[b:b + 1], M, 28, True),
                           yc[b:b + 1])


# --- the CUDA kernels' work split, emulated on the CPU ---------------------
# The kernels themselves run only on the card (chip_smoke.py holds them
# against their plain versions there); these tests hold the index plans
# that csrc/mixdec.cu and csrc/fastfir.cu follow against the plain
# versions, in float32, so that a plan that drops, repeats or misplaces a
# term fails here.

N_SM = 132   # the H100's streaming multiprocessors


def _scatter_slot(p, lane):
    """The floats (first, count) that a lane of P holds after the
    reduce-scatter of 2R values, and whether it writes them."""
    cnt, first, writer, off = 2 * mixdec.R, 0, True, p // 2
    while off >= 1:
        if cnt > 1:
            cnt //= 2
            first += cnt if lane & off else 0
        elif lane & off:
            writer = False
        off //= 2
    return first, cnt, writer


def _mixdec_float_writes(n_out, n_ch, dec, ntaps, lp):
    """How many times the kernel writes each float of y [n_ch, n_out] (re,
    im interleaved): every block, warp, output group and lane, as the
    kernel walks them."""
    R, P = mixdec.R, mixdec.lanes(dec)
    S, warps = 32 // P, lp.threads // 32
    slots = [_scatter_slot(P, pl) for pl in range(P)]
    writes = np.zeros((n_ch, 2 * n_out), np.int64)
    for ch in range(n_ch):
        for tile in range(lp.n_tiles):
            o0 = tile * lp.tile_out
            outs = min(lp.tile_out, n_out - o0)
            groups = -(-outs // R)
            for warp in range(warps):
                # one chunk of phases: the warp walks the tile's groups;
                # several: the warp owns group ``warp`` through them
                starts = (range(warp * S, groups, warps * S) if dec <= 32
                          else [warp])
                for g0 in starts:
                    gi = g0 + np.arange(S)
                    assert gi.max() < lp.tile_out // R   # inside the window
                    for first, cnt, writer in slots:
                        if not writer:
                            continue
                        j = first + np.arange(cnt)
                        o = gi[:, None] * R + j[None, :] // 2
                        keep = o < outs
                        np.add.at(writes[ch],
                                  (2 * (o0 + gi[:, None] * R) + j)[keep], 1)
    return writes


@pytest.mark.parametrize("n_out,n_ch,dec,ntaps", [
    (262_144, 1, 32, 1063),     # the flagship
    (1024, 1, 32, 1063),        # the session's one-frame block
    (1024, 64, 128, 3127),      # the 64-channel bank
    (262_144, 2, 32, 1063),     # the stacked pair
    (1024, 1, 128, 1506),       # the CW plan (d = 3)
    (1000, 1, 4, 123),          # a 250 kHz input, a partial tile
    (4096, 1, 1, 1), (777, 3, 2, 51), (32_768, 1, 256, 6256)])
def test_mixdec_launch_plan_covers_every_output_once(n_out, n_ch, dec,
                                                    ntaps):
    lp = mixdec.launch_plan(n_out, n_ch, dec, ntaps, N_SM)
    assert lp.smem_bytes <= mixdec.SMEM_MAX
    assert lp.threads in (128, 256, 512)
    assert lp.tile_out % (mixdec.R * lp.threads // 32
                          * (32 // mixdec.lanes(dec))) == 0
    if dec > 32:
        assert lp.tile_out == mixdec.R * lp.threads // 32
    assert lp.n_tiles * lp.tile_out >= n_out > (lp.n_tiles - 1) * lp.tile_out
    writes = _mixdec_float_writes(n_out, n_ch, dec, ntaps, lp)
    assert (writes == 1).all()
    if (n_out, n_ch, dec) == (1024, 1, 32):
        assert lp.n_tiles >= 16              # over tens of SMs, not 4
    if n_out == 262_144:                     # window overlap <= ~15%
        assert (ntaps - dec) / (lp.tile_out * dec) <= 0.15


def _mixdec_emulated(z, taps, dec, n_out):
    """csrc/mixdec.cu's order of the sum in float32: lane p of P sums its
    phases p, p+P, .. in turn, each over k, into R outputs; then the P
    lanes' sums meet pairwise over the xor tree of the reduce-scatter."""
    L, P = taps.numel(), mixdec.lanes(dec)
    K = -(-L // dec)
    g = torch.zeros(K * dec)
    g[:L] = taps
    g = g.reshape(K, dec)
    u = torch.zeros((n_out + K) * dec, dtype=torch.complex64)
    u[:z.numel()] = z
    u = torch.view_as_real(u.reshape(n_out + K, dec))     # [m, p, 2]
    acc = torch.zeros(n_out, P, 2)
    for q in range(dec // P):
        ph = torch.arange(P) + q * P
        for k in range(K):
            acc = acc + g[k, ph][None, :, None] * u[k:k + n_out, ph]
    off = P // 2
    while off >= 1:
        acc = acc + acc[:, torch.arange(P) ^ off]
        off //= 2
    return torch.view_as_complex(acc[:, 0].contiguous())


@pytest.mark.parametrize("in_rate,bw", [(250_000.0, 20_000.0),   # D = 4
                                        (2e6, 20_000.0),         # D = 32
                                        (10e6, 20_000.0),        # D = 128
                                        (2e6, 1000.0)])          # d = 3
def test_mixdec_kernel_order_matches_fused(in_rate, bw):
    """The kernel's phase-to-lane, R-output sliding-window order of the
    sum equals ``decimator.fused_process`` to float32 roundoff."""
    rng = np.random.default_rng(12)
    plan = plan_decimation(in_rate, bw)
    tp, _ = mixdec.init(plan, 0.0, "cpu")
    dec, t = plan.decimation, decimator.tail_length(plan)
    n_out = 203
    z = torch.from_numpy(_cplx(rng, t + n_out * dec, 100.0))
    _, want = decimator.fused_process(plan, decimator.FusedParams(tp.h_eq),
                                      decimator.FusedCarry(z[:t]), z[t:])
    got = _mixdec_emulated(z, tp.taps, dec, n_out)
    assert torch.equal(tp.taps, tp.h_eq.flip(-1))
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               atol=2e-6 * float(want.abs().max()))


def _fft_emulated(x, inverse):
    """csrc/fastfir.cu's transform in complex64, pass by pass: the radices
    of ``fastfir.fft_plan``, butterfly j of each thread's share, the
    quarter-table twiddle indices rotated by powers of -i, the in-register
    radix-2 DIF network and its bit reversal, the Stockham write-back."""
    n = x.shape[-1]
    ept, radices = fastfir.fft_plan(n)
    tpf = n // ept
    tw = fastfir._twiddles(n, "cpu").numpy()
    quarter = max(n // 4, 1)
    c16 = np.exp(-2j * np.pi * np.arange(16) / 16).astype(np.complex64)
    if inverse:
        c16 = c16.conj()
    ns = 1
    for r in radices:
        j = (np.arange(tpf)[:, None] + tpf * np.arange(ept // r)[None, :]
             ).reshape(-1)
        assert np.array_equal(np.sort(j), np.arange(n // r))
        v = x[j[:, None] + np.arange(r)[None, :] * (n // r)]
        if ns > 1:
            m = (j % ns)[:, None] * np.arange(r)[None, :] * (n // (ns * r))
            assert m.max() < n
            w = tw[m % quarter] * (-1j) ** (m // quarter)
            v = v * (w.conj() if inverse else w).astype(np.complex64)
        length = r
        while length >= 2:                     # radix-2 DIF in registers
            h = length // 2
            v = v.reshape(len(j), r // length, length)
            a, b = v[..., :h].copy(), v[..., h:].copy()
            v[..., :h] = a + b
            v[..., h:] = (a - b) * c16[np.arange(h) * (16 // length)]
            v = v.reshape(len(j), r)
            length = h
        bits = r.bit_length() - 1
        rev = [int(f"{i:0{bits}b}"[::-1], 2) if bits else 0 for i in range(r)]
        v = v[:, rev]
        y = np.empty_like(x)
        dst = (j // ns) * ns * r + j % ns
        y[dst[:, None] + np.arange(r)[None, :] * ns] = v
        x, ns = y, ns * r
    return x


@pytest.mark.parametrize("nfft", [1 << k for k in range(2, 14)])
def test_fastfir_fft_plan_matches_torch_fft(nfft):
    """Every nfft the kernel takes: its radix plan and twiddle indices,
    emulated pass by pass, give torch.fft's forward and (unscaled)
    inverse transforms within K2's tolerance, 5e-5 x peak."""
    rng = np.random.default_rng(13)
    ept, radices = fastfir.fft_plan(nfft)
    assert int(np.prod(radices)) == nfft and all(ept % r == 0
                                                 for r in radices)
    assert nfft // ept <= fastfir.MAX_THREADS
    x = _cplx(rng, nfft, 100.0)
    for inverse, ref in ((False, torch.fft.fft),
                         (True, lambda a: torch.fft.ifft(a) * nfft)):
        want = ref(torch.from_numpy(x)).numpy()
        got = _fft_emulated(x, inverse)
        np.testing.assert_allclose(got, want,
                                   atol=5e-5 * np.abs(want).max())


def test_fastfir_cpu_stream_keeps_tail_when_block_is_shorter():
    """A block shorter than the tail (4096/3073: 1,024 new samples, a
    3,072-sample history): the carry keeps the history's last samples,
    call after call, equal to filtering the concatenated stream."""
    rng = np.random.default_rng(14)
    tp, tc = ff_ops.init(100.0, 2800.0, 0.0, 62_500.0, "cpu", nfft=4096,
                         ntaps=3073)
    xs = [torch.from_numpy(_cplx(rng, 1024, 100.0)) for _ in range(4)]
    got = []
    for x in xs:
        tc, y = fastfir.process(tp, tc, x)
        got.append(y)
    z = torch.cat([torch.zeros(3072, dtype=torch.complex64), *xs])
    want = fastfir.filter_frames_plain(tp.h_freq, z, 3073)
    np.testing.assert_allclose(torch.cat(got).numpy(), want.numpy(),
                               atol=1e-5 * float(want.abs().max()))
    assert torch.equal(tc.tail, z[-3072:])


@pytest.mark.parametrize("nfft,frames,want", [
    (2048, 256, 1),       # the flagship: one 128-thread frame a block
    (2048, 1, 1),         # the session's block
    (2048, 64, 1),        # K6's 64 x 1
    (2048, 1024, 2),      # K6's 4 x 256: two frames a block
    (512, 8, 1), (64, 4096, 31), (8192, 512, 1)])
def test_fastfir_frames_per_block(nfft, frames, want):
    """Several frames share a block only when the call has frames to
    spare beyond one per SM, and a block never exceeds the kernel's
    thread limit."""
    fpb = fastfir.frames_per_block(nfft, frames, N_SM)
    assert fpb == want
    assert fpb * (nfft // fastfir.fft_plan(nfft)[0]) <= fastfir.MAX_THREADS


def test_mixdec_launch_plan_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        mixdec.launch_plan(1024, 1, 24, 100, N_SM)      # D not 2^k
    with pytest.raises(ValueError):
        mixdec.launch_plan(1024, 1, 32, 40_000, N_SM)   # taps beyond smem
