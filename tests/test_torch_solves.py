"""The chunked schedules of K4 over rows, N3h and N2, emulated in torch on
the CPU, against the plain versions and the JAX package.

The CUDA kernels (``csrc/scan.cu`` ``solve_kernel``/``solve_rows_kernel``
and ``hang_kernel``/``hang_rows_kernel``, ``csrc/iir.cu``) cut each row
into chunks, compose each chunk's maps, carry the chunks' aggregates
forward in order and step every chunk from its start value; a guess-verify
solve freezes a row once it validates and stops when every row has.  The
emulations below run that schedule with a chunk of ``chunk`` samples
(small here, so that short rows span several chunks):

* K4 rows: the two-rate averager, warm start and rounds, each round's
  affine solve chunk by chunk, rows frozen once their unforgiven
  mismatches are 0;
* N3h: hang mode's decay solve, whose distance since the last rise carries
  across a chunk boundary as the max of the earlier chunks' last rises,
  and whose hold windows span boundaries;
* N2: the biquad's 2x2 affine maps, each chunk's aggregate composed into
  the next chunk's start state.

Each is held against its plain version (the port's CPU path) and JAX's
solve (XLA on the CPU, vmapped over rows as JAX's banks run it); the
wrappers' dispatch (plain versions for CPU tensors, no launch counted)
and ``set_tune_freqs``'s in-place write are checked too.  The kernels
themselves run only on the card: ``chip_smoke.py`` holds them to their
plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesdr_tpu.ops import agc as j_agc
from cutesdr_tpu.ops import iir as j_iir
from cutesdr_tpu_torch import kernels
from cutesdr_tpu_torch.design.iir_biquad import biquad_lowpass
from cutesdr_tpu_torch.kernels import iir as iir_k
from cutesdr_tpu_torch.kernels import scan
from cutesdr_tpu_torch.ops import agc as t_agc
from cutesdr_tpu_torch.ops import iir as t_iir
from cutesdr_tpu_torch.ops import nco
from cutesdr_tpu_torch.pipeline import receiver as rx
from cutesdr_tpu_torch.pipeline import stepgraph
from cutesdr_tpu_torch.shard import channels as t_ch

torch.set_num_threads(1)

FS = 15_625.0
NO_RISE = -(1 << 30)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _peaks(seed: int, rows: int, n: int, step: int = 128) -> torch.Tensor:
    """AGC window peaks of seeded noise under stepping envelopes, one row
    a stream (different envelopes: rows take different rounds)."""
    rng = np.random.default_rng(seed)
    cfg = t_agc.AgcConfig(True, False, FS)
    c = t_agc.init_carry(cfg, "cpu")
    out = []
    for _ in range(rows):
        env = np.repeat(10.0 ** rng.uniform(1, 4, -(-n // step)), step)[:n]
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * env
        out.append(t_agc._prefix(cfg, c, _t(x.astype(np.complex64)))[2])
    return torch.stack(out)


# ------------------------------------------------------------ schedules --

ITEMS = 8                     # elements a thread composes (scan_common.cuh)


def _fma(a, b, c):
    """fmaf: a*b + c rounded once (the product is exact in double)."""
    return (a.double() * b.double() + c.double()).float()


def _compose(l, r):
    """Affine maps x -> a*x + b, "l then r", as ``scan_common.cuh``."""
    return l[0] * r[0], _fma(r[0], l[1], r[1])


def _chunked_affine(A: torch.Tensor, B: torch.Tensor, x0: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """x[i] = A[i]*x[i-1] + B[i] over [C, n] rows from x0 [C], as the
    kernels schedule it: a chunk's threads compose ITEMS elements each in
    order, an ordered (Hillis-Steele) block scan gives each thread its
    prefix and the chunk its map, the chunks' start values compose the
    earlier chunks' maps in order from x0, and each thread steps its
    elements from its prefix applied to the start (fmaf throughout)."""
    C, n = B.shape
    nch = -(-n // chunk)
    pad = nch * chunk - n
    T = chunk // ITEMS
    Ac = torch.cat([A, A.new_ones(C, pad)], -1).reshape(C, nch, T, ITEMS)
    Bc = torch.cat([B, B.new_zeros(C, pad)], -1).reshape(C, nch, T, ITEMS)
    t = (A.new_ones(C, nch, T), B.new_zeros(C, nch, T))
    for k in range(ITEMS):
        t = _compose(t, (Ac[..., k], Bc[..., k]))
    inc, d = t, 1
    while d < T:
        sh = lambda v, fill: torch.cat([v.new_full((C, nch, d), fill),
                                        v[..., :-d]], -1)
        inc = _compose((sh(inc[0], 1.0), sh(inc[1], 0.0)), inc)
        d *= 2
    ex = (torch.cat([A.new_ones(C, nch, 1), inc[0][..., :-1]], -1),
          torch.cat([B.new_zeros(C, nch, 1), inc[1][..., :-1]], -1))
    starts, s = B.new_empty(C, nch), x0
    for c in range(nch):
        starts[:, c] = s
        s = _fma(inc[0][:, c, -1], s, inc[1][:, c, -1])
    v = _fma(ex[0], starts[..., None], ex[1])
    x = torch.empty_like(Bc)
    for k in range(ITEMS):
        v = _fma(Ac[..., k], v, Bc[..., k])
        x[..., k] = v
    return x.reshape(C, -1)[:, :n]


def _k4_schedule(peak, x0, rise, fall, n_iters: int, chunk: int):
    """K4 over rows: (x, each row converged, rounds run)."""
    C, n = peak.shape
    one = np.float32(1.0)
    ag = scan.warm_rate(rise, fall)
    x = _chunked_affine(torch.full_like(peak, one - ag), peak * ag, x0, chunk)
    pat = peak > scan.shift1(x, x0)
    active = torch.ones(C, dtype=torch.bool)
    ok = torch.zeros(C, dtype=torch.bool)
    rounds = 0
    while True:
        rounds += 1
        A = torch.where(pat, one - rise, one - fall)
        B = torch.where(pat, peak * rise, peak * fall)
        xn = _chunked_affine(A, B, x0, chunk)
        prev = scan.shift1(xn, x0)
        new = peak > prev
        fused = lambda c, b: (prev.double() * float(c) + b.double()).float()
        same = fused(one - rise, peak * rise) == fused(one - fall, peak * fall)
        count = ((new != pat) & (peak != prev) & ~same).sum(-1)
        x = torch.where(active[:, None], xn, x)
        pat = torch.where(active[:, None], new, pat)
        done = active & (count == 0)
        ok |= done
        active &= ~done
        if not bool(active.any()) or rounds >= n_iters:
            return x, ok, rounds


def _last_rise(pat: torch.Tensor, virtual: torch.Tensor, chunk: int):
    """The last rise at or before each element, chunk by chunk: within a
    chunk a running max of the rising indices, from the carry into the
    chunk (the max of the earlier chunks' last rises, or the virtual rise
    before the block).  Returns (last rise [C, n], carry [C, nch])."""
    C, n = pat.shape
    nch = -(-n // chunk)
    idx = torch.arange(n).expand(C, n)
    rising = torch.where(pat, idx, NO_RISE)
    rising = torch.cat([rising, rising.new_full((C, nch * chunk - n),
                                                NO_RISE)], -1)
    rising = rising.reshape(C, nch, chunk)
    chunk_last = rising.amax(-1)
    before = torch.cat([virtual[:, None], chunk_last[:, :-1]], -1)
    carry = torch.cummax(before, -1).values
    inside = torch.cummax(rising, -1).values
    last = torch.maximum(inside, carry[..., None]).reshape(C, -1)[:, :n]
    return last, carry


def _n3h_schedule(peak, d0, timer0, rise, fall, hang: int, n_iters: int,
                  chunk: int):
    """N3h over rows: (d, timer, each row converged, rounds run, the
    carries into the chunks of the last round)."""
    C, n = peak.shape
    idx = torch.arange(n)
    virtual = -1 - timer0.long()
    pat = peak > scan.shift1(peak, d0)
    d = torch.empty_like(peak)
    timer = torch.empty(C, dtype=torch.int32)
    active = torch.ones(C, dtype=torch.bool)
    ok = torch.zeros(C, dtype=torch.bool)
    rounds = 0
    while True:
        rounds += 1
        last, carry = _last_rise(pat, virtual, chunk)
        dist = idx - last
        hold = ~pat & (scan.shift1(dist, timer0.long()) < hang)
        alpha = torch.where(pat, torch.tensor(rise), torch.where(
            hold, torch.tensor(0.0), torch.tensor(fall)))
        dn = _chunked_affine(1.0 - alpha, alpha * peak, d0, chunk)
        new = peak > scan.shift1(dn, d0)
        count = (new != pat).sum(-1)
        keep = active[:, None]
        d = torch.where(keep, dn, d)
        timer = torch.where(active, dist[:, -1].clamp(max=hang).int(), timer)
        pat = torch.where(keep, new, pat)
        done = active & (count == 0)
        ok |= done
        active &= ~done
        if not bool(active.any()) or rounds >= n_iters:
            return d, timer, ok, rounds, carry


def _n2_schedule(x: torch.Tensor, coefs, w1, w2, chunk: int):
    """N2 over [R, n] rows: each chunk's 2x2 aggregate (M^len, b) composed
    in order, the chunks' start states the aggregates applied one after
    another to (w[-1], w[-2]), each chunk stepped from its start with y
    formed in the same pass.  Returns (y, w[n-1], w[n-2])."""
    b0, b1, b2, a1, a2 = (np.float32(c) for c in coefs)
    R, n = x.shape
    nch = -(-n // chunk)
    xc = torch.cat([x, x.new_zeros(R, nch * chunk - n)], -1).reshape(
        R, nch, chunk)
    lens = torch.clamp(n - torch.arange(nch) * chunk, max=chunk)
    m = torch.tensor([[-a1, -a2], [1.0, 0.0]], dtype=torch.float32)
    A = torch.eye(2).expand(R, nch, 2, 2).clone()
    b = x.new_zeros(R, nch, 2)
    for k in range(chunk):
        live = (k < lens)[None, :, None]
        nb = torch.stack([m[0, 0] * b[..., 0] + m[0, 1] * b[..., 1]
                          + xc[..., k], b[..., 0]], -1)
        b = torch.where(live, nb, b)
        A = torch.where(live[..., None], m @ A, A)
    s = torch.stack([w1.reshape(-1).expand(R), w2.reshape(-1).expand(R)],
                    -1).float()
    starts = x.new_empty(R, nch, 2)
    for c in range(nch):
        starts[:, c] = s
        s = (A[:, c] @ s[..., None])[..., 0] + b[:, c]
    y = torch.empty_like(xc)
    p1, p2 = starts[..., 0], starts[..., 1]
    for k in range(chunk):
        w = xc[..., k] - a1 * p1 - a2 * p2
        y[..., k] = b0 * w + b1 * p1 + b2 * p2
        p1, p2 = w, p1
    return y.reshape(R, -1)[:, :n], s[:, 0], s[:, 1]


# ---------------------------------------------------------------- bars --

def _exact_two_rate(peak, x0, rise, fall, x):
    """The float64 solve of the two-rate averager with the pattern that
    ``x`` induces and the float32 rates: each solve's own reassociation
    error shows against it."""
    one = np.float32(1.0)
    pat = peak > scan.shift1(torch.as_tensor(np.array(x)), x0)
    A = torch.where(pat, float(one - rise), float(one - fall))
    B = torch.where(pat, peak * rise, peak * fall)
    return scan.first_order_recurrence(A.double(), B.double(), x0.double())


def _exact_hang(peak, d0, timer0, rise, fall, hang, d):
    """The float64 solve of hang mode's decay averager with the pattern
    that ``d`` induces."""
    from cutesdr_tpu_torch.ops.util import distance_since_last_true
    pat = peak > scan.shift1(torch.as_tensor(np.array(d)), d0)
    dist = distance_since_last_true(pat, timer0)
    hold = ~pat & (scan.shift1(dist, timer0) < hang)
    alpha = torch.where(pat, float(rise), torch.where(hold, 0.0, float(fall)))
    alpha = alpha.float()
    return scan.first_order_recurrence((1.0 - alpha).double(),
                                       (alpha * peak).double(), d0.double())


def _hold_to_bar(got, plain, ref, exact):
    """K4's bar (PERF.md §6): ``got`` no farther from the float64 solve of
    its pattern than the plain version is from its own, or 1e-5 decades;
    within 1e-5 plus the plain version's own error of the plain solve,
    and of the JAX package's ``ref`` plus its own error too."""
    err = lambda v: float((torch.as_tensor(np.array(v)).double()
                           - exact(v)).abs().max())
    e_g, e_p, e_r = err(got), err(plain), err(ref)
    assert e_g <= max(e_p, 1e-5)
    diff = lambda a, b: float((torch.as_tensor(np.array(a)).double()
                               - torch.as_tensor(np.array(b)).double()
                               ).abs().max())
    assert diff(got, plain) <= 1e-5 + e_p
    assert diff(got, ref) <= 1e-5 + e_p + e_r


# ----------------------------------------------------------------- K4 --

def _jax_two_rate_rows(peak, x0, rise, fall, n_iters):
    f = jax.jit(jax.vmap(lambda x0_, pk: j_agc._two_rate_parallel(
        jnp.float32(rise), jnp.float32(fall), x0_, pk, n_iters)))
    x, valid = f(jnp.asarray(x0.numpy()), jnp.asarray(peak.numpy()))
    return np.asarray(x), np.asarray(valid)


@pytest.mark.parametrize("n,chunk", [(1024, 2048), (1000, 256),
                                     (2048, 2048)])
@pytest.mark.parametrize("averager", ["attack", "decay"])
def test_k4_rows_schedule(n, chunk, averager):
    """Rows of one chunk (1,024 and 2,048 at the kernel's 2,048) and of
    several (1,000 in chunks of 256): the schedule's x held to the plain
    solve and JAX's vmapped solve at K4's bar (``_hold_to_bar``), each
    row's flag equal to that row solved alone (plain) and to JAX's, rows
    that converge in different rounds frozen (each equal to its own
    solve)."""
    p = t_agc.make_params(t_agc.AgcConfig(True, False, FS), -100.0, 30.0,
                          0.0, 200.0)
    rise, fall = ((p.attack_rise_alpha, p.attack_fall_alpha)
                  if averager == "attack" else
                  (p.decay_rise_alpha, p.decay_fall_alpha))
    peak = _peaks(7, 4, n, step=64)
    x0 = torch.tensor([-5.0, -4.0, -3.5, -6.0])
    x, ok, rounds = _k4_schedule(peak, x0, rise, fall, t_agc.GUESS_ITERS,
                                 chunk)
    xp, okp, rp = scan.guess_verify_solve_plain(peak, x0, rise, fall,
                                                t_agc.GUESS_ITERS)
    alone = [scan.guess_verify_solve_plain(peak[c], x0[c], rise, fall,
                                           t_agc.GUESS_ITERS)
             for c in range(4)]
    assert ok.tolist() == [bool(o) for _, o, _ in alone]
    assert bool(ok.all()) == bool(okp) and abs(rounds - rp) <= 1
    jx, jvalid = _jax_two_rate_rows(peak, x0, rise, fall, t_agc.GUESS_ITERS)
    assert jvalid.tolist() == ok.tolist()
    _hold_to_bar(x, xp, jx, lambda v: _exact_two_rate(peak, x0, rise, fall,
                                                      v))
    for c in range(4):
        xc, okc, _ = _k4_schedule(peak[c:c + 1], x0[c:c + 1], rise, fall,
                                  t_agc.GUESS_ITERS, chunk)
        assert torch.equal(xc[0], x[c]) and bool(okc[0]) == bool(ok[c])


def test_k4_rows_freeze_and_cut():
    """Rows that validate in different rounds: a row is left as its own
    round left it; cut at one round, the rows that have not validated say
    so, as the plain loop and JAX do (the bank's forced fallback)."""
    p = t_agc.make_params(t_agc.AgcConfig(True, False, FS), -100.0, 30.0,
                          0.0, 200.0)
    rise, fall = p.attack_rise_alpha, p.attack_fall_alpha
    rng = np.random.default_rng(3)
    smooth = _peaks(11, 1, 1000, step=1000)
    rough = _t((-3.0 + 0.3 * rng.standard_normal((1, 1000))).astype(
        np.float32))
    peak = torch.cat([smooth, rough])
    x0 = torch.tensor([-5.0, -3.0])
    rounds_alone = [_k4_schedule(peak[c:c + 1], x0[c:c + 1], rise, fall,
                                 t_agc.GUESS_ITERS, 256)[2] for c in range(2)]
    assert rounds_alone[0] < rounds_alone[1]
    x, ok, rounds = _k4_schedule(peak, x0, rise, fall, t_agc.GUESS_ITERS, 256)
    assert ok.tolist() == [True, True] and rounds == max(rounds_alone)
    _, cut, _ = _k4_schedule(peak, x0, rise, fall, 1, 256)
    _, okp, _ = scan.guess_verify_solve_plain(peak, x0, rise, fall, 1)
    _, jvalid = _jax_two_rate_rows(peak, x0, rise, fall, 1)
    assert cut.tolist() == jvalid.tolist() and not bool(okp)
    assert cut.tolist() == [rounds_alone[0] == 1, False]


# ---------------------------------------------------------------- N3h --

def _hang_case(hang_ms: float = 2.0):
    """Spikes 6 samples before each 256-sample chunk boundary and a hold
    of ``hang_ms`` (31 samples at 15.625 kHz for 2 ms) that crosses it;
    rows whose timers carry in at 0, mid-hold and at the cap."""
    p = t_agc.make_params(t_agc.AgcConfig(True, True, FS), -100.0, 30.0,
                          0.0, hang_ms)
    rng = np.random.default_rng(5)
    n = 1000
    base = (-4.0 + 0.05 * rng.standard_normal((3, n))).astype(np.float32)
    base[:, 250::256] = -1.0
    base[1, 100:104] = -0.5
    d0 = torch.tensor([-4.0, -2.0, -3.0])
    timer0 = torch.tensor([0, p.hang_time // 2, p.hang_time],
                          dtype=torch.int32)
    return p, _t(base), d0, timer0


def _jax_hang_rows(decay_ms, peak, d0, timer0, n_iters):
    jp = j_agc.make_params(j_agc.AgcConfig(True, True, FS), -100.0, 30.0,
                           0.0, decay_ms)
    f = jax.jit(jax.vmap(lambda d0_, t0, pk: j_agc._hang_decay_parallel(
        jp, d0_, t0, pk, n_iters)))
    d, timer, valid = f(jnp.asarray(d0.numpy()), jnp.asarray(timer0.numpy()),
                        jnp.asarray(peak.numpy()))
    return np.asarray(d), np.asarray(timer), np.asarray(valid)


@pytest.mark.parametrize("chunk", [256, 2048])
def test_n3h_schedule_carries_the_last_rise(chunk):
    """Hold windows across chunk boundaries: the carry into a chunk is the
    last rise of the chunk before it (a spike 6 samples before the
    boundary, a hold of 31 samples across it), and the schedule's
    patterns, timers and flags equal the plain solve's and JAX's, d held
    to both at K4's bar (``_hold_to_bar``)."""
    p, peak, d0, timer0 = _hang_case()
    args = (p.decay_rise_alpha, p.decay_fall_alpha, p.hang_time)
    d, timer, ok, rounds, carry = _n3h_schedule(peak, d0, timer0, *args,
                                                t_agc.GUESS_ITERS, chunk)
    if chunk == 256:
        rose = peak[:, 250] > scan.shift1(d, d0)[:, 250]
        assert bool(rose.all())
        assert carry[:, 1].tolist() == [250, 250, 250]
        assert p.hang_time > 256 - 250           # held across the boundary
    dp, tp, okp = scan.hang_solve_plain(peak, d0, timer0, *args,
                                        t_agc.GUESS_ITERS)
    alone = [scan.hang_solve_plain(peak[c], d0[c], timer0[c], *args,
                                   t_agc.GUESS_ITERS)[2] for c in range(3)]
    assert ok.tolist() == [bool(o) for o in alone]
    assert bool(ok.all()) == bool(okp)
    assert torch.equal(timer, tp)
    pat = lambda v: peak > scan.shift1(torch.as_tensor(np.array(v)), d0)
    assert torch.equal(pat(d), pat(dp))
    jd, jt, jvalid = _jax_hang_rows(2.0, peak, d0, timer0,
                                    t_agc.GUESS_ITERS)
    assert jvalid.tolist() == ok.tolist() and torch.equal(pat(d), pat(jd))
    np.testing.assert_array_equal(timer.numpy(), jt)
    _hold_to_bar(d, dp, jd, lambda v: _exact_hang(peak, d0, timer0, *args,
                                                  v))


def test_n3h_schedule_keyed_and_cut():
    """A keyed envelope (hard on/off every 300 samples, the class of bench
    row 12) over rows of several chunks: equal to the plain solve and
    JAX's; cut at one round, not converged, as the plain loop and JAX."""
    p = t_agc.make_params(t_agc.AgcConfig(True, True, FS), -100.0, 30.0,
                          0.0, 20.0)
    rng = np.random.default_rng(9)
    n = 1200
    key = np.where((np.arange(n) // 300) % 2 == 0, 8000.0, 80.0)
    cfg = t_agc.AgcConfig(True, True, FS)
    c = t_agc.init_carry(cfg, "cpu")
    rows = []
    for _ in range(2):
        x = key * np.exp(1j * rng.uniform(0, 2 * np.pi, n))
        rows.append(t_agc._prefix(cfg, c, _t(x.astype(np.complex64)))[2])
    peak = torch.stack(rows)
    d0 = torch.tensor([-5.0, -1.0])
    timer0 = torch.tensor([0, 3], dtype=torch.int32)
    args = (p.decay_rise_alpha, p.decay_fall_alpha, p.hang_time)
    for iters in (t_agc.GUESS_ITERS, 1):
        d, timer, ok, rounds, _ = _n3h_schedule(peak, d0, timer0, *args,
                                                iters, 256)
        dp, tp, okp = scan.hang_solve_plain(peak, d0, timer0, *args, iters)
        jd, jt, jvalid = _jax_hang_rows(20.0, peak, d0, timer0, iters)
        assert bool(ok.all()) == bool(okp) and jvalid.tolist() == ok.tolist()
        assert torch.equal(timer, tp)
        np.testing.assert_array_equal(timer.numpy(), jt)
        if iters > 1:
            _hold_to_bar(d, dp, jd, lambda v: _exact_hang(
                peak, d0, timer0, *args, v))
        assert bool(ok.all()) == (iters > 1)


# ----------------------------------------------------------------- N2 --

def _biquad64(x, coefs, w1, w2):
    b0, b1, b2, a1, a2 = (float(np.float32(c)) for c in coefs)
    x = x.double().numpy()
    y = np.empty_like(x)
    ends = np.empty((2, x.shape[0]))
    for r in range(x.shape[0]):
        p1, p2 = float(w1[r]), float(w2[r])
        for i, v in enumerate(x[r].tolist()):
            w = v - a1 * p1 - a2 * p2
            y[r, i] = b0 * w + b1 * p1 + b2 * p2
            p1, p2 = w, p1
        ends[:, r] = p1, p2
    return y, ends


@pytest.mark.parametrize("fs", [15_625.0, 62_500.0])
def test_n2_schedule_aggregates_across_chunks(fs):
    """FM's 3 kHz lowpass at its rates (62.5 kHz: the poles closest to the
    unit circle): the 2x2 aggregates carried over chunks of 256 (1,000
    samples, a partial last chunk) give y and the final states within
    1.5x the plain version's distance from the float64 solve (or 2 ulps
    of the output's scale), and within 1e-5 of JAX's
    ``lax.associative_scan``, from nonzero states."""
    coefs = biquad_lowpass(3000.0, 1.0, fs)
    params = t_iir.IirParams(*(np.float32(c) for c in coefs))
    rng = np.random.default_rng(13)
    x = _t((300.0 * rng.standard_normal((3, 1000))).astype(np.float32))
    w1 = _t(rng.standard_normal(3).astype(np.float32) * 100)
    w2 = _t(rng.standard_normal(3).astype(np.float32) * 100)
    y, e1, e2 = _n2_schedule(x, params, w1, w2, 256)
    yp, p1, p2 = iir_k.biquad_plain(x, params, w1, w2)
    y64, ends = _biquad64(x, params, w1, w2)
    eps = float(np.finfo(np.float32).eps)
    for got, plain, exact in ((y, yp, y64), (e1, p1, ends[0]),
                              (e2, p2, ends[1])):
        err = np.abs(got.double().numpy() - exact).max()
        err_p = np.abs(plain.double().numpy() - exact).max()
        assert err <= max(1.5 * err_p, 2 * eps * np.abs(exact).max())
    jp = j_iir.IirParams(*(jnp.float32(c) for c in params))
    jc = j_iir.IirCarry(jnp.asarray(w1.numpy()), jnp.asarray(w2.numpy()))
    jcarry, jy = jax.jit(jax.vmap(j_iir.process, in_axes=(None, 0, 0)))(
        jp, jc, jnp.asarray(x.numpy()))
    scale = float(np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5 * scale)
    np.testing.assert_allclose(e1.numpy(), np.asarray(jcarry.w1),
                               atol=1e-5 * scale)


# ------------------------------------------------------------ dispatch --

def test_wrappers_take_the_plain_versions_on_the_cpu():
    """CPU tensors take each new kernel's plain version, bitwise, and
    count no launch: K4 over rows (``guess_verify_solve``), N3h
    (``hang_solve``), N2 (``biquad``, real and complex, and
    ``ops/iir.process`` through it)."""
    kernels.reset_launches()
    p = t_agc.make_params(t_agc.AgcConfig(True, True, FS), -100.0, 30.0,
                          0.0, 2.0)
    peak = _peaks(2, 3, 600)
    x0 = torch.tensor([-5.0, -4.0, -3.0])
    got = scan.guess_verify_solve(peak, x0, p.attack_rise_alpha,
                                  p.attack_fall_alpha, 24)
    want = scan.guess_verify_solve_plain(peak, x0, p.attack_rise_alpha,
                                         p.attack_fall_alpha, 24)
    assert torch.equal(got[0], want[0]) and got[1:] == want[1:]
    timer0 = torch.tensor([0, 5, 31], dtype=torch.int32)
    args = (peak, x0, timer0, p.decay_rise_alpha, p.decay_fall_alpha,
            p.hang_time, 24)
    got, want = scan.hang_solve(*args), scan.hang_solve_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    coefs = t_iir.init(biquad_lowpass(3000.0, 1.0, FS), "cpu")[0]
    rng = np.random.default_rng(1)
    for cplx in (False, True):
        x = rng.standard_normal((2, 333)).astype(np.float32)
        if cplx:
            x = (x + 1j * rng.standard_normal((2, 333))).astype(np.complex64)
        x = _t(x)
        w = torch.zeros(2, dtype=x.dtype)
        got, want = iir_k.biquad(x, coefs, w, w), iir_k.biquad_plain(
            x, coefs, w, w)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    carry, y = t_iir.process(coefs, t_iir.IirCarry(w[0], w[0]), x[0])
    assert torch.equal(y, iir_k.biquad_plain(x[0], coefs, w[0], w[0])[0])
    assert not any(kernels.LAUNCHES.values())


# --------------------------------------------------------------- banks --

class _EagerGraph:
    """``StepGraph``'s interface over the eager step on static buffers (a
    capture needs the card), with its block check."""

    made = []
    _fits = stepgraph.StepGraph._fits

    def __init__(self, step, params, state, block, device):
        self.step, self.params, self.block = step, params, block
        self.iq = torch.zeros(block, dtype=torch.complex64)
        self.state = stepgraph.clone(state)
        _EagerGraph.made.append(self)

    def run(self, iq):
        return self.run_planes(iq.real, iq.imag)

    def run_planes(self, re, im):
        self._fits(re, im)
        new, out = self.step(self.params, self.state, re.float(), im.float())
        stepgraph._copy_into(self.state, new)
        return stepgraph.clone(out)

    def load_state(self, state):
        stepgraph._copy_into(self.state, state)


def test_set_tune_freqs_writes_in_place():
    """The bank's DDS increments are one device tensor, written in place
    by ``set_tune_freqs`` (a graph captured it by pointer)."""
    cfg = rx.ReceiverConfig(mode="usb", input_rate=10e6)
    freqs = [-4.5e6 + 140e3 * i for i in range(4)]
    bank = t_ch.ChannelBank(cfg, freqs, "cpu")
    inc = bank.params.dec.phase_inc
    ptr = inc.data_ptr()
    new = [f + 1234.0 for f in freqs]
    bank.set_tune_freqs(new)
    assert bank.params.dec.phase_inc is inc and inc.data_ptr() == ptr
    assert inc.tolist() == [nco.phase_increment(f, cfg.input_rate)
                            for f in new]


@pytest.mark.parametrize("kind", ["bank", "stacked"])
def test_bank_graph_path_matches_eager(monkeypatch, kind):
    """A bank's graph bookkeeping with the capture stood in for: four
    blocks bitwise the eager bank step with a retune (``set_tune_freqs``:
    the graph's copy of the increments written in place too) and a volume
    change on block 2, one capture; ``state`` reads the graph's buffers;
    the rule holds for the bank; a mis-shaped block is refused."""
    monkeypatch.setattr(rx, "bank_graph_rule", lambda cfg, device: True)
    monkeypatch.setattr(stepgraph, "StepGraph", _EagerGraph)
    _EagerGraph.made = []
    cfg = rx.ReceiverConfig(mode="usb", agc_hang=True)
    freqs = [100e3, 150e3]
    make = t_ch.ChannelBank if kind == "bank" else t_ch.StackedReceiver
    g, e = make(cfg, freqs, "cpu"), make(cfg, freqs, "cpu")
    assert g.graphed
    shape = (cfg.block_size,) if kind == "bank" else (2, cfg.block_size)
    rng = np.random.default_rng(4)
    params, state = stepgraph.clone(e.params), e.state
    for i in range(4):
        x = _t(((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                * 300.0).astype(np.complex64))
        if i == 2:
            moved = [f + 25.0 for f in freqs]
            g.set_tune_freqs(moved)
            g.params = rx.volume_params(g.params, 61)
            incs = [nco.phase_increment(f, cfg.input_rate) for f in moved]
            params = rx.volume_params(params._replace(
                dec=params.dec._replace(phase_inc=torch.tensor(incs))), 61)
        out = g.process(x)
        state, want = rx.bank_receiver_step(cfg, params, state, x,
                                            kind == "bank")
        for f in ("audio", "n_audio", "smeter_ave_db", "smeter_peak_db"):
            a, b = getattr(out, f), getattr(want, f)
            assert torch.equal(a, b), (i, f)
    assert len(_EagerGraph.made) == 1
    held = _EagerGraph.made[0].params
    assert torch.equal(held.dec.phase_inc, g.params.dec.phase_inc)
    assert float(held.audio_gain) == g.params.audio_gain
    for (p, a), (_, b) in zip(stepgraph.walk(g.state),
                              stepgraph.walk(state)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), p
    with pytest.raises(ValueError, match="graphed step"):
        g.process(np.zeros(cfg.block_size + 1, np.complex64))
