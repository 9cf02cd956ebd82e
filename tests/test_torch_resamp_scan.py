"""The work split of the banded resampler kernel (csrc/resamp.cu) and the
plain version of the guess-verify solve (csrc/scan.cu), on the CPU.

The kernels run only on the card, where chip_smoke.py holds them against
their plain versions.  Here ``resamp.launch_plan`` is emulated as the
kernel walks it, so that a plan that drops, repeats or misplaces an output
or a tap fails; and ``scan.guess_verify_solve_plain``, the solve kernel's
plain version, is held to the per-round loop it replaced (bitwise) and to
JAX's ``ops/agc._two_rate_parallel`` (within 1e-5 decades, the scans'
bar)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cutesdr_tpu.ops import agc as j_agc
from cutesdr_tpu_torch import kernels
from cutesdr_tpu_torch.kernels import resamp, scan
from cutesdr_tpu_torch.ops import agc as t_agc
from cutesdr_tpu_torch.ops import resampler as t_rs
from cutesdr_tpu_torch.ops.util import first_order_recurrence

torch.set_num_threads(1)

N_SM = 132   # the H100's streaming multiprocessors
FLAGSHIP = 62_500.0 / 48_000.0


def _walk(plan, K, n_streams):
    """The kernel's walk of one launch: every (stream, block, pass,
    thread) of a pass that runs takes output k = kb + thread / G of its
    block (kb = k0 + pass * 256 / G), as lane thread % G; a group past the
    block's last output repeats that output and writes nothing.  Returns
    (stream, k, lane) of the groups that own their output."""
    T, G = resamp.THREADS, plan.lanes
    slots = T // G
    tid = np.arange(T)
    passes = -(-plan.outputs_per_block // slots)
    k0 = np.arange(plan.blocks) * plan.outputs_per_block
    kend = np.minimum(k0 + plan.outputs_per_block, K)[:, None, None]
    kb = k0[:, None, None] + slots * np.arange(passes)[None, :, None]
    kslot = kb + tid[None, None, :] // G
    own = np.broadcast_to(kb < kend, kslot.shape) & (kslot < kend)
    k = kslot[own]
    lane = np.broadcast_to(tid % G, own.shape)[own]
    s = np.repeat(np.arange(n_streams), k.size)
    return s, np.tile(k, n_streams), np.tile(lane, n_streams)


@pytest.mark.parametrize("periods", [28, 29, 48])
@pytest.mark.parametrize("n_streams,n,ratio,nominal", [
    (1, 1024, FLAGSHIP, FLAGSHIP),                      # the session block
    (1, 262_144, FLAGSHIP * (1 + 50e-6), FLAGSHIP),     # rate-locked tail
    (64, 1024, 78_125.0 / 48_000.0, 78_125.0 / 48_000.0),   # the bank
])
def test_resamp_launch_plan_covers_every_output_and_tap_once(
        periods, n_streams, n, ratio, nominal):
    """Every output of every stream is written once (by lane 0 of the
    group that owns it), every tap that can be non-zero (t_int + 1 ..
    t_int + P + 1) is visited once by one lane of that group, and at the
    ratio M was sized for every output takes the staged path: its taps
    lie inside the block's staged span of z and inside the table."""
    K, M = t_rs.band_size(n, t_rs.max_out_for(n, nominal), periods)
    plan = resamp.launch_plan(K, n_streams, M, periods, N_SM)
    assert plan.outputs_per_block in (32, 64, 128, 256)
    assert plan.taps_per_lane * plan.lanes >= periods + 1
    s, k, lane = _walk(plan, K, n_streams)
    out = np.bincount((s * K + k)[lane == 0], minlength=n_streams * K)
    assert (out == 1).all()
    d = (1 + lane[:, None]
         + plan.lanes * np.arange(plan.taps_per_lane)[None, :])
    real = d <= periods + 1
    flat = (np.repeat(s * K + k, plan.taps_per_lane).reshape(d.shape)
            * (periods + 2) + d)[real]
    visits = np.bincount(flat, minlength=n_streams * K * (periods + 2))
    assert (visits.reshape(n_streams, K, periods + 2)[..., 1:] == 1).all()

    params, _ = t_rs.init(ratio, "cpu")
    t0 = torch.linspace(0.0, 0.99 * ratio, n_streams)[:, None]
    t_int, _ = t_rs._times(params, t0, torch.arange(K, dtype=torch.float32))
    t_int = t_int.numpy()
    base = (np.maximum(t_int[:, ::resamp.CHUNK], 0) // 128) * 128
    kk = np.arange(K)
    b0 = base[:, kk // resamp.CHUNK]
    lo = base[:, (kk // plan.outputs_per_block * plan.outputs_per_block)
              // resamp.CHUNK]
    Ti = t_int - b0
    assert (Ti + 1 >= 0).all() and (Ti + periods + 1 < M).all()
    assert ((b0 - lo) + Ti + periods + 1 < plan.span).all()


def test_resamp_launch_plan_spreads_small_calls():
    """The session block's 832 outputs spread over 26 blocks of 32 at 8
    lanes an output; the rate-locked tail takes 2 lanes an output (its
    404,352 threads fill the card's 270,336 resident ones), walks 256
    outputs a block and still gives the card four blocks per SM."""
    K, M = t_rs.band_size(1024, t_rs.max_out_for(1024, FLAGSHIP), 28)
    assert resamp.launch_plan(K, 1, M, 28, N_SM) == (
        8, 32, 4, resamp.span_cap(M, 28, 32), K // 32)
    K, M = t_rs.band_size(262_144, t_rs.max_out_for(262_144, FLAGSHIP), 28)
    plan = resamp.launch_plan(K, 1, M, 28, N_SM)
    assert plan.lanes == 2 and plan.taps_per_lane == 16
    assert plan.outputs_per_block == 256 and plan.blocks >= 4 * N_SM
    assert resamp.launch_plan(K, 1, M, 48, N_SM).taps_per_lane == 32


# --- the guess-verify solve ------------------------------------------------

def _peak(seed, n=65_536, fs=62_500.0):
    """The AGC's window peak (decades) of a stepping-envelope block."""
    rng = np.random.default_rng(seed)
    env = np.repeat(10.0 ** rng.uniform(1, 4, n // 512), 512)
    x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
         * env).astype(np.complex64)
    cfg = t_agc.AgcConfig(True, False, fs)
    c = t_agc.init_carry(cfg, "cpu")
    p = t_agc.make_params(cfg, -100.0, 30.0, 0.0, 200.0)
    return t_agc._prefix(cfg, c, torch.from_numpy(x))[2], c.attack_ave, p


def _round_loop(peak, x0, rise, fall, n_iters):
    """The per-round loop the solve replaced: the warm start, then rounds
    of ``guess_round_plain`` with the count read after each."""
    ag = np.sqrt(rise * fall)
    xg = first_order_recurrence((np.float32(1.0) - ag)
                                * torch.ones_like(peak), peak * ag, x0)
    pattern = peak > scan.shift1(xg, x0)
    for rounds in range(1, n_iters + 1):
        x, pattern, count = scan.guess_round_plain(peak, pattern, x0, rise,
                                                   fall)
        if int(count) == 0:
            return x, True, rounds
    return x, False, n_iters


@pytest.mark.parametrize("seed,averager,n_iters,ok", [
    (2, "attack", 24, True),       # 4 rounds
    (1, "decay", 24, True),        # 4 rounds
    (2, "attack", 2, False),       # stopped after 2 rounds, not converged
])
def test_guess_verify_solve_plain_matches_round_loop(seed, averager,
                                                     n_iters, ok):
    """At 65,536 samples (the kernel's gate): the same x bitwise, ok and
    round count as the per-round loop, on series that take 4 rounds; with
    2 rounds allowed, not converged after both; and within 1e-5 decades
    of JAX's _two_rate_parallel with the same ok."""
    peak, x0, p = _peak(seed)
    rise, fall = ((p.attack_rise_alpha, p.attack_fall_alpha)
                  if averager == "attack"
                  else (p.decay_rise_alpha, p.decay_fall_alpha))
    kernels.reset_launches()
    x, got_ok, rounds = scan.guess_verify_solve(peak, x0, rise, fall,
                                                n_iters)
    assert not any(kernels.LAUNCHES.values())        # CPU: plain version
    wx, want_ok, want_rounds = _round_loop(peak, x0, rise, fall, n_iters)
    assert bool(got_ok) == want_ok == ok
    assert rounds == want_rounds and rounds >= (4 if ok else 2)
    assert torch.equal(x, wx)
    jx, jvalid = jax.jit(lambda pk: j_agc._two_rate_parallel(
        jnp.float32(rise), jnp.float32(fall), jnp.float32(float(x0)), pk,
        n_iters))(jnp.asarray(peak.numpy()))
    assert bool(jvalid) == ok
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5)


def test_guess_verify_loop_reads_each_round_but_the_last():
    """The plain loop reads a round's flag on the host only to decide
    whether to run another: a converged solve returns True (nothing left
    to read), one cut at ``n_iters`` returns its flag unread, as a 0-dim
    bool; a bank freezes its converged rows and returns one flag for all
    of them."""
    peak, x0, p = _peak(3)
    rise, fall = p.attack_rise_alpha, p.attack_fall_alpha
    x, ok = t_agc._two_rate_parallel(rise, fall, x0, peak,
                                     t_agc.GUESS_ITERS, fast=True)
    assert ok is True
    _, cut, rounds = scan.guess_verify_solve_plain(peak, x0, rise, fall, 1)
    assert isinstance(cut, torch.Tensor) and cut.dim() == 0 and rounds == 1
    rows = torch.stack([peak, _peak(4)[0]])
    xb, okb = t_agc._two_rate_parallel(rise, fall, torch.stack([x0, x0]),
                                       rows, t_agc.GUESS_ITERS, fast=False)
    assert okb is True
    assert torch.equal(xb[0], x)
