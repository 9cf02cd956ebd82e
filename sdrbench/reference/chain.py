"""The plain reference of a receiver chain, and its lower-precision
control.

``Reference(config, block_samples)`` works out the outputs of one block
of a stream of blocks (a single receiver, or a bank of channels tuned
across one stream) from the capture alone, in float64: the input stage,
DC cal, NCO mix and decimation, channel filter, S-meter, the levels (the
AGC), demodulation, the resampler, at a volume of 1.  The filters,
increments and constants come from ``design``; nothing is read from the
program under test.

The chain names no mode.  Its input, levels and demod stages are parts
(``reference/parts/``, one file each) picked by the configuration: for
each stage the one part that takes it, the input stage the identity
where none does.  A configuration that a stage has no part for, or two,
is refused.

A block far into a stream depends on everything before it only through
the decimator's and the filters' finite histories and the parts' states,
which forget.  So block ``b`` is worked out from the stream's state at
block ``b - warm`` taken cold: the decimator reads the true input before
it, every other history starts empty and every average at its initial
level, and ``warm`` blocks span the longest memory of the chosen parts
(``warm_s``: the two-rate AGC's is twelve of its decay time constants
and at least a second); in practice they meet far sooner
(``control.py --warm-check``).  Within ``warm`` blocks of the stream's
start the reference starts at block 0 with the stream's own initial
state, and is exact.  The NCO phase and the resampler's output times are
exact functions of the absolute sample index: the 32-bit DDS
accumulator, and output m at input time m * dt
(``design.resample_step``).

``precision="tf32"`` is the control: the same chain in float32 whose every
intermediate value is rounded to TF32's 10-bit mantissa, and whose
products run with TF32 allowed.  Heavy stages run on ``device`` (the card
in a benchmark run); the sequential recurrences run on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from sdrbench.reference import design, parts
from sdrbench.reference.stage import PRECISIONS, Rates, round_tf32

GROUP_SAMPLES = 1 << 28      # input samples x channels mixed at once


@dataclass
class BlockOutput:
    """The reference's outputs of one block: per channel the audio of
    outputs ``m_lo[c]`` .. ``m_hi[c] - 1`` (absolute output indices of the
    stream), the S-meter's average and peak (dB)."""
    m_lo: np.ndarray
    m_hi: np.ndarray
    audio: list
    smeter_ave: np.ndarray
    smeter_peak: np.ndarray


class Reference:
    """The reference of one configuration (its file's dict) under one
    traffic (the capture's block length)."""

    def __init__(self, config: dict, block_samples: int,
                 precision: str = "float64", device="cpu"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        rx = config["receiver"]
        chosen = parts.choose(rx)
        self.device = torch.device(device)
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64
        self.fs = float(rx["input_rate"])
        self.h_dec, self.D, self.d, self.fs_out = design.decimator(
            self.fs, rx["mode"])
        nfft, ntaps = int(rx["fastfir_nfft"]), int(rx["fastfir_ntaps"])
        self.n_frame = nfft - (ntaps - 1)
        cw = float(rx.get("cw_offset", 0.0))
        self.h_chan = design.channel_taps(float(rx["low_cut"]),
                                          float(rx["hi_cut"]), cw,
                                          self.fs_out, ntaps)
        self.block_samples = B = int(block_samples)
        if B % (self.D * self.n_frame):
            raise ValueError(f"block {B} is not whole frames of "
                             f"{self.D * self.n_frame} input samples")
        self.n = B // self.D          # demodulated samples a block
        tunes = channel_freqs(config)
        self.incs = [design.dds_increment(f - cw, self.fs) for f in tunes]
        dc = config.get("dc_cal", [0.0, 0.0])
        self.dc = complex(float(dc[0]), float(dc[1]))
        self.smeter = design.SMeterConstants(self.fs_out)
        self.audio_rate = rx.get("audio_rate")
        self.periods = int(rx["resampler_periods"])
        if self.audio_rate is not None:
            self.dt = design.resample_step(self.fs_out, float(self.audio_rate))
        rates = Rates(self.fs, self.fs_out, B, self.n)
        self.parts = {stage: None if mod is None
                      else mod.Part(rx, rates, precision, device)
                      for stage, mod in chosen.items()}
        warm_s = max(p.warm_s for p in self.parts.values() if p is not None)
        self.warm = max(1, math.ceil(warm_s * self.fs / B))

    # ------------------------------------------------------------ helpers

    def _r(self, x):
        """A value as the precision keeps it (TF32 rounding in the
        control, else itself)."""
        return round_tf32(x) if self.tf32 else x

    def _matmul_tf32(self, on: bool):
        torch.backends.cuda.matmul.allow_tf32 = on

    # ------------------------------------------------------------- stages

    def _inputs(self, capture, b0: int, b: int):
        """The DC-calibrated input of blocks b0 .. b with the decimator's
        history before them (the raw planes zero before the stream's
        start, through the input stage), and the absolute index of each
        sample, on ``device``."""
        re, im = capture
        N = re.shape[-1]
        hist = len(self.h_dec) - 1 - self.d
        B = self.block_samples
        k = torch.arange(b0 * B - hist, (b + 1) * B,
                         dtype=torch.int64, device=self.device)
        idx = torch.remainder(k, N)
        live = k >= 0
        xr = torch.where(live, re[idx].to(self.dtype), 0.0)
        xi = torch.where(live, im[idx].to(self.dtype), 0.0)
        if self.parts["input"] is not None:
            xr, xi = self.parts["input"](xr, xi)
        return k, self._r(xr - self.dc.real), self._r(xi - self.dc.imag)

    def _front(self, k, xr, xi, n_out: int, incs: list) -> torch.Tensor:
        """Mix + decimate + channel filter of a group of channels: the
        filtered samples, [C, 2, n_out] (real, imaginary), on ``device``."""
        # the DDS accumulator k * inc mod 2^32, without overflowing int64
        inc = torch.tensor(incs, dtype=torch.int64,
                           device=self.device)[:, None]
        km = (k & 0xFFFFFFFF)[None]
        acc = ((((km >> 16) * inc) & 0xFFFFFFFF) << 16) + (km & 0xFFFF) * inc
        ang = (acc & 0xFFFFFFFF).to(torch.float64) * (2.0 * math.pi
                                                       / design.TWO32)
        del acc
        c = self._r(torch.cos(ang).to(self.dtype))
        s = self._r(torch.sin(ang).to(self.dtype))
        del ang
        mr = self._r(self._r(xr * c) - self._r(xi * s))
        mi = self._r(self._r(xr * s) + self._r(xi * c))
        del c, s
        dec = self._r(self._decimate(torch.stack([mr, mi], 1), n_out))
        ntaps = len(self.h_chan)
        hf = self.h_chan[::-1]
        wr = torch.tensor(hf.real.copy(), dtype=self.dtype, device=self.device)
        wi = torch.tensor(hf.imag.copy(), dtype=self.dtype, device=self.device)
        wt = self._r(torch.stack([torch.stack([wr, -wi]),
                                  torch.stack([wi, wr])]))
        xp = torch.nn.functional.pad(dec, (ntaps - 1, 0))
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=self.tf32):
            return self._r(torch.nn.functional.conv1d(xp, wt))

    def _decimate(self, x: torch.Tensor, n_out: int) -> torch.Tensor:
        """out[..., n] = sum_i w[i] x[..., D n + i] over [C, 2, n] rows,
        with w the composed taps flipped: as a convolution over the D
        polyphase rows (x[D q + r] is row r), K = ceil(L / D) taps a row."""
        D, L = self.D, len(self.h_dec)
        K = -(-L // D)
        pad = K * D - L
        w = torch.tensor(np.concatenate([np.zeros(pad), self.h_dec[::-1]]),
                         dtype=self.dtype, device=self.device)
        C = x.shape[0]
        xp = torch.nn.functional.pad(self._r(x), (pad, 0))
        rows = xp.shape[-1] // D
        X = xp[..., :rows * D].reshape(2 * C, rows, D).transpose(1, 2)
        W = self._r(w).reshape(K, D).T[None]
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=self.tf32):
            y = torch.nn.functional.conv1d(X.contiguous(), W.contiguous())
        return y[:, 0, :n_out].reshape(C, 2, n_out)

    def _levels(self, filt: torch.Tensor):
        """S-meter and levels over [C, 2, n] filtered rows: (leveled [C, 2,
        n], the S-meter's decay average at the end [C], the per-sample
        S-meter dB [C, n])."""
        fr, fi = filt[:, 0], filt[:, 1]
        r = self._r
        pwr = r(r(r(fr * fr) + r(fi * fi)) / design.FULL_SCALE ** 2)
        sm_db = r(10.0 * torch.log10(torch.clamp(pwr, min=1e-16)))
        d_end = self._smeter(sm_db)
        return self.parts["levels"](filt), d_end, sm_db

    def _smeter(self, m: torch.Tensor) -> torch.Tensor:
        """The S-meter's decay average at the end of [C, n] rows of dB
        values, from -120 dB: a = EMA(m), d = max(EMA(m), a)."""
        sc = self.smeter
        rows, n = m.shape
        if not self.tf32:
            start = torch.full((rows,), -120.0, dtype=m.dtype, device=m.device)
            return _smeter_closed(m, sc.attack, sc.decay, start, start)
        mt = np.ascontiguousarray(m.cpu().numpy().T)
        a = np.full(rows, -120.0, np.float32)
        d = np.full(rows, -120.0, np.float32)
        r = self._r
        sa, sd = np.float32(sc.attack), np.float32(sc.decay)
        for i in range(n):
            v = mt[i]
            a = r(a + r(sa * r(v - a)))
            d = np.maximum(r(d + r(sd * r(v - d))), a)
        return torch.tensor(d, device=m.device)

    def _resample(self, audio: torch.Tensor, b0: int, b: int):
        """Block b's outputs of the resampler over the audio of blocks
        b0 .. b ([C, n] rows): (m_lo, m_hi, [C, m_hi - m_lo])."""
        P, dt, n = self.periods, self.dt, self.n
        p, q = dt.numerator, dt.denominator
        m_lo = -((-b * n * q) // p)          # first m with m*dt >= b*n
        m_hi = -((-(b + 1) * n * q) // p)
        K = m_hi - m_lo
        base_i, base_r = divmod(m_lo * p, q)
        kk = np.arange(K, dtype=np.int64)
        t = base_r + kk * p                  # exact: K * p < 2^63
        i0 = base_i + t // q - P - b0 * n    # index of tap j = 0 in the rows
        dev, dtype = self.device, self.dtype
        frac = torch.tensor((t % q).astype(np.float64) / q, device=dev)
        j = torch.arange(1, P + 1, device=dev)
        w = design.sinc_weight(j[None, :] - frac[:, None], P)
        idx = torch.tensor(i0, device=dev)[:, None] + j[None, :]
        ok = idx >= 0
        g = torch.where(ok, audio[:, torch.where(ok, idx, 0)], 0.0)
        self._matmul_tf32(self.tf32)
        try:
            y = torch.matmul(self._r(g)[:, :, None, :],
                             self._r(w.to(dtype))[None, :, :, None])[..., 0, 0]
        finally:
            self._matmul_tf32(False)
        return m_lo, m_hi, self._r(y)

    # --------------------------------------------------------------- run

    def block(self, capture, b: int) -> BlockOutput:
        """The outputs of block ``b`` (0 is the stream's first) of the
        stream over ``capture`` ((re, im) int16 planes on ``device``,
        repeated without end)."""
        b0 = max(0, b - self.warm)
        n_all = (b + 1 - b0) * self.n
        k, xr, xi = self._inputs(capture, b0, b)
        group = max(1, GROUP_SAMPLES // k.numel())
        filt = torch.cat([self._front(k, xr, xi, n_all,
                                      self.incs[g:g + group])
                          for g in range(0, len(self.incs), group)])
        del k, xr, xi
        leveled, d_end, sm_db = self._levels(filt)
        del filt
        cal = self.smeter.calibration
        sm_ave = d_end.double().cpu().numpy() + cal
        last = sm_db[:, (b - b0) * self.n:].amax(-1)
        sm_peak = torch.clamp(last, min=0.0).double().cpu().numpy() + cal
        audio = self.parts["demod"](leveled)
        C = len(self.incs)
        if self.audio_rate is None:
            lo = np.full(C, b * self.n)
            out = audio[:, (b - b0) * self.n:].double()
            return BlockOutput(lo, lo + self.n, list(out.cpu().numpy()),
                               sm_ave, sm_peak)
        m_lo, m_hi, out = self._resample(audio, b0, b)
        return BlockOutput(np.full(C, m_lo), np.full(C, m_hi),
                           list(out.double().cpu().numpy()), sm_ave, sm_peak)


def channel_freqs(config: dict) -> list[float]:
    """The tune frequency of each channel of a configuration: the single
    receiver's ``tune_freq``, or a bank's grid."""
    if config.get("entry") == "channel_bank":
        ch = config["channels"]
        return [float(ch["start_hz"]) + float(ch["step_hz"]) * i
                for i in range(int(ch["count"]))]
    return [float(config["receiver"]["tune_freq"])]


def _smeter_closed(m: torch.Tensor, sa: float, sd: float, a0: torch.Tensor,
                   d0: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """d at the end of rows m of a[n] = a[n-1] + sa (m[n] - a[n-1]) and
    d[n] = max(d[n-1] + sd (m[n] - d[n-1]), a[n]), in float64 without a
    loop over samples: each recurrence has one slope c, so within a chunk
    x[j] = c^j (x0 + sum_{i<=j} s m[i] c^-i), and d, a max-affine one,
    d[j] = c^j (B[j] + max(d0, max_{i<=j} a[i] c^-i - B[i])) with B the
    sum for d.  Chunks keep c^-j near 1."""
    ca, cd = 1.0 - sa, 1.0 - sd
    j = torch.arange(1, chunk + 1, dtype=torch.float64, device=m.device)
    a, d = a0.double(), d0.double()
    for s in range(0, m.shape[-1], chunk):
        mm = m[:, s:s + chunk].double()
        T = mm.shape[-1]
        ga, gd = ca ** -j[:T], cd ** -j[:T]
        aa = (a[:, None] + torch.cumsum(sa * mm * ga, -1)) / ga
        B = torch.cumsum(sd * mm * gd, -1)
        v = torch.maximum(d[:, None], torch.cummax(aa * gd - B, -1).values)
        a, d = aa[:, -1], (B[:, -1] + v[:, -1]) / gd[-1]
    return d
