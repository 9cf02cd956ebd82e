"""The plain reference of an SSB receiver chain, and its lower-precision
control.

``Reference(config, block_samples)`` works out the outputs of one block
of a stream of blocks (a single receiver, or a bank of channels tuned
across one stream) from the capture alone, in float64: DC cal, NCO mix
and decimation, channel filter, S-meter, AGC, SSB demodulation, the
resampler, at a volume of 1. The filters, increments and constants come from
``design``; nothing is read from the program under test.

A block far into a stream depends on everything before it only through
the decimator's and the filters' finite histories and the averagers'
levels, which forget at the AGC's decay rate. So block ``b`` is worked
out from the stream's state at block ``b - warm`` taken cold: the
decimator reads the true input before it, every other history starts
empty and the averagers start at their initial levels, and ``warm``
blocks span at least twelve of the AGC's decay time constants (e^-12 of
a gap of its decay averager is left where it only falls) and a second
(``WARM_MIN_S``); in practice the averagers meet far sooner
(``control.py --warm-check``). Within ``warm`` blocks of the stream's
start the reference starts at block 0 with the stream's own initial
state, and is exact. The NCO phase and the resampler's output times are
exact functions of the absolute sample index: the 32-bit DDS
accumulator, and output m at input time m * dt
(``design.resample_step``).

``precision="tf32"`` is the control: the same chain in float32 whose every
intermediate value is rounded to TF32's 10-bit mantissa, and whose
products run with TF32 allowed.  Heavy stages run on ``device`` (the card
in a benchmark run); the averagers' recurrences run on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from sdrbench.reference import design

PRECISIONS = ("float64", "tf32")
GROUP_SAMPLES = 1 << 28      # input samples x channels mixed at once
# the least warm-up: two of the S-meter's 500 ms decay constants, and
# several syllables of the captures' 2-3 Hz envelopes, whose rises bring
# the S-meter's decay average onto its attack average
WARM_MIN_S = 1.0


def round_tf32(x):
    """``x`` (float32, numpy or torch) rounded to TF32: 10 mantissa bits,
    to nearest, ties to even."""
    if isinstance(x, torch.Tensor):
        b = x.contiguous().view(torch.int32)
        b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
        return b.view(torch.float32)
    a = np.ascontiguousarray(x, np.float32)
    b = a.view(np.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(np.float32)


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
        mode = rx.get("mode", "usb")
        if mode not in ("usb", "lsb", "cwu", "cwl"):
            raise ValueError(f"the reference demodulates SSB/CW, not {mode}")
        if rx.get("agc_hang", False) or rx.get("nb_on", False) \
                or rx.get("stereo", False):
            raise ValueError("the reference has no hang AGC, blanker or "
                             "stereo")
        self.device = torch.device(device)
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64
        self.fs = float(rx["input_rate"])
        self.h_dec, self.D, self.d, self.fs_out = design.decimator(self.fs,
                                                                   mode)
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
        self.agc_on = bool(rx.get("agc_on", True))
        self.agc = design.AgcConstants(
            self.fs_out, float(rx["agc_thresh_db"]), float(rx["agc_slope"]),
            float(rx["agc_decay_ms"]), float(rx["agc_manual_gain_db"]))
        self.smeter = design.SMeterConstants(self.fs_out)
        self.audio_rate = rx.get("audio_rate")
        self.periods = int(rx["resampler_periods"])
        if self.audio_rate is not None:
            self.dt = design.resample_step(self.fs_out, float(self.audio_rate))
        warm_s = max(12.0 * float(rx["agc_decay_ms"]) * 1e-3, WARM_MIN_S)
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
        history before them (zero before the stream's start), and the
        absolute index of each sample, on ``device``."""
        re, im = capture
        N = re.shape[-1]
        hist = len(self.h_dec) - 1 - self.d
        B = self.block_samples
        k = torch.arange(b0 * B - hist, (b + 1) * B,
                         dtype=torch.int64, device=self.device)
        idx = torch.remainder(k, N)
        live = k >= 0
        xr = torch.where(live, re[idx].to(self.dtype), 0.0) - self.dc.real
        xi = torch.where(live, im[idx].to(self.dtype), 0.0) - self.dc.imag
        return k, self._r(xr), self._r(xi)

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
        """S-meter and AGC over [C, 2, n] filtered rows: (leveled [C, 2,
        n], the S-meter's decay average at the end [C], the per-sample
        S-meter dB [C, n])."""
        fr, fi = filt[:, 0], filt[:, 1]
        r = self._r
        pwr = r(r(r(fr * fr) + r(fi * fi)) / design.FULL_SCALE ** 2)
        sm_db = r(10.0 * torch.log10(torch.clamp(pwr, min=1e-16)))
        d_end = self._smeter(sm_db)
        ac = self.agc
        if not self.agc_on:
            return r(filt * ac.manual_gain), d_end, sm_db
        inst = torch.maximum(fr.abs(), fi.abs())
        mag = r(torch.log10(inst + 3.2767e-4) - math.log10(design.FULL_SCALE))
        hist = torch.full(mag.shape[:-1] + (ac.window - 1,), -16.0,
                          dtype=mag.dtype, device=mag.device)
        peak = torch.nn.functional.max_pool1d(
            torch.cat([hist, mag], -1)[:, None], ac.window, 1)[:, 0]
        magsel = torch.tensor(self._averagers(peak.cpu().numpy()),
                              device=mag.device)
        gain = r(torch.where(magsel <= ac.knee, ac.fixed_gain,
                             0.7 * 10.0 ** (magsel * (ac.slope - 1.0))))
        delayed = torch.nn.functional.pad(filt, (ac.delay, 0))[..., :-ac.delay]
        return r(delayed * gain[:, None]), d_end, sm_db

    def _averagers(self, peak: np.ndarray) -> np.ndarray:
        """max(attack, decay) of the AGC's two-rate averagers, row by
        row, sample by sample, from -5 decades (on the host)."""
        ac = self.agc
        if not self.tf32 and peak.shape[0] == 1:
            return _averagers_scalar(peak[0].tolist(), ac)[None]
        rows, n = peak.shape
        dt = peak.dtype
        r = self._r
        # the attack averager's rows, then the decay averager's
        x = np.full(2 * rows, -5.0, dt)
        rise = np.repeat(np.array([ac.a_rise, ac.d_rise], dt), rows)
        fall = np.repeat(np.array([ac.a_fall, ac.d_fall], dt), rows)
        pt = np.ascontiguousarray(np.concatenate([peak, peak]).T)
        out = np.empty((n, 2 * rows), dt)
        g = np.empty_like(x)
        for i in range(n):
            np.subtract(pt[i], x, out=g)
            a = np.where(g > 0, rise, fall)
            if self.tf32:
                x = r(x + r(a * r(g)))
            else:
                np.multiply(a, g, out=g)
                np.add(x, g, out=x)
            out[i] = x
        return np.maximum(out[:, :rows], out[:, rows:]).T

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
        audio = leveled[:, 0]                 # SSB: the real part
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


def _averagers_scalar(peak: list, ac) -> np.ndarray:
    att = dec = -5.0
    ar, af, dr, df = ac.a_rise, ac.a_fall, ac.d_rise, ac.d_fall
    out = [0.0] * len(peak)
    for i, p in enumerate(peak):
        att += (ar if p > att else af) * (p - att)
        dec += (dr if p > dec else df) * (p - dec)
        out[i] = att if att > dec else dec
    return np.array(out)


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
