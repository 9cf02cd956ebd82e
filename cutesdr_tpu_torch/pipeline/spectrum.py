"""Spectrum display path (port of ``cutesdr_tpu/pipeline/spectrum.py``):
windowed power FFT, averaging, dB mapping, and bin -> pixel reduction.

Reference analogue: CFft's display half (dsp/fft.cpp), which fuses the
windowing, power averaging, dB mapping and overload detection into its
radix-4 butterflies (:465-502, :560-589).  As in the JAX package each
concern is a plain function over a batched FFT (``torch.fft`` on the
device the state lives on; the JAX package uses ``jnp.fft`` outside any
kernel):

  * power spectrum |FFT(window*x)|^2, fftshifted so bin 0 = -fs/2;
  * averaging: a moving average over the first ave_size frames, then the
    sum-replace recurrence sum <- sum - ave + new, ave = sum/ave_size
    (dsp/fft.cpp:465-476), one frame at a time;
  * dB map: 0.1-dB units, y = log10(p + K_C) + K_B, the reference's
    absolute calibration (dsp/fft.cpp:170-188) without its +6 dB slip;
  * bin -> pixel: max-hold when bins outnumber pixels, nearest bin
    otherwise (dsp/fft.cpp:308-410);
  * overload when any I exceeds 32000 counts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import NamedTuple

import numpy as np
import torch

from cutesdr_tpu_torch.design.windows import window_table
from cutesdr_tpu_torch.types import CDTYPE, MAX_AMPLITUDE, RDTYPE, \
    resolve_device

MIN_FFT_SIZE = 512
MAX_FFT_SIZE = 65536
K_MAXDB = 0.0
K_MINDB = -220.0
OVER_LIMIT = 32000.0


@dataclass(frozen=True)
class SpectrumConfig:
    fft_size: int = 4096
    ave_size: int = 1
    sample_rate: float = 2_000_000.0
    db_compensation: float = 0.0     # gain-calibration offset in dB
    window: str = "hann"

    def __post_init__(self):
        n = self.fft_size
        if not (MIN_FFT_SIZE <= n <= MAX_FFT_SIZE) or n & (n - 1):
            raise ValueError(f"fft_size must be a power of 2 in "
                             f"[{MIN_FFT_SIZE},{MAX_FFT_SIZE}], got {n}")

    @cached_property
    def k_b(self) -> float:
        # a full-scale (32767) complex tone reads 0 dB: the gain-normalized
        # windows have coherent gain 1, so the FFT peak is N*A
        return (self.db_compensation
                - 20.0 * np.log10(self.fft_size * MAX_AMPLITUDE)) / 10.0

    @cached_property
    def k_c(self) -> float:
        return 10.0 ** ((K_MINDB / 10.0) - self.k_b)


class SpectrumState(NamedTuple):
    pwr_ave: torch.Tensor    # [fft_size] averaged power, fftshifted
    pwr_sum: torch.Tensor
    count: torch.Tensor      # int32 0-dim frames accumulated, saturates at
                             # ave_size


def init(cfg: SpectrumConfig, device, dtype=RDTYPE) -> SpectrumState:
    z = torch.zeros(cfg.fft_size, dtype=dtype, device=device)
    return SpectrumState(pwr_ave=z, pwr_sum=z.clone(),
                         count=torch.zeros((), dtype=torch.int32,
                                           device=device))


def frame_power(cfg: SpectrumConfig, x: torch.Tensor,
                rdtype=RDTYPE) -> torch.Tensor:
    """|FFT(window*x)|^2 of each fft_size frame of ``x`` [..., fft_size],
    fftshifted."""
    win = torch.from_numpy(window_table(cfg.window, cfg.fft_size,
                                        with_gain=True)).to(x.device, rdtype)
    spec = torch.fft.fftshift(torch.fft.fft(x * win, dim=-1), dim=-1)
    return (spec.real * spec.real + spec.imag * spec.imag).to(rdtype)


def accumulate(cfg: SpectrumConfig, state: SpectrumState,
               x: torch.Tensor) -> tuple[SpectrumState, torch.Tensor]:
    """Feed one fft_size block of complex input; returns (state',
    overload).  Takes [..., fft_size]: leading axes average as further
    frames, in order."""
    rdtype = state.pwr_ave.dtype
    overload = (x.real > OVER_LIMIT).any()
    pwr = frame_power(cfg, x, rdtype)
    ave, total, count = state
    for p in pwr.reshape(-1, cfg.fft_size):
        count = torch.clamp(count + 1, max=cfg.ave_size)
        # while still filling: a moving average over `count` frames; then
        # the sum-replace recurrence (a leaky exponential window)
        total = torch.where(count < cfg.ave_size, total + p, total - ave + p)
        ave = total / count.to(rdtype)
    return SpectrumState(pwr_ave=ave, pwr_sum=total, count=count), overload


def accumulate_frames(cfg: SpectrumConfig, state: SpectrumState,
                      x: torch.Tensor, counted: int) -> SpectrumState:
    """``accumulate`` over the frames of ``x`` [F, fft_size], in order,
    for a caller that knows how many frames the state has counted
    (``counted``, a host count, so nothing is read from the device).  The
    frames until the average is full go through ``accumulate``; after
    that the sum-replace recurrence is linear, sum <- a*sum + p with
    a = 1 - 1/ave_size, and the rest take its closed form in one weighted
    sum: a^M*sum + sum_j a^(M-1-j)*p_j (the same value up to the order of
    the float32 sums)."""
    head = max(0, min(x.shape[0], cfg.ave_size - counted))
    if head:
        state, _ = accumulate(cfg, state, x[:head])
    rest = x[head:]
    m = rest.shape[0]
    if m == 0:
        return state
    rdtype = state.pwr_ave.dtype
    pwr = frame_power(cfg, rest, rdtype)
    a = 1.0 - 1.0 / cfg.ave_size
    w = torch.pow(a, torch.arange(m - 1, -1, -1, dtype=torch.float64,
                                  device=x.device)).to(rdtype)
    total = (a ** m) * state.pwr_sum + (w[:, None] * pwr).sum(0)
    return SpectrumState(pwr_ave=total / cfg.ave_size, pwr_sum=total,
                         count=state.count)


def db_spectrum(cfg: SpectrumConfig, state: SpectrumState) -> torch.Tensor:
    """Averaged spectrum in 0.1-dB units (K_MINDB/10 .. K_MAXDB/10), bin 0
    = -fs/2."""
    return torch.log10(state.pwr_ave + cfg.k_c) + cfg.k_b


def reset(cfg: SpectrumConfig, state: SpectrumState) -> SpectrumState:
    return init(cfg, state.pwr_ave.device, state.pwr_ave.dtype)


def screen_map(cfg: SpectrumConfig, db: torch.Tensor, max_height: int,
               max_width: int, max_db: float, min_db: float,
               start_freq: float, stop_freq: float) -> torch.Tensor:
    """Map dB bins to integer pixel heights (0 = top), max-hold where
    several bins share a pixel."""
    n = cfg.fft_size
    bin_min = int(start_freq * n / cfg.sample_rate) + n // 2
    bin_max = int(stop_freq * n / cfg.sample_rate) + n // 2
    bin_min = min(max(bin_min, 0), n - 1)
    bin_max = min(max(bin_max, 0), n - 1)

    gain = -10.0 / (max_db - min_db) * max_height
    y_all = torch.clamp(gain * (db - max_db / 10.0), 0,
                        max_height).to(torch.int32)
    if (bin_max - bin_min) > max_width:
        # more bins than pixels: per-pixel max-hold (the least y is the
        # strongest signal: y is an inverted screen coordinate)
        bins = np.arange(bin_min, bin_max + 1)
        px = ((bins - bin_min) * max_width) // (bin_max - bin_min)
        seg = torch.from_numpy(px).to(db.device)
        out = torch.full((max_width + 1,), max_height, dtype=torch.int32,
                         device=db.device)
        return out.scatter_reduce(0, seg, y_all[bin_min:bin_max + 1],
                                  reduce="amin")
    # more pixels than bins: nearest-bin lookup
    px = np.arange(max_width)
    tbl = bin_min + (px * (bin_max - bin_min)) // max_width
    return y_all[torch.from_numpy(tbl).to(db.device)]


@dataclass
class SpectrumAnalyzer:
    """Stateful wrapper with display-rate throttling, on the card unless
    ``device`` says otherwise.

    Reference analogue: the FFT accumulate/throttle logic of
    CSdrInterface::ProcessIQData (interface/sdrinterface.cpp:895-908),
    m_DisplaySkipValue = fs / (fft_size * max_display_rate)."""
    cfg: SpectrumConfig
    max_display_rate: float = 10.0
    device: str = "cuda"
    state: SpectrumState = field(init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.state = init(self.cfg, self.device)
        self._pending = np.zeros(0, np.complex64)
        self._skip = max(1, int(self.cfg.sample_rate
                                / (self.cfg.fft_size * self.max_display_rate)))
        self._skip_count = 0
        self._overload = False        # the last frame's flag, on the device
        # feed_planes: the frame being collected
        self._fbuf_re = np.zeros(self.cfg.fft_size, np.float32)
        self._fbuf_im = np.zeros(self.cfg.fft_size, np.float32)
        self._collected = 0
        self._skip_remaining = 0

    def _acc(self, re: np.ndarray, im: np.ndarray) -> None:
        x = torch.complex(torch.as_tensor(re, dtype=RDTYPE),
                          torch.as_tensor(im, dtype=RDTYPE))
        self.state, self._overload = accumulate(self.cfg, self.state,
                                                x.to(self.device, CDTYPE))

    @property
    def overload(self) -> bool:
        """The last accumulated frame's A/D-overload flag: kept on the
        device, read only here (when a status or a display frame asks)."""
        return bool(self._overload)

    def feed(self, iq: np.ndarray) -> bool:
        """Append raw IQ; returns True when a new display frame is ready.
        Every ``_skip``-th fft_size frame of the stream is accumulated;
        only those frames are sliced out (the others are counted, not
        copied), and the tail short of a frame is kept."""
        iq = np.asarray(iq, np.complex64)
        n = self.cfg.fft_size
        pend = len(self._pending)
        frames = (pend + len(iq)) // n
        # frame f spans stream samples [f*n, (f+1)*n) of pending ++ iq;
        # the first one the throttle keeps is the one that brings the
        # count up to _skip
        for f in range(self._skip - 1 - self._skip_count, frames,
                       self._skip):
            lo = f * n - pend
            frame = (iq[lo:lo + n] if lo >= 0 else
                     np.concatenate([self._pending, iq[:n - pend]]))
            self._acc(frame.real, frame.imag)
        ready = self._skip - 1 - self._skip_count < frames
        self._skip_count = (self._skip_count + frames) % self._skip
        lo = frames * n - pend
        self._pending = (np.concatenate([self._pending, iq]) if lo < 0
                         else iq[lo:].copy())
        return ready

    def feed_planes(self, re, im) -> bool:
        """Plane-format feed (int16 wire format or float32): samples of
        skipped display frames are never buffered or converted, the
        throttle applied at sample granularity, so a fast stream costs one
        fft_size frame of host work per display update."""
        n = self.cfg.fft_size
        ready = False
        pos, total = 0, len(re)
        while pos < total:
            if self._skip_remaining > 0:
                take = min(self._skip_remaining, total - pos)
                self._skip_remaining -= take
                pos += take
                continue
            take = min(n - self._collected, total - pos)
            c = self._collected
            self._fbuf_re[c:c + take] = re[pos:pos + take]
            self._fbuf_im[c:c + take] = im[pos:pos + take]
            self._collected += take
            pos += take
            if self._collected == n:
                self._acc(self._fbuf_re, self._fbuf_im)
                self._collected = 0
                self._skip_remaining = (self._skip - 1) * n
                ready = True
        return ready

    def spectrum_db(self) -> np.ndarray:
        """Current averaged spectrum in dB (not 0.1-dB units)."""
        return db_spectrum(self.cfg, self.state).cpu().numpy() * 10.0
