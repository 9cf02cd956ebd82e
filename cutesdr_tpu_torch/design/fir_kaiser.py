"""Kaiser-window FIR design from passband/stopband specs.

Reproduces the reference design math exactly in float64 so tap counts and
coefficients match bit-for-bit (reference: dsp/fir.cpp:173-261 lowpass,
:278-367 highpass, :374-407 Hilbert bandpass transform, :414-432 Bessel I0).

Design recipe (classic Kaiser method):
  beta from stopband attenuation Astop,
  tap estimate N = (Astop - 8) / (2.285 * 2pi * |dF|) + 1  (dF normalized),
  windowed ideal sinc (LP) or spectral-inversion sinc (HP).

The port's own copy of ``cutesdr_tpu/design/fir_kaiser.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np

from cutesdr_tpu_torch.types import K_2PI, K_PI

MAX_NUMCOEF = 75  # reference cap on designed tap count (dsp/fir.h:16)


def izero(x: float) -> float:
    """Modified Bessel function I0(x) by series, terminating at 1e-9 relative
    term size (same series/termination as the reference implementation)."""
    x2 = x / 2.0
    total = 1.0
    ds = 1.0
    di = 1.0
    while True:
        t = (x2 / di) ** 2
        ds *= t
        total += ds
        di += 1.0
        if ds < 1e-9 * total:
            break
    return total


def kaiser_beta(astop: float) -> float:
    """Kaiser shape parameter from stopband attenuation in dB."""
    if astop < 20.96:
        return 0.0
    if astop >= 50.0:
        return 0.1102 * (astop - 8.71)
    return 0.5842 * (astop - 20.96) ** 0.4 + 0.07886 * (astop - 20.96)


def _num_taps(astop: float, delta_f_norm: float) -> int:
    # int() truncation matches the reference's implicit double->int conversion
    return int((astop - 8.0) / (2.285 * K_2PI * delta_f_norm) + 1)


def _kaiser_window(num_taps: int, beta: float) -> np.ndarray:
    n = np.arange(num_taps, dtype=np.float64)
    half = (num_taps - 1.0) / 2.0
    x = (n - half) / half
    izb = izero(beta)
    return np.array([izero(beta * np.sqrt(max(1.0 - xi * xi, 0.0))) / izb for xi in x])


def design_lowpass(scale: float, astop: float, fpass: float, fstop: float,
                   fsamprate: float, max_taps: int = MAX_NUMCOEF) -> np.ndarray:
    """Kaiser lowpass; 6 dB cutoff at (fpass+fstop)/2.  Returns float64 taps."""
    norm_fpass = fpass / fsamprate
    norm_fstop = fstop / fsamprate
    norm_fcut = (norm_fstop + norm_fpass) / 2.0

    beta = kaiser_beta(astop)
    num_taps = _num_taps(astop, norm_fstop - norm_fpass)
    num_taps = min(max(num_taps, 3), max_taps)

    fcenter = 0.5 * (num_taps - 1)
    n = np.arange(num_taps, dtype=np.float64)
    x = n - fcenter
    with np.errstate(invalid="ignore", divide="ignore"):
        c = np.sin(K_2PI * x * norm_fcut) / (K_PI * x)
    c = np.where(n == fcenter, 2.0 * norm_fcut, c)
    return scale * c * _kaiser_window(num_taps, beta)


def design_highpass(scale: float, astop: float, fpass: float, fstop: float,
                    fsamprate: float, max_taps: int = MAX_NUMCOEF) -> np.ndarray:
    """Kaiser highpass (allpass-minus-lowpass sinc); odd tap count forced."""
    norm_fpass = fpass / fsamprate
    norm_fstop = fstop / fsamprate
    norm_fcut = (norm_fstop + norm_fpass) / 2.0

    beta = kaiser_beta(astop)
    num_taps = _num_taps(astop, norm_fpass - norm_fstop)
    num_taps = min(max(num_taps, 3), max_taps - 1)
    num_taps |= 1  # force odd so the allpass impulse lands on a tap

    fcenter = 0.5 * (num_taps - 1)
    n = np.arange(num_taps, dtype=np.float64)
    x = n - fcenter
    with np.errstate(invalid="ignore", divide="ignore"):
        c = np.sin(K_PI * x) / (K_PI * x) - np.sin(K_2PI * x * norm_fcut) / (K_PI * x)
    c = np.where(n == fcenter, 1.0 - 2.0 * norm_fcut, c)
    return scale * c * _kaiser_window(num_taps, beta)


def hilbert_bandpass(lp_taps: np.ndarray, freq_offset: float,
                     samplerate: float) -> tuple[np.ndarray, np.ndarray]:
    """Complex frequency-shift transform of real LP taps into a Hilbert
    bandpass pair with 90-degree phase relation between I and Q branches:

      hI[n] = 2 h[n] cos(2 pi F (n - (N-1)/2) / fs)
      hQ[n] = 2 h[n] sin(2 pi F (n - (N-1)/2) / fs)

    Used by the SAM stereo demod to split sidebands (reference transform:
    dsp/fir.cpp:374-388, used at dsp/samdemod.cpp:67-73).
    """
    num_taps = len(lp_taps)
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    w = K_2PI * freq_offset / samplerate
    return 2.0 * lp_taps * np.cos(w * n), 2.0 * lp_taps * np.sin(w * n)
