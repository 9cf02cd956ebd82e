"""Cosine-sum window functions used across the framework.

The reference hardcodes one window per site behind #if blocks (display FFT:
dsp/fft.cpp:189-239; FastFIR design: dsp/fastfir.cpp:91-126; resampler table:
dsp/fractresampler.cpp:101-106).  Here they are one parametrized table.

Each entry: (coefficients a0..aN, amplitude gain used by the display path).
w[i] = gain * sum_k (-1)^k a_k cos(2 pi k i / (N-1))

The port's own copy of ``cutesdr_tpu/design/windows.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np

_WINDOWS: dict[str, tuple[tuple[float, ...], float]] = {
    "rectangle":        ((1.0,), 1.0),
    "hann":             ((0.5, 0.5), 2.0),
    "hamming":          ((0.54, 0.46), 1.852),
    "blackman_nuttall": ((0.3635819, 0.4891775, 0.1365995, 0.0106411), 2.8),
    "blackman_harris":  ((0.35875, 0.48829, 0.14128, 0.01168), 2.82),
    "nuttall":          ((0.355768, 0.487396, 0.144232, 0.012604), 2.8),
    "flattop":          ((1.0, 1.942604, 1.340318, 0.440811, 0.043097), 1.0),
}

WINDOW_NAMES = tuple(_WINDOWS)


def window_table(name: str, n: int, with_gain: bool = False) -> np.ndarray:
    """Length-``n`` window, float64.  ``with_gain`` applies the display-path
    amplitude gain factor (used only by the spectrum display FFT)."""
    try:
        coefs, gain = _WINDOWS[name]
    except KeyError:
        raise ValueError(f"unknown window {name!r}; choose from {WINDOW_NAMES}")
    i = np.arange(n, dtype=np.float64)
    w = np.zeros(n, dtype=np.float64)
    for k, a in enumerate(coefs):
        w += ((-1.0) ** k) * a * np.cos(2.0 * np.pi * k * i / (n - 1))
    if with_gain:
        w *= gain
    return w
