"""RBJ-style biquad coefficient design (direct form 2).

Analog prototypes H(s) discretized with the standard bilinear-style alpha
substitution; everything pre-scaled by 1/a0 (reference: dsp/iir.cpp:86-165;
the runtime recurrence is ``ops/iir.py``).  Returns (b0, b1, b2, a1, a2)
float64 with the a-terms sign convention
  w0 = x - a1*w1 - a2*w2 ; y = b0*w0 + b1*w1 + b2*w2.

The port's own copy of the lowpass of ``cutesdr_tpu/design/iir_biquad.py``
(numpy only), the one design the port uses.
"""

from __future__ import annotations

import numpy as np

from cutesdr_tpu_torch.types import K_2PI

Biquad = tuple[float, float, float, float, float]


def _wa(f0: float, q: float, fs: float) -> tuple[float, float, float]:
    w0 = K_2PI * f0 / fs
    alpha = np.sin(w0) / (2.0 * q)
    return w0, alpha, 1.0 / (1.0 + alpha)


def biquad_lowpass(f0: float, q: float, fs: float) -> Biquad:
    w0, alpha, A = _wa(f0, q, fs)
    c = np.cos(w0)
    return (A * (1 - c) / 2, A * (1 - c), A * (1 - c) / 2,
            A * (-2 * c), A * (1 - alpha))
