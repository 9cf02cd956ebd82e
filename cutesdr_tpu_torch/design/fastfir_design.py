"""Design of the main channel bandpass filter for fast convolution.

The channel filter is a 1025-tap complex bandpass built as a Blackman-Nuttall
windowed sinc lowpass of width (hi-lo)/2, complex-shifted to be centered at
(hi+lo)/2 — so an arbitrary passband anywhere in ±fs/2 — then pre-scaled by
1/NFFT and transformed to the frequency domain once at design time.
(reference: dsp/fastfir.cpp:55-57 sizes, :206-254 design; runtime overlap-save
uses it in ops/fastfir.py.)

The port's own copy of ``cutesdr_tpu/design/fastfir_design.py`` (numpy
only).
"""

from __future__ import annotations

import numpy as np

from cutesdr_tpu_torch.design.windows import window_table
from cutesdr_tpu_torch.types import K_2PI, K_PI

CONV_FFT_SIZE = 2048   # power of 2
CONV_FIR_SIZE = 1025   # FFT_SIZE/2 + 1 so the valid output block is 1024


def design_fastfir(f_lo_cut: float, f_hi_cut: float, offset: float,
                   sample_rate: float,
                   fft_size: int = CONV_FFT_SIZE,
                   fir_size: int = CONV_FIR_SIZE,
                   window: str = "blackman_nuttall") -> np.ndarray:
    """Return the frequency-domain filter H, complex128 of length fft_size.

    ``offset`` is the CW tone offset added to both cut frequencies.  Cutoffs
    range over (-fs/2, +fs/2) with hi > lo.  H already includes the 1/NFFT
    scaling so y = IFFT_unscaled(FFT(x) * H) is correctly normalized when the
    IFFT is the unscaled conjugate transform; with jnp.fft.ifft (which scales
    by 1/N itself) the runtime multiplies back by NFFT — see ops/fastfir.py.
    """
    flo = f_lo_cut + offset
    fhi = f_hi_cut + offset
    if not (flo < fhi):
        raise ValueError(f"need lo < hi, got {flo} >= {fhi}")
    if not (-sample_rate / 2.0 < flo and fhi < sample_rate / 2.0):
        raise ValueError(f"cutoffs ({flo},{fhi}) out of ±fs/2 ({sample_rate})")

    n_fl = flo / sample_rate
    n_fh = fhi / sample_rate
    n_fc = (n_fh - n_fl) / 2.0              # prototype LP cutoff
    n_fs = K_2PI * (n_fh + n_fl) / 2.0      # required frequency shift (rad)
    fcenter = 0.5 * (fir_size - 1)

    win = window_table(window, fir_size)
    i = np.arange(fir_size, dtype=np.float64)
    x = i - fcenter
    with np.errstate(invalid="ignore", divide="ignore"):
        z = np.sin(K_2PI * x * n_fc) / (K_PI * x) * win
    z = np.where(i == fcenter, 2.0 * n_fc, z)

    h = np.zeros(fft_size, dtype=np.complex128)
    h[:fir_size] = z * np.exp(1j * n_fs * x) / fft_size
    return np.fft.fft(h)
