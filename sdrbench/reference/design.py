"""Filter and oscillator design of the plain reference, worked out from a
configuration alone.

A frozen copy of CuteSDR 1.02's design rules, in numpy and float64:

* the decimation chain: the cheapest half-band (or CIC3) stage whose
  alias-free band covers the signal, halving the rate until the 51-tap
  stage's band or the 15.8 kHz floor is reached (dsp/downconvert.cpp:
  114-173, thresholds and half-band tables dsp/filtercoef.h:17-424),
  composed into one FIR at the input rate, H(z) = prod_k H_k(z^(2^k));
* the channel filter: a Blackman-Nuttall windowed-sinc low-pass of half
  the passband, shifted to the passband's centre (dsp/fastfir.cpp:
  206-254), as time-domain taps;
* the DDS increment of a tuned channel, round(-f/fs * 2^32) mod 2^32;
* the resampler's P-period Blackman-Harris windowed sinc
  (dsp/fractresampler.cpp:101-106), evaluated at exact positions;
* the AGC's and the S-meter's constants (dsp/agc.cpp:174-296,
  dsp/smeter.cpp);
* the Kaiser-window high-pass FIR (dsp/fir.cpp:278-367, with the tap
  estimate and window shape of :184-198 and the Bessel series of
  :414-432) and the RBJ biquad low-pass (dsp/iir.cpp:86-165).

Nothing here reads the program under test.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

FULL_SCALE = 32767.0
TWO32 = 1 << 32
FIR_MAX_TAPS = 75         # CFir's coefficient limit (dsp/fir.h:16)

# normalised alias-free bandwidths of the decimate-by-2 stages
_USABLE = {
    "cic3": 0.5 - 0.4985, "hb11": 0.5 - 0.475, "hb15": 0.5 - 0.451,
    "hb19": 0.5 - 0.428, "hb23": 0.5 - 0.409, "hb27": 0.5 - 0.392,
    "hb31": 0.5 - 0.378, "hb35": 0.5 - 0.366, "hb39": 0.5 - 0.356,
    "hb43": 0.5 - 0.347, "hb47": 0.5 - 0.340, "hb51": 0.5 - 0.333,
}
_MENU = tuple(_USABLE)

# first half of each half-band table's non-zero taps (h[0], h[2], ...);
# the centre tap is 0.5, the other odd taps 0
_HB_HALF = {
    "hb11": [0.0060431029837374152, -0.049372515458761493,
             0.29332944952052842],
    "hb15": [-0.001442203300285281, 0.013017512802724852,
             -0.061653278604903369, 0.30007792316024057],
    "hb19": [0.00042366527106480427, -0.0040717333369021894,
             0.019895653881950692, -0.070740034412329067,
             0.30449249772844139],
    "hb23": [-0.00014987651418332164, 0.0014748633283609852,
             -0.0074416944990005314, 0.026163522731980929,
             -0.077593699116544707, 0.30754683719791986],
    "hb27": [0.000063730426952664685, -0.00061985193978569082,
             0.0031512504783365756, -0.011173151342856621,
             0.03171888754393197, -0.082917863582770729,
             0.3097770473566307],
    "hb31": [-0.000030957335326552226, 0.00029271992847303054,
             -0.0014770381124258423, 0.0052539088990950535,
             -0.014856378748476874, 0.036406651919555999,
             -0.08699862567952929, 0.31140967076042625],
    "hb35": [0.000017017718072971716, -0.00015425042851962818,
             0.00076219685751140838, -0.002691614694785393,
             0.0075927497927344764, -0.018325727896057686,
             0.040351004914363969, -0.090198224668969554,
             0.31264689763504327],
    "hb39": [-0.000010175082832074367, 0.000088036416015024345,
             -0.00042370835558387595, 0.0014772557414459019,
             -0.0041468438954260153, 0.0099579126901608011,
             -0.021433527104289002, 0.043598963493432855,
             -0.092695953625928404, 0.31358799113382152],
    "hb43": [0.0000067666739082756387, -0.000055275221547958285,
             0.00025654074579418561, -0.0008748125689163153,
             0.0024249876017061502, -0.0057775190656021748,
             0.012299834239523121, -0.024244050662087069,
             0.046354303503099069, -0.094729903598633314,
             0.31433918020123208],
    "hb47": [-0.0000045298314172004251, 0.000035333704512843228,
             -0.00015934776420643447, 0.0005340788063118928,
             -0.0014667949695500761, 0.0034792089350833247,
             -0.0073794356720317733, 0.014393786384683398,
             -0.026586603160193314, 0.048538673667907428,
             -0.09629115286535718, 0.31490673428547367],
    "hb51": [0.0000033359253688981639, -0.000024584155158361803,
             0.00010677777483317733, -0.00034890723143173914,
             0.00094239127078189603, -0.0022118302078923137,
             0.0046575030752162277, -0.0090130973415220566,
             0.016383673864361164, -0.028697281101743237,
             0.05043292242400841, -0.097611898315791965,
             0.31538104435015801],
}

# the largest output band of each mode (gui/mainwindow.cpp:1000-1054):
# LSB-like modes key off the low edge's limit, the others off the high
_MAX_BW = {"am": 10000.0, "sam": 10000.0, "fm": 15000.0, "usb": 20000.0,
           "lsb": 20000.0, "cwu": 1000.0, "cwl": 1000.0}
MIN_OUTPUT_RATE = 15800.0


def _half_band(name: str) -> np.ndarray:
    half = _HB_HALF[name]
    n = 4 * len(half) - 1
    h = np.zeros(n)
    for k, v in enumerate(half):
        h[2 * k] = h[n - 1 - 2 * k] = v
    h[(n - 1) // 2] = 0.5
    return h


def stage_taps(name: str) -> np.ndarray:
    """A stage's FIR (CIC3 as its [1, 3, 3, 1] / 8 equivalent)."""
    if name == "cic3":
        return np.array([1.0, 3.0, 3.0, 1.0]) / 8.0
    return _half_band(name)


def stages(input_rate: float, mode: str) -> tuple[str, ...]:
    """The decimate-by-2 stages from ``input_rate`` for ``mode``."""
    bw = _MAX_BW[mode]
    out, f = [], input_rate
    while f > bw / _USABLE["hb51"] and f > MIN_OUTPUT_RATE:
        out.append(next(n for n in _MENU if f >= bw / _USABLE[n]))
        f /= 2.0
    return tuple(out)


def decimator(input_rate: float, mode: str) -> tuple[np.ndarray, int, int,
                                                     float]:
    """(composed taps H, decimation D, offset d, output rate): output n is
    sum_j H[j] x[D n + d - j]; d counts the CIC3 stages' one-sample
    lead."""
    h, d = np.array([1.0]), 0
    names = stages(input_rate, mode)
    for k, name in enumerate(names):
        hk = stage_taps(name)
        up = np.zeros((len(hk) - 1) * (1 << k) + 1)
        up[::1 << k] = hk
        h = np.convolve(h, up)
        d += (1 << k) if name == "cic3" else 0
    D = 1 << len(names)
    return h, D, d, input_rate / D


def channel_taps(low_cut: float, hi_cut: float, offset: float,
                 sample_rate: float, ntaps: int) -> np.ndarray:
    """Complex time-domain taps of the channel filter: y[n] = sum_i h[i]
    x[n - i] (the overlap-save filter's valid output)."""
    flo = (low_cut + offset) / sample_rate
    fhi = (hi_cut + offset) / sample_rate
    fc = (fhi - flo) / 2.0
    shift = 2.0 * np.pi * (fhi + flo) / 2.0
    i = np.arange(ntaps, dtype=np.float64)
    x = i - 0.5 * (ntaps - 1)
    a = (0.3635819, 0.4891775, 0.1365995, 0.0106411)   # Blackman-Nuttall
    win = sum(((-1.0) ** k) * c * np.cos(2.0 * np.pi * k * i / (ntaps - 1))
              for k, c in enumerate(a))
    with np.errstate(invalid="ignore", divide="ignore"):
        z = np.sin(2.0 * np.pi * x * fc) / (np.pi * x) * win
    z = np.where(x == 0, 2.0 * fc, z)
    return z * np.exp(1j * shift * x)


def dds_increment(freq_hz: float, sample_rate: float) -> int:
    """The 32-bit DDS increment that shifts +freq_hz to DC."""
    return int(np.int64(np.round(-freq_hz / sample_rate * TWO32))) % TWO32


def sinc_weight(v, periods: int):
    """The resampler's weight at offsets ``v`` (a float64 tensor; 0 < v <=
    P, else 0): the Blackman-Harris window over P periods times sinc(v -
    P/2)."""
    import torch
    a = (0.35875, 0.48829, 0.14128, 0.01168)
    w = sum(((-1.0) ** k) * c * torch.cos(2.0 * np.pi * k * v / periods)
            for k, c in enumerate(a))
    fi = np.pi * (v - periods / 2)
    small = fi.abs() < 1e-12
    s = torch.where(small, 1.0, torch.sin(fi) / torch.where(small, 1.0, fi))
    return torch.where((v > 0) & (v <= periods), w * s, 0.0)


def resample_step(in_rate: float, out_rate: float) -> Fraction:
    """The input samples between two outputs, as an exact fraction: the
    configuration's in/out ratio."""
    return Fraction(in_rate) / Fraction(out_rate)


class AgcConstants:
    """The AGC's constants at ``fs`` (dsp/agc.cpp:174-296): delays and
    windows in samples, averager coefficients, the knee and the gains."""

    def __init__(self, fs: float, thresh_db: float, slope: float,
                 decay_ms: float, manual_gain_db: float):
        self.delay = min(int(fs * 0.015), 2047)
        self.window = int(fs * 0.018)
        self.knee = thresh_db / 20.0
        self.slope = slope / 100.0
        self.fixed_gain = 0.7 * 10.0 ** (self.knee * (self.slope - 1.0))
        self.manual_gain = FULL_SCALE * 10.0 ** (-(100.0 - manual_gain_db)
                                                 / 20.0)
        self.a_rise = 1.0 - np.exp(-1.0 / (fs * 0.002))
        self.a_fall = 1.0 - np.exp(-1.0 / (fs * 0.005))
        self.d_rise = 1.0 - np.exp(-1.0 / (fs * decay_ms * 1e-3 * 0.3))
        self.d_fall = 1.0 - np.exp(-1.0 / (fs * decay_ms * 1e-3))


class SMeterConstants:
    """The S-meter's 10 ms attack and 500 ms decay averagers and its
    +5 dB calibration (dsp/smeter.cpp)."""

    def __init__(self, fs: float):
        self.attack = 1.0 - np.exp(-1.0 / (fs * 0.01))
        self.decay = 1.0 - np.exp(-1.0 / (fs * 0.5))
        self.calibration = 5.0


def _bessel_i0(x: float) -> float:
    """I0(x) by its power series, to a term under 1e-9 of the sum."""
    total = term = 1.0
    k = 1
    while term >= 1e-9 * total:
        term *= (x / (2.0 * k)) ** 2
        total += term
        k += 1
    return total


def kaiser_highpass(astop: float, fpass: float, fstop: float,
                    sample_rate: float) -> np.ndarray:
    """Taps of a Kaiser-window high-pass FIR, unit gain, passing above
    ``fpass`` and ``astop`` dB down below ``fstop``: a unit impulse less
    the windowed-sinc low-pass cut midway, over an odd count of taps
    estimated from the transition band, (astop - 8) / (2.285 * 2 pi *
    df) + 1, at most ``FIR_MAX_TAPS``."""
    if astop < 20.96:
        beta = 0.0
    elif astop >= 50.0:
        beta = 0.1102 * (astop - 8.71)
    else:
        beta = 0.5842 * (astop - 20.96) ** 0.4 + 0.07886 * (astop - 20.96)
    df = (fpass - fstop) / sample_rate
    ntaps = int((astop - 8.0) / (2.285 * 2.0 * np.pi * df) + 1.0)
    ntaps = min(max(ntaps, 3), FIR_MAX_TAPS - 1) | 1
    fcut = (fpass + fstop) / 2.0 / sample_rate
    half = (ntaps - 1) / 2.0
    taps = np.empty(ntaps)
    for i in range(ntaps):
        x = i - half
        lowpass = 2.0 * fcut if x == 0 else (np.sin(2.0 * np.pi * x * fcut)
                                             / (np.pi * x))
        c = (1.0 if x == 0 else 0.0) - lowpass
        w = _bessel_i0(beta * np.sqrt(max(1.0 - (x / half) ** 2, 0.0)))
        taps[i] = c * w / _bessel_i0(beta)
    return taps


def biquad_lowpass(f0: float, q: float, sample_rate: float) -> tuple:
    """(b0, b1, b2, a1, a2) of the RBJ low-pass biquad at corner ``f0``
    and quality ``q``, normalised by a0, for the direct form 2 recurrence
    w = x - a1 w1 - a2 w2, y = b0 w + b1 w1 + b2 w2."""
    w0 = 2.0 * np.pi * f0 / sample_rate
    alpha = np.sin(w0) / (2.0 * q)
    c = np.cos(w0)
    a0 = 1.0 + alpha
    return ((1.0 - c) / 2.0 / a0, (1.0 - c) / a0, (1.0 - c) / 2.0 / a0,
            -2.0 * c / a0, (1.0 - alpha) / a0)
