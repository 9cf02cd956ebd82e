"""AD6620 digital-downconverter register loader (SDR-IQ / SDR-14 radios).

Reference analogue: interface/ad6620.{h,cpp}: builds the ~270-message
register-write sequence (mode, NCO dither, CIC2/CIC5 scale+rate, RCF
scale/rate/offset, up to 256 FIR taps) sent ack-paced over ASCP
TYPE_HOST_DATA_ITEM1 messages.

Profile parameters (CIC rates, RCF rate, tap counts, usable bandwidths) and
the CIC scale tables match the reference (interface/ad6620.cpp:73-90,
96-372).  The RCF FIR tap *values* are designed here at load time with the
framework's own Kaiser designer to each profile's published pass/stop spec
(0.001 dB passband, -90 dB stopband; spec comments at e.g.
interface/ad6620.cpp:94-95) and quantized to the AD6620's signed 20-bit
coefficient format — functionally equivalent programming, not a copied
table.  Unlike the reference (which only updates scales/tap-counts in its
constructor — a latent bug when switching profiles), scales and tap counts
are derived per profile here.

The port's own copy of ``cutesdr_tpu/io/ad6620.py`` (numpy and the
standard library); a test holds its code equal to the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cutesdr_tpu_torch.io import ascp

# register addresses
ADR_MODECTRL = 0x300
ADR_NCOCTRL = 0x301
ADR_NCOSYNCMASK = 0x302
ADR_NCOFREQ = 0x303
ADR_NCOPHZOFFSET = 0x304
ADR_CIC2SCALE = 0x305
ADR_CIC2M = 0x306
ADR_CIC5SCALE = 0x307
ADR_CIC5M = 0x308
ADR_RCFCTRL = 0x309
ADR_RCFM = 0x30A
ADR_RCFOFFSET = 0x30B
ADR_TAPS = 0x30C

MODECTRL_RESET = 1 << 0
MODECTRL_SREAL = 0 << 1
MODECTRL_DREAL = 1 << 1
MODECTRL_SCOMPLEX = 1 << 2
MODECTRL_SYNCMASTER = 1 << 3
NCOCTRL_BYPASS = 1 << 0
NCOCTRL_PHZDITHER = 1 << 1
NCOCTRL_AMPDITHER = 1 << 2

# per-stage gain-compensation scale values indexed by decimation rate
CIC2_SCALE_TBL = [0,
                  0, 0, 2, 2, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 6, 6]
CIC5_SCALE_TBL = [0,
                  0, 0, 3, 5, 7, 8, 10, 10, 11, 12, 13, 13, 14, 15, 15, 15,
                  16, 16, 17, 17, 17, 18, 18, 18, 19, 19, 19, 20, 20, 20,
                  20, 20]


@dataclass(frozen=True)
class Ad6620Profile:
    """(cic2_rate, cic5_rate, rcf_rate, taps, usable_bw, passband stop/pass
    fractions of the RCF input rate)."""
    cic2_rate: int
    cic5_rate: int
    rcf_rate: int
    taps: int
    usable_bw: int
    pass_frac: float        # of final output rate; .001 dB passband edge
    stop_frac: float        # -90 dB stopband edge

    @property
    def total_decimation(self) -> int:
        return self.cic2_rate * self.cic5_rate * self.rcf_rate


# 13 canned bandwidth profiles (interface/ad6620.cpp: FILxxx constants);
# pass/stop fractions from the published design specs, extended by the
# constant pass/stop ratio 1.6276 where the reference leaves them undocumented.
_R = 1.6276
PROFILES: dict[str, Ad6620Profile] = {
    "5k":    Ad6620Profile(16, 32, 16, 256, 5000,      0.0025, 0.004069),
    "10k":   Ad6620Profile(8, 32, 16, 256, 10000,      0.005, 0.008138),
    "25k":   Ad6620Profile(7, 21, 12, 256, 25000,      0.0125, 0.018896),
    "50k":   Ad6620Profile(8, 30, 5, 256, 50000,       0.025, 0.037792),
    "100k":  Ad6620Profile(5, 30, 4, 256, 100000,      0.0125, 0.018896),
    "150k":  Ad6620Profile(5, 28, 3, 256, 150000,      0.0125, 0.0125 * _R),
    "190k":  Ad6620Profile(10, 17, 2, 256, 190000,     0.0125, 0.0125 * _R),
    "250k":  Ad6620Profile(5, 11, 4, 220, 250000,      0.0125, 0.0125 * _R),
    "500k":  Ad6620Profile(2, 29, 2, 116, 500000,      0.0125, 0.0125 * _R),
    "1000k": Ad6620Profile(2, 13, 2, 52, 1000000,      0.0125, 0.0125 * _R),
    "1500k": Ad6620Profile(2, 8, 2, 32, 1500000,       0.0125, 0.0125 * _R),
    "2000k": Ad6620Profile(2, 5, 2, 20, 2000000,       0.0125, 0.0125 * _R),
    "4000k": Ad6620Profile(2, 4, 2, 16, 4000000,       0.0125, 0.0125 * _R),
}

# GUI bandwidth-index -> profile, per radio sample-rate index
# (interface/sdrinterface.cpp:59-65 SDRIQ_6620FILTERS)
SDRIQ_BW_PROFILES = ("50k", "100k", "150k", "190k")

COEF_MAX = (1 << 19) - 1    # signed 20-bit coefficient full scale


ADC_CLOCK = 66_666_666.6667   # SDR-IQ/14 A/D clock feeding the AD6620
RCF_ASTOP_DB = 90.0           # published stopband spec


def design_rcf_taps(profile: Ad6620Profile) -> np.ndarray:
    """Design the RCF decimating FIR for a profile, quantized to signed
    20-bit integers with full-scale normalization (the AD6620 coefficient
    format).

    The spec fractions are in MHz units (pass_frac·1e6 Hz single-sided).
    A Kaiser windowed sinc is sized to the profile's tap budget: passband
    edge preserved, transition as tight as the tap count allows — which
    puts the -90 dB edge inside the first folding alias band (k·fs_out ±
    passband), the only region a *decimating* filter must attenuate
    (verified in tests/test_io.py::test_ad6620_rcf_response).
    """
    from cutesdr_tpu_torch.design.fir_kaiser import izero, kaiser_beta

    n = profile.taps
    rcf_in = ADC_CLOCK / (profile.cic2_rate * profile.cic5_rate)
    fs_out = rcf_in / profile.rcf_rate
    fpass = profile.pass_frac * 1e6 / rcf_in
    # available transition: from the passband edge to where the first
    # decimation alias band starts folding back onto it
    trans_avail = (fs_out - profile.pass_frac * 1e6) / rcf_in - fpass
    # use the full gap; attenuation = what the tap budget supports, capped
    # at the 90 dB spec (Kaiser estimate inverted)
    astop = min(RCF_ASTOP_DB, 8.0 + 2.285 * 2.0 * np.pi * trans_avail * n)
    fc = fpass + trans_avail / 2.0
    beta = kaiser_beta(astop)
    x = np.arange(n) - (n - 1) / 2.0
    with np.errstate(invalid="ignore", divide="ignore"):
        h = np.sin(2 * np.pi * fc * x) / (np.pi * x)
    if n % 2:
        h[(n - 1) // 2] = 2.0 * fc
    izb = izero(beta)
    half = (n - 1) / 2.0
    win = np.array([izero(beta * np.sqrt(max(1.0 - (xi / half) ** 2, 0.0)))
                    / izb for xi in x])
    h *= win
    h = h / np.max(np.abs(h)) * COEF_MAX
    return np.round(h).astype(np.int64)


def load_messages(profile_name: str, phz_dither: bool = True,
                  amp_dither: bool = True) -> list[bytes]:
    """The full ack-paced register-write message sequence for one profile.

    Each message is a TYPE_HOST_DATA_ITEM1 ASCP frame carrying
    (u16 address, u32 data, u8 data_high), matching the reference's
    GetNext6620Msg framing (interface/ad6620.cpp:567-580).
    """
    p = PROFILES[profile_name]
    regs: list[tuple[int, int]] = []
    regs.append((ADR_MODECTRL,
                 MODECTRL_SREAL | MODECTRL_RESET | MODECTRL_SYNCMASTER))
    nco = (NCOCTRL_AMPDITHER if amp_dither else 0) | \
          (NCOCTRL_PHZDITHER if phz_dither else 0)
    regs.append((ADR_NCOCTRL, nco))
    regs.append((ADR_CIC2SCALE, CIC2_SCALE_TBL[p.cic2_rate]))
    regs.append((ADR_CIC2M, p.cic2_rate - 1))
    regs.append((ADR_CIC5SCALE, CIC5_SCALE_TBL[p.cic5_rate]))
    regs.append((ADR_CIC5M, p.cic5_rate - 1))
    regs.append((ADR_RCFCTRL, 4))          # RCF scale == IF gain
    regs.append((ADR_RCFM, p.rcf_rate - 1))
    regs.append((ADR_RCFOFFSET, 0))
    regs.append((ADR_TAPS, p.taps - 1))
    for i, c in enumerate(design_rcf_taps(p)):
        regs.append((i, int(c) & 0xFFFFFFFF))
    regs.append((ADR_MODECTRL, MODECTRL_SREAL | MODECTRL_SYNCMASTER))

    msgs = []
    for adr, data in regs:
        m = ascp.AscpMessage(ascp.TYPE_HOST_DATA_ITEM1)
        m.add_u16(adr).add_u32(data).add_u8(0)
        msgs.append(m.to_bytes())
    return msgs


class Ad6620Loader:
    """Ack-paced iterator over the load sequence (send one message, wait for
    the data-item ack, send the next — interface/sdrinterface.cpp:376-380)."""

    def __init__(self, profile_name: str):
        self._msgs = load_messages(profile_name)
        self._idx = 0

    def next_message(self) -> bytes | None:
        if self._idx >= len(self._msgs):
            return None
        m = self._msgs[self._idx]
        self._idx += 1
        return m

    @property
    def done(self) -> bool:
        return self._idx >= len(self._msgs)

    def __len__(self) -> int:
        return len(self._msgs)
