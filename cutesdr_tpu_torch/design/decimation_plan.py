"""Decimation-chain planning: pick the cascade of decimate-by-2 stages.

Given an input sample rate and the desired maximum output bandwidth, greedily
choose the cheapest decimate-by-2 stage whose alias-free usable bandwidth
still covers the signal at the current rate, halving the rate each step,
until either the rate is inside the 51-tap filter's usable band or the
15.8 kHz output-rate floor is reached.  This is the same stage-selection rule
as the reference chain builder (dsp/downconvert.cpp:114-173, thresholds from
dsp/filtercoef.h:17-28), evaluated once at configure time; the result is a
static plan baked into the compiled pipeline.

The port's own copy of ``cutesdr_tpu/design/decimation_plan.py`` with the
half-band tables it reads from ``cutesdr_tpu/coefficients.py`` (numpy
only; the values are the reference's, dsp/filtercoef.h:17-424).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Normalized alias-free bandwidths (fraction of input sample rate).
# A stage with constant X can be used while  bandwidth <= X * input_rate.
CIC3_MAX = 0.5 - 0.4985
HB11TAP_MAX = 0.5 - 0.475
HB15TAP_MAX = 0.5 - 0.451
HB19TAP_MAX = 0.5 - 0.428
HB23TAP_MAX = 0.5 - 0.409
HB27TAP_MAX = 0.5 - 0.392
HB31TAP_MAX = 0.5 - 0.378
HB35TAP_MAX = 0.5 - 0.366
HB39TAP_MAX = 0.5 - 0.356
HB43TAP_MAX = 0.5 - 0.347
HB47TAP_MAX = 0.5 - 0.340
HB51TAP_MAX = 0.5 - 0.333


def _hb(center_half: list[float]) -> np.ndarray:
    """Build a symmetric half-band table from its first half of non-zero taps.

    ``center_half`` lists taps h[0], h[2], h[4], ... up to but excluding the
    center; the center tap is always 0.5 and odd taps (except center) are 0.
    """
    n_half = len(center_half)
    length = 4 * n_half - 1  # e.g. 3 non-zero half taps -> 11 taps
    h = np.zeros(length, dtype=np.float64)
    for k, v in enumerate(center_half):
        h[2 * k] = v
        h[length - 1 - 2 * k] = v
    h[(length - 1) // 2] = 0.5
    return h


HB11TAP_H = _hb([0.0060431029837374152, -0.049372515458761493,
                 0.29332944952052842])

HB15TAP_H = _hb([-0.001442203300285281, 0.013017512802724852,
                 -0.061653278604903369, 0.30007792316024057])

HB19TAP_H = _hb([0.00042366527106480427, -0.0040717333369021894,
                 0.019895653881950692, -0.070740034412329067,
                 0.30449249772844139])

HB23TAP_H = _hb([-0.00014987651418332164, 0.0014748633283609852,
                 -0.0074416944990005314, 0.026163522731980929,
                 -0.077593699116544707, 0.30754683719791986])

HB27TAP_H = _hb([0.000063730426952664685, -0.00061985193978569082,
                 0.0031512504783365756, -0.011173151342856621,
                 0.03171888754393197, -0.082917863582770729,
                 0.3097770473566307])

HB31TAP_H = _hb([-0.000030957335326552226, 0.00029271992847303054,
                 -0.0014770381124258423, 0.0052539088990950535,
                 -0.014856378748476874, 0.036406651919555999,
                 -0.08699862567952929, 0.31140967076042625])

HB35TAP_H = _hb([0.000017017718072971716, -0.00015425042851962818,
                 0.00076219685751140838, -0.002691614694785393,
                 0.0075927497927344764, -0.018325727896057686,
                 0.040351004914363969, -0.090198224668969554,
                 0.31264689763504327])

HB39TAP_H = _hb([-0.000010175082832074367, 0.000088036416015024345,
                 -0.00042370835558387595, 0.0014772557414459019,
                 -0.0041468438954260153, 0.0099579126901608011,
                 -0.021433527104289002, 0.043598963493432855,
                 -0.092695953625928404, 0.31358799113382152])

HB43TAP_H = _hb([0.0000067666739082756387, -0.000055275221547958285,
                 0.00025654074579418561, -0.0008748125689163153,
                 0.0024249876017061502, -0.0057775190656021748,
                 0.012299834239523121, -0.024244050662087069,
                 0.046354303503099069, -0.094729903598633314,
                 0.31433918020123208])

HB47TAP_H = _hb([-0.0000045298314172004251, 0.000035333704512843228,
                 -0.00015934776420643447, 0.0005340788063118928,
                 -0.0014667949695500761, 0.0034792089350833247,
                 -0.0073794356720317733, 0.014393786384683398,
                 -0.026586603160193314, 0.048538673667907428,
                 -0.09629115286535718, 0.31490673428547367])

HB51TAP_H = _hb([0.0000033359253688981639, -0.000024584155158361803,
                 0.00010677777483317733, -0.00034890723143173914,
                 0.00094239127078189603, -0.0022118302078923137,
                 0.0046575030752162277, -0.0090130973415220566,
                 0.016383673864361164, -0.028697281101743237,
                 0.05043292242400841, -0.097611898315791965,
                 0.31538104435015801])

# Ordered stage menu used by the decimation planner: (name, usable_bw, taps).
# CIC3 has no FIR table (polyphase recurrence, gain-compensated by 1/8).
STAGE_MENU = (
    ("cic3", CIC3_MAX, None),
    ("hb11", HB11TAP_MAX, HB11TAP_H),
    ("hb15", HB15TAP_MAX, HB15TAP_H),
    ("hb19", HB19TAP_MAX, HB19TAP_H),
    ("hb23", HB23TAP_MAX, HB23TAP_H),
    ("hb27", HB27TAP_MAX, HB27TAP_H),
    ("hb31", HB31TAP_MAX, HB31TAP_H),
    ("hb35", HB35TAP_MAX, HB35TAP_H),
    ("hb39", HB39TAP_MAX, HB39TAP_H),
    ("hb43", HB43TAP_MAX, HB43TAP_H),
    ("hb47", HB47TAP_MAX, HB47TAP_H),
    ("hb51", HB51TAP_MAX, HB51TAP_H),
)

HB_TABLES = {name: taps for name, _, taps in STAGE_MENU if taps is not None}

# CIC N=3 decimate-by-2 equivalent FIR: H(z) = ((1+z^-1)/2)^3 = moving average
# cube, taps [1,3,3,1]/8 (matches the reference polyphase recurrence
# dsp/downconvert.cpp:444-460 with its 0.125 gain compensation).
CIC3_EQUIV_H = np.array([1.0, 3.0, 3.0, 1.0]) / 8.0

MIN_OUTPUT_RATE = 7900.0 * 2.0


@dataclass(frozen=True)
class DecimationPlan:
    in_rate: float
    max_bw: float
    stages: tuple[str, ...]          # stage names in order, each decimates by 2
    out_rate: float

    @property
    def decimation(self) -> int:
        return 1 << len(self.stages)

    def stage_taps(self, name: str) -> np.ndarray:
        """FIR taps of a stage (CIC3 via its [1,3,3,1]/8 equivalent)."""
        if name == "cic3":
            return CIC3_EQUIV_H
        return HB_TABLES[name]

    def composed_taps(self) -> np.ndarray:
        """Single equivalent FIR at the *input* rate for the whole cascade.

        Composition rule for cascaded decimators: H_eq(z) = prod_k H_k(z^(2^k)).
        Convolving the zero-stuffed stage responses gives one FIR whose
        stride-``decimation`` polyphase implementation is mathematically
        identical to running the cascade — this powers the fused MXU path.
        """
        h = np.array([1.0])
        for k, name in enumerate(self.stages):
            hk = self.stage_taps(name)
            up = np.zeros((len(hk) - 1) * (1 << k) + 1)
            up[:: 1 << k] = hk
            h = np.convolve(h, up)
        return h


def plan_decimation(in_rate: float, max_bw: float) -> DecimationPlan:
    stages: list[str] = []
    f = in_rate
    while f > max_bw / HB51TAP_MAX and f > MIN_OUTPUT_RATE:
        for name, usable, _ in STAGE_MENU:
            if f >= max_bw / usable:
                stages.append(name)
                break
        else:
            # below even hb51's requirement: cannot be reached because the
            # while-condition guarantees f > max_bw / HB51TAP_MAX
            raise AssertionError("no usable stage")
        f /= 2.0
    return DecimationPlan(in_rate=in_rate, max_bw=max_bw,
                          stages=tuple(stages), out_rate=f)
