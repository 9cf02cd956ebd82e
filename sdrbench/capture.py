"""The one generator of captures: a recording of a band, made on the device
from a traffic file's parameters and a seed, as the int16 I/Q planes a
radio's wire carries.

A traffic file fixes the capture's structure: its length, the block a
call hands the entry, the band noise's level, the DC offset, and every
station (kind, carrier, level, message tones, syllabic envelope), given
one by one (``stations``) or as a ladder of levels over a channel grid
(``ladder``).  The seed draws only the noise realisation and the phases
of the message tones, so every seed gives the same work.

Every frequency (carriers, tones, envelopes, modulations) is rounded to a
whole number of periods over the capture, so a capture repeated without
end has no step at its seam.  Phases are exact: sample n of a tone of k
periods over N samples has phase 2 pi (k n mod N) / N.

Kinds of station known here:

* ``ssb_voice``: an upper (``sideband`` "usb") or lower sideband voice
  stand-in, tones at the carrier +- ``tones_hz`` under a raised-cosine
  syllabic envelope of ``envelope_hz`` that dips to ``envelope_floor``;
* ``am``: a carrier amplitude-modulated by one tone (``tone_hz``,
  ``depth``);
* ``cw``: a steady carrier.

Any other kind is a file, ``stations/<kind>.py``, whose ``parts(st, rate,
n, rng)`` returns the station: an object whose call gives its (re, im)
values, float64, at int64 sample indices (taken modulo the capture's
``n``), and whose ``fixed()`` gives what the seed does not draw (the tests
hold it equal across seeds).  A kind draws from ``rng`` only what varies
from seed to seed; the stations draw in the traffic's order.

A station's ``level_dbfs`` is its peak amplitude against the int16 full
scale (a sum past it is clipped, as a radio's A/D clips); the noise's
``noise_dbfs`` is its complex RMS.
"""

from __future__ import annotations

import importlib
import math
from pathlib import Path

import numpy as np
import torch

FULL_SCALE = 32767.0
CHUNK = 1 << 22           # samples made at once
KINDS = Path(__file__).resolve().parent / "stations"


def _grid(freq_hz: float, rate: float, n: int) -> int:
    """Periods over the capture of the grid frequency nearest ``freq_hz``
    (negative frequencies as negative counts)."""
    return int(round(freq_hz * n / rate))


def expand(traffic: dict) -> list[dict]:
    """The traffic's stations, the ladder's included, one dict each."""
    out = [dict(s) for s in traffic.get("stations", [])]
    lad = traffic.get("ladder")
    if lad:
        empty = set(lad.get("empty", []))
        level = float(lad["level_top_dbfs"])
        for i in range(int(lad["count"])):
            if i in empty:
                continue
            st = dict(lad["station"])
            st["carrier_hz"] = (float(lad["carrier_start_hz"])
                                + float(lad["carrier_step_hz"]) * i)
            st["level_dbfs"] = level
            level -= float(lad["level_step_db"])
            out.append(st)
    return out


class _Tone:
    """One complex exponential a * e^{j (2 pi k n / N + phi)}."""

    def __init__(self, k: int, amp: float, phase: float):
        self.k, self.amp, self.phase = k, amp, phase


class _Tones:
    """A station of the kinds known here: a sum of tones, under a
    raised-cosine envelope {"k": periods, "floor": f} or none."""

    def __init__(self, tones: list, env, n: int):
        self.tones, self.env, self.n = tones, env, n

    def fixed(self):
        return [(t.k, t.amp) for t in self.tones], self.env

    def __call__(self, idx: torch.Tensor):
        n = self.n
        scale = 2.0 * math.pi / n
        sr = torch.zeros(idx.shape, dtype=torch.float64, device=idx.device)
        si = torch.zeros_like(sr)
        for t in self.tones:
            ang = torch.remainder(idx * t.k, n).double() * scale + t.phase
            sr += t.amp * torch.cos(ang)
            si += t.amp * torch.sin(ang)
        if self.env is not None:
            ang = torch.remainder(idx * self.env["k"], n).double() * scale
            e = self.env["floor"] + (1.0 - self.env["floor"]) * (
                0.5 - 0.5 * torch.cos(ang))
            sr, si = sr * e, si * e
        return sr, si


def _station(st: dict, rate: float, n: int, rng):
    """One station of the traffic, its seed's draws made."""
    kind = st["kind"]
    if kind not in ("cw", "am", "ssb_voice"):
        path = KINDS / f"{kind}.py"
        if not kind.isidentifier() or not path.exists():
            raise ValueError(f"unknown station kind {kind!r}: no "
                             f"stations/{kind}.py")
        mod = importlib.import_module(f"sdrbench.stations.{kind}")
        return mod.parts(st, rate, n, rng)
    amp = FULL_SCALE * 10.0 ** (float(st["level_dbfs"]) / 20.0)
    fc = float(st["carrier_hz"])
    if kind == "cw":
        return _Tones([_Tone(_grid(fc, rate, n), amp, 0.0)], None, n)
    if kind == "am":
        depth = float(st.get("depth", 0.5))
        fm = float(st["tone_hz"])
        a0 = amp / (1.0 + depth)
        ph = float(rng.uniform(0.0, 2.0 * math.pi))
        return _Tones([_Tone(_grid(fc, rate, n), a0, 0.0),
                       _Tone(_grid(fc + fm, rate, n), a0 * depth / 2.0, ph),
                       _Tone(_grid(fc - fm, rate, n), a0 * depth / 2.0, -ph)],
                      None, n)
    sign = -1.0 if st.get("sideband", "usb") == "lsb" else 1.0
    tones = [float(f) for f in st["tones_hz"]]
    weights = np.asarray(st.get("weights", [1.0] * len(tones)), float)
    weights = weights / weights.sum()
    phases = rng.uniform(0.0, 2.0 * math.pi, len(tones))
    parts = [_Tone(_grid(fc + sign * f, rate, n), amp * w, float(p))
             for f, w, p in zip(tones, weights, phases)]
    env = {"k": _grid(float(st["envelope_hz"]), rate, n),
           "floor": float(st.get("envelope_floor", 0.1))}
    return _Tones(parts, env, n)


def stations(traffic: dict, seed: int) -> list:
    """Each station of the traffic, the seed's draws made."""
    n = int(traffic["capture_samples"])
    rate = float(traffic["sample_rate"])
    rng = np.random.default_rng(seed)
    return [_station(st, rate, n, rng) for st in expand(traffic)]


def signal(parts: list, idx: torch.Tensor) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The stations' sum at sample indices ``idx`` (int64, any, taken
    modulo the capture's length), float64, without noise or DC."""
    xr = torch.zeros(idx.shape, dtype=torch.float64, device=idx.device)
    xi = torch.zeros_like(xr)
    for station in parts:
        sr, si = station(idx)
        xr += sr
        xi += si
    return xr, xi


def make(traffic: dict, seed: int, device) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The capture of ``traffic`` for ``seed``: (re, im) int16 planes of
    ``capture_samples`` on ``device``."""
    device = torch.device(device)
    n = int(traffic["capture_samples"])
    parts = stations(traffic, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    sigma = FULL_SCALE * 10.0 ** (float(traffic["noise_dbfs"]) / 20.0) \
        / math.sqrt(2.0)
    dc = traffic.get("dc_counts", [0.0, 0.0])
    re = torch.empty(n, dtype=torch.int16, device=device)
    im = torch.empty(n, dtype=torch.int16, device=device)
    for s in range(0, n, CHUNK):
        idx = torch.arange(s, min(n, s + CHUNK), dtype=torch.int64,
                           device=device)
        sr, si = signal(parts, idx)
        for plane, x, d in ((re, sr, dc[0]), (im, si, dc[1])):
            x = x + float(d) + sigma * torch.randn(
                idx.shape, generator=gen, device=device,
                dtype=torch.float32).double()
            plane[s:s + idx.numel()] = torch.clamp(
                torch.round(x), -FULL_SCALE, FULL_SCALE).to(torch.int16)
    return re, im


def check(traffic: dict, config_rate: float) -> None:
    """Raise unless the traffic fits a configuration of ``config_rate``
    samples a second: its rate, and whole blocks in the capture."""
    if float(traffic["sample_rate"]) != float(config_rate):
        raise ValueError(f"traffic at {traffic['sample_rate']} S/s for a "
                         f"configuration at {config_rate}")
    n, b = int(traffic["capture_samples"]), int(traffic["block_samples"])
    if n % b:
        raise ValueError(f"capture of {n} samples is not whole blocks of {b}")
