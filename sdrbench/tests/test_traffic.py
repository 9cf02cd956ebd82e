"""Every seed of a traffic gives the same structure and work, and a
capture repeats without a step: each traffic file's, and the inline FM
traffic's (its kinds are files of ``stations/``)."""

import json
import math

import pytest
import torch

from sdrbench import capture, run
from sdrbench.tests import small

INLINE = "fm_nb_inline"
TRAFFIC = sorted(p.stem for p in (small.ROOT / "traffic").glob("*.json")) \
    + [INLINE]


def _traffic(name, n=1 << 16):
    if name == INLINE:
        tr = small.fm_nb().traffic
    else:
        tr = json.loads((small.ROOT / "traffic" / f"{name}.json")
                        .read_text())
    tr["capture_samples"] = n
    return tr


@pytest.mark.parametrize("name", TRAFFIC)
def test_seeds_share_structure(name):
    tr = _traffic(name)
    a, b = capture.stations(tr, 1), capture.stations(tr, 2 ** 31 + 7)
    assert len(a) == len(b) > 0
    for sa, sb in zip(a, b):
        assert type(sa) is type(sb) and sa.fixed() == sb.fixed()
    ra, _ = capture.make(tr, 1, "cpu")
    rb, _ = capture.make(tr, 2 ** 31 + 7, "cpu")
    assert not torch.equal(ra, rb)


@pytest.mark.parametrize("name", TRAFFIC)
def test_capture_wraps_without_a_step(name):
    n = 1 << 16
    tr = _traffic(name, n)
    parts = capture.stations(tr, 5)
    xr, xi = capture.signal(parts, torch.arange(0, n + 64))
    assert torch.equal(xr[n:], xr[:64]) and torch.equal(xi[n:], xi[:64])
    step = (xr.diff().abs() + xi.diff().abs())
    assert step[n - 1] <= step[:n - 1].max()


def _kind(stations, name):
    return [s for s in stations if type(s).__module__.endswith(name)]


def test_an_impulse_train_is_the_same_for_every_seed():
    tr = _traffic(INLINE)
    n, idx = tr["capture_samples"], torch.arange(0, tr["capture_samples"])
    trains = [_kind(capture.stations(tr, seed), "impulses")[0](idx)
              for seed in (1, 2 ** 31 + 7)]
    assert all(torch.equal(x, y) for x, y in zip(*trains))
    st = [s for s in tr["stations"] if s["kind"] == "impulses"][0]
    count = round(st["rate_hz"] * n / tr["sample_rate"])
    width = round(st["width_us"] * 1e-6 * tr["sample_rate"])
    on = (trains[0][0] != 0) | (trains[0][1] != 0)
    assert int(on.sum()) == count * width
    peak = torch.hypot(*trains[0]).max()
    assert float(peak) == pytest.approx(
        capture.FULL_SCALE * 10 ** (st["level_dbfs"] / 20))


def test_an_fm_station_has_a_constant_envelope_and_its_deviation():
    tr = _traffic(INLINE)
    st = [s for s in tr["stations"] if s["kind"] == "nbfm_voice"][0]
    fm = _kind(capture.stations(tr, 5), "nbfm_voice")[0]
    xr, xi = fm(torch.arange(0, tr["capture_samples"] + 1))
    amp = capture.FULL_SCALE * 10 ** (st["level_dbfs"] / 20)
    assert torch.allclose(torch.hypot(xr, xi), torch.tensor(amp,
                          dtype=torch.float64), rtol=1e-12)
    # the instantaneous frequency stays within the carrier +- the summed
    # deviations, and comes near both edges (this seed's phases)
    z = torch.complex(xr, xi)
    f = torch.angle(z[1:] * z[:-1].conj()) * tr["sample_rate"] / (2 * math.pi)
    dev = sum(st["deviation_hz"])
    carrier = round(st["carrier_hz"] * tr["capture_samples"]
                    / tr["sample_rate"]) * tr["sample_rate"] \
        / tr["capture_samples"]
    assert float((f - carrier).abs().max()) <= dev * 1.001
    assert float((f - carrier).max()) > 0.9 * dev
    assert float((f - carrier).min()) < -0.9 * dev


def test_ladder_levels_and_empty_channels():
    tr = _traffic("band_capture_13ms_blocks")
    lad = tr["ladder"]
    st = capture.expand(tr)
    assert len(st) == lad["count"] - len(lad["empty"])
    levels = [s["level_dbfs"] for s in st]
    assert levels[0] == lad["level_top_dbfs"]
    assert all(abs(a - b - lad["level_step_db"]) < 1e-9
               for a, b in zip(levels, levels[1:]))


def test_two_seeds_do_the_same_work():
    cell = small.listener()
    counts = [run.run_cell(cell, seed, 0.3, False, device="cpu",
                           limits={})[1] for seed in (11, 2 ** 31 + 3)]
    for k in ("agc_fallbacks", "pll_tiers", "launches_per_block"):
        assert counts[0][k] == counts[1][k]
    assert counts[0]["agc_fallbacks"] == 0
