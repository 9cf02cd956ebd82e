"""Every seed of a traffic gives the same structure and work, and a
capture repeats without a step."""

import json

import pytest
import torch

from sdrbench import capture, run
from sdrbench.tests import small

TRAFFIC = sorted(p.stem for p in (small.ROOT / "traffic").glob("*.json"))


def _traffic(name, n=1 << 16):
    tr = json.loads((small.ROOT / "traffic" / f"{name}.json").read_text())
    tr["capture_samples"] = n
    return tr


@pytest.mark.parametrize("name", TRAFFIC)
def test_seeds_share_structure(name):
    tr = _traffic(name)
    a, b = capture.stations(tr, 1), capture.stations(tr, 2 ** 31 + 7)
    assert len(a) == len(b) > 0
    for (ta, ea), (tb, eb) in zip(a, b):
        assert [(t.k, t.amp) for t in ta] == [(t.k, t.amp) for t in tb]
        assert ea == eb
    ra, _ = capture.make(tr, 1, "cpu")
    rb, _ = capture.make(tr, 2 ** 31 + 7, "cpu")
    assert not torch.equal(ra, rb)


@pytest.mark.parametrize("name", TRAFFIC)
def test_capture_wraps_without_a_step(name):
    n = 1 << 16
    tr = _traffic(name, n)
    parts = capture.stations(tr, 5)
    xr, xi = capture.signal(parts, torch.arange(0, n + 64), n)
    assert torch.equal(xr[n:], xr[:64]) and torch.equal(xi[n:], xi[:64])
    step = (xr.diff().abs() + xi.diff().abs())
    assert step[n - 1] <= step[:n - 1].max()


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
