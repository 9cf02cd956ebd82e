"""The roofline's work counts against hand arithmetic at the flagship's
shapes (2 MSPS USB, 8,388,608-sample blocks)."""

import json

import pytest

from sdrbench import work
from sdrbench.tests import small


@pytest.fixture
def flagship():
    cfg = json.loads((small.ROOT / "configs" /
                      "listener_usb_2msps.json").read_text())
    tr = json.loads((small.ROOT / "traffic" /
                     "capture_flagship_blocks.json").read_text())
    return work.shapes(cfg, tr)


def test_shapes(flagship):
    assert flagship.decimation == 32
    assert flagship.demod == 262144


def test_front_end(flagship):
    # stages hb11, hb11, hb15, hb23, hb51: 7, 7, 9, 13, 27 non-zero taps
    # at 16, 8, 4, 2, 1 outputs a final output; 1,063 composed taps
    macs = 262144 * (7 * 16 + 7 * 8 + 9 * 4 + 13 * 2 + 27)
    nbytes, flops = work.front_end(flagship)
    assert nbytes == 8388608 * 8 + 1062 * 8 + 262144 * 8
    assert flops == 6 * 8388608 + 4 * macs
    assert work.least_s(nbytes, flops) == pytest.approx(69214512 / 3.35e12)


def test_channel_filter(flagship):
    nbytes, flops = work.channel_filter(flagship)
    assert nbytes == (1024 + 2 * 262144) * 8 + 2048 * 8
    assert flops == 256 * (8 * 2048 * 11 + 6 * 2048)


def test_resampler(flagship):
    outputs = 262144 * 48000 / 62500
    nbytes, flops = work.resampler(flagship)
    assert nbytes == pytest.approx((28 + 262144) * 4 + outputs * 4)
    assert flops == pytest.approx(outputs * 28 * 2)
