"""Small cells of the benchmark's configurations for the CPU tests: the
configuration's own file, with a 20 ms AGC decay (so the reference's
warm-up is 0.4 s of signal), a short capture and one-frame blocks; and
an FM listener with the noise blanker on, built inline from the
flagship's files (no cell of the benchmark has it yet)."""

import copy
import json
from pathlib import Path

from sdrbench import spec

ROOT = Path(__file__).resolve().parents[1]


def cell(config: str, traffic: str, capture_samples: int, block: int,
         channels: int | None = None, per_layer=()) -> spec.Cell:
    cfg = json.loads((ROOT / "configs" / f"{config}.json").read_text())
    tr = json.loads((ROOT / "traffic" / f"{traffic}.json").read_text())
    cfg["receiver"]["agc_decay_ms"] = 20.0
    tr["capture_samples"] = capture_samples
    tr["block_samples"] = block
    if channels is not None:
        cfg["channels"]["count"] = channels
        tr["ladder"]["count"] = channels
        tr["ladder"]["empty"] = [1]
    e2e = [{"name": n} for n in ("msps", "block_p95_ms", "setup_s")]
    return spec.Cell(f"small_{config}", copy.deepcopy(cfg), tr, 1, e2e,
                     list(per_layer))


def listener(**kw) -> spec.Cell:
    return cell("listener_usb_2msps", "capture_flagship_blocks", 1 << 20,
                32768, **kw)


def bank(**kw) -> spec.Cell:
    return cell("monitor_bank64_usb_10msps", "band_capture_13ms_blocks",
                1 << 21, 131072, channels=3, **kw)


# an NBFM station at the tune (a voice stand-in of three tones at 2.5 kHz
# peak deviation) and a train of 10 us impulses at full scale, ringing at
# the tune, 100 a second, over the flagship's -70 dBFS noise and DC spur
FM_STATIONS = [
    {"kind": "nbfm_voice", "carrier_hz": 100000.0, "level_dbfs": -20.0,
     "tones_hz": [400.0, 1000.0, 1700.0],
     "deviation_hz": [1000.0, 800.0, 700.0]},
    {"kind": "impulses", "carrier_hz": 100000.0, "level_dbfs": 0.0,
     "rate_hz": 100.0, "width_us": 10.0},
]


def fm_nb(**kw) -> spec.Cell:
    """The FM listener with the blanker: the flagship's configuration in
    mode ``fm`` with FM's cuts, the blanker on at threshold 50 and 20 us
    (40 samples, over the 20-sample pulses and the delay of 21), and an
    inline traffic of ``FM_STATIONS``, at the listener's small size."""
    c = cell("listener_usb_2msps", "capture_flagship_blocks", 1 << 20, 32768,
             **kw)
    c.config["receiver"].update(mode="fm", low_cut=-7500.0, hi_cut=7500.0,
                                nb_on=True, nb_threshold=50.0,
                                nb_width_us=20.0)
    c.config["name"] = "fm_nb_inline"
    c.traffic.update(name="fm_nb_impulse_inline",
                     stations=copy.deepcopy(FM_STATIONS))
    c.name = "small_fm_nb"
    return c
