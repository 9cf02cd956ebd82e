"""Small cells of the benchmark's configurations for the CPU tests: the
configuration's own file, with a 20 ms AGC decay (so the reference's
warm-up is 0.4 s of signal), a short capture and one-frame blocks."""

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
