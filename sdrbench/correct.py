"""Whether what the timed path produced is correct: a sample of the
window's blocks against the plain reference.

A block's record is what the host held of it: its index in the stream,
each channel's audio outputs before it, its audio and its S-meter row
(n_audio, average, peak).  The reference (``reference.chain``) works out
the same block from the capture alone, and two numbers are compared:

* ``audio_err``: the largest gap between a channel's audio and the
  reference's, output by output (aligned by their index in the stream),
  over the reference's peak in that block; a block whose first or last
  output lies more than one output away from the reference's, or whose
  gap is not a number, reads ``FAR`` (JSON has no inf);
* ``smeter_err_db``: the largest gap of the S-meter's average or peak, in
  dB.

Each number's limit comes from ``limits/<workload>.json``; PERF.md gives
the readings each was set from.  A number with no limit file is read and
shown, and fails.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from sdrbench.reference.chain import BlockOutput, Reference

NUMBERS = ("audio_err", "smeter_err_db")
FAR = 1e30


def limits_for(workload: str, root: Path) -> dict:
    path = root / "limits" / f"{workload}.json"
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)


def compare(before, audio, scal, ref: BlockOutput) -> dict:
    """The two numbers of one block: ``before`` [C] outputs before it,
    ``audio`` [C, cap], ``scal`` [3, C], against the reference's block."""
    C = len(ref.audio)
    audio = np.asarray(audio, np.float64).reshape(C, -1)
    scal = np.asarray(scal, np.float64).reshape(3, C)
    err, sm = 0.0, 0.0
    for c in range(C):
        ms = int(before[c])
        me = ms + int(scal[0, c])
        lo, hi = int(ref.m_lo[c]), int(ref.m_hi[c])
        if abs(ms - lo) > 1 or abs(me - hi) > 1 or me > ms + audio.shape[1]:
            err = FAR
            continue
        a, b = max(ms, lo), min(me, hi)
        got = audio[c, a - ms:b - ms]
        want = ref.audio[c][a - lo:b - lo]
        peak = float(np.max(np.abs(want))) if len(want) else 0.0
        gap = float(np.max(np.abs(got - want))) if len(want) else 0.0
        rel = gap / peak if peak > 0 else (0.0 if gap == 0 else FAR)
        err = max(err, rel if math.isfinite(rel) else FAR)
        gaps = (abs(scal[1, c] - ref.smeter_ave[c]),
                abs(scal[2, c] - ref.smeter_peak[c]))
        sm = max(sm, *(g if math.isfinite(g) else FAR for g in gaps))
    return {"audio_err": err, "smeter_err_db": float(sm)}


def as_record(b: int, out: BlockOutput, cap: int):
    """A reference's block in the form of the host's record (the control
    stands in for the program with it)."""
    C = len(out.audio)
    audio = np.zeros((C, cap))
    n = np.zeros(C)
    for c, row in enumerate(out.audio):
        audio[c, :len(row)] = row
        n[c] = len(row)
    scal = np.stack([n, out.smeter_ave, out.smeter_peak])
    return b, np.asarray(out.m_lo, np.int64), audio, scal


def readings(config: dict, traffic: dict, capture, records, device,
             precision: str = "float64") -> dict:
    """The two numbers over ``records`` (the worst block of each)."""
    ref = Reference(config, int(traffic["block_samples"]), precision, device)
    worst = dict.fromkeys(NUMBERS, 0.0)
    for b, before, audio, scal in records:
        got = compare(before, audio, scal, ref.block(capture, b))
        for k in NUMBERS:
            worst[k] = max(worst[k], got[k])
    return worst


def judge(config: dict, traffic: dict, capture, records, limits: dict,
          device) -> dict:
    """Each number beside its limit: {name: {"value", "limit"}}."""
    got = readings(config, traffic, capture, records, device)
    return {k: {"value": got[k], "limit": limits.get(k)} for k in NUMBERS}


def passed(checks: dict) -> bool:
    return all(c["limit"] is not None and c["value"] <= c["limit"]
               for c in checks.values())
