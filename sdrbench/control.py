"""The readings that a cell's limits are set from: the program's numbers
over many seeds, and the control's.

    python3 -m sdrbench.control --workload NAME --seeds 1,2,3 --seconds S
        [--control] [--warm-check]

For each seed, one run of the cell (``run.run_cell``, without limits)
gives the program's two numbers over the blocks it checks.  With
``--control`` the control stands in for the program on the same blocks:
the reference computed in TF32 (``reference.chain``, ``precision="tf32"``),
held against the float64 reference as the program is.  With
``--warm-check`` the float64 reference is also worked out from twice as
many warm-up blocks, and its gap to the usual one is shown: it should be
far below the program's.  One JSON line a seed.  Runs on the card only,
as the benchmark does.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from sdrbench import correct, run, spec
from sdrbench.reference.chain import Reference


def control_readings(cell, keep: dict, device, warm_factor: int = 1,
                     precision: str = "tf32") -> dict:
    """The two numbers of ``precision``'s reference (or, at float64, of
    the reference from ``warm_factor`` times the warm-up) standing in for
    the program on the blocks of ``keep``."""
    B = int(cell.traffic["block_samples"])
    ref = Reference(cell.config, B, "float64", device)
    other = Reference(cell.config, B, precision, device)
    other.warm = ref.warm * warm_factor
    worst = dict.fromkeys(correct.NUMBERS, 0.0)
    cap = run.receiver_config(cell.config, cell.traffic).audio_block_cap
    for b, *_ in keep["records"]:
        _, before, audio, scal = correct.as_record(
            b, other.block(keep["capture"], b), cap)
        got = correct.compare(before, audio, scal,
                              ref.block(keep["capture"], b))
        for k in worst:
            worst[k] = max(worst[k], got[k])
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m sdrbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--warm-check", action="store_true")
    args = ap.parse_args(argv)
    repo = Path.cwd()
    cell = spec.load_cell(args.workload, spec.load_benchmark(repo), repo=repo)
    run.cache_dirs(repo)
    import torch
    if not torch.cuda.is_available():
        print("sdrbench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        keep: dict = {}
        result, counts = run.run_cell(cell, seed, args.seconds, False,
                                      limits={}, keep=keep)
        line = {"seed": seed, "program": {k: v["value"] for k, v in
                                          result["checks"].items()},
                "blocks": [r[0] for r in keep["records"]],
                "work": counts, "metrics": result["metrics"],
                "failed": result["failed"]}
        if args.control:
            line["control"] = control_readings(cell, keep, "cuda")
        if args.warm_check:
            line["warm2"] = control_readings(cell, keep, "cuda", 2,
                                             "float64")
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
