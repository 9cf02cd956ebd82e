"""Throughput of the PyTorch + CUDA port's flagship receiver on the card.

    python3 bench_torch.py [--reps N] [--iters N] [--frames-per-block N]

Runs ``bench.py``'s flagship configuration (2 MSPS USB, tune 100 kHz,
48 kHz audio, frames_per_block=256: 8,388,608 input samples a step) with
the input resident on the card and the state chained, and prints ONE JSON
line on stdout:

  {"metric": "iq_msps_per_gpu", "value": N, "unit": "Msamples/s",
   "vs_baseline": N, "stats": {...}, "ms_per_step": ..., ...}

``vs_baseline`` is Msps / 2.0: the reference sustains a 2 MSPS stream in
real time on one ~3 GHz x86 core (BASELINE.md).  Details go to stderr; an
error prints a line with ``error`` and exits 1.  ``--device cpu`` exists
for the tests.  The work is ``cutesdr_tpu_torch.bench_suite.bench_receiver``
(also ``python -m cutesdr_tpu_torch.cli bench``).
"""

import sys

from cutesdr_tpu_torch.bench_suite import flagship_main

if __name__ == "__main__":
    sys.exit(flagship_main())
