"""Runtime metrics and observability.

Reference analogue: the status-bar / qDebug monitors scattered through the
reference — UDP missed-packet counter (interface/netiobase.cpp:488-496),
sound queue depth + ppm rate error + over/underflow messages
(interface/soundout.cpp), keepalive watchdog, A/D overload flag, S-meter.
Here: one structured metrics registry updated per superblock, queryable as
a dict and renderable as a status line.

The port's own copy of ``cutesdr_tpu/metrics.py`` (plain Python).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class StreamMetrics:
    started_at: float = field(default_factory=time.monotonic)
    samples_in: int = 0
    blocks: int = 0
    audio_samples_out: int = 0
    missed_packets: int = 0
    dropped_samples: int = 0
    audio_overflows: int = 0
    audio_underflows: int = 0
    ppm_error: int = 0
    smeter_ave_db: float = -120.0
    smeter_peak_db: float = -120.0
    squelch_open: bool = True
    # PLL solver-tier counters (probes-enabled SAM/FM sessions only):
    # blocks solved by tier 0 = parallel linear, 1 = chunked guess-verify,
    # 2 = sequential scan — a persistent all-tier-2 stream flags a silent
    # fallback regression (ADVICE r4)
    pll_tier_blocks: list = field(default_factory=lambda: [0, 0, 0])
    # the A/D-overload flag's source (a session's display analyzer, whose
    # flag stays on the device): read when the metrics are reported, not
    # on every block
    overload_flag: Optional[Callable[[], bool]] = field(default=None,
                                                        repr=False)

    @property
    def overload(self) -> bool:
        return bool(self.overload_flag()) if self.overload_flag else False

    def update_block(self, n_in: int, n_audio: int, smeter_ave: float,
                     smeter_peak: float) -> None:
        self.samples_in += n_in
        self.blocks += 1
        self.audio_samples_out += n_audio
        self.smeter_ave_db = smeter_ave
        self.smeter_peak_db = smeter_peak

    @property
    def elapsed(self) -> float:
        return time.monotonic() - self.started_at

    @property
    def throughput_msps(self) -> float:
        e = self.elapsed
        return self.samples_in / e / 1e6 if e > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "elapsed_s": round(self.elapsed, 2),
            "samples_in": self.samples_in,
            "blocks": self.blocks,
            "throughput_msps": round(self.throughput_msps, 3),
            "audio_samples_out": self.audio_samples_out,
            "missed_packets": self.missed_packets,
            "dropped_samples": self.dropped_samples,
            "audio_overflows": self.audio_overflows,
            "audio_underflows": self.audio_underflows,
            "ppm_error": self.ppm_error,
            "smeter_ave_db": round(self.smeter_ave_db, 1),
            "smeter_peak_db": round(self.smeter_peak_db, 1),
            "overload": self.overload,
            "squelch_open": self.squelch_open,
        }

    def json_line(self) -> str:
        return json.dumps(self.as_dict())

    def status_line(self) -> str:
        """The status-bar string (connection metrics + S-meter + rate)."""
        return (f"{self.throughput_msps:6.2f} Msps | "
                f"S {self.smeter_ave_db:6.1f} dB | "
                f"gap {self.missed_packets} | ppm {self.ppm_error:+d} | "
                f"{'OVR ' if self.overload else ''}"
                f"{'SQ' if not self.squelch_open else ''}")
