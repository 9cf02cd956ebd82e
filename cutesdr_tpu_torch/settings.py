"""Session settings persistence + stream-state checkpointing.

Reference analogue: QSettings under MoeTronix/CuteSdr — ~55 keys covering
radio/network parameters, FFT/display setup, volume, NCO-spur cal offsets,
and the per-mode demod settings array (gui/mainwindow.cpp:272-458).  Here:
one JSON document with the same information organized as dataclasses.

Checkpoint/resume (new capability — the reference has none): the receiver's
carry pytree (filter tails, NCO phase accumulator, PLL/AGC averages,
resampler time, stream offset) serializes to an .npz, giving deterministic
mid-stream resume.

The port's own copy of ``cutesdr_tpu/settings.py``: the same settings
documents; the checkpoint flattens the port's ``ReceiverState`` (NamedTuples
of tensors) in field order.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path

import numpy as np
import torch

from cutesdr_tpu_torch.pipeline.receiver import (MODE_DEFAULT_CUTS,
                                                 ReceiverConfig)


@dataclass
class DemodSettings:
    """Per-mode user settings (the m_DemodSettings[] array)."""
    hi_cut: float
    low_cut: float
    offset: float = 0.0
    squelch_value: int = 0
    agc_slope: float = 0.0
    agc_thresh: float = -100.0
    agc_manual_gain: float = 30.0
    agc_decay: float = 200.0
    agc_on: bool = True
    agc_hang_on: bool = False
    filter_click_resolution: int = 100


@dataclass
class RadioSettings:
    ip: str = "10.0.0.100"
    port: int = 50000
    radio_type: str = "NetSDR"
    bandwidth_index: int = 0
    rf_gain: int = 0
    center_frequency: int = 15_000_000
    demod_frequency: int = 15_000_000
    spur_offset_i: float = 0.0
    spur_offset_q: float = 0.0


@dataclass
class DisplaySettings:
    fft_size: int = 4096
    fft_ave: int = 1
    max_display_rate: int = 10
    span_freq: int = 100_000
    max_db: float = 0.0
    min_db: float = -120.0


@dataclass
class SessionSettings:
    radio: RadioSettings = field(default_factory=RadioSettings)
    display: DisplaySettings = field(default_factory=DisplaySettings)
    demod_mode: str = "usb"
    volume: int = 80
    stereo: bool = False
    nb_on: bool = False
    nb_threshold: float = 50.0
    nb_width_us: float = 2.0
    demod: dict[str, DemodSettings] = field(default_factory=dict)

    def __post_init__(self):
        for mode, (lo, hi) in MODE_DEFAULT_CUTS.items():
            self.demod.setdefault(mode, DemodSettings(hi_cut=hi, low_cut=lo))

    def save(self, path: str | Path) -> None:
        doc = asdict(self)
        Path(path).write_text(json.dumps(doc, indent=2))

    @classmethod
    def load(cls, path: str | Path) -> "SessionSettings":
        if not Path(path).exists():
            return cls()
        doc = json.loads(Path(path).read_text())
        radio = RadioSettings(**doc.get("radio", {}))
        display = DisplaySettings(**doc.get("display", {}))
        demod = {k: DemodSettings(**v) for k, v in doc.get("demod", {}).items()}
        rest = {k: v for k, v in doc.items()
                if k not in ("radio", "display", "demod")}
        return cls(radio=radio, display=display, demod=demod, **rest)


def receiver_config_from_settings(s: SessionSettings, input_rate: float,
                                  mode: str | None = None) -> ReceiverConfig:
    """Build a ReceiverConfig from persisted settings — the equivalent of
    MainWindow handing m_DemodSettings[mode] to SetDemod
    (gui/mainwindow.cpp:967-994)."""
    mode = mode or s.demod_mode
    d = s.demod[mode]
    return ReceiverConfig(
        input_rate=input_rate, mode=mode,
        low_cut=d.low_cut, hi_cut=d.hi_cut, cw_offset=d.offset,
        tune_freq=float(s.radio.demod_frequency - s.radio.center_frequency),
        agc_on=d.agc_on, agc_hang=d.agc_hang_on,
        agc_thresh_db=d.agc_thresh, agc_manual_gain_db=d.agc_manual_gain,
        agc_slope=d.agc_slope, agc_decay_ms=d.agc_decay,
        squelch_ui=d.squelch_value,
        nb_on=s.nb_on, nb_threshold=s.nb_threshold,
        nb_width_us=s.nb_width_us, stereo=s.stereo)


# ----------------------------------------------------------- checkpointing --

def _leaves(tree) -> list[torch.Tensor]:
    """The tensors of a state (NamedTuples of tensors, None for absent
    parts) in field order."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def _rebuild(tree, leaves):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(_rebuild(sub, leaves) for sub in tree))
    return next(leaves)


def save_state(path: str | Path, state, stream_offset: int = 0) -> None:
    """Serialize a receiver state (+ stream position) to .npz."""
    arrays = {f"leaf_{i}": v.detach().cpu().numpy()
              for i, v in enumerate(_leaves(state))}
    arrays["__stream_offset__"] = np.asarray(stream_offset, np.int64)
    np.savez(path, **arrays)


def load_state(path: str | Path, state_template):
    """Restore a state saved by save_state; returns (state, stream_offset).
    The template supplies the structure, dtypes and device; a leaf of
    another shape (another configuration) raises ValueError."""
    data = np.load(path)
    restored = []
    for i, tmpl in enumerate(_leaves(state_template)):
        a = data[f"leaf_{i}"]
        if tuple(a.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"checkpoint leaf {i} shape {a.shape} != template "
                f"{tuple(tmpl.shape)} (config mismatch)")
        restored.append(torch.from_numpy(a).to(tmpl.device, tmpl.dtype))
    return (_rebuild(state_template, iter(restored)),
            int(data["__stream_offset__"]))
