"""Finds what a cell is made of, by name, from files of their own.

``BENCHMARK.json`` at the root names the cells, their configuration and
traffic, and the metrics.  The rest sits beside this file:

* ``configs/<config>.json``: the deployment (``ReceiverConfig`` fields
  under ``receiver``, the entry, a bank's channels, the DC cal);
* ``traffic/<traffic>.json``: the capture's parameters (``capture``);
* ``metrics/<metric>.py``: one reader a per-layer metric, with ``UNIT``,
  ``LAYER`` (a key of ``layers/``), ``MOVES`` and ``read(ctx)``;
* ``layers/<layer>.json``: a layer's name and the kernel symbols the
  device trace gives it.

Nothing here names a configuration, a traffic or a metric: each is found
by the name ``BENCHMARK.json`` gives it, so a new one is new files.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    """One cell: its entry in ``BENCHMARK.json`` and what it names."""
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def listing(kind: str, root: Path = HERE) -> dict[str, Path]:
    """The files of one kind (``configs``, ``traffic``, ``metrics``,
    ``layers``) by name."""
    suffix = ".py" if kind == "metrics" else ".json"
    d = root / kind
    if not d.is_dir():
        return {}
    return {p.stem: p for p in sorted(d.iterdir())
            if p.suffix == suffix and not p.stem.startswith("_")}


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict, root: Path = HERE,
              repo: Path = HERE.parent) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json``'s object), its
    configuration and traffic read from their files."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(repo / configs[w["config"]]["file"])
    traffic_files = listing("traffic", root)
    if w["traffic"] not in traffic_files:
        raise KeyError(f"no traffic file for {w['traffic']!r}")
    traffic = _json(traffic_files[w["traffic"]])
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def load_metric(name: str, root: Path = HERE):
    """The reader module of per-layer metric ``name``."""
    files = listing("metrics", root)
    if name not in files:
        raise KeyError(f"no reader for metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"sdrbench_metric_{name}", files[name])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_layers(root: Path = HERE) -> dict[str, dict]:
    """Every layer map: key -> {"layer": name, "kernels": [symbols]}."""
    return {k: _json(p) for k, p in listing("layers", root).items()}


def load_benchmark(repo: Path) -> dict:
    return _json(repo / "BENCHMARK.json")
