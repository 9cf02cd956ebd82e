"""The reference's parts, one module a part, found by file name.

Each module here (a name not starting with ``_``) declares ``STAGE``
(one of ``STAGES``), ``takes(rx)``, whether it works that stage for a
configuration's ``receiver`` dict, and ``Part``, built from ``(rx,
rates, precision, device)`` (``reference.stage``).  ``choose`` picks, for
each stage, the one part that takes a configuration: a new mode, input
stage or AGC is a new file here, and no file is edited.
"""

from __future__ import annotations

import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent
STAGES = ("input", "levels", "demod")
# stages that are the identity where no part takes them
OPTIONAL = ("input",)


def listing() -> dict:
    """Every part's module by name."""
    return {p.stem: importlib.import_module(f"{__name__}.{p.stem}")
            for p in sorted(HERE.glob("*.py"))
            if not p.stem.startswith("_")}


def choose(rx: dict) -> dict:
    """Each stage's module for ``rx`` (None for an optional stage that no
    part takes).  Raises where a stage has no part, or more than one."""
    mods = listing()
    for name, mod in mods.items():
        if mod.STAGE not in STAGES:
            raise ValueError(f"part {name!r} has stage {mod.STAGE!r}, not "
                             f"one of {STAGES}")
    chosen = {}
    for stage in STAGES:
        names = [n for n, m in mods.items() if m.STAGE == stage
                 and m.takes(rx)]
        if len(names) > 1:
            raise ValueError(f"{stage} parts {names} all take mode "
                             f"{rx.get('mode')!r}")
        if not names and stage not in OPTIONAL:
            settings = {k: rx[k] for k in ("agc_on", "agc_hang", "nb_on",
                                           "stereo") if k in rx}
            raise ValueError(f"no {stage} part takes mode "
                             f"{rx.get('mode')!r} ({settings})")
        chosen[stage] = mods[names[0]] if names else None
    return chosen
