"""Reading a traced window: the device's activity from ``torch.profiler``
and the benchmark's own spans.

The harness marks what the host does with ``record_function`` spans
(``submit``, ``collect``); this module turns the profiler's events into
what the per-layer readers read (``Context``) and into the breakdown of
the result line: the device operations that took most time, and the
longest idle gaps named by the span the host was in.
"""

from __future__ import annotations

from dataclasses import dataclass, field

SPANS = ("submit", "collect")


@dataclass
class Context:
    """What a per-layer reader reads: the traced window's device events
    ((name, start_s, seconds)), the blocks submitted in it, its length
    and busy time, the benchmark's spans of the untraced blocks (seconds
    each), the compute stream's (idle, timed) seconds over the untraced
    blocks by their CUDA events, the cell's shapes and the layer maps."""
    events: list
    blocks: int
    window_s: float
    busy_s: float
    spans: dict
    stream_idle: tuple
    shapes: object
    layers: dict
    _by_layer: dict = field(default_factory=dict)

    def device_s(self, layer: str) -> float | None:
        """Device seconds of the layer's kernels in the window (None where
        none ran)."""
        if layer not in self._by_layer:
            pats = self.layers[layer].get("kernels")
            hits = [d for name, _, d in self.events
                    if pats is None or any(p in name for p in pats)]
            self._by_layer[layer] = sum(hits) if hits else None
        return self._by_layer[layer]

    def device_items(self) -> int:
        return len(self.events)


def device_events(prof) -> tuple[list, list]:
    """(device events, host spans) of a finished profiler: ``(name,
    start_s, seconds)`` for every kernel, copy and set on the device, and
    ``(name, start_s, end_s)`` for the benchmark's spans."""
    dev, host = [], []
    for e in prof.events():
        start = e.time_range.start * 1e-6
        end = e.time_range.end * 1e-6
        if "CUDA" in str(e.device_type):
            # record_function spans also come as device-side annotations
            if e.name not in SPANS and not getattr(e, "is_user_annotation",
                                                   False):
                dev.append((e.name, start, end - start))
        elif e.name in SPANS:
            host.append((e.name, start, end))
    dev.sort(key=lambda t: t[1])
    return dev, host


def busy_and_gaps(dev: list, t0: float, t1: float) -> tuple[float, list]:
    """Seconds in [t0, t1] in which the device ran something, and the idle
    gaps (start, seconds) between."""
    busy, gaps = 0.0, []
    cur_s, cur_e = None, t0
    for _, s, d in dev:
        s, e = max(s, t0), min(s + d, t1)
        if e <= s:
            continue
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s - cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if t1 > cur_e:
        gaps.append((cur_e, t1 - cur_e))
    return busy, gaps


def breakdown(dev: list, gaps: list, host: list, top: int = 10) -> dict:
    """The device operations that took most time ([name, seconds]) and the
    longest idle gaps by the span the host was in at the gap's start."""
    by_name: dict = {}
    for name, _, d in dev:
        by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    named = []
    for start, length in sorted(gaps, key=lambda g: -g[1])[:top]:
        label = "other"
        for name, s, e in host:
            if s <= start < e:
                label = name
                break
        named.append([label, length])
    return {"device_ops": [[n[:96], t] for n, t in ops], "idle_gaps": named}
