"""The traced run's Chrome trace (``torch.profiler``'s export), reduced
to host spans and device events, and the arithmetic on them.

Host spans are the ``user_annotation`` events: the program's stages
(``timing.stage``, on every thread) and the harness's own spans around
the window and around each compress and decompress call.  Device events
are the kernels, copies and memsets (``kernel``, ``gpu_memcpy``,
``gpu_memset``), with the card that ran them.  Times are in
microseconds, on the clock the profiler aligns both to.
"""

from __future__ import annotations

import collections
import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: prefix of the harness's own spans
OWN = "portbench."

Interval = Tuple[float, float]


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float


@dataclasses.dataclass
class DeviceEvent:
    name: str
    cat: str
    start: float
    end: float
    device: int


@dataclasses.dataclass
class Trace:
    spans: List[Span]
    device: List[DeviceEvent]

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


def load(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return from_events(events)


def from_events(events: Iterable[Dict]) -> Trace:
    spans, dev = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0))
        if cat == "user_annotation":
            spans.append(Span(e["name"], ts, ts + dur))
        elif cat in DEVICE_CATS:
            d = e.get("args", {}).get("device", e.get("pid", 0))
            dev.append(DeviceEvent(e["name"], cat, ts, ts + dur, int(d)))
    return Trace(spans, dev)


def union_us(intervals: Iterable[Interval]) -> float:
    """Length of the union of ``(start, end)`` intervals (a copy of
    ``scalce_tpu_torch.stage_profile._union_s``, in the intervals' unit)."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of the intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals: Iterable[Interval],
         windows: Sequence[Interval]) -> List[Interval]:
    """Every interval's overlap with every window (the windows are
    disjoint)."""
    out = []
    for s, e in intervals:
        for ws, we in windows:
            lo, hi = max(s, ws), min(e, we)
            if hi > lo:
                out.append((lo, hi))
    return out


def busy_by_device(events: Iterable[DeviceEvent],
                   windows: Sequence[Interval]) -> Dict[int, float]:
    """Per device that ran an event inside ``windows``: the union of its
    events' intervals there."""
    per: Dict[int, List[Interval]] = collections.defaultdict(list)
    for ev in events:
        per[ev.device].append((ev.start, ev.end))
    out = {}
    for d, iv in per.items():
        inside = clip(iv, windows)
        if inside:
            out[d] = union_us(inside)
    return out


def idle_share(events: Iterable[DeviceEvent],
               windows: Sequence[Interval]) -> Optional[float]:
    """Percent of the windows' time in which a device ran nothing,
    averaged over the devices that ran something in them; None when no
    device did."""
    busy = busy_by_device(events, windows)
    span = sum(we - ws for ws, we in windows)
    if not busy or span <= 0:
        return None
    return 100.0 * (1.0 - sum(busy.values()) / len(busy) / span)


def time_in(spans: Iterable[Span], windows: Sequence[Interval]) -> float:
    """Summed length of the spans that start inside a window."""
    return sum(s.end - s.start for s in spans
               if any(ws <= s.start < we for ws, we in windows))


def short_name(name: str, width: int = 96) -> str:
    """A device event's name without a kernel's argument list."""
    if not name.startswith(("Memcpy", "Memset")):
        name = name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0]
        if name.startswith("void "):
            name = name[5:]
    return name[:width]


def top_device_ops(events: Iterable[DeviceEvent],
                   window: Interval, n: int = 10) -> List[List]:
    """The ``n`` device operations that took most time in ``window``:
    ``[name, seconds]`` summed over their events."""
    per: Dict[str, float] = collections.defaultdict(float)
    for ev in events:
        lo, hi = max(ev.start, window[0]), min(ev.end, window[1])
        if hi > lo:
            per[short_name(ev.name)] += (hi - lo) / 1e6
    return [[k, v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(tr: Trace, window: Interval, n: int = 10) -> List[List]:
    """The ``n`` longest stretches of ``window`` in which no device ran
    anything, ``[label, seconds]``: the label names the harness's call
    that the stretch falls in (or "between calls") and the program's
    stage whose spans, on any thread, cover most of the stretch (or "no
    stage")."""
    busy = merged(clip([(e.start, e.end) for e in tr.device], [window]))
    gaps, t = [], window[0]
    for s, e in busy + [(window[1], window[1])]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:n]:
        mid = (s + e) / 2
        calls = [sp.name[len(OWN):] for sp in tr.spans
                 if sp.name.startswith(OWN) and sp.name != OWN + "window"
                 and sp.start <= mid < sp.end]
        cover: Dict[str, float] = collections.defaultdict(float)
        for sp in tr.spans:
            if not sp.name.startswith(OWN):
                cover[sp.name] += max(0.0, min(sp.end, e) - max(sp.start, s))
        stage = max(cover, key=cover.get) if cover and max(
            cover.values()) > 0 else "no stage"
        label = (calls[0] if calls else "between calls") + ": " + stage
        out.append([label, (e - s) / 1e6])
    return out
