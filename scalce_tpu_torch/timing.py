"""The pipeline's stage spans, wait spans and counters, recorded under
``--profile`` (:func:`profile`).

The pipeline wraps each stage, and each blocking wait of one thread on
another (``wait ...``), in :func:`stage`, and counts what crosses the
link, what the delta leaves as literals and the blocks whose delta the
host matched with :func:`count`.  Off (the
default) a stage or a count costs one global check and adds no clock,
lock, thread or device work.  Inside :func:`profile` each stage is a
``torch.profiler.record_function`` span of its name, on the thread that
runs it (the profile records every thread); stages may nest within a
thread.  Counts add to the current driver call's counters (``compress``
or ``decompress``, named by :func:`begin`).  When the profile stops, each
kernel, copy and memset a card ran is given to the innermost stage
around the host call that queued it (:func:`device_time_by_stage`), per
card too (:func:`device_time_by_card`), and :func:`counters` returns the
counters and that device time.

:func:`device_busy` runs a call under its own ``torch.profiler`` and
gives the card's busy seconds (:func:`union_s`) and its device seconds
by kind (:func:`device_event_kind`: the port's kernels K1-K8 by their
CUDA names, :data:`PORT_KERNELS`, the copies, the other torch kernels).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import (Callable, Dict, Iterable, Iterator, List, Mapping,
                    Optional, Tuple)

import torch

#: True while :func:`profile` records
_profiling = False
#: numbers the traces that one process writes
_traces = itertools.count()
#: while profiling: the stage names used, the driver call that counts
#: add to, and the counters per call (under ``_lock``)
_names: set = set()
_call = "compress"
_counts: Dict[str, Dict[str, int]] = {}
_lock = threading.Lock()
#: what the last profile recorded (:func:`counters`)
_last: Dict = {}

#: the device time of launches outside every stage
NO_STAGE = "no stage"
#: the port's hand-written kernels, by their CUDA function names (K7:
#: its match and literal-placement kernels)
PORT_KERNELS = {"K1": "core_rank_kernel", "K2": "hist_ctx_kernel",
                "K3": "rans_encode_kernel", "K4": "rans_decode_kernel",
                "K5": "rans_encode_flat_kernel", "K6": "histogram_kernel",
                "K7": "delta_seq_", "K8": "compact_kernel"}


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """The block as the span ``name`` on this thread, inside
    :func:`profile`."""
    if not _profiling:
        yield
        return
    _names.add(name)
    with torch.profiler.record_function(name):
        yield


def recording() -> bool:
    """Whether :func:`profile` records (for a count that costs work to
    compute)."""
    return _profiling


def begin(call: str) -> None:
    """Name the driver call (``compress`` or ``decompress``) that later
    counts add to."""
    global _call
    _call = call


def count(name: str, n: int) -> None:
    """Add ``n`` to the current call's counter ``name`` (nothing outside
    :func:`profile`)."""
    if not _profiling:
        return
    with _lock:
        c = _counts.setdefault(_call, {})
        c[name] = c.get(name, 0) + int(n)


def counters() -> Dict:
    """The last profile's counters, ``{call: {name: n}}``, under
    ``"device_us"`` the cards' microseconds per stage
    (:func:`device_time_by_stage`) and under ``"device_us_by_card"`` the
    same per card, ``{card: {stage: us}}`` (:func:`device_time_by_card`);
    both empty without a card."""
    return _last


def device_time_by_stage(
        device: Iterable[Tuple[int, float]],
        launches: Mapping[int, Tuple[int, float]],
        spans: Iterable[Tuple[str, int, float, float]]) -> Dict[str, float]:
    """The device time of each stage.

    ``device``: ``(correlation, duration)`` of each device event;
    ``launches``: correlation -> ``(thread, time)`` of the host call that
    queued it; ``spans``: ``(name, thread, start, end)`` of the stages,
    properly nested within a thread.  Each device event's duration goes
    to the innermost span on its launch's thread that contains the
    launch, or to :data:`NO_STAGE` (also when its launch is unknown), so
    the sums add up to the events' total."""
    by_card = device_time_by_card(((c, d, 0) for c, d in device), launches,
                                  spans)
    return _summed(by_card)


def _summed(by_card: Mapping[int, Mapping[str, float]]) -> Dict[str, float]:
    """Each stage's time summed over the cards."""
    out: Dict[str, float] = collections.defaultdict(float)
    for per in by_card.values():
        for name, t in per.items():
            out[name] += t
    return dict(out)


def device_time_by_card(
        device: Iterable[Tuple[int, float, int]],
        launches: Mapping[int, Tuple[int, float]],
        spans: Iterable[Tuple[str, int, float, float]]
) -> Dict[int, Dict[str, float]]:
    """:func:`device_time_by_stage` per card: ``device`` holds
    ``(correlation, duration, card)`` of each device event, and each
    card's events are given to the stages as there ->
    ``{card: {stage: duration}}``; summed over the cards, the stages'
    times are :func:`device_time_by_stage`'s."""
    per_thread: Dict[int, list] = collections.defaultdict(list)
    for name, tid, s, e in spans:
        per_thread[tid].append((s, -e, name))
    # per thread: the spans by start (outer first at equal starts), and
    # the index of the span around each (-1: none)
    threads = {}
    for tid, v in per_thread.items():
        v.sort()
        parent, open_ = [], []
        for s, neg_e, _ in v:
            while open_ and -v[open_[-1]][1] < s:
                open_.pop()
            parent.append(open_[-1] if open_ else -1)
            open_.append(len(parent) - 1)
        threads[tid] = ([s for s, _, _ in v], v, parent)

    def innermost(tid: int, t: float) -> str:
        if tid not in threads:
            return NO_STAGE
        starts, v, parent = threads[tid]
        # the last span to start at or before t; if it has ended by t, a
        # span that runs at t and started before it holds it: climb
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and -v[i][1] < t:
            i = parent[i]
        return v[i][2] if i >= 0 else NO_STAGE

    out: Dict[int, Dict[str, float]] = collections.defaultdict(
        lambda: collections.defaultdict(float))
    for corr, dur, card in device:
        at = launches.get(corr)
        out[card][NO_STAGE if at is None else innermost(*at)] += dur
    return {card: dict(per) for card, per in out.items()}


def _device_us(prof, names) -> Dict[int, Dict[str, float]]:
    """:func:`device_time_by_card` over the stopped profile's events, in
    microseconds.  Device events are the cards' kernels, copies and
    memsets (not the card-side copies of the host's spans), each with
    its card's index; a launch is the CUDA runtime or driver call
    (``cuda*``, ``cu*``) that shares the event's correlation id (the
    host's ops number theirs apart); thread ids are the profiler's own,
    the same for calls and spans."""
    device, launches, spans = [], {}, []
    cpu = torch.autograd.DeviceType.CPU
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cpu:
            if not e.is_user_annotation():
                device.append((e.correlation_id(), e.duration_ns() / 1e3,
                               e.device_index()))
        elif e.is_user_annotation():
            if e.name() in names:
                spans.append((e.name(), e.start_thread_id(), e.start_ns(),
                              e.start_ns() + e.duration_ns()))
        elif e.name().startswith("cu"):
            launches[e.correlation_id()] = (e.start_thread_id(),
                                             e.start_ns())
    return device_time_by_card(device, launches, spans)


@contextlib.contextmanager
def profile(trace_dir: Optional[str], device,
            write_counters: bool = False) -> Iterator[None]:
    """Run the block under ``torch.profiler`` (host activity, and the
    card's kernels and copies when ``device`` is a CUDA device) and write
    its Chrome trace to ``trace_dir/scalce_tpu_torch.<pid>.<n>.trace.json``
    (``n`` counts this process's traces), also when the block raises;
    with ``write_counters`` (the CLI's ``--profile``), :func:`counters`
    beside it as ``scalce_tpu_torch.<pid>.<n>.counters.json``; nothing
    when ``trace_dir`` is None."""
    global _profiling, _last
    if trace_dir is None:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    # without profile_all_threads only the spans of the thread that
    # starts the profile reach the trace; the stages run on the -T
    # workers and the prefetch threads too
    prof = torch.profiler.profile(
        activities=activities,
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    _names.clear()
    _counts.clear()
    prof.start()
    _profiling = True
    try:
        yield
    finally:
        _profiling = False
        prof.stop()
        by_card = _device_us(prof, set(_names))
        _last = {**{c: dict(v) for c, v in _counts.items()},
                 "device_us": _summed(by_card),
                 "device_us_by_card": by_card}
        base = os.path.join(
            trace_dir, f"scalce_tpu_torch.{os.getpid()}.{next(_traces)}")
        prof.export_chrome_trace(base + ".trace.json")
        if write_counters:
            with open(base + ".counters.json", "w") as f:
                json.dump(_last, f, indent=1, sort_keys=True)


def union_s(spans: List[Tuple[float, float]]) -> float:
    """Total length in seconds of the union of (start_us, end_us) spans."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def device_event_kind(name: str) -> str:
    """Device event -> one of K1-K8, ``pageable copies`` (to or from
    pageable host memory), ``pinned copies`` (page-locked), ``other
    copies`` (device to device, memsets) or ``torch kernels``."""
    for k, fn in PORT_KERNELS.items():
        if fn in name:
            return k
    if name.startswith(("Memcpy", "Memset")):
        return "pageable copies" if "Pageable" in name else \
            "pinned copies" if "Pinned" in name else "other copies"
    return "torch kernels"


def device_busy(fn: Callable[[], object]) -> Optional[Dict]:
    """Run ``fn()`` under ``torch.profiler``: its wall seconds, the
    device's busy seconds (the union of the device events' intervals),
    and device seconds by kind (:func:`device_event_kind`) and by event
    name (the 12 largest, names cut to 80 characters); None if no device
    event was recorded."""
    from torch import profiler
    activities = [profiler.ProfilerActivity.CPU,
                  profiler.ProfilerActivity.CUDA]
    with profiler.profile(activities=activities, acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    spans, per_name, per_kind = [], {}, {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        spans.append((s, e))
        name, kind = ev.name[:80], device_event_kind(ev.name)
        per_name[name] = per_name.get(name, 0.0) + (e - s) / 1e6
        per_kind[kind] = per_kind.get(kind, 0.0) + (e - s) / 1e6
    if not spans:
        return None
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_s": wall, "busy_s": union_s(spans),
            "device_events": len(spans), "by_kind_s": per_kind,
            "top_device_s": dict(top)}
