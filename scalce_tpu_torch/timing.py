"""Per-stage wall times of the compress and decompress paths, and the
``--profile`` trace.

The pipeline wraps each stage in :func:`stage`.  Off (the default) a stage
costs two global lookups.  Inside :func:`collect` each stage synchronizes
the device on entry and on exit, so its seconds include the device work it
queued and no other stage's, and the seconds of each stage are added
under a lock (stages run on the driver's threads).  Stages do not nest
within a thread.  Per-stage seconds are defined at ``-T 1`` only: with
more assembly workers, stages on different threads overlap and their
synchronizations wait for each other's device work.  Even at ``-T 1`` the
parse (and the upload) run on prefetch threads beside the main thread,
so the stages' sum may exceed the wall.

Inside :func:`profile` each stage is also a
``torch.profiler.record_function`` span of its name, on the thread that
runs it (the profile records every thread), and adds no
synchronization.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, Optional

import torch

#: (device, seconds per stage, lock) while :func:`collect` is active
_active = None
#: True while :func:`profile` records
_profiling = False
#: numbers the traces that one process writes
_traces = itertools.count()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    with (torch.profiler.record_function(name) if _profiling
          else contextlib.nullcontext()):
        if _active is None:
            yield
            return
        device, seconds, lock = _active
        _sync(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(device)
            dt = time.perf_counter() - t0
            with lock:
                seconds[name] += dt


@contextlib.contextmanager
def collect(device) -> Iterator[Dict[str, float]]:
    """Record every stage run inside the block into the yielded dict."""
    global _active
    seconds: Dict[str, float] = collections.defaultdict(float)
    _active = (torch.device(device), seconds, threading.Lock())
    try:
        yield seconds
    finally:
        _active = None


@contextlib.contextmanager
def profile(trace_dir: Optional[str], device) -> Iterator[None]:
    """Run the block under ``torch.profiler`` (host activity, and the
    card's kernels and copies when ``device`` is a CUDA device) and write
    its Chrome trace to ``trace_dir/scalce_tpu_torch.<pid>.<n>.trace.json``
    (``n`` counts this process's traces), also when the block raises;
    nothing when ``trace_dir`` is None."""
    global _profiling
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
    prof.start()
    _profiling = True
    try:
        yield
    finally:
        _profiling = False
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            trace_dir,
            f"scalce_tpu_torch.{os.getpid()}.{next(_traces)}.trace.json"))
