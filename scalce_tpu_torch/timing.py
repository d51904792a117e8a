"""Per-stage wall times of the compress and decompress paths.

The pipeline wraps each stage in :func:`stage`.  Off (the default) a stage
costs one global lookup.  Inside :func:`collect` each stage synchronizes
the device on entry and on exit, so its seconds include the device work it
queued and no other stage's, and the seconds of each stage are added
under a lock (stages run on the driver's threads).  Stages do not nest
within a thread.  Per-stage seconds are defined at ``-T 1`` only: with
more assembly workers, stages on different threads overlap and their
synchronizations wait for each other's device work.  Even at ``-T 1`` the
parse (and the upload) run on prefetch threads beside the main thread,
so the stages' sum may exceed the wall.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, Iterator

import torch

#: (device, seconds per stage, lock) while :func:`collect` is active
_active = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
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
