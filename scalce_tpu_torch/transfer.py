"""Host <-> device copies through page-locked memory on copy streams.

Each device a pipeline drives has a :class:`Link`: one stream for the
host-to-device copies and one for the device-to-host copies, beside the
compute stream (the caller's current stream, where every kernel runs).

- :meth:`Link.upload` copies host arrays into page-locked staging
  tensors (a host copy: the caller may reuse or recycle its arrays as
  soon as it returns), then into new device tensors on the H2D stream.
  :meth:`Staged.wait` orders the compute stream after those copies and
  hands the tensors to it (``record_stream``), so it may run on another
  thread than the upload, later.
- :meth:`Link.download` orders the D2H stream after the work queued so
  far on the compute stream and copies tensors into page-locked host
  tensors there; :meth:`Fetched.wait` blocks until they have landed.
  The device tensors are handed to the D2H stream, so the caller drops
  them at once.  At most :data:`DEPTH` downloads are in flight: the
  next one first waits for the oldest, which bounds the device memory
  held by blocks waiting for their copies (and the blocks queued on the
  card) whatever the number of host workers.

The page-locked tensors come from PyTorch's caching host allocator, a
pool of page-locked buffers by size class: a buffer whose tensor is
freed while an asynchronous copy on it is queued is reused only after
that copy has finished (the allocator records an event on the copy's
stream), so the pool never grows past the transfers in flight: the
upload prefetch, the pending downloads and the host arrays the
assembly workers still read.  A failed pin or copy raises; nothing
falls back to pageable memory.  On the CPU both directions hand over
the memory as it is.

Under ``--profile`` the link counts the bytes it hands over each way
(``h2d_bytes``, ``d2h_bytes``), and each wait for a download is the
stage ``wait download``.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from scalce_tpu_torch import timing
from scalce_tpu_torch.convert import host_form

#: downloads in flight per device before the next one waits
DEPTH = 2


class Staged(dict):
    """Device tensors by name (a value may be a tuple of tensors), whose
    host-to-device copies were queued on a copy stream."""

    #: the copies' completion on the H2D stream (None on the CPU)
    event: Optional[torch.cuda.Event] = None
    #: the page-locked staging tensors by name (empty on the CPU)
    host: Dict[str, torch.Tensor]

    def wait(self) -> "Staged":
        """Order the current stream after the copies and hand it the
        tensors; returns self."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.event)
            for v in self.values():
                for t in (v if isinstance(v, tuple) else (v,)):
                    if t.numel():
                        t.record_stream(stream)
        return self


class Fetched:
    """Host arrays by name whose device-to-host copies were queued on a
    copy stream; :meth:`wait` gives them once they have landed."""

    def __init__(self, arrays: Dict[str, np.ndarray],
                 event: Optional[torch.cuda.Event] = None):
        self._arrays = arrays
        self.event = event

    def wait(self) -> Dict[str, np.ndarray]:
        with timing.stage("wait download"):
            if self.event is not None:
                self.event.synchronize()
        return self._arrays


class Link:
    """The copy streams of one device (see the module docstring)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.h2d = torch.cuda.Stream(self.device) if cuda else None
        self.d2h = torch.cuda.Stream(self.device) if cuda else None
        self._inflight: collections.deque = collections.deque()
        self._lock = threading.Lock()

    def upload(self, arrays: Mapping[str, np.ndarray]) -> Staged:
        """Reference arrays -> the port's tensors on the device (u16 ->
        int32, u32 -> int64, as :func:`convert.from_reference`)."""
        host = {name: torch.from_numpy(host_form(a))
                for name, a in arrays.items()}
        if timing.recording():
            timing.count("h2d_bytes", _nbytes(host.values()))
        out = Staged()
        out.host = {}
        if self.h2d is None:
            out.update(host)
            return out
        out.device = self.device
        with torch.cuda.stream(self.h2d):
            for name, src in host.items():
                pinned = torch.empty_like(src, pin_memory=True)
                pinned.copy_(src)
                dst = torch.empty_like(src, device=self.device)
                dst.copy_(pinned, non_blocking=True)
                out[name], out.host[name] = dst, pinned
            out.event = torch.cuda.Event()
            out.event.record(self.h2d)
        return out

    def download(self, *groups: Mapping[str, torch.Tensor]
                 ) -> List[Fetched]:
        """Queue the download of each group of tensors (made contiguous
        first, on the compute stream) after the work queued so far;
        returns one :class:`Fetched` per group, sharing one event."""
        groups = [{name: t.detach().contiguous() for name, t in g.items()}
                  for g in groups]
        if timing.recording():
            timing.count("d2h_bytes",
                         sum(_nbytes(g.values()) for g in groups))
        if self.d2h is None:
            return [Fetched({name: t.numpy() for name, t in g.items()})
                    for g in groups]
        self.d2h.wait_stream(torch.cuda.current_stream(self.device))
        out = []
        with torch.cuda.stream(self.d2h):
            for g in groups:
                arrays = {}
                for name, t in g.items():
                    pinned = torch.empty_like(t, device="cpu",
                                              pin_memory=True)
                    pinned.copy_(t, non_blocking=True)
                    if t.numel():
                        t.record_stream(self.d2h)
                    arrays[name] = pinned.numpy()
                out.append(arrays)
            event = torch.cuda.Event()
            event.record(self.d2h)
        with self._lock:
            self._inflight.append(event)
            oldest = self._inflight.popleft() \
                if len(self._inflight) > DEPTH else None
        if oldest is not None:
            with timing.stage("wait download"):
                oldest.synchronize()
        return [Fetched(arrays, event) for arrays in out]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)
