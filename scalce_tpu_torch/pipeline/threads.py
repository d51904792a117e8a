# Copy of scalce_tpu/pipeline/driver.py: _prefetch (adapted) and _AsyncWriter
"""The pipelined drivers' two background threads: :func:`_prefetch` runs
an iterator (the FASTQ parse, the uploads, the container read) one
bounded queue ahead of its consumer, and :class:`_AsyncWriter` writes
rendered FASTQ in order behind the decode.  ``_AsyncWriter`` is the
reference's verbatim (``tests/test_torch_imports.py`` holds it equal to
the original).  ``_prefetch`` is the reference's with two additions, so
that a consumer that stops early stops the whole chain of prefetches at
once, even while its exception (and so the frames that reference the
iterators) is still alive: closing the generator joins its thread, and
the thread closes its iterator when it stops.  A consumer may name its
wait for each item, which then is a :func:`~scalce_tpu_torch.timing.stage`."""

from __future__ import annotations

import contextlib
import queue as _queue
import threading
from typing import Iterator, List, Optional

from scalce_tpu_torch.timing import stage


def _prefetch(it: Iterator, depth: int = 3,
              wait: Optional[str] = None) -> Iterator:
    """Run an iterator in a background thread with a bounded queue,
    ``depth`` items ahead of the consumer.  The thread closes ``it`` (if
    it has ``close``) when it stops; closing this generator stops the
    thread and waits for it.  ``wait``: the stage name of the consumer's
    wait for each item (None: not a stage)."""
    q: _queue.Queue = _queue.Queue(maxsize=depth)
    _END = object()
    err: List[BaseException] = []
    stop = threading.Event()

    def worker():
        try:
            for item in it:
                # bounded put with a stop check so an abandoned consumer
                # (emit/writer raised) doesn't leave this thread blocked
                # on a full queue holding the input file open forever
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except _queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:           # propagate parse errors
            err.append(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                try:
                    close()
                except BaseException as e:   # raised to the consumer
                    err.append(e)
            # the sentinel put must also be stop-aware: with the queue
            # full and the consumer gone, an unbounded put would block
            # this thread (and the open input handle) forever
            while not stop.is_set():
                try:
                    q.put(_END, timeout=0.2)
                    break
                except _queue.Full:
                    continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            with stage(wait) if wait else contextlib.nullcontext():
                item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()   # worker notices within its put timeout and exits
        t.join()


class _AsyncWriter:
    """Single background writer draining an ordered (file, buffer)
    queue — file writes at disk-writeback speed were ~50 ms of every
    decompressed block's wall; overlapping them with decode costs one
    thread and preserves per-file byte order (emit enqueues in block
    order)."""

    def __init__(self, depth: int = 4):
        self._q: _queue.Queue = _queue.Queue(maxsize=depth)
        self._err: List[BaseException] = []
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            out, buf = item
            try:
                out.write(buf)
            except BaseException as e:     # surfaced on next write/close
                self._err.append(e)

    def write(self, out, buf) -> None:
        if self._err:
            raise self._err[0]
        self._q.put((out, buf))

    def close(self) -> None:
        self._q.put(None)
        self._t.join()
        if self._err:
            raise self._err[0]
