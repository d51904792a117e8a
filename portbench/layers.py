"""What the per-layer readers (``metrics/<name>.py``) share: the traced
window's reading context and the few ways a metric is read from it.

A reader is ``read(ctx) -> float or None``; None means it found nothing
to read in this cell, and the harness leaves the metric out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from portbench import manifest, peaks
from portbench import trace as tr
from portbench.reference import records as ref

SIDES = ("compress", "decompress")


@dataclasses.dataclass
class Context:
    trace: tr.Trace
    #: the harness's spans around each call, per side
    windows: Dict[str, List[tr.Interval]]
    #: calls and blocks (a pair's two mates count once) per side
    calls: Dict[str, int]
    blocks: Dict[str, int]
    #: the input's own counts over both mates (:func:`input_counts`)
    counts: Dict[str, int]
    #: the program's counter of each stream's bytes, one compress
    stream_bytes: Dict[str, int]
    #: FASTQ bytes per side over the window: read by every compress,
    #: written by every decompress (a pair's two mates together)
    nbytes: Dict[str, int] = dataclasses.field(default_factory=dict)


def input_counts(files, core_k: int) -> Dict[str, int]:
    """Reads, bases, k-mer windows inside reads and quality symbols of
    the input files (both mates of a pair)."""
    reads = bases = windows = 0
    for data in files:
        lens = list(map(len, ref.lines(data)[1::4]))
        reads += len(lens)
        bases += sum(lens)
        windows += sum(max(n - core_k + 1, 0) for n in lens)
    return {"reads": reads, "bases": bases, "kmer_windows": windows,
            "qual_symbols": bases}


def span_ms_per_block(ctx: Context, span: str, side: str) -> Optional[float]:
    """Milliseconds of the program's ``span`` (summed over every thread)
    inside the side's calls, per block."""
    spans = ctx.trace.named(span)
    t = tr.time_in(spans, ctx.windows[side])
    if not t or not ctx.blocks[side]:
        return None
    return t / 1e3 / ctx.blocks[side]


def rate_MBps(ctx: Context, side: str) -> Optional[float]:
    """The side's FASTQ megabytes (1e6 B) over the summed durations of the
    harness's spans around its calls."""
    us = sum(e - s for s, e in ctx.windows[side])
    if us <= 0 or not ctx.nbytes.get(side):
        return None
    return ctx.nbytes[side] / us


def device_idle(ctx: Context, side: str) -> Optional[float]:
    return tr.idle_share(ctx.trace.device, ctx.windows[side])


def pinned_copy_ms_per_block(ctx: Context, side: str) -> Optional[float]:
    """Device milliseconds of copies to or from page-locked host memory
    inside the side's calls, per block."""
    ev = [(e.start, e.end) for e in ctx.trace.device
          if e.cat == "gpu_memcpy" and "Pinned" in e.name]
    t = sum(e - s for s, e in tr.clip(ev, ctx.windows[side]))
    if not t or not ctx.blocks[side]:
        return None
    return t / 1e3 / ctx.blocks[side]


def bits_per(ctx: Context, stream: str, count: str) -> Optional[float]:
    """A stream's bits over one of the input's counts."""
    if not ctx.stream_bytes or not ctx.counts.get(count):
        return None
    return 8.0 * ctx.stream_bytes[stream] / ctx.counts[count]


def roofline(ctx: Context, kernel: str) -> Optional[float]:
    """Percent of the kernel's device time that its work's bytes need at
    the card's HBM bandwidth: ``work/<kernel>.py`` counts the bytes of
    one pass over the input from the input's own counts, once per call
    of the side it runs in; the device time is that of the events whose
    name holds the kernel's function name, inside those calls."""
    work = manifest.load_module("work", kernel)
    ev = [(e.start, e.end) for e in ctx.trace.device
          if e.cat == "kernel" and work.KERNEL in e.name]
    secs = sum(e - s for s, e in tr.clip(ev, ctx.windows[work.SIDE])) / 1e6
    if secs <= 0 or not ctx.calls[work.SIDE]:
        return None
    nbytes = work.bytes_moved(ctx.counts, ctx.stream_bytes) \
        * ctx.calls[work.SIDE]
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / secs
