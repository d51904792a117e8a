"""Compress and decompress drivers (port of the reference's
``scalce_tpu/pipeline/driver.py`` entry points: single-end, paired-end,
lossy and ``--data-parallel``), pipelined as the reference's are.

The compress's item is a tuple of mates, ``(block,)`` single-end and
``(mate 1, mate 2)`` for ``-r``, from the parse on, as the decompress
carries each block's payloads per mate: one path for both.  The
single-device :class:`BlockEncoder` runs groups of one item, the
:class:`ShardedEncoder` (``--data-parallel``) groups of D items over
the devices; both take the same three calls (:func:`_encoder`).
Compress runs on these threads:

- parse: :func:`~scalce_tpu_torch.pipeline.threads._prefetch` over the
  FASTQ parse, three items ahead;
- upload: ``_prefetch`` over the uploads (page-locked staging, the H2D
  copies on the device's copy stream), two groups ahead;
- main: dispatch, in block order -- every kernel of a group and its
  downloads, queued on the device without waiting for it
  (``transfer.Link`` keeps at most ``transfer.DEPTH`` downloads in
  flight per device, whatever ``-T`` is); then the emits (container
  writes), in block order;
- ``cfg.threads`` (``-T``) assembly workers: each group's host half
  (wait for its downloads, payload bytes), at most ``threads + 2``
  groups pending.  With ``-T 1`` or less the main thread assembles each
  group right after its dispatch: the same code, no pool.

Under host core and for long reads there is no upload thread and
nothing is queued on a device: the workers run each block whole on the
host.

Multi-host (``cfg.n_hosts`` > 1): every host parses the whole input and
encodes the blocks it owns (``block_id % n_hosts == host_id``, chosen
after the lossy preamble, so that every host samples the same reads and
builds the same map) into its own triplet ``<output>.host<h>``, with no
part splitting; :func:`merge_hosts` then interleaves the hosts' blocks
into the 1-host triplet, byte for byte (``parallel/merge.py``).

Decompress runs the container read on a prefetch thread, the payload
parse and each block's finish and FASTQ render on a pool of ``-T``
workers, the quality decode's K4 launch and download and, under
``--delta-device``, each block's sequence reconstruction and download
on the main thread, and the ordered writes on a writer thread.  Bytes
never depend on ``-T``.  An exception on any thread raises out of
:func:`compress` or :func:`decompress` once the threads it started have
stopped.

Under ``--profile`` the main thread's blocking waits are stages of their
own: ``wait input`` (the compress's next uploaded block, or parsed block
under host core), ``wait assemble`` (the oldest pending host half),
``wait parse`` and ``wait finish`` (the decompress's oldest payload
parse, and the oldest block's finish and render).  The decompress
counts its finish tasks (``finish_tasks``) and the blocks they finish
(``finish_blocks``).
"""

from __future__ import annotations

import collections
import concurrent.futures as _fut
import contextlib
import dataclasses
import itertools
import json
import os
import sys
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from scalce_tpu_torch import container, timing
from scalce_tpu_torch.config import Config, resolve_read_len
from scalce_tpu_torch.io import fastq
from scalce_tpu_torch.models import lossy
from scalce_tpu_torch.parallel.merge import (host_prefix,
                                             merge_host_outputs, owns_block)
from scalce_tpu_torch.parallel.mesh import ShardedEncoder
from scalce_tpu_torch.pipeline.decode import DECODE_GROUP, BlockDecoder
from scalce_tpu_torch.pipeline.encode import BlockEncoder, file_meta
from scalce_tpu_torch.pipeline.threads import _AsyncWriter, _prefetch
from scalce_tpu_torch.timing import stage


@dataclasses.dataclass
class RunStats:
    """The reference's run record (per-stream bytes, ratio, GB/s, host
    seconds of the compress's ``device_dispatch`` and ``assemble``
    calls, summed over the threads that ran them, placement) plus
    ``device``, the devices it ran on."""
    mode: str
    device: str = ""
    n_reads: int = 0
    n_blocks: int = 0
    input_bytes: int = 0
    output_bytes: int = 0
    stream_bytes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"n": 0, "r": 0, "q": 0})
    stage_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    wall_s: float = 0.0
    placement: str = ""         # compute placement (encode)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if self.input_bytes and self.output_bytes:
            d["ratio"] = self.input_bytes / self.output_bytes
        if self.wall_s > 0:
            d["GBps"] = self.input_bytes / self.wall_s / 1e9
        return json.dumps(d, sort_keys=True)


def _lossy_preamble(cfg: Config, blocks: Iterator):
    """Sample the first ``cfg.sample_size`` reads (both mates of a pair)
    for the lossy histogram -> ``(qual_map, blocks)``: the sampled blocks
    are buffered and come first again, so the input is read once (copy
    of the reference's sampling pass)."""
    if cfg.lossy_pct <= 0:
        return lossy.identity_map(), blocks
    hist = np.zeros(lossy.N_SYMS, np.int64)
    buffered = []
    sampled = 0
    with stage("lossy preamble"):
        for item in blocks:
            for b in item:
                hist += lossy.sample_histogram(b.qual, b.lengths, b.n_reads)
                sampled += b.n_reads
            buffered.append(item)
            if sampled >= cfg.sample_size:
                break
        qual_map = lossy.build_quant_map(hist, cfg.lossy_pct) if buffered \
            else lossy.identity_map()
    return qual_map, _chain(buffered, blocks)


def _chain(first, rest: Iterator) -> Iterator:
    """``first``'s items, then ``rest``'s; closing it closes ``rest``."""
    yield from first
    yield from rest


def _run_pipelined(items: Iterator, dispatch: Callable, assemble: Callable,
                   emit: Callable, workers: int,
                   stage_s: Optional[Dict[str, float]] = None) -> None:
    """The reference's three-stage pipeline: ``dispatch(item)`` on this
    thread, in order; ``assemble(item, dispatched)`` on a pool of
    ``workers`` threads, at most ``workers + 2`` pending; ``emit`` of each
    result on this thread, in order.  With ``workers <= 1`` each item is
    assembled here, right after its dispatch.  ``stage_s`` accumulates
    the seconds of both calls under a lock."""
    times = stage_s if stage_s is not None else {}
    times.setdefault("device_dispatch", 0.0)
    times.setdefault("assemble", 0.0)
    times_lock = threading.Lock()

    def timed(label, fn, *a):
        t0 = time.monotonic()
        try:
            return fn(*a)
        finally:
            with times_lock:        # pool workers update concurrently
                times[label] += time.monotonic() - t0

    if workers <= 1:
        for item in items:
            emit(timed("assemble", assemble, item,
                       timed("device_dispatch", dispatch, item)))
        return
    pool = _fut.ThreadPoolExecutor(max_workers=workers)
    pending: collections.deque = collections.deque()
    try:
        for item in items:
            dispatched = timed("device_dispatch", dispatch, item)
            pending.append(pool.submit(timed, "assemble", assemble, item,
                                       dispatched))
            while len(pending) >= workers + 2:
                emit(_oldest(pending))
        while pending:
            emit(_oldest(pending))
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _oldest(pending: collections.deque):
    """The result of the oldest pending host half, waited for as the
    ``wait assemble`` stage."""
    with stage("wait assemble"):
        return pending.popleft().result()


def _mates(blocks: Iterator) -> Iterator:
    """Single-end blocks as items of one mate, ``(block,)``; closes
    ``blocks`` when it stops."""
    with contextlib.closing(blocks):
        for block in blocks:
            yield (block,)


def _parsed(blocks: Iterator, keep: Callable[[int], bool]) -> Iterator:
    """The parsed items (tuples of mates), timed as ``parse FASTQ``,
    whose block id ``keep`` takes (this host's, and not yet in a resumed
    triplet).  Closes ``blocks`` (the input) when it stops."""
    with contextlib.closing(blocks):
        while True:
            with stage("parse FASTQ"):
                item = next(blocks, None)
            if item is None:
                return
            if keep(item[0].block_id):
                yield item


def _staged(groups: Iterator, upload: Optional[Callable],
            wait: Optional[str] = None) -> Iterator:
    """Each group with its upload (None when ``upload`` is: host core
    sends nothing), the parse one prefetch thread ahead (stopped when
    this generator stops); ``wait``: the stage name of the wait for each
    parsed group."""
    with contextlib.closing(_prefetch(groups, wait=wait)) as parsed:
        for group in parsed:
            yield group, None if upload is None else upload(group)


def _groups(items: Iterator, D: int) -> Iterator[List]:
    """``items`` in lists of D (the last may be shorter)."""
    group = []
    for item in items:
        group.append(item)
        if len(group) == D:
            yield group
            group = []
    if group:
        yield group


def _host_output(cfg: Config):
    """``(prefix, part_size)`` of this host's triplet: the output's, or
    under multi-host the host's own intermediate, unsplit (the merge
    splits the final triplet into parts)."""
    if cfg.n_hosts > 1:
        return host_prefix(cfg.output, cfg.host_id), 0
    return cfg.output, cfg.part_size


def merge_hosts(cfg: Config) -> int:
    """After every host's compress: merge the hosts' triplets (both
    mates' for ``-r``) into the final one, which equals the 1-host
    run's; returns the number of blocks (summed over the mates)."""
    mates = (1, 2) if cfg.paired else (None,)
    return sum(merge_host_outputs(cfg.output, cfg.n_hosts,
                                  part_size=cfg.part_size, mate=mate)
               for mate in mates)


def _open_writers(cfg: Config) -> List[container.TripletWriter]:
    """This host's output triplet, or the ``_1``/``_2`` pair of them
    (:func:`_host_output`).  A resumed pair whose mates hold different
    durable blocks (a crash between the mates' writes) is cut back to
    the blocks both hold, so pairs stay in sync."""
    meta = file_meta(cfg)
    mates = (1, 2) if cfg.paired else (None,)
    prefix, part_size = _host_output(cfg)

    def open_all(**kw):
        return [container.TripletWriter(prefix, meta, part_size=part_size,
                                        mate=m, resume=cfg.resume, **kw)
                for m in mates]
    writers = open_all()
    if cfg.resume and cfg.paired \
            and writers[0].existing_blocks != writers[1].existing_blocks:
        common = writers[0].existing_blocks & writers[1].existing_blocks
        for w in writers:
            w.abort()
        writers = open_all(keep_only=common)
        if any(w.existing_blocks != common for w in writers):
            raise RuntimeError("paired resume could not cut both mates "
                               "back to their common blocks")
    return writers


def _encoder(cfg: Config, device, qual_map):
    """The run's encoder: :class:`ShardedEncoder` under
    ``--data-parallel`` (groups of D items over the devices), else the
    single-device :class:`BlockEncoder` (groups of one).  Either takes
    groups of items, each a tuple of mates (one, or two for ``-r``):
    ``upload(group)`` on the upload thread (None under host core and for
    long reads: nothing crosses to a device, ``on_host``),
    ``dispatch(group, pre)`` on the main thread, and ``assemble(group,
    dispatched)``, one tuple of outputs per item, on any thread;
    ``placement`` is ``"host"`` or ``"device"`` (the cores'; long reads:
    ``"host"``) and ``devices`` the devices it queues work on."""
    if cfg.data_parallel:
        return ShardedEncoder(cfg, device, qual_map=qual_map)
    return BlockEncoder(cfg, device, qual_map)


def compress(cfg: Config, device) -> RunStats:
    """Compress ``cfg.inputs`` (one FASTQ, or a pair with ``cfg.paired``)
    into the ``cfg.output`` triplet (``_1``/``_2`` triplets for a pair)
    on ``cfg.threads`` assembly workers; with ``cfg.data_parallel``, in
    groups of blocks over every device that ``device`` names
    (``parallel/mesh.py``); with ``cfg.lossy_pct``, through the lossy
    quality map of the sampled reads; with ``cfg.n_hosts`` > 1, this
    host's share of the blocks into its own triplet (see the module
    docstring)."""
    t0 = time.monotonic()
    timing.begin("compress")
    for p in cfg.inputs:
        if p != "-" and not os.path.exists(p):
            raise FileNotFoundError(f"input FASTQ not found: {p}")
    cfg = resolve_read_len(cfg)
    if cfg.paired:
        blocks = fastq.iter_paired_blocks(*cfg.inputs, cfg.block_reads,
                                          cfg.max_read_len)
    else:
        (path,) = cfg.inputs
        blocks = _mates(fastq.iter_blocks(path, cfg.block_reads,
                                          cfg.max_read_len))
    qual_map, blocks = _lossy_preamble(cfg, blocks)
    enc = _encoder(cfg, device, qual_map)
    stats = RunStats(mode="compress", placement=enc.placement,
                     device=",".join(str(d) for d in enc.devices) or "host")
    writers = _open_writers(cfg)

    def assemble_recycle(item, dispatched):
        # the host half is the last reader of the parsed arrays (the
        # upload copied them into page-locked staging): the parser may
        # reuse them
        group = item[0]
        outs = enc.assemble(group, dispatched)
        for mates in group:
            for b in mates:
                fastq.recycle_block(b)
        return outs

    def emit(outs):
        for ebs in outs:
            with stage("write"):
                for w, eb in zip(writers, ebs):
                    w.add_block(eb.block_id, eb.payloads, eb.n_reads)
            stats.n_blocks += 1
            for eb in ebs:
                stats.n_reads += eb.n_reads
                for k, p in eb.payloads.items():
                    stats.stream_bytes[k] += len(p)
            if cfg.verbose:
                print(f"[scalce_tpu_torch] block {ebs[0].block_id}: "
                      f"{sum(eb.n_reads for eb in ebs)} reads, "
                      f"{sum(eb.total_bytes for eb in ebs)} bytes",
                      file=sys.stderr)

    done = writers[0].existing_blocks
    groups = _groups(_parsed(blocks, lambda bid: owns_block(
        bid, cfg.host_id, cfg.n_hosts) and bid not in done), enc.D)
    # host core and long reads: no upload stage, the parse's prefetch
    # alone (the reference's host-core branch); this thread's wait for
    # its next input is ``wait input``
    if enc.on_host:
        items = _staged(groups, None, wait="wait input")
    else:
        items = _prefetch(_staged(groups, enc.upload), depth=2,
                          wait="wait input")
    try:
        with contextlib.closing(items):
            _run_pipelined(items, lambda it: enc.dispatch(*it),
                           assemble_recycle, emit, cfg.threads,
                           stats.stage_s)
    finally:
        for w in writers:
            w.close()
    stats.input_bytes = sum(_file_size(p) for p in cfg.inputs)
    stats.output_bytes = sum(stats.stream_bytes.values())
    stats.wall_s = time.monotonic() - t0
    return stats


class _StageWrites:
    """A binary output whose writes are timed as the ``write`` stage
    (on the writer thread)."""

    def __init__(self, out):
        self._out = out

    def write(self, buf) -> None:
        with stage("write"):
            self._out.write(buf)


def decompress(cfg: Config, device) -> RunStats:
    """Decompress the triplet named by ``cfg.inputs[0]`` to FASTQ on
    ``cfg.threads`` workers; a paired triplet (either mate's file names
    it) to ``<output>_1.fastq`` and ``<output>_2.fastq`` in lockstep,
    record i of one pairing with record i of the other.  Each mate has
    its own decoder."""
    t0 = time.monotonic()
    timing.begin("decompress")
    (path,) = cfg.inputs
    reader = container.TripletReader(path)
    if reader.meta.get("paired"):
        readers = [reader if reader.mate == m else container.TripletReader(
            container.part_paths(reader.prefix, 0, m)["r"]) for m in (1, 2)]
        paths = [f"{cfg.output}_{m}.fastq" for m in (1, 2)]
    else:
        readers = [reader]
        paths = [None if cfg.output == "-" else cfg.output
                 if cfg.output.endswith(".fastq") else cfg.output + ".fastq"]
    decs = [BlockDecoder(reader.meta, device, keep_order=cfg.keep_order,
                         qual_on_device=cfg.qual_on_device,
                         delta_on_device=cfg.delta_on_device)
            for _ in readers]
    stats = RunStats(mode="decompress", device=str(decs[0].device))
    with contextlib.ExitStack() as files:
        outs = []
        for p in paths:
            if p is None:
                outs.append(sys.stdout.buffer)
                files.callback(sys.stdout.buffer.flush)
            else:
                outs.append(files.enter_context(open(p, "wb")))
        items = files.enter_context(contextlib.closing(
            _prefetch(_lockstep(readers), depth=8)))
        _run_decode_pipeline(items, decs, [_StageWrites(o) for o in outs],
                             cfg.threads, stats)
    stats.output_bytes = sum(_file_size(p) for p in paths)
    stats.wall_s = time.monotonic() - t0
    return stats


def _lockstep(readers) -> Iterator[List[Dict[str, bytes]]]:
    """Each block's payloads from every mate's triplet; the mates must
    hold the same block ids in the same order."""
    for items in itertools.zip_longest(*(r.iter_blocks() for r in readers)):
        if None in items or len({bid for bid, _ in items}) != 1:
            raise ValueError("mate triplets disagree on block order")
        yield [payloads for _, payloads in items]


def _run_decode_pipeline(items: Iterator, decs: List[BlockDecoder],
                         outs: List, workers: int, stats: RunStats) -> None:
    """The reference's pipelined decompress over one or more channels
    (mates); ``items`` yields each block's payloads per channel.

      pool:          payload parse, at most ``2 * workers + DECODE_GROUP``
                     blocks ahead
      this thread:   each group's quality decode (``dispatch_quals``: one
                     K4 launch per group whose streams share (B, L, T,
                     order), else per block, and the grids' download;
                     host placement: nothing) and, under
                     ``--delta-device``, each block's sequence
                     reconstruction and the codes' download
                     (``dispatch_seqs``), with the template-name start of
                     each block
      pool:          each block's finish (host quality decode, or the
                     wait for its row of the group's grids; ``_finish``)
                     and FASTQ render, a task a block
      writer thread: ordered writes
    """
    C = len(decs)
    pool = _fut.ThreadPoolExecutor(max_workers=max(1, workers))
    parse_pending: collections.deque = collections.deque()
    out_pending: collections.deque = collections.deque()
    name_ctr = [1] * C
    max_parse = max(1, workers) * 2 + DECODE_GROUP
    writer = _AsyncWriter()

    def finish(c, payloads, parsed, dev, d, start, seq_dev):
        b = decs[c].finish_block(payloads, parsed, dev, d, start, seq_dev)
        with stage("render FASTQ"):
            return b, fastq.render_fastq_records(
                b.seq, b.qual, b.lengths, b.n_reads, b.exc_pos, b.exc_byte,
                b.names, b.plus)

    def emit(futs):
        for c, f in futs:
            with stage("wait finish"):
                b, buf = f.result()
            if buf is not None and len(buf):
                writer.write(outs[c], buf)
            stats.n_reads += b.n_reads
            if c == 0:
                stats.n_blocks += 1

    def drain(block_all: bool) -> None:
        while out_pending and (block_all or len(out_pending) > 2
                               or out_pending[0][0][1].done()):
            emit(out_pending.popleft())

    def dispatch(group) -> None:
        # group: [(payloads per channel, (parsed, enc) per channel)];
        # one finish task a block, in block order, mate 1's first
        futs = []
        for c, dec in enumerate(decs):
            plist = [g[0][c] for g in group]
            parsed = [g[1][c][0] for g in group]
            encs = [g[1][c][1] for g in group]
            starts = []
            for pr in parsed:
                starts.append(name_ctr[c])
                name_ctr[c] += pr[2]
            # quality decode on the card: one K4 launch for a group whose
            # streams share (B, L, T, order), else one a block
            uniform = len({(e.B, e.L, e.T, e.order) for e in encs}) == 1
            chunks = [range(len(group))] if dec.qual_on_device and uniform \
                else [[i] for i in range(len(group))]
            for idx in chunks:
                dev = dec.dispatch_quals([parsed[i] for i in idx],
                                         [encs[i] for i in idx])
                seq_dev = dec.dispatch_seqs([parsed[i] for i in idx])
                for d, i in enumerate(idx):
                    futs.append((c, pool.submit(
                        finish, c, plist[i], parsed[i], dev, d, starts[i],
                        None if seq_dev is None else seq_dev[d])))
                    timing.count("finish_tasks", 1)
                    timing.count("finish_blocks", 1)    # the task's blocks
        out_pending.append(futs)
        drain(False)

    def parse_item(ptuple):
        return tuple(decs[c].parse_block(ptuple[c]) for c in range(C))

    def parsed():
        # the oldest block's payloads and parse
        pt, f = parse_pending.popleft()
        with stage("wait parse"):
            return pt, f.result()

    try:
        group: List = []
        for ptuple in items:
            parse_pending.append((ptuple, pool.submit(parse_item, ptuple)))
            while len(parse_pending) >= max_parse:
                group.append(parsed())
                if len(group) == DECODE_GROUP:
                    dispatch(group)
                    group = []
        while parse_pending:
            group.append(parsed())
            if len(group) == DECODE_GROUP:
                dispatch(group)
                group = []
        if group:
            dispatch(group)
        drain(True)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        writer.close()   # join pending writes; re-raise writer errors


def _file_size(path) -> int:
    try:
        return os.path.getsize(path)
    except (OSError, TypeError):
        return 0
