"""Serial compress/decompress drivers (port of the reference's
``scalce_tpu/pipeline/driver.py`` entry points, paired-end, lossy and
``--data-parallel`` included, without its host pipelining threads:
ROADMAP.md Queue 1 item 17)."""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import sys
import time
from typing import Dict, Iterator, List

import numpy as np

from scalce_tpu_torch import container
from scalce_tpu_torch.config import Config, resolve_read_len
from scalce_tpu_torch.io import fastq
from scalce_tpu_torch.models import lossy
from scalce_tpu_torch.parallel.mesh import ShardedEncoder
from scalce_tpu_torch.pipeline.decode import DECODE_GROUP, BlockDecoder
from scalce_tpu_torch.pipeline.encode import BlockEncoder, file_meta
from scalce_tpu_torch.timing import stage


@dataclasses.dataclass
class RunStats:
    """The reference's run record (per-stream bytes, ratio, GB/s, host
    seconds of the compress's ``device_dispatch`` and ``assemble``
    calls, placement) plus ``device``, the devices it ran on."""
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


def _timed(seconds: Dict[str, float], name: str, fn, *args):
    """``fn(*args)``, adding its host-clock seconds to ``seconds[name]``
    (no device synchronization: a dispatch's time is its enqueue and
    whatever its own downloads wait for)."""
    t0 = time.monotonic()
    try:
        return fn(*args)
    finally:
        seconds[name] = seconds.get(name, 0.0) + time.monotonic() - t0


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
            for b in item if isinstance(item, tuple) else (item,):
                hist += lossy.sample_histogram(b.qual, b.lengths, b.n_reads)
                sampled += b.n_reads
            buffered.append(item)
            if sampled >= cfg.sample_size:
                break
        qual_map = lossy.build_quant_map(hist, cfg.lossy_pct) if buffered \
            else lossy.identity_map()
    return qual_map, itertools.chain(buffered, blocks)


def _open_writers(cfg: Config) -> List[container.TripletWriter]:
    """The output triplet, or the ``_1``/``_2`` pair of them.  A resumed
    pair whose mates hold different durable blocks (a crash between the
    mates' writes) is cut back to the blocks both hold, so pairs stay
    in sync."""
    meta = file_meta(cfg)
    mates = (1, 2) if cfg.paired else (None,)

    def open_all(**kw):
        return [container.TripletWriter(cfg.output, meta,
                                        part_size=cfg.part_size, mate=m,
                                        resume=cfg.resume, **kw)
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


def compress(cfg: Config, device) -> RunStats:
    """Compress ``cfg.inputs`` (one FASTQ, or a pair with ``cfg.paired``)
    into the ``cfg.output`` triplet (``_1``/``_2`` triplets for a pair);
    with ``cfg.data_parallel``, in groups of blocks over every device
    that ``device`` names (``parallel/mesh.py``); with ``cfg.lossy_pct``,
    through the lossy quality map of the sampled reads."""
    t0 = time.monotonic()
    for p in cfg.inputs:
        if p != "-" and not os.path.exists(p):
            raise FileNotFoundError(f"input FASTQ not found: {p}")
    cfg = resolve_read_len(cfg)
    if cfg.paired:
        blocks = fastq.iter_paired_blocks(*cfg.inputs, cfg.block_reads,
                                          cfg.max_read_len)
    else:
        (path,) = cfg.inputs
        blocks = fastq.iter_blocks(path, cfg.block_reads, cfg.max_read_len)
    qual_map, blocks = _lossy_preamble(cfg, blocks)
    if cfg.data_parallel:
        senc = ShardedEncoder(cfg, device, qual_map=qual_map)
        D, devices = senc.D, senc.mesh

        def dispatch(group):
            # a tail group takes the single-device encoder at assembly
            if len(group) < D:
                return None
            return senc.encode_device_pair(group) if cfg.paired \
                else senc.encode_device(group)

        def assemble(group, devout):
            if devout is None:
                return [senc._fallback.encode_block_pair(*b) if cfg.paired
                        else senc._fallback.encode_block(b) for b in group]
            return senc.assemble_pair(group, devout) if cfg.paired \
                else senc.assemble(group, devout)
    else:
        enc = BlockEncoder(cfg, device, qual_map)
        D, devices = 1, [enc.device]

        def dispatch(group):
            return [enc.encode_device_pair(*b) if cfg.paired
                    else enc.encode_device(b) for b in group]

        def assemble(group, devouts):
            return [enc.assemble_pair(*b, d) if cfg.paired
                    else enc.assemble(b, d) for b, d in zip(group, devouts)]
    stats = RunStats(mode="compress", placement="device",
                     device=",".join(str(d) for d in devices))
    writers = _open_writers(cfg)
    try:
        for group in _groups(blocks, D, writers[0].existing_blocks):
            devout = _timed(stats.stage_s, "device_dispatch", dispatch,
                            group)
            for out in _timed(stats.stage_s, "assemble", assemble, group,
                              devout):
                ebs = out if cfg.paired else (out,)
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
    finally:
        for w in writers:
            w.close()
    stats.input_bytes = sum(_file_size(p) for p in cfg.inputs)
    stats.output_bytes = sum(stats.stream_bytes.values())
    stats.wall_s = time.monotonic() - t0
    return stats


def _groups(blocks: Iterator, D: int, done) -> Iterator[List]:
    """Parsed blocks (or pairs of blocks) in groups of D (the last may be
    shorter), skipping the block ids in ``done`` (already in a resumed
    triplet)."""
    group = []
    while True:
        with stage("parse FASTQ"):
            item = next(blocks, None)
        if item is None:
            break
        first = item[0] if isinstance(item, tuple) else item
        if first.block_id in done:
            continue
        group.append(item)
        if len(group) == D:
            yield group
            group = []
    if group:
        yield group


def check_decode_config(cfg: Config) -> None:
    """Raise NotImplementedError outside the ported decode slice."""
    if cfg.delta_on_device:
        raise NotImplementedError(
            "--delta-device decode: ROADMAP.md Queue 1 item 15")


def decompress(cfg: Config, device) -> RunStats:
    """Decompress the triplet named by ``cfg.inputs[0]`` to FASTQ; a
    paired triplet (either mate's file names it) to ``<output>_1.fastq``
    and ``<output>_2.fastq`` in lockstep, record i of one pairing with
    record i of the other.  Each mate has its own decoder (and
    template-name counter)."""
    t0 = time.monotonic()
    check_decode_config(cfg)
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
                         qual_on_device=cfg.qual_on_device)
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
        group = []
        for payloads in _lockstep(readers):
            group.append(payloads)
            if len(group) == DECODE_GROUP:
                _decode_group(group, decs, outs, stats)
                group = []
        if group:
            _decode_group(group, decs, outs, stats)
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


def _decode_group(group, decs, outs, stats: RunStats) -> None:
    """A group of up to DECODE_GROUP blocks: one K4 launch per mate, the
    mates one after the other, so one mate's decode buffers are held at
    a time (K4's output is about 1 GB per group of 4 full blocks)."""
    for c, (dec, out) in enumerate(zip(decs, outs)):
        for b in dec.decode_blocks([payloads[c] for payloads in group]):
            with stage("render FASTQ"):
                buf = fastq.render_fastq_records(b.seq, b.qual, b.lengths,
                                                 b.n_reads, b.exc_pos,
                                                 b.exc_byte, b.names, b.plus)
            with stage("write"):
                if buf is not None:
                    out.write(buf)
            stats.n_reads += b.n_reads
    stats.n_blocks += len(group)


def _file_size(path) -> int:
    try:
        return os.path.getsize(path)
    except (OSError, TypeError):
        return 0
