"""Serial compress/decompress drivers (port of the reference's
``scalce_tpu/pipeline/driver.py`` entry points, ``--data-parallel``
included, without its host pipelining threads: ROADMAP.md Queue 1 item
17)."""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Dict, Iterator, List

from scalce_tpu import container
from scalce_tpu.config import Config, resolve_read_len
from scalce_tpu.io import fastq
from scalce_tpu_torch.parallel.mesh import ShardedEncoder
from scalce_tpu_torch.pipeline.decode import DECODE_GROUP, BlockDecoder
from scalce_tpu_torch.pipeline.encode import BlockEncoder, file_meta
from scalce_tpu_torch.timing import stage


@dataclasses.dataclass
class RunStats:
    mode: str
    device: str = ""
    n_reads: int = 0
    n_blocks: int = 0
    input_bytes: int = 0
    output_bytes: int = 0
    stream_bytes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"n": 0, "r": 0, "q": 0})
    wall_s: float = 0.0

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if self.input_bytes and self.output_bytes:
            d["ratio"] = self.input_bytes / self.output_bytes
        return json.dumps(d, sort_keys=True)


def compress(cfg: Config, device) -> RunStats:
    """Compress ``cfg.inputs[0]`` into the ``cfg.output`` triplet; with
    ``cfg.data_parallel``, in groups of blocks over every device that
    ``device`` names (``parallel/mesh.py``)."""
    t0 = time.monotonic()
    for p in cfg.inputs:
        if p != "-" and not os.path.exists(p):
            raise FileNotFoundError(f"input FASTQ not found: {p}")
    cfg = resolve_read_len(cfg)
    if cfg.data_parallel:
        senc = ShardedEncoder(cfg, device)
        D, encode_group, devices = senc.D, senc.encode_blocks, senc.mesh
    else:
        enc = BlockEncoder(cfg, device)
        D, devices = 1, [enc.device]

        def encode_group(group):
            return [enc.encode_block(b) for b in group]
    stats = RunStats(mode="compress",
                     device=",".join(str(d) for d in devices))
    (path,) = cfg.inputs
    writer = container.TripletWriter(cfg.output, file_meta(cfg),
                                     part_size=cfg.part_size, mate=None,
                                     resume=cfg.resume)
    try:
        blocks = fastq.iter_blocks(path, cfg.block_reads, cfg.max_read_len)
        for group in _groups(blocks, D, writer.existing_blocks):
            for eb in encode_group(group):
                with stage("write"):
                    writer.add_block(eb.block_id, eb.payloads, eb.n_reads)
                stats.n_blocks += 1
                stats.n_reads += eb.n_reads
                for k, p in eb.payloads.items():
                    stats.stream_bytes[k] += len(p)
                if cfg.verbose:
                    print(f"[scalce_tpu_torch] block {eb.block_id}: "
                          f"{eb.n_reads} reads, {eb.total_bytes} bytes",
                          file=sys.stderr)
    finally:
        writer.close()
    stats.input_bytes = _file_size(path)
    stats.output_bytes = sum(stats.stream_bytes.values())
    stats.wall_s = time.monotonic() - t0
    return stats


def _groups(blocks: Iterator, D: int, done) -> Iterator[List]:
    """Parsed blocks in groups of D (the last may be shorter), skipping
    the block ids in ``done`` (already in a resumed triplet)."""
    group = []
    while True:
        with stage("parse FASTQ"):
            block = next(blocks, None)
        if block is None:
            break
        if block.block_id in done:
            continue
        group.append(block)
        if len(group) == D:
            yield group
            group = []
    if group:
        yield group


def check_decode_config(cfg: Config, meta: Dict) -> None:
    """Raise NotImplementedError outside the ported decode slice."""
    if meta.get("paired"):
        raise NotImplementedError("paired-end: ROADMAP.md Queue 1 item 12")
    if cfg.delta_on_device:
        raise NotImplementedError(
            "--delta-device decode: ROADMAP.md Queue 1 item 15")
    if not cfg.qual_on_device:
        raise NotImplementedError(
            "host quality decode (the port decodes qualities on the "
            "device, --qual-device): ROADMAP.md Queue 1 item 11")


def decompress(cfg: Config, device) -> RunStats:
    """Decompress the triplet named by ``cfg.inputs[0]`` to FASTQ."""
    t0 = time.monotonic()
    (path,) = cfg.inputs
    reader = container.TripletReader(path)
    check_decode_config(cfg, reader.meta)
    dec = BlockDecoder(reader.meta, device, keep_order=cfg.keep_order)
    stats = RunStats(mode="decompress", device=str(dec.device))
    if cfg.output == "-":
        out_path = None
        out = sys.stdout.buffer
    else:
        out_path = cfg.output if cfg.output.endswith(".fastq") \
            else cfg.output + ".fastq"
        out = open(out_path, "wb")
    try:
        group = []
        for _, payloads in reader.iter_blocks():
            group.append(payloads)
            if len(group) == DECODE_GROUP:
                _emit(dec.decode_blocks(group), out, stats)
                group = []
        if group:
            _emit(dec.decode_blocks(group), out, stats)
    finally:
        if out_path is None:
            out.flush()
        else:
            out.close()
    stats.output_bytes = _file_size(out_path) if out_path else 0
    stats.wall_s = time.monotonic() - t0
    return stats


def _emit(blocks, out, stats: RunStats) -> None:
    for b in blocks:
        with stage("render FASTQ"):
            buf = fastq.render_fastq_records(b.seq, b.qual, b.lengths,
                                             b.n_reads, b.exc_pos,
                                             b.exc_byte, b.names, b.plus)
        with stage("write"):
            if buf is not None:
                out.write(buf)
        stats.n_reads += b.n_reads
        stats.n_blocks += 1


def _file_size(path) -> int:
    try:
        return os.path.getsize(path)
    except (OSError, TypeError):
        return 0
