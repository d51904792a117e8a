# Copy of scalce_tpu/config.py (only the imports differ).
"""Typed configuration for scalce_tpu.

The reference keeps its run configuration in mutable globals populated by
``getopt_long`` [REF: scalce scalce.c / const.h — UNVERIFIED; SURVEY.md §2
L4].  Here it is a frozen dataclass constructed once by the CLI (or by
library callers) and threaded explicitly through the pipeline — no globals,
which also keeps the jit'd functions pure.

Flag parity with the scalce CLI (SURVEY.md §1):
  -d            decompress            -> ``mode="decompress"``
  -r            paired-end            -> ``paired=True``
  -T <n>        threads               -> ``threads`` (host worker threads)
  -p <pct>      lossy quality         -> ``lossy_pct``
  -S <n>        lossy sample size     -> ``sample_size``
  -B <size>     output part cap      -> ``part_size`` (bytes)
  -n <lib>      discard/regen names  -> ``name_lib``
  -o <prefix>   output prefix        -> ``output``
  gz/bz/no backend selection         -> ``backend``
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional, Tuple

from scalce_tpu_torch.io.backend import BACKENDS as _AVAILABLE_BACKENDS
from scalce_tpu_torch.io.backend import DEFAULT_BACKEND as _DEFAULT_BACKEND

#: Sentinel for "no part splitting" (-B absent).
NO_PART_LIMIT = 0


def parse_size(text: str) -> int:
    """Parse a human size like ``500M``, ``2G``, ``1024`` into bytes.

    Mirrors the reference's ``-B <size>`` argument surface
    [REF: scalce.c option parsing — UNVERIFIED].
    """
    m = re.fullmatch(r"\s*(\d+)\s*([kKmMgGtT]?)[bB]?\s*", text)
    if not m:
        raise ValueError(f"cannot parse size: {text!r}")
    value = int(m.group(1))
    unit = m.group(2).lower()
    mult = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}[unit]
    return value * mult


@dataclasses.dataclass(frozen=True)
class Config:
    """Complete run configuration.

    Device-pipeline-relevant fields are consumed as *static* arguments by
    the jit'd block functions; changing them recompiles, which matches how
    a user actually runs the tool (fixed settings per invocation).
    """

    # --- scalce-compatible surface -------------------------------------
    mode: str = "compress"            # "compress" | "decompress"
    inputs: Tuple[str, ...] = ()       # 1 file, or 2 when paired
    output: str = "out"                # -o output prefix
    paired: bool = False               # -r
    threads: int = dataclasses.field(  # -T (host-side assembly workers)
        default_factory=lambda: (os.cpu_count() or 4) + 2)
                                       # default cores+2: workers block
                                       # on device fetches/IO, so mild
                                       # oversubscription keeps the
                                       # cores fed (bytes are invariant
                                       # to -T — pinned by test)
    lossy_pct: int = 0                 # -p ; 0 = lossless qualities
    sample_size: int = 100_000         # -S ; reads sampled for lossy histogram
    part_size: int = NO_PART_LIMIT     # -B ; max compressed bytes per part
    name_lib: Optional[str] = None     # -n ; regenerate names as "<lib>.N"
    backend: str = _DEFAULT_BACKEND    # zstd | gz | bz | no (generic byte
                                       # backend; zstd reaches gz ratios at
                                       # a fraction of the host CPU, falls
                                       # back to gz where unavailable)
    keep_order: bool = False           # decompress in original read order
                                       # (beyond reference parity: scalce
                                       # cannot restore input order)
    resume: bool = False               # skip blocks already durable in the
                                       # output (restart after crash)

    # --- TPU pipeline shape --------------------------------------------
    block_reads: int = 1 << 18         # reads per device block (static
                                       # shape); bigger blocks = denser
                                       # buckets = better delta matching
                                       # (~+11% ratio 32k -> 128k, +4.3%
                                       # 128k -> 256k at ~-3% encode
                                       # speed on large inputs; the
                                       # bench pins its own 128k blocks
                                       # for pipeline granularity)
    max_read_len: int = 0              # padded read length (static shape);
                                       # 0 = AUTO: size from the longest
                                       # sequence line in the input head
                                       # (>= 128, ceil to a multiple of
                                       # 16) via resolve_read_len — 151bp
                                       # HiSeq reads compress with no
                                       # flags (VERDICT r4 #7)
    core_k: int = 12                   # core k-mer length (2k bits <= 31)
    dict_seed: int = 0x5CA1CE          # core-dictionary ranking seed
    dict_mode: str = "hash"            # "hash" = implicit minimizer ranking
                                       # "lut"  = explicit 4^k rank table
                                       # "lcp"  = LCP-landmark ranking
                                       #          (models/core_dict.py;
                                       #          A/B: EXPERIMENTS.md)

    # --- entropy coder shape -------------------------------------------
    qual_T_target: int = 2048          # rANS lane span target (symbols per
                                       # lane; lanes = B*L/T); larger T =
                                       # less per-lane state/count
                                       # overhead (1024->2048 saves
                                       # ~39KB/131k-block, +0.6% overall
                                       # ratio, measured) but a longer
                                       # serial scan on the device
                                       # decode placement
    qual_context_order: int = 0        # 0 = auto-select 1/2/3 per block
                                       # by trial table cost (host path);
                                       # 1/2/3 fixes the order (3 = fine
                                       # pos buckets x full prev symbol)
    qual_on_device: bool = False       # place the quality entropy codec
                                       # on the accelerator (best with
                                       # locally-attached TPUs) or the
                                       # host (best when the device link
                                       # is narrow).  Both paths emit
                                       # IDENTICAL bytes (pinned by test)
                                       # — a pure placement choice.

    core_on_device: Optional[bool] = None
                                       # place the core matcher +
                                       # bucket sort on the accelerator
                                       # (True), on the host in native
                                       # C (False), or AUTO (None,
                                       # default): probe the device
                                       # link once and pick — device on
                                       # locally-attached TPUs, host
                                       # when the link is narrower than
                                       # the host's own matcher.
                                       # Identical output bytes either
                                       # way (pinned by test).  Host
                                       # placement requires host-placed
                                       # qualities+delta and the
                                       # implicit hash dictionary.

    delta_on_device: bool = False      # place the predecessor-delta
                                       # match on the accelerator or the
                                       # host.  Host placement downloads
                                       # the sorted 2-bit-packed block
                                       # (L/4 bytes/read) instead of the
                                       # delta products and runs the
                                       # byte-compare match in native C
                                       # — the win on narrow links, like
                                       # qual_on_device.  Identical
                                       # output bytes either way (pinned
                                       # by test).  Device placement is
                                       # forced when the native library
                                       # is unavailable or qualities are
                                       # device-placed.

    data_parallel: bool = False        # shard blocks over all local
                                       # devices (config 4; single-host DP)

    # --- multi-host data parallelism ------------------------------------
    n_hosts: int = 1                   # total hosts in the job
    host_id: int = 0                   # this host's rank
                                       # (host h encodes blocks with
                                       #  block_id % n_hosts == h; outputs
                                       #  merge deterministically)

    # --- misc -----------------------------------------------------------
    stats_json: bool = False           # emit machine-readable stats
    profile_dir: Optional[str] = None  # torch.profiler trace output dir
    verbose: bool = False

    def __post_init__(self) -> None:
        if self.mode not in ("compress", "decompress"):
            raise ValueError(f"bad mode: {self.mode}")
        if self.backend not in ("zstd", "gz", "bz", "no"):
            raise ValueError(f"bad backend: {self.backend} "
                             "(want zstd|gz|bz|no)")
        if self.backend not in _AVAILABLE_BACKENDS:
            raise ValueError(f"backend {self.backend!r} unavailable on "
                             "this host (zstandard not installed); "
                             "use --backend gz")
        if not (0 <= self.lossy_pct <= 100):
            raise ValueError("lossy_pct must be in [0, 100]")
        if self.paired and self.mode == "compress" and len(self.inputs) != 2:
            raise ValueError("-r (paired) compression requires two inputs")
        if self.core_k < 4 or self.core_k > 15:
            raise ValueError("core_k must be in [4, 15] (2k bits in int32)")
        if self.core_on_device is False:
            if self.qual_on_device or self.delta_on_device:
                raise ValueError("host core placement requires host-"
                                 "placed qualities and delta")
            if self.dict_mode != "hash":
                raise ValueError("host core placement supports only "
                                 "--dict-mode hash")
            if self.data_parallel:
                raise ValueError("--data-parallel shards device work; "
                                 "use device core placement")
        if self.block_reads & (self.block_reads - 1):
            raise ValueError("block_reads must be a power of two")
        if self.block_reads < 256:
            raise ValueError("block_reads must be >= 256")
        if self.max_read_len % 16:
            raise ValueError("max_read_len must be a multiple of 16 "
                             "(2-bit packing granularity)")
        if self.max_read_len > 1 << 20:
            raise ValueError("max_read_len must be <= 2^20")
        if self.max_read_len > 32752:
            # LONG-READ MODE (v6 container): the short-read core
            # matcher cannot run (15/16-bit delta fields, automaton
            # sized for short reads) — reads are minimizer-reordered
            # and delta-coded against the anchored predecessor instead
            # (ops/minimizer.py, EXPERIMENTS.md §14); wide i32 shifts
            # ride the shv4 planes.  Non-overlapping rows stay pure
            # literals through the order-2 literal rANS; qualities use
            # the standard coder with T = L.  Host pipeline only (the
            # device stages pack 15-bit lengths).
            if self.core_on_device is True or self.qual_on_device \
                    or self.delta_on_device:
                raise ValueError("max_read_len > 32752 (long-read mode) "
                                 "runs the host pipeline: device "
                                 "placements are unavailable")
            if self.data_parallel:
                raise ValueError("max_read_len > 32752 (long-read mode) "
                                 "does not support --data-parallel")
        if self.block_reads * self.max_read_len >= 1 << 31:
            raise ValueError("block_reads * max_read_len must be < 2^31 "
                             "(flat base positions are int32 on device)")
        if self.qual_T_target < 64 or self.qual_T_target > 32768 or \
                self.qual_T_target & (self.qual_T_target - 1):
            raise ValueError("qual_T_target must be a power of two in "
                             "[64, 32768] (word counts are 16-bit)")
        if self.qual_context_order not in (0, 1, 2, 3):
            raise ValueError("qual_context_order must be 0 (auto), 1, 2 "
                             "or 3")
        if (self.qual_context_order == 0 and self.qual_on_device
                and self.mode == "compress"):
            # decompress reads each block's order from the container;
            # only the ENCODE device path compiles per order
            raise ValueError("qual_context_order=0 (auto) requires the "
                             "host quality path (the device path "
                             "compiles per order)")
        if not (0 <= self.host_id < self.n_hosts):
            raise ValueError("host_id must be in [0, n_hosts)")
        if self.dict_mode not in ("hash", "lut", "lcp"):
            raise ValueError("dict_mode must be 'hash', 'lut' or 'lcp'")
        if self.dict_mode in ("lut", "lcp") and self.core_k > 12:
            raise ValueError(f"dict_mode={self.dict_mode!r} requires "
                             "core_k <= 12 (4^k LUT)")


def resolve_read_len(cfg: Config) -> Config:
    """Resolve ``max_read_len == 0`` (AUTO) to a concrete padded width.

    Compress mode probes the input head (io.fastq.probe_max_read_len:
    deterministic, >= 128, multiple of 16); stdin and decompress keep
    the 128 floor (decode takes its width from the container metadata).
    ``dataclasses.replace`` re-runs validation, so long-read widths
    picked by the probe hit the same placement constraints an explicit
    --max-read-len would."""
    if cfg.max_read_len:
        return cfg
    width = None
    if cfg.mode == "compress" and cfg.inputs:
        from scalce_tpu_torch.io.fastq import probe_max_read_len
        width = probe_max_read_len(cfg.inputs)
    return dataclasses.replace(cfg, max_read_len=width or 128)
