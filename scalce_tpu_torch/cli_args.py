# Copy of build_parser and config_from_args of scalce_tpu/cli.py (only
# the imports differ).
"""The reference's argument parser and its Config builder."""

from __future__ import annotations

import argparse

from scalce_tpu_torch.config import Config, parse_size
from scalce_tpu_torch.version import __version__


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="scalce_tpu",
        description="TPU-native SCALCE-class FASTQ compressor")
    p.add_argument("inputs", nargs="+", help="input FASTQ (or .scalce* with -d)")
    p.add_argument("-d", "--decompress", action="store_true")
    p.add_argument("-r", "--paired", action="store_true",
                   help="paired-end mode (two inputs)")
    p.add_argument("-o", "--output", default="out", help="output prefix")
    p.add_argument("-T", "--threads", type=int, default=4)
    p.add_argument("-p", "--lossy", type=int, default=0, metavar="PCT",
                   help="lossy quality quantization percentage")
    p.add_argument("-S", "--sample-size", type=int, default=100_000)
    p.add_argument("-B", "--part-size", default="0",
                   help="max compressed bytes per part (e.g. 500M)")
    p.add_argument("-n", "--name-lib", default=None, metavar="LIB",
                   help="discard names; regenerate as LIB.N")
    p.add_argument("-c", "--backend", choices=("zstd", "gz", "bz", "no"),
                   default="zstd",
                   help="generic byte backend for payload arrays; -c is "
                        "the reference's spelling of its gz/bz/no output "
                        "modes [REF: scalce.c -c flag — UNVERIFIED; "
                        "SURVEY.md §1], zstd is the fast default")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard blocks over all local devices")
    p.add_argument("--n-hosts", type=int, default=1,
                   help="total hosts in a multi-host job (this host "
                        "encodes blocks with id %% n-hosts == host-id)")
    p.add_argument("--host-id", type=int, default=0)
    p.add_argument("--merge-hosts", action="store_true",
                   help="merge per-host outputs into the final triplet "
                        "(run on one host after all hosts finish)")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted compression: finished "
                        "blocks in the output are kept, torn tails "
                        "truncated (scalce_tpu extension)")
    p.add_argument("--keep-order", action="store_true",
                   help="decompress in original read order (scalce_tpu "
                        "extension; the reference cannot restore order)")
    p.add_argument("--block-reads", type=int, default=1 << 18)
    p.add_argument("--max-read-len", type=int, default=0,
                   help="padded read width; 0 (default) auto-sizes "
                        "from the input head (>=128, multiple of 16)")
    p.add_argument("--core-k", type=int, default=12)
    p.add_argument("--dict-mode", choices=("hash", "lut", "lcp"),
                   default="hash",
                   help="core dictionary: implicit minimizer hash, "
                        "explicit 4^k rank table (low-complexity cores "
                        "demoted), or LCP-landmark ranking (paper-like "
                        "cores; see EXPERIMENTS.md for the A/B)")
    p.add_argument("--qual-order", type=int, choices=(0, 1, 2, 3),
                   default=0,
                   help="quality context order; 0 (default) auto-selects "
                        "1, 2 or 3 per block by trial table cost "
                        "(3 = fine position buckets x full prev symbol)")
    p.add_argument("--qual-device", action="store_true",
                   help="place the quality entropy codec on the "
                        "accelerator (best with locally-attached TPUs); "
                        "default is the host path — both emit identical "
                        "bytes")
    p.add_argument("--delta-device", action="store_true",
                   help="place the sequence predecessor-delta on the "
                        "accelerator: encode-side match, and on "
                        "decompress the pointer-doubling chain "
                        "reconstruction; default host — identical "
                        "bytes either way")
    p.add_argument("--core-placement", choices=("auto", "device", "host"),
                   default="auto",
                   help="where the core matcher + bucket sort runs: "
                        "the accelerator, the host (native C), or "
                        "AUTO (default — probe the device link once "
                        "and pick).  Identical output bytes either way")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler trace of the run to DIR")
    p.add_argument("--stats-json", action="store_true",
                   help="print machine-readable run stats to stdout")
    p.add_argument("--version", action="version",
                   version=f"scalce_tpu {__version__}")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    return Config(
        mode="decompress" if args.decompress else "compress",
        inputs=tuple(args.inputs),
        output=args.output,
        paired=args.paired,
        threads=args.threads,
        lossy_pct=args.lossy,
        sample_size=args.sample_size,
        part_size=parse_size(args.part_size),
        name_lib=args.name_lib,
        backend=args.backend,
        keep_order=args.keep_order,
        resume=args.resume,
        data_parallel=args.data_parallel,
        block_reads=args.block_reads,
        max_read_len=args.max_read_len,
        core_k=args.core_k,
        dict_mode=args.dict_mode,
        qual_context_order=args.qual_order,
        qual_on_device=args.qual_device,
        delta_on_device=args.delta_device,
        core_on_device={"auto": None, "device": True,
                        "host": False}[args.core_placement],
        stats_json=args.stats_json,
        profile_dir=args.profile,
        verbose=args.verbose,
        n_hosts=args.n_hosts,
        host_id=args.host_id,
    )
