"""Command line of the port: the reference's flags plus ``--device``.

  python -m scalce_tpu_torch input.fastq -o out                 compress
  python -m scalce_tpu_torch r1.fq r2.fq -r -o out              paired-end
  python -m scalce_tpu_torch input.fastq -p 30 [-S N] -o out    lossy
  python -m scalce_tpu_torch -d out.00.scalcen -o result        decompress
  python -m scalce_tpu_torch -d out.00_1.scalcen -o result      result_1.fastq
                                                                result_2.fastq

``-r`` writes ``out.00_1.*`` and ``out.00_2.*`` triplets (mate 2 follows
mate 1's order); ``-p PCT`` maps qualities through a map built from the
first ``-S`` reads (default 100,000), within PCT percent of each value.
``--data-parallel`` compresses in groups of blocks (or pairs) over every
visible card (``--device cuda``), or over the one device that ``cuda:N``
or ``cpu`` names; the triplets are the same.  The parser is the
reference's (``cli_args.build_parser``, a copy), with its quality
defaults: the qualities are coded on the host, each block at the context
order that its trial picks (``--qual-order 0``), so the bare command
writes ``python -m scalce_tpu``'s bytes; ``--qual-device`` with a fixed
``--qual-order`` codes them on the device (kernels K2-K6), and
``--qual-device`` on decompress decodes them there (K4).  For short
reads the cores and the delta run on the device by default (the
placement defaults move there; they change no byte), and the backend is
the best installed one.  An input whose width resolves above 32752
(``--max-read-len``, or the probe of its head) is a long-read file: the
bare command then keeps the reference's placement defaults, and long
reads run on the host (minimizer order and anchored delta, container
v7); an explicit device placement there raises the reference's
ValueError.  ``--core-placement host`` runs the whole block on the host
(the native core matcher, sort and delta match; nothing reaches a
device), and ``--core-placement auto`` measures the link to the device
once and keeps the cores on the host below 200 MB/s; with either, the
delta match runs on the host too, as the reference's defaults have it.
``--dict-mode lut|lcp`` ranks cores by an explicit 4^k table (core k <=
12; K1's table variant on the card).  ``-d --delta-device`` rebuilds
the sequences by pointer doubling on the device in place of the host's
serial walk.

Multi-host: each host runs the compress with ``--n-hosts N --host-id h``
(its share of the blocks into ``out.host<h>.*``), then one host runs it
with ``--merge-hosts`` (the 1-host triplet); ``python -m
scalce_tpu_torch.parallel.multihost`` does all three over
``torch.distributed``.  ``--profile DIR`` writes a ``torch.profiler``
trace of the run into DIR, and beside it the run's counters and device
time per stage (``timing.profile``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional

from scalce_tpu_torch import timing
from scalce_tpu_torch.cli_args import build_parser as _reference_parser
from scalce_tpu_torch.cli_args import config_from_args as _reference_config
from scalce_tpu_torch.config import Config, resolve_read_len
from scalce_tpu_torch.io.backend import DEFAULT_BACKEND


class _Default(str):
    """A parser default that :func:`config_from_args` tells apart from
    the same word on the command line (argparse keeps the object)."""


#: ``--core-placement`` when the command line does not give it: the
#: device for short reads, the reference's AUTO for long reads
BARE_CORE_PLACEMENT = _Default("device")


def _set_help(parser: argparse.ArgumentParser, dest: str, text: str):
    for action in parser._actions:
        if action.dest == dest:
            action.help = text


def build_parser() -> argparse.ArgumentParser:
    p = _reference_parser()
    p.prog = "scalce_tpu_torch"
    p.description = "PyTorch + CUDA port of scalce_tpu"
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; every visible card "
                        "under --data-parallel), cuda:N, or cpu (plain "
                        "torch versions of every kernel)")
    # delta_device None: when compressing, the device delta match beside
    # device cores (host cores, or AUTO, take the reference's host match);
    # when decompressing, the host delta walk (the flag names both)
    p.set_defaults(core_placement=BARE_CORE_PLACEMENT, delta_device=None,
                   backend=DEFAULT_BACKEND)
    _set_help(p, "core_placement",
              "where the core matcher and sort run: the device (default "
              "for short reads), the host (native C), or AUTO (probe the "
              "device link once and pick; the default for long reads, "
              "which run on the host).  The same bytes either way")
    _set_help(p, "profile",
              "write a torch.profiler trace of the run (Chrome trace "
              "JSON; host spans of every pipeline stage, and the card's "
              "kernels and copies under --device cuda) into DIR, and "
              "beside it the run's counters and device time per stage")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    """The Config of a parsed command line: the reference's, with the
    port's placement defaults.  Without ``--core-placement``, a compress
    puts the cores and the delta on the device when the input's resolved
    width is a short read's; a long-read input keeps the reference's
    defaults (AUTO cores, host delta), which long-read mode runs on the
    host.  ``--delta-device`` unset means the device delta beside device
    cores when compressing and the host walk when decompressing."""
    args = argparse.Namespace(**vars(args))
    compress = not args.decompress
    bare = (args.core_placement is BARE_CORE_PLACEMENT and compress
            and not args.merge_hosts)
    if bare:
        args.core_placement = "auto"
    if args.delta_device is None:
        args.delta_device = compress and args.core_placement == "device"
    cfg = _reference_config(args)
    if bare and all(p == "-" or os.path.exists(p) for p in cfg.inputs):
        # (a missing input is the driver's FileNotFoundError)
        cfg = resolve_read_len(cfg)
        from scalce_tpu_torch.pipeline.encode import SHORT_READ_MAX
        if cfg.max_read_len <= SHORT_READ_MAX:
            cfg = dataclasses.replace(cfg, core_on_device=True,
                                      delta_on_device=True)
    return cfg


def run(cfg: Config, device):
    """Compress or decompress as ``cfg`` says on ``device``, under
    ``torch.profiler`` when ``cfg.profile_dir`` is set; returns the
    :class:`~scalce_tpu_torch.pipeline.driver.RunStats`."""
    from scalce_tpu_torch.pipeline import driver
    with timing.profile(cfg.profile_dir, device, write_counters=True):
        if cfg.mode == "compress":
            return driver.compress(cfg, device)
        return driver.decompress(cfg, device)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.merge_hosts:
        from scalce_tpu_torch.pipeline import driver
        n = driver.merge_hosts(cfg)
        print(f"[scalce_tpu_torch] merged {n} blocks from {cfg.n_hosts} "
              "hosts", file=sys.stderr)
        return 0
    stats = run(cfg, args.device)
    if cfg.stats_json:
        print(stats.to_json())
    else:
        print(f"[scalce_tpu_torch] {stats.mode} on {stats.device}: "
              f"{stats.n_reads} reads in {stats.n_blocks} blocks, "
              f"{stats.wall_s:.2f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
