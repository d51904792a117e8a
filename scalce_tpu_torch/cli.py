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
``--qual-device`` on decompress decodes them there (K4).  The cores and
the delta run on the device by default (the placement defaults move
there; they change no byte), and the backend is the best installed one.
``--core-placement host`` runs the whole block on the host (the native
core matcher, sort and delta match; nothing reaches a device), and
``--core-placement auto`` measures the link to the device once and
keeps the cores on the host below 200 MB/s; with either, the delta match
runs on the host too, as the reference's defaults have it.
``--dict-mode lut|lcp`` ranks cores by an explicit 4^k table (core k <=
12; K1's table variant on the card).  ``-d --delta-device`` rebuilds
the sequences by pointer doubling on the device in place of the host's
serial walk.  Long reads, multi-host and ``--profile`` raise
NotImplementedError naming the ROADMAP.md item that will add them.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from scalce_tpu_torch.cli_args import build_parser as _reference_parser
from scalce_tpu_torch.cli_args import config_from_args
from scalce_tpu_torch.io.backend import DEFAULT_BACKEND


def build_parser():
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
    p.set_defaults(core_placement="device", delta_device=None,
                   backend=DEFAULT_BACKEND)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.merge_hosts:
        raise NotImplementedError(
            "--merge-hosts (multi-host, n_hosts > 1): ROADMAP.md Queue 1 "
            "item 16")
    if args.profile:
        raise NotImplementedError("--profile: ROADMAP.md Queue 1 item 18")
    if args.delta_device is None:
        args.delta_device = (not args.decompress
                             and args.core_placement == "device")
    cfg = config_from_args(args)
    from scalce_tpu_torch.pipeline import driver
    if cfg.mode == "compress":
        stats = driver.compress(cfg, args.device)
    else:
        stats = driver.decompress(cfg, args.device)
    if cfg.stats_json:
        print(stats.to_json())
    else:
        print(f"[scalce_tpu_torch] {stats.mode} on {stats.device}: "
              f"{stats.n_reads} reads in {stats.n_blocks} blocks, "
              f"{stats.wall_s:.2f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
