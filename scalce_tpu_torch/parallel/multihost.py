"""Multi-host compress: run on every host (rank) of the job

    python -m scalce_tpu_torch.parallel.multihost input.fastq -o out \\
        --coordinator HOST0:PORT --num-processes N --process-id R \\
        [--device cuda:0] [any compress flag of python -m scalce_tpu_torch]

Each rank joins the gloo process group (``distributed.init_multihost``),
compresses its strided share of the blocks (``block_id % N == R``) into
``out.host<R>.*`` on ``cuda:(R % cards)`` unless ``--device`` names
another device, waits at the barrier, and rank 0 merges the hosts'
triplets into ``out``'s, which equals a 1-host compress of the same
input and flags, byte for byte.  Every rank parses the whole input, so
under ``-p`` every rank samples the same reads and builds the same map.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from scalce_tpu_torch import cli
from scalce_tpu_torch.parallel import distributed


def build_parser():
    p = cli.build_parser()
    p.prog = "python -m scalce_tpu_torch.parallel.multihost"
    p.description = ("multi-host compress over torch.distributed: each "
                     "rank encodes its share, rank 0 merges")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rank 0's address for the rendezvous")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.set_defaults(device=None)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.decompress or args.merge_hosts:
        raise SystemExit("multihost compresses: decompress the merged "
                         "triplet with python -m scalce_tpu_torch -d")
    topo = distributed.init_multihost(args.coordinator, args.num_processes,
                                      args.process_id)
    try:
        if args.device is None:
            args.device = f"cuda:{topo.host_id % max(1, topo.n_local_devices)}"
        args.n_hosts, args.host_id = topo.n_hosts, topo.host_id
        cfg = cli.config_from_args(args)
        print(f"[multihost] host {topo.host_id}/{topo.n_hosts} on "
              f"{args.device}", file=sys.stderr)
        stats = cli.run(cfg, args.device)
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize(args.device)
        print(f"[multihost] host {topo.host_id}: {stats.n_blocks} blocks, "
              f"{stats.n_reads} reads, {stats.wall_s:.3f} s",
              file=sys.stderr)
        distributed.barrier()
        if topo.host_id == 0 and topo.n_hosts > 1:
            from scalce_tpu_torch.pipeline import driver
            n = driver.merge_hosts(cfg)
            print(f"[multihost] merged {n} blocks", file=sys.stderr)
        if cfg.stats_json:
            print(stats.to_json())
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
