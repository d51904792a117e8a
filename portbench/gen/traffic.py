"""A traffic mix's input files from its parameters and the run's seed.

A mix (``traffic/<name>.json``) gives the reads' length, the genome
they are drawn from, the quality and naming models, the
reverse-complement and N rates and the reads per chunk; the
configuration gives the number of reads, which a pair splits over its
two mates.  The file is made chunk by chunk with the frozen generator (:mod:`portbench.gen.synth`), every chunk from the
same genome and from a seed of its own derived from the run's seed, on
a pool of threads (numpy's generators and array operations release the
interpreter lock), and the names are numbered across chunks.  A pair's
mate 2 follows ``synth_pair``: the same chunk's reads under the mate's
own seed, with the ``illumina`` names that mark the mate.
"""

from __future__ import annotations

import concurrent.futures as _fut
import os
from typing import Dict, List

import numpy as np

from portbench.gen import synth

#: keys a mix must give
KEYS = ("chunk_reads", "read_len", "genome_len", "qual_model",
        "name_style", "pair_name_style", "rc_rate", "n_rate")


def sub_seed(seed: int, *purpose: int) -> int:
    """A 63-bit seed for one purpose (the genome, a chunk of a mate) of
    the run's ``seed``, which may be any whole number."""
    ss = np.random.SeedSequence([seed % (1 << 64), *purpose])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def genome(mix: Dict, seed: int) -> np.ndarray:
    """The genome that every read of the run is drawn from."""
    rng = np.random.default_rng(sub_seed(seed, 0))
    return rng.integers(0, 4, size=int(mix["genome_len"]), dtype=np.uint8)


def make_files(mix: Dict, seed: int, paired: bool, reads: int,
               workers: int = 0) -> List[List[bytes]]:
    """The input file's bytes, or both mates' for ``paired``, as chunks
    of the mix's ``chunk_reads`` reads: ``reads`` reads in all, made on
    ``workers`` threads (0: one per core, at most 8)."""
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic mix lacks {missing}")
    total = int(reads)
    mates = (1, 2) if paired else (None,)
    per_mate = total // len(mates)
    chunk = int(mix["chunk_reads"])
    g = genome(mix, seed)
    starts = list(range(0, per_mate, chunk))

    def one(job):
        mate, c0 = job
        style = mix["pair_name_style"] if paired else mix["name_style"]
        return synth.synth_fastq(
            min(chunk, per_mate - c0), int(mix["read_len"]),
            seed=sub_seed(seed, 1, mate or 1, c0), genome=g,
            qual_model=mix["qual_model"], name_style=style,
            rc_rate=float(mix["rc_rate"]), n_rate=float(mix["n_rate"]),
            mate=mate, first_index=c0 + 1)

    jobs = [(m, c0) for m in mates for c0 in starts]
    n = workers or min(8, os.cpu_count() or 1)
    with _fut.ThreadPoolExecutor(max_workers=n) as pool:
        parts = list(pool.map(one, jobs))
    return [parts[i * len(starts):(i + 1) * len(starts)]
            for i in range(len(mates))]
