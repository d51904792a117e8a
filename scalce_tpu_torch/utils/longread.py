"""Synthetic long reads: HiFi-like FASTQ sampled from one random genome.

Each read is a forward-strand substring of the genome with independent
substitutions, insertions and deletions at the given per-base rates, and
a random-walk quality string.  Deterministic in ``seed``; numpy, one
vectorized pass per read, so tens of megabases take seconds.
"""

from __future__ import annotations

import numpy as np

_ACGT = np.frombuffer(b"ACGT", np.uint8)


def synth_long_fastq(n_reads: int, min_len: int, max_len: int, *,
                     genome_len: int, sub: float = 0.005,
                     ins: float = 0.0, dele: float = 0.0,
                     seed: int = 0) -> bytes:
    """``n_reads`` records of ``min_len``-``max_len`` bases (before
    indels) from a ``genome_len``-base genome; names ``@lr<i>/ccs``."""
    rng = np.random.default_rng(seed)
    genome = _ACGT[rng.integers(0, 4, genome_len)]
    out = []
    for i in range(n_reads):
        ln = int(rng.integers(min_len, max_len + 1))
        start = int(rng.integers(0, genome_len - ln + 1))
        seq = genome[start:start + ln]
        seq = seq[rng.random(ln) >= dele]
        hit = rng.random(seq.shape[0]) < sub
        seq[hit] = _ACGT[rng.integers(0, 4, int(hit.sum()))]
        at = np.flatnonzero(rng.random(seq.shape[0]) < ins)
        seq = np.insert(seq, at, _ACGT[rng.integers(0, 4, at.shape[0])])
        qual = (np.clip(np.cumsum(rng.integers(-1, 2, seq.shape[0]))
                        + 30, 2, 60) + 33).astype(np.uint8)
        out.append(b"@lr%d/ccs\n%s\n+\n%s\n" % (i, seq.tobytes(),
                                                qual.tobytes()))
    return b"".join(out)
