# Copy of scalce_tpu/models/core_dict.py (verbatim).
"""Core-substring dictionary generation (the LCE/LCP dictionary).

The reference ships a compiled-in table of LCP-derived core substrings
with a priority ranking [REF: scalce reads.c pattern data — UNVERIFIED;
SURVEY.md §2 "LCE core dictionary"].  scalce_tpu's default replacement
is the *implicit* dictionary — the ``mix32`` minimizer ranking over all
k-mers (``ops.bitops.mix32``), which needs no storage or broadcast.

This module provides the *explicit* mode (``Config.dict_mode='lut'``):
an offline-generated rank LUT over all ``4**k`` k-mers, replicated to
every device.  The generator mirrors what the LCP construction buys the
reference — cores land on locally-distinctive sequence — by demoting
low-complexity k-mers (homopolymers / dinucleotide repeats never become
cores, so poly-A tails don't funnel half the block into one bucket):

    rank = (max_run_class << 28) | (16 - distinct_2mers) << 24
                                 | mix32(kmer) >> 8

Lower rank = higher priority.  Deterministic by construction, so every
host/device derives the identical table (SURVEY.md §8 hard part:
"deterministic multi-host ordering").
"""

from __future__ import annotations

import numpy as np


def _mix32_np(x: np.ndarray, seed: int) -> np.ndarray:
    x = x.astype(np.uint32) ^ np.uint32(seed & 0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x85EBCA6B)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(13)
    x = (x * np.uint32(0xC2B2AE35)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    return x


def kmer_bases(k: int) -> np.ndarray:
    """uint8 [4^k, k]: the base codes of every k-mer (big-endian order)."""
    kmers = np.arange(4 ** k, dtype=np.uint64)
    shifts = (2 * np.arange(k - 1, -1, -1)).astype(np.uint64)
    return ((kmers[:, None] >> shifts) & 3).astype(np.uint8)


def complexity_scores(k: int):
    """(distinct 2-mer count [4^k], longest homopolymer run [4^k])."""
    bases = kmer_bases(k)
    two = bases[:, :-1] * 4 + bases[:, 1:]
    distinct = np.zeros(len(bases), np.int32)
    for v in range(16):
        distinct += (two == v).any(axis=1)
    runs = np.ones(len(bases), np.int32)
    cur = np.ones(len(bases), np.int32)
    for j in range(1, k):
        same = bases[:, j] == bases[:, j - 1]
        cur = np.where(same, cur + 1, 1)
        runs = np.maximum(runs, cur)
    return distinct, runs


def build_rank_lut(k: int, seed: int) -> np.ndarray:
    """uint32 [4^k] priority table; lower = preferred as core."""
    if k > 12:
        raise ValueError("explicit LUT limited to k <= 12 (4^k entries)")
    n = 4 ** k
    distinct, runs = complexity_scores(k)
    run_class = np.minimum(runs * 4 // k, 3).astype(np.uint32)   # 0..3
    poverty = np.uint32(16) - distinct.astype(np.uint32)         # fewer=worse
    h = _mix32_np(np.arange(n, dtype=np.uint32), seed)
    rank = (run_class << np.uint32(28)) | (poverty << np.uint32(24)) \
        | (h >> np.uint32(8))
    return rank.astype(np.uint32)


def lcp_landmarks(k: int) -> np.ndarray:
    """bool [4^k]: the k-mer's center is a locally-consistent landmark.

    The paper's LCP construction (SCALCE §2, Sahinalp–Vishkin parsing)
    marks positions that are local extrema under the (iterated) alphabet
    order; blocks anchored at marked positions form cores, and the
    marking depends only on a bounded neighbourhood — which is what
    makes it consistent across strings sharing a substring.  For the
    fixed-k LUT slot, the equivalent property is computed on the k-mer's
    own bases: the center position must be a strict local extremum, with
    ties broken by the run-boundary rule (first position of an equal
    run counts, later ones don't — the standard tie handling that keeps
    markings sparse inside homopolymers).
    """
    bases = kmer_bases(k)
    c = k // 2
    left = bases[:, c - 1].astype(np.int16)
    mid = bases[:, c].astype(np.int16)
    right = bases[:, c + 1].astype(np.int16)
    is_max = (mid > left) & (mid > right)
    is_min = (mid < left) & (mid < right)
    # run-boundary: equal to the left neighbour never marks (only the
    # first position of an equal run may be a landmark)
    run_start = mid != left
    return (is_max | is_min) & run_start


def build_rank_lut_lcp(k: int, seed: int) -> np.ndarray:
    """LCP-mode priority table: landmark k-mers (paper-§2 cores) rank
    ahead of all others; complexity demotion and the seeded hash break
    ties — measured against ``build_rank_lut`` and the implicit mix32
    ranking in scripts/exp_dictionary.py."""
    if k > 12:
        raise ValueError("explicit LUT limited to k <= 12 (4^k entries)")
    n = 4 ** k
    distinct, runs = complexity_scores(k)
    run_class = np.minimum(runs * 4 // k, 3).astype(np.uint32)
    mark = lcp_landmarks(k)
    h = _mix32_np(np.arange(n, dtype=np.uint32), seed)
    rank = (run_class << np.uint32(30)) \
        | ((~mark).astype(np.uint32) << np.uint32(29)) \
        | (h >> np.uint32(3))
    return rank.astype(np.uint32)
