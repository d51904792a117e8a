# Copy of scalce_tpu/ops/minimizer.py (verbatim).
"""Global-minimizer keys for long reads (container v6).

Long-read mode cannot use the short-read core matcher (its automaton
and delta fields assume <=32752 bp), but the boosting idea — make
overlapping reads adjacent — carries over with a cheaper landmark: the
GLOBAL MINIMIZER, the position of the minimum avalanche-hashed k-mer in
the read.  Two reads covering the same locus almost surely contain the
same minimum k-mer, so sorting by (min-hash, -min-pos) clusters them
and gives a per-pair alignment anchor (shift = minpos_prev - minpos_cur)
— EXPERIMENTS.md §14 measured 1.7-3.4x on the sequence stream.

Host-only NumPy (long-read mode never touches the device); column-tiled
so the k-mer image never materializes at [n, L] for megabase reads.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

#: minimizer k-mer length (32-bit packed; plenty of anchor specificity)
K = 16
#: per-row sentinel for "no k-mer" (reads shorter than K)
NO_KEY = np.uint32(0xFFFFFFFF)


def mix32_np(x: np.ndarray) -> np.ndarray:
    """NumPy mirror of the core matcher's avalanche hash
    (ops/core_match.py mix32 contract — same constants)."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x7FEB352D)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(15)
    x = (x * np.uint32(0x846CA68B)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    return x


def minimizer_keys(codes: np.ndarray, lengths: np.ndarray,
                   tile: int = 1 << 16
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-read global minimizer over 2-bit codes.

    codes: u8 [n, L] (values 0..3; exception positions carry whatever
    code the parser wrote — the minimizer is a pure function of the
    stored codes, so encode/decode see the same frame).
    lengths: [n] per-read lengths.

    Returns (hash u32 [n], pos i64 [n]): the min of mix32(16-mer) over
    every k-mer start ``p`` with ``p + K <= len``, and the FIRST
    position attaining it (ties by position keep the leftmost — the
    deterministic anchor contract).  Reads with no k-mer get
    (NO_KEY, 0); callers must not bucket on NO_KEY.
    """
    n, L = codes.shape
    lengths = np.asarray(lengths, np.int64)
    best_h = np.full(n, NO_KEY, np.uint32)
    best_p = np.zeros(n, np.int64)
    if n == 0 or L < K:
        return best_h, best_p
    w = codes.astype(np.uint32)
    for t0 in range(0, L - K + 1, tile):
        t1 = min(t0 + tile, L - K + 1)
        width = t1 - t0
        km = np.zeros((n, width), np.uint32)
        for t in range(K):
            km = (km << np.uint32(2)) | w[:, t0 + t: t0 + t + width]
        h = mix32_np(km)
        # mask starts whose k-mer would cross the read end
        pos = np.arange(t0, t1, dtype=np.int64)[None, :]
        h = np.where(pos + K <= lengths[:, None], h, NO_KEY)
        p_loc = h.argmin(axis=1)
        h_loc = h[np.arange(n), p_loc]
        # strict < keeps the earlier tile's position on ties
        better = h_loc < best_h
        best_h = np.where(better, h_loc, best_h)
        best_p = np.where(better, t0 + p_loc, best_p)
    return best_h, best_p


def segment_minimizer_keys(codes: np.ndarray, lengths: np.ndarray,
                           nseg: int, tile: int = 1 << 16
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-read per-segment minimizers (container v7 multi-anchor delta).

    Segment s of a read of length ``len`` owns k-mer START positions
    ``[len*s//nseg, len*(s+1)//nseg)``.  NOTE: this is the ANCHOR
    SELECTION partition only — the decoder maps a column c to its
    shift via ``min(c*nseg//len, nseg-1)`` (seqs._cell_shifts), which
    differs at non-divisible lengths.  That is fine: anchors are
    alignment HINTS (any shift produces a valid mask); correctness
    rests solely on the encoder's mask construction and the decoder
    using the SAME column map, which both do.  Returns (hash u32 [n, nseg],
    pos i64 [n, nseg]); segments with no k-mer (short reads / tails)
    get (NO_KEY, 0) and callers fall back to the global anchor.
    EXPERIMENTS.md §16: per-segment anchors recover 1.1-1.8x on
    indel-bearing long reads where the single fixed shift is a no-op.
    """
    n, L = codes.shape
    lengths = np.asarray(lengths, np.int64)
    best_h = np.full((n, nseg), NO_KEY, np.uint32)
    best_p = np.zeros((n, nseg), np.int64)
    if n == 0 or L < K:
        return best_h, best_p
    w = codes.astype(np.uint32)
    lo = (lengths[:, None] * np.arange(nseg)[None, :]) // nseg
    hi = (lengths[:, None] * np.arange(1, nseg + 1)[None, :]) // nseg
    for t0 in range(0, L - K + 1, tile):
        t1 = min(t0 + tile, L - K + 1)
        width = t1 - t0
        km = np.zeros((n, width), np.uint32)
        for t in range(K):
            km = (km << np.uint32(2)) | w[:, t0 + t: t0 + t + width]
        h_all = mix32_np(km)
        pos = np.arange(t0, t1, dtype=np.int64)[None, :]
        h_all = np.where(pos + K <= lengths[:, None], h_all, NO_KEY)
        for s in range(nseg):
            h = np.where((pos >= lo[:, None, s]) & (pos < hi[:, None, s]),
                         h_all, NO_KEY)
            p_loc = h.argmin(axis=1)
            h_loc = h[np.arange(n), p_loc]
            better = h_loc < best_h[:, s]
            best_h[:, s] = np.where(better, h_loc, best_h[:, s])
            best_p[:, s] = np.where(better, t0 + p_loc, best_p[:, s])
    return best_h, best_p
