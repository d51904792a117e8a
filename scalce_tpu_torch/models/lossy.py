"""Lossy quality quantization (``-p <pct>``): a jax-free copy of
``scalce_tpu/models/lossy.py``.

A quality value v (Phred, byte - 33) may be replaced by its bin's
representative r only if ``|r - v| <= pct/100 * v``; the representative
is the bin's most frequent value in the sampled histogram (ties -> the
lowest value).  The map is a 256-entry byte LUT; the encoder's quality
pass A reads the permuted quality grid through it on the device
(``streams/qualities.py::sym_ctx_hist``: kernel K2 on the card,
``remap_qualities`` in the plain version).  Sequences and names are
untouched.
"""

from __future__ import annotations

import numpy as np

from scalce_tpu_torch.streams.qualities import N_SYMS, QUAL_OFFSET


def identity_map() -> np.ndarray:
    return np.arange(256, dtype=np.uint8)


def sample_histogram(qual: np.ndarray, lengths: np.ndarray,
                     n_reads: int) -> np.ndarray:
    """Histogram of quality symbols over the valid region (int64 [N_SYMS])."""
    B, L = qual.shape
    n = min(n_reads, B)
    mask = np.arange(L)[None, :] < lengths[:n, None]
    vals = qual[:n][mask]
    sym = np.clip(vals.astype(np.int64) - QUAL_OFFSET, 0, N_SYMS - 1)
    return np.bincount(sym, minlength=N_SYMS).astype(np.int64)


def build_quant_map(hist: np.ndarray, pct: int) -> np.ndarray:
    """Greedy deterministic bin merge -> byte LUT (uint8 [256]).

    Walks the symbol alphabet ascending, growing a bin while EVERY
    member m stays within ``pct/100 * m`` of the bin's (recomputed)
    most-frequent representative.  Bytes outside the symbol range map
    to themselves.
    """
    if pct <= 0:
        return identity_map()
    budget = pct / 100.0
    rep_of = np.arange(N_SYMS, dtype=np.int64)

    def bin_ok(members: np.ndarray) -> int:
        """Representative if the bin is valid, else -1."""
        h = hist[members]
        r = members[np.argmax(h)]          # argmax -> lowest index on ties
        if np.all(np.abs(members - r) <= budget * np.maximum(members, 0)):
            return int(r)
        return -1

    start = 0
    while start < N_SYMS:
        end = start                        # bin is [start, end] inclusive
        rep = start
        while end + 1 < N_SYMS:
            cand = np.arange(start, end + 2)
            r = bin_ok(cand)
            if r < 0:
                break
            end += 1
            rep = r
        rep_of[start:end + 1] = rep
        start = end + 1

    lut = identity_map()
    sym_range = np.arange(N_SYMS)
    lut[sym_range + QUAL_OFFSET] = (rep_of + QUAL_OFFSET).astype(np.uint8)
    return lut


def max_abs_error(lut: np.ndarray) -> int:
    sym = np.arange(N_SYMS)
    mapped = lut[sym + QUAL_OFFSET].astype(np.int64) - QUAL_OFFSET
    return int(np.abs(mapped - sym).max())
