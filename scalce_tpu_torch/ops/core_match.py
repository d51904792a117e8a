"""Canonical core matcher and sort keys (port of
``scalce_tpu/ops/core_match.py``).

Each read's core is the minimum-rank k-mer over both strands (rank =
``mix32``, the implicit hash dictionary, or an explicit rank LUT of
``models/core_dict.py``); reads are then ordered by
(core, bases from the core onward).  The ranks come from kernel K1
(``ops/core_rank.py``), which builds the k-mers and the window mask
from the codes itself; everything around it is plain torch.  Only
the gather form of the reverse complement is ported: the reference's
uniform-length fast path gives identical values and existed because
TPU gathers are slow.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from scalce_tpu_torch.ops.bitops import MASK32, U32_MAX, pack_bases_u32
from scalce_tpu_torch.ops.core_rank import (core_rank_codes, revcomp_kmer,
                                            rolling_kmers, window_invalid)

#: Bucket key for reads with no valid core window (sorts after all cores).
NO_CORE = U32_MAX

__all__ = ["NO_CORE", "rolling_kmers", "window_invalid", "revcomp_kmer",
           "reverse_complement", "find_cores_canonical", "build_sort_keys"]


def _flip_index(lengths: torch.Tensor, L: int):
    """(source column of each reversed cell, clamped; cell inside read)."""
    col = torch.arange(L, dtype=torch.int64, device=lengths.device)[None, :]
    src = lengths.to(torch.int64)[:, None] - 1 - col
    return src.clamp(min=0), src >= 0


def reverse_complement(codes: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """Per-read reverse complement within each read's length (padding
    stays 0)."""
    src, inside = _flip_index(lengths, codes.shape[1])
    flipped = codes.gather(1, src)
    return torch.where(inside, 3 - flipped, 0).to(torch.uint8)


def find_cores_canonical(codes: torch.Tensor, lengths: torch.Tensor,
                         exc: torch.Tensor, k: int, seed: int,
                         rank_lut: Optional[torch.Tensor] = None):
    """Core selection over both strands; k-mers rank by ``mix32`` with
    ``seed``, or by ``rank_lut`` (int32 ``[4^k]`` u32 bits; None: the
    implicit dictionary).

    Returns ``(core_kmer u32 [B], core_pos [B], is_rc bool [B],
    codes_oriented [B, L], exc_oriented [B, L])``: the strand with the
    lower-ranked core wins (a tie goes forward); ``NO_CORE`` marks reads
    without a valid window; the RC core position is in the RC frame,
    ``len - k - p_fwd``."""
    bf, pf, br, pfw, kf, kr = core_rank_codes(codes, exc, lengths, k, seed,
                                              rank_lut)
    lengths = lengths.to(torch.int64)
    use_rc = br < bf
    best = torch.where(use_rc, br, bf)
    none = best == U32_MAX
    ck = torch.where(none, NO_CORE, torch.where(use_rc, kr, kf))
    cp = torch.where(none, 0, torch.where(use_rc, lengths - k - pfw, pf))
    use_rc = use_rc & ~none
    src, inside = _flip_index(lengths, codes.shape[1])
    rc_codes = torch.where(inside, 3 - codes.gather(1, src), 0).to(
        torch.uint8)
    exc_rc = exc.gather(1, src) & inside
    codes_o = torch.where(use_rc[:, None], rc_codes, codes)
    exc_o = torch.where(use_rc[:, None], exc_rc, exc)
    return ck, cp, use_rc, codes_o, exc_o


def build_sort_keys(codes: torch.Tensor, lengths: torch.Tensor,
                    core_kmer: torch.Tensor, core_pos: torch.Tensor,
                    n_reads: int, suffix_words: int = 2
                    ) -> Tuple[torch.Tensor, ...]:
    """Lexicographic sort keys: (core k-mer, ``suffix_words`` u32 words
    of bases from the core position onward, zeroed past the read's end,
    row index).  Padded rows (row >= n_reads) get all-ones keys."""
    B, L = codes.shape
    if L % 16:
        codes = torch.nn.functional.pad(codes, (0, 16 - L % 16))
    words = pack_bases_u32(codes)                        # [B, W]
    words_p = torch.nn.functional.pad(words, (0, suffix_words + 1))
    core_pos = core_pos.to(torch.int64)
    widx = (core_pos >> 4)[:, None] + torch.arange(
        suffix_words + 1, dtype=torch.int64, device=codes.device)[None, :]
    g = words_p.gather(1, widx)                          # [B, sw + 1]
    s = (2 * (core_pos & 15))[:, None]
    a, b = g[:, :-1], g[:, 1:]
    lo = torch.where(s == 0, 0, b >> (32 - s))
    suffix = ((a << s) & MASK32) | lo
    # keep the top 2v bits of word j, v = valid bases from core_pos + 16j
    j16 = 16 * torch.arange(suffix_words, dtype=torch.int64,
                            device=codes.device)[None, :]
    v = (lengths.to(torch.int64)[:, None] - core_pos[:, None] - j16).clamp(
        0, 16)
    keep = torch.where(v <= 0, 0, (MASK32 << (32 - 2 * v)) & MASK32)
    suffix = suffix & keep
    row = torch.arange(B, dtype=torch.int64, device=codes.device)
    pad = row >= n_reads
    keys = [torch.where(pad, U32_MAX, core_kmer)]
    for w in range(suffix_words):
        keys.append(torch.where(pad, U32_MAX, suffix[:, w]))
    keys.append(row)
    return tuple(keys)
