"""K7: the aligned-predecessor delta of a sorted block.

Port of ``scalce_tpu/pipeline/encode.py::_delta_seq``, which the
reference leaves to XLA inside its stage-B jit (no ``pallas_call``).
The CUDA kernel is ``csrc/delta_seq.cu``; :func:`delta_seq` takes stage
A's outputs as they are (uint8 ``[B, L]`` codes, int64 ``[B]`` lengths,
core ranks and core positions) and returns the delta products.  Each
read matches against the best of its :data:`DELTA_K` predecessors in the
same core bucket (most matching bases; a tie goes to the nearest).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from scalce_tpu_torch.ops import _cuda, core_match
from scalce_tpu_torch.ops.bitops import MASK32, pack_bases_u32, popcount32

SOURCE = "scalce_tpu_torch/csrc/delta_seq.cu"
REPLACES = "scalce_tpu/pipeline/encode.py:213"

DELTA_K = 4           # candidate predecessors per read (2-bit selector)
_EVEN = 0x55555555

MAX_SMEM = 232_448    # shared bytes a CTA may take on the H100
MAX_ROWS = 128        # rows per tile
_SMEM_TARGET = 65_536  # a tile's shared bytes where rows allow (3 CTAs/SM)
_MIN_ROWS = 16        # ... but no fewer rows, while they fit


class TilePlan(NamedTuple):
    """How ``csrc/delta_seq.cu`` cuts a block of W words a row: ``rows``
    per CTA (both launches), ``group`` lanes per row, and each launch's
    shared bytes (the match launch's tile of ``rows + DELTA_K`` rows: their
    packed words, int64 core, int32 len and cp; the place launch's output
    words)."""
    rows: int
    group: int
    match_smem: int
    place_smem: int


def tile_plan(W: int) -> TilePlan:
    """The tile plan for W = L/16 words a row (the kernel computes the
    same shared bytes from ``rows``)."""
    group = min(32, 1 << (W - 1).bit_length())
    per_row = 4 * W + 16
    rows = min(MAX_ROWS, max(_MIN_ROWS, _SMEM_TARGET // per_row - DELTA_K),
               MAX_SMEM // per_row - DELTA_K)
    if rows < 1:
        raise ValueError(f"W = {W}: a row of {per_row} shared bytes leaves "
                         "no tile in a CTA's shared memory")
    return TilePlan(rows, group, (rows + DELTA_K) * per_row,
                    4 * (rows * W + 1))


def _shifted_eq(P: torch.Tensor, prev_words: torch.Tensor,
                len_s: torch.Tensor, prev_len: torch.Tensor,
                shift: torch.Tensor, row_ok: torch.Tensor) -> torch.Tensor:
    """Packed equality mask ``[B, W]``: the low bit of 2-bit lane c of
    the row is set where ``prev[c + shift] == codes[c]`` and c lies in
    ``[max(-shift, 0), min(len, prev_len - shift))`` — the bases the
    predecessor can supply.  The shifted predecessor window is one
    word-level gather plus a funnel shift."""
    B, W = P.shape
    dev = P.device
    zeros = torch.zeros((B, W), dtype=torch.int64, device=dev)
    padded = torch.cat([zeros, prev_words, zeros, zeros[:, :1]], dim=1)
    widx = ((shift >> 4) + W)[:, None] + torch.arange(
        W + 1, dtype=torch.int64, device=dev)[None, :]
    G = padded.gather(1, widx)                       # [B, W + 1]
    bs = (2 * (shift & 15))[:, None]
    g0, g1 = G[:, :W], G[:, 1:]
    shifted = torch.where(bs == 0, g0,
                          ((g0 << bs) & MASK32) | (g1 >> (32 - bs)))
    x = shifted ^ P
    eq = ~(x | (x >> 1)) & _EVEN
    base0 = 16 * torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    lo = torch.clamp(-shift, min=0)
    hi = torch.minimum(len_s, prev_len - shift)
    n1 = torch.clamp(hi[:, None] - base0, 0, 16)
    n0 = torch.clamp(lo[:, None] - base0, 0, 16)
    ones1 = torch.where(n1 == 0, 0, (MASK32 << (32 - 2 * n1)) & MASK32)
    ones0 = torch.where(n0 == 0, 0, (MASK32 << (32 - 2 * n0)) & MASK32)
    return eq & ones1 & ~ones0 & torch.where(row_ok, _EVEN, 0)[:, None]


def delta_seq_plain(codes_s: torch.Tensor, len_s: torch.Tensor,
                    ck_s: torch.Tensor, cp_s: torch.Tensor,
                    n_reads: int) -> Dict[str, torch.Tensor]:
    """Plain torch version of :func:`delta_seq` (the literal words as
    u32 values in int64)."""
    B, L = codes_s.shape
    dev = codes_s.device
    row = torch.arange(B, dtype=torch.int64, device=dev)
    col = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    len_s = len_s.to(torch.int64)
    cp_s = cp_s.to(torch.int64)
    P = pack_bases_u32(codes_s)                      # [B, W]

    best_count = torch.full((B,), -1, dtype=torch.int64, device=dev)
    best_shift = torch.zeros(B, dtype=torch.int64, device=dev)
    best_k = torch.zeros(B, dtype=torch.int64, device=dev)
    for k in range(1, DELTA_K + 1):
        src = (row - k).clamp(min=0)
        same = ((ck_s == ck_s[src]) & (ck_s != core_match.NO_CORE)
                & (row >= k) & (row < n_reads))
        shift = torch.where(same, cp_s[src] - cp_s, 0)
        eqm = _shifted_eq(P, P[src], len_s, len_s[src], shift, same)
        cnt = torch.where(same, popcount32(eqm).sum(dim=1), -1)
        better = cnt > best_count
        best_count = torch.where(better, cnt, best_count)
        best_shift = torch.where(better, shift, best_shift)
        best_k = torch.where(better, k - 1, best_k)

    # rebuild the winning mask once from the winning predecessor row
    src = (row - 1 - best_k).clamp(min=0)
    eqm = _shifted_eq(P, P[src], len_s, len_s[src], best_shift,
                      best_count >= 0)
    bitpos = 2 * (15 - col % 16)
    match = ((eqm[:, :, None].expand(-1, -1, 16).reshape(B, -1) >> bitpos)
             & 1).bool()

    # literals: valid non-copied bases, compacted row-major by a cumsum
    # scatter (non-literals land in a discarded trailing slot)
    lit_mask = (~match & (col < len_s[:, None])).reshape(-1)
    n_lits = lit_mask.sum()
    dst = torch.where(lit_mask, torch.cumsum(lit_mask, dim=0) - 1, B * L)
    flat = torch.zeros(B * L + 1, dtype=torch.uint8, device=dev)
    flat.scatter_(0, dst, codes_s.reshape(-1))
    lit_packed = pack_bases_u32(flat[:B * L])

    bit_w = 1 << torch.arange(8, dtype=torch.int64, device=dev)
    mask_bits = (match.reshape(B, L // 8, 8).to(torch.int64) * bit_w).sum(
        dim=2).to(torch.uint8)
    return {"mask_bits": mask_bits, "shifts": best_shift.to(torch.int16),
            "pred_k": best_k.to(torch.uint8), "lit_packed": lit_packed,
            "n_lits": n_lits}


def delta_seq(codes_s: torch.Tensor, len_s: torch.Tensor,
              ck_s: torch.Tensor, cp_s: torch.Tensor,
              n_reads: int) -> Dict[str, torch.Tensor]:
    """Aligned-predecessor delta over the sorted block (codes in [0, 4),
    L a multiple of 16).  Returns ``mask_bits`` u8 ``[B, L/8]`` (copy
    bits, LSB-first), ``shifts`` i16 ``[B]``, ``pred_k`` u8 ``[B]``,
    ``lit_packed`` ``[B*L/16]`` (the non-copied bases, row-major, 2-bit
    big-endian, zero-padded) and ``n_lits`` (int64, 0-d).  CPU tensors
    take the plain version (``lit_packed`` u32 values in int64); CUDA
    tensors launch ``csrc/delta_seq.cu`` (``lit_packed`` as int32 holding
    the u32 bits, what the download takes)."""
    if codes_s.device.type == "cpu":
        return delta_seq_plain(codes_s, len_s, ck_s, cp_s, n_reads)
    launch, out = prepare(codes_s, len_s, ck_s, cp_s, n_reads)
    launch()
    delta_seq.launches += 1
    return out


delta_seq.launches = 0


def prepare(codes_s: torch.Tensor, len_s: torch.Tensor, ck_s: torch.Tensor,
            cp_s: torch.Tensor, n_reads: int):
    """The CUDA path of :func:`delta_seq` up to the launch.  Returns
    ``(launch, out)``: each ``launch()`` runs the match kernel, the scan
    of the rows' literal counts, and the literal-placement kernel into
    ``out``'s tensors."""
    B, L = codes_s.shape
    dev = codes_s.device
    _cuda.require(codes_s, "codes_s", torch.uint8, device=dev)
    for name, t in (("len_s", len_s), ("ck_s", ck_s), ("cp_s", cp_s)):
        _cuda.require(t, name, torch.int64, (B,), dev)
    if L % 16 or codes_s.data_ptr() % 16:
        raise ValueError(f"codes_s: rows of {L} bytes at "
                         f"{codes_s.data_ptr():#x}; the kernel reads rows "
                         "of a multiple of 16 bytes, 16-byte aligned")
    W = L // 16
    plan = tile_plan(W)
    shifts = torch.empty(B, dtype=torch.int16, device=dev)
    pred_k = torch.empty(B, dtype=torch.uint8, device=dev)
    lit_count = torch.empty(B, dtype=torch.int64, device=dev)
    lit_end = torch.empty(B, dtype=torch.int64, device=dev)
    mask_bits = torch.empty((B, 2 * W), dtype=torch.uint8, device=dev)
    own = torch.empty((B, W), dtype=torch.int32, device=dev)
    lit_packed = torch.empty(B * W, dtype=torch.int32, device=dev)
    tiles = (B, W, plan.rows, plan.group)

    def launch():
        _cuda.launch("scalce_delta_match", dev, codes_s.data_ptr(),
                     len_s.data_ptr(), ck_s.data_ptr(), cp_s.data_ptr(),
                     *tiles, n_reads, core_match.NO_CORE, shifts.data_ptr(),
                     pred_k.data_ptr(), mask_bits.data_ptr(),
                     lit_count.data_ptr(), own.data_ptr(),
                     lit_packed.data_ptr())
        torch.cumsum(lit_count, 0, out=lit_end)
        _cuda.launch("scalce_delta_place", dev, own.data_ptr(),
                     mask_bits.data_ptr(), len_s.data_ptr(),
                     lit_count.data_ptr(), lit_end.data_ptr(), *tiles,
                     lit_packed.data_ptr())
    return launch, {"mask_bits": mask_bits, "shifts": shifts,
                    "pred_k": pred_k, "lit_packed": lit_packed,
                    "n_lits": lit_end[-1]}
