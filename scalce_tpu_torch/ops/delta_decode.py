"""Predecessor-delta reconstruction on the device (port of
``scalce_tpu/ops/delta_decode.py``, the ``--delta-device`` decode).

The encoder's copy mask is row-sequential: row i copies its masked
cells from row ``i - 1 - pred_k[i]`` at column ``col + shifts[i]``, so
the host walks the rows in order.  Here every copy cell points at its
source cell and every literal or padding cell at itself, and
``ceil(log2 B)`` rounds of ``p = p[p]`` collapse each chain to its
terminal cell, whose value is a literal (pointer doubling over per-cell
provenance): O(B·L·log B) gathers instead of a B-step serial walk.  The
reference's is an XLA graph, not a Pallas kernel, so this torch body is
its port; pointers are int32 (B·L < 2^31 by Config).

SAFETY: a gather with an index out of range faults the CUDA context (the
reference's XLA gathers clamp instead), so the caller must run the deep
payload validation first (``seqs.parse_fields`` with
``delta_device=True``), which raises ``ValueError`` before anything is
uploaded.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def ceil_log2(x: int) -> int:
    """Doubling rounds that collapse chains of up to ``x`` rows."""
    return max(1, (max(x, 1) - 1).bit_length())


def host_inputs(mask_bits: np.ndarray, shifts: np.ndarray,
                pred_k: np.ndarray, lits: np.ndarray, lens: np.ndarray,
                B: int, L: int) -> Dict[str, np.ndarray]:
    """A block's validated delta fields (``n`` rows) padded to its ``B``
    rows as :func:`reconstruct` takes them: mask bits u8 ``[B, L/8]``,
    shifts, predecessor offsets and lengths int32 ``[B]``, literals u8
    (at least one, so an all-copy block still has a gather source)."""
    n = len(lens)
    mb = np.zeros((B, L // 8), np.uint8)
    mb[:n] = mask_bits
    sh = np.zeros(B, np.int32)
    sh[:n] = shifts
    pk = np.zeros(B, np.int32)
    pk[:n] = pred_k
    ln = np.zeros(B, np.int32)
    ln[:n] = lens
    lp = np.zeros(max(1, lits.shape[0]), np.uint8)
    lp[:lits.shape[0]] = lits
    return {"mask_bits": mb, "shifts": sh, "pred_k": pk, "lits": lp,
            "lengths": ln}


def reconstruct(mask_bits: torch.Tensor, shifts: torch.Tensor,
                pred_k: torch.Tensor, lits: torch.Tensor,
                lengths: torch.Tensor, L: int) -> torch.Tensor:
    """:func:`host_inputs`' tensors (on any device) -> the block's codes,
    uint8 ``[B, L]`` (canonical orientation, padding cells zero)."""
    B = mask_bits.shape[0]
    dev = mask_bits.device
    col = torch.arange(L, dtype=torch.int32, device=dev)
    # LSB-first mask bits -> the [B, L] copy grid
    bits = (mask_bits[:, col >> 3] >> (col & 7).to(torch.uint8)) & 1
    valid = col[None, :] < lengths[:, None]
    is_copy = bits.bool() & valid
    # literal cells take the next literal in row-major order, the order
    # the encoder emitted them
    lit_cell = (valid & ~is_copy).reshape(-1)
    lit_idx = (torch.cumsum(lit_cell, 0, dtype=torch.int32) - 1).clamp(
        0, lits.shape[0] - 1)
    val0 = torch.where(lit_cell, torch.index_select(lits, 0, lit_idx), 0)
    row = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    self_i = row * L + col[None, :]
    src = (row - 1 - pred_k[:, None]) * L + col[None, :] + shifts[:, None]
    ptr = torch.where(is_copy, src, self_i).reshape(-1)
    # each hop strictly lowers the row, so chains are < B hops long
    for _ in range(ceil_log2(B)):
        ptr = torch.index_select(ptr, 0, ptr)
    return torch.index_select(val0, 0, ptr).reshape(B, L)


def reconstruct_device(mask_bits: np.ndarray, shifts: np.ndarray,
                       pred_k: np.ndarray, lits: np.ndarray,
                       lens: np.ndarray, B: int, L: int, out: np.ndarray,
                       device="cpu") -> None:
    """Drop-in peer of ``seqs._reconstruct`` (the reference's): the
    block's codes into ``out`` (uint8 ``[B, L]``), reconstructed on
    ``device`` (blocking)."""
    x = {k: torch.from_numpy(a).to(device) for k, a in host_inputs(
        mask_bits, shifts, pred_k, lits, lens, B, L).items()}
    out[:] = reconstruct(x["mask_bits"], x["shifts"], x["pred_k"],
                         x["lits"], x["lengths"], L).cpu().numpy()
