"""rANS table construction (port of ``scalce_tpu/models/entropy.py``).

:func:`device_normalize` turns a block's (context, symbol) histogram into
the static frequency tables on the device; the host half below is a
jax-free copy of the reference's (the reference module imports its
constants from ``ops/rans.py``, which imports jax).  The stored table
defines the codec, so both halves must give the reference's exact
tables: every f32 step runs in the reference's order and every
reduction stays in integers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from scalce_tpu_torch.ops.rans import M_TOTAL, PROB_BITS


def device_normalize(counts: torch.Tensor, n_ctx: int, n_syms: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Histogram ``[..., C*S]`` -> (freq u32 ``[..., C, S]``, cum u32
    ``[..., C, S]``) in int64; a leading axis holds several blocks'
    histograms, each row normalized on its own.

    Reserve 1 per present symbol, scale the rest by
    ``floor((c * scale) * bias)`` with ``bias`` the f32 constant
    ``1 - 1e-5`` (so the remainder d >= 0), add d to the most frequent
    symbol (first on ties); empty rows put all mass on symbol 0."""
    out_shape = counts.shape[:-1] + (n_ctx, n_syms)
    ci = counts.reshape(-1, n_syms).to(torch.int32)
    nz = ci > 0
    nnz = nz.sum(dim=1, dtype=torch.int32)
    total = ci.sum(dim=1, dtype=torch.int32)
    scale = (M_TOTAL - nnz).to(torch.float32) / \
        total.clamp(min=1).to(torch.float32)
    bias = torch.full((), 1.0 - 1e-5, dtype=torch.float32, device=ci.device)
    f_extra = torch.floor((ci.to(torch.float32) * scale[:, None]) * bias)
    f = torch.where(nz, 1 + f_extra.to(torch.int32), 0)
    d = M_TOTAL - f.sum(dim=1, dtype=torch.int32)
    sym = torch.arange(n_syms, dtype=torch.int64, device=ci.device)
    top = torch.where(ci == ci.max(dim=1, keepdim=True).values, sym,
                      n_syms).min(dim=1).values
    rows = torch.arange(ci.shape[0], device=ci.device)
    f[rows, top] += torch.where(nnz > 0, d, 0)
    empty = (nnz == 0)[:, None]
    f = torch.where(empty, torch.where(sym == 0, M_TOTAL, 0), f)
    f = f.to(torch.int64)
    return f.reshape(out_shape), (torch.cumsum(f, dim=1) - f).reshape(
        out_shape)


# ---------------------------------------------------------------------------
# host half: copies of scalce_tpu/models/entropy.py

def host_normalize(counts: np.ndarray, n_ctx: int, n_syms: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy/C mirror of :func:`device_normalize` (same tables)."""
    from scalce_tpu_torch import native as _native
    if _native.AVAILABLE and hasattr(_native, "host_normalize_tbl"):
        return _native.host_normalize_tbl(np.asarray(counts), n_ctx, n_syms)
    return host_normalize_np(counts, n_ctx, n_syms)


def host_normalize_np(counts: np.ndarray, n_ctx: int, n_syms: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    ci = np.asarray(counts).reshape(n_ctx, n_syms).astype(np.int32)
    nz = ci > 0
    nnz = nz.sum(axis=1).astype(np.int32)
    total = ci.sum(axis=1).astype(np.int32)
    c = ci.astype(np.float32)
    scale = (M_TOTAL - nnz).astype(np.float32) / \
        np.maximum(total, 1).astype(np.float32)
    bias = np.float32(1.0 - 1e-5)
    f_extra = np.floor(c * scale[:, None] * bias).astype(np.int32)
    f = np.where(nz, 1 + f_extra, 0)
    d = M_TOTAL - f.sum(axis=1).astype(np.int32)
    top = np.argmax(ci, axis=1)
    f[np.arange(n_ctx), top] += np.where(nnz > 0, d, 0)
    empty = nnz == 0
    if empty.any():
        f[empty] = 0
        f[empty, 0] = M_TOTAL
    f = f.astype(np.uint32)
    cum = np.cumsum(f, axis=1, dtype=np.uint32) - f
    return f, cum


def freq_to_cum(freq: np.ndarray) -> np.ndarray:
    """Exclusive prefix sum per context row (uint32 [C, n_syms])."""
    cum = np.zeros_like(freq)
    np.cumsum(freq[:, :-1], axis=1, out=cum[:, 1:])
    return cum


def build_decode_lut(freq: np.ndarray, cum: np.ndarray) -> np.ndarray:
    """Packed decode table uint32 ``[C * M_TOTAL]``: entry (c, slot) is
    ``sym << 24 | (freq-1) << 12 | cum``."""
    C, n_syms = freq.shape
    if n_syms > 256:
        raise ValueError("n_syms must fit 8 bits in the packed LUT")
    sym_of_slot = np.repeat(
        np.tile(np.arange(n_syms, dtype=np.uint32), C),
        freq.reshape(-1).astype(np.int64)).reshape(C, M_TOTAL)
    f = np.take_along_axis(freq, sym_of_slot.astype(np.int64), axis=1)
    cm = np.take_along_axis(cum, sym_of_slot.astype(np.int64), axis=1)
    packed = (sym_of_slot << 24) | ((f - 1) << PROB_BITS) | cm
    return packed.reshape(-1).astype(np.uint32)


def table_payload(freq: np.ndarray) -> bytes:
    """Deflated u16 image of normalized freq tables."""
    import zlib
    return zlib.compress(freq.astype("<u2").tobytes(), 6)


def payload_to_freq(payload: bytes, n_ctx: int, n_syms: int) -> np.ndarray:
    import zlib
    return np.frombuffer(zlib.decompress(payload), dtype="<u2").reshape(
        n_ctx, n_syms).astype(np.uint32)
