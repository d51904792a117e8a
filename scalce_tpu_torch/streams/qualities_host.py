# Copy of the host codec of scalce_tpu/streams/qualities.py (_pos_bucket_np
# through decode_host; only the imports differ: _host_rans_encode is
# streams/seqs.py's copy).
"""Host placement of the quality stream (``Config.qual_on_device=False``,
the CLI's default): the sorted block's qualities are entropy-coded on the
host, in the native C library, bit-identically to the device path.
``order=0`` picks the cheapest of orders 1, 2 and 3 per block by a trial
on a row sample (:func:`_auto_order`); :func:`decode_host` is the host
quality decode.  The numpy fallbacks run where the native library did
not build."""

from __future__ import annotations

import os
import zlib
from typing import Optional

import numpy as np

from scalce_tpu_torch import native as _native
from scalce_tpu_torch.models import entropy
from scalce_tpu_torch.ops import rans
from scalce_tpu_torch.streams.qualities import (N_SYMS, QUAL_OFFSET,
                                                _POS_BUCKETS, _POS_BUCKETS32,
                                                _PREV1_FULL, _PREV2_LEVELS,
                                                _PREV_LEVELS, EncodedQuals,
                                                n_contexts, pick_T)
from scalce_tpu_torch.streams.seqs import _host_rans_encode

#: SCALCE_TABLE_PROBE=zlib switches the order auto-trial's table-cost
#: probe from the analytic run-length model back to a measured zlib
#: Z_RLE compress (A/B validation only — see _table_cost_bytes)
_TABLE_PROBE_ZLIB = os.environ.get("SCALCE_TABLE_PROBE", "") == "zlib"

_NATIVE_Q = _native.AVAILABLE and hasattr(_native, "rans_encode_lanes")


def _pos_bucket_np(col: np.ndarray, order: int) -> np.ndarray:
    if order == 3:
        return np.minimum(col // 4, _POS_BUCKETS32 - 1).astype(np.uint32)
    return np.minimum(col // 16, _POS_BUCKETS - 1).astype(np.uint32)


def _ctx_from_np(prev1, prev2, pb, c0, c1, valid, order: int) -> np.ndarray:
    """NumPy mirror of :func:`_ctx_from` (integer ops only)."""
    if order == 2:
        pq = np.where(c0, np.uint32(_PREV_LEVELS),
                      np.minimum(prev1 >> 2, _PREV_LEVELS - 1)
                      ).astype(np.uint32)
        ctx = pb.astype(np.uint32) * np.uint32(_PREV_LEVELS + 1) + pq
        p2 = np.where(c0 | c1, np.uint32(_PREV2_LEVELS - 1),
                      np.minimum(prev2 >> 4, _PREV2_LEVELS - 2)
                      ).astype(np.uint32)
        ctx = ctx * np.uint32(_PREV2_LEVELS) + p2
    else:
        pq = np.where(c0, np.uint32(_PREV1_FULL),
                      np.minimum(prev1, _PREV1_FULL - 1)).astype(np.uint32)
        ctx = pb.astype(np.uint32) * np.uint32(_PREV1_FULL + 1) + pq
    return np.where(valid, ctx + np.uint32(1), np.uint32(0))


def _sym_ctx_np(qual: np.ndarray, lengths: np.ndarray, order: int):
    B, L = qual.shape
    col = np.arange(L, dtype=np.int32)[None, :]
    valid = col < lengths[:, None]
    sym = np.clip(qual.astype(np.int32) - QUAL_OFFSET, 0, N_SYMS - 1)
    sym = np.where(valid, sym, 0).astype(np.uint32)
    prev1 = np.zeros_like(sym)
    prev1[:, 1:] = sym[:, :-1]
    prev2 = np.zeros_like(sym)
    prev2[:, 2:] = sym[:, :-2]
    pb = _pos_bucket_np(col, order)
    ctx = _ctx_from_np(prev1, prev2, pb, col == 0, col == 1, valid, order)
    return sym, ctx, valid


def encode_host(qual: np.ndarray, lengths: np.ndarray, order: int = 1,
                T_target: int = 1024,
                qual_map: Optional[np.ndarray] = None,
                perm: Optional[np.ndarray] = None) -> EncodedQuals:
    """Host-side quality encode (qual already in SORTED order, or in
    ORIGINAL order with the sort permutation passed as ``perm`` — the
    native paths fuse the row gather into the coder's own row copy;
    ``lengths`` are always the SORTED-frame lengths).

    Bit-identical to :func:`encode` / the fused device passes.
    ``order=0`` auto-selects the cheapest of orders 1/2/3 per block by
    table-aware trial cost on the histograms (the adaptivity the
    reference's AC gets for free, recovered at negligible host cost).
    """
    fused = (_NATIVE_Q and hasattr(_native, "qual_hist_one")
             and hasattr(_native, "rans_encode_qual"))
    if qual_map is not None:
        qual_map = np.asarray(qual_map)
        # the lossless identity map is the common case: never worth a
        # 16MB remap gather; the fused native path takes it as a LUT
        if np.array_equal(qual_map, np.arange(256, dtype=np.uint8)):
            qual_map = None
        elif not fused:
            qual = qual_map[qual]
            qual_map = None
    if perm is not None and not fused:
        qual = qual[perm]
        perm = None
    elif perm is not None and hasattr(_native, "permute_rows_u8"):
        # materialize the sorted grid ONCE with the native scatter copy
        # (sequential reads); every later pass then streams it in order.
        # Row-indirecting the passes themselves pays an L3-latency read
        # per row PER PASS (hist + encode + sample = ~30 ms/block worse,
        # measured).  The remap LUT stays fused (clamp_sym_m).
        qual = _native.permute_rows_u8(qual, perm)
        perm = None
    B, L = qual.shape
    lengths = np.asarray(lengths)
    T = pick_T(B, L, T_target)
    if order == 0:
        order = _auto_order(qual, lengths, L, perm, qual_map)
    if _NATIVE_Q and hasattr(_native, "rans_encode_qual"):
        # grid-free path: one single-order histogram pass, then encode
        # straight off the quality grid (contexts recomputed inline,
        # reciprocal divide) — byte-identical to the grid path below
        counts = _native.qual_hist_one(qual, lengths, L, order,
                                       n_contexts(order), perm, qual_map)
        freq, cum = entropy.host_normalize(counts, n_contexts(order),
                                           N_SYMS)
        states, wcounts, words = _native.rans_encode_qual(
            qual, lengths, freq, cum, T, order, perm, qual_map)
        return EncodedQuals(freq=freq, states=states, counts=wcounts,
                            words=words, B=B, L=L, T=T, order=order)
    if _NATIVE_Q:
        sym, ctx, counts = _native.qual_sym_ctx_hist(
            qual, lengths, L, order, n_contexts(order))
        freq, cum = entropy.host_normalize(counts, n_contexts(order),
                                           N_SYMS)
        states, wcounts, words = _native.rans_encode_lanes(
            sym, ctx, freq, cum, B * L // T, T)
        return EncodedQuals(freq=freq, states=states, counts=wcounts,
                            words=words, B=B, L=L, T=T, order=order)
    sym, ctx, _ = _sym_ctx_np(qual, lengths, order)
    idx = ctx.reshape(-1).astype(np.int64) * N_SYMS + sym.reshape(-1)
    counts = np.bincount(idx, minlength=n_contexts(order) * N_SYMS)
    C = n_contexts(order)
    freq, cum = entropy.host_normalize(counts, C, N_SYMS)
    states, words, emits = _host_rans_encode(idx, freq, cum, T)
    wt = words.T                        # [N, T]
    et = emits.T
    return EncodedQuals(freq=freq, states=states,
                        counts=et.sum(axis=1).astype(np.int64),
                        words=wt[et], B=B, L=L, T=T, order=order)


def _table_cost_bytes(freq: np.ndarray) -> int:
    """Estimated stored size of a normalized table (the container
    deflates the u16 image with the file's backend; this probe feeds
    order auto-selection, i.e. OUTPUT BYTES, so it must be identical on
    every host — zlib is always present, zstandard is optional).

    Analytic Z_RLE-class model over the byte image's run structure:
    literal bytes (value changes + the <3-length run residue) cost a
    Huffman-ish ~0.66 bytes, run tokens ~0.5.  Fitted against real
    zlib Z_RLE sizes on order-1/2/3 tables from both synth profiles
    (within ~8%, and the ranking it feeds has table-cost margins far
    wider than that; measured picks unchanged on the bench and hiseq
    corpora).  Replaces a per-block zlib run (~3.5 ms at order-3
    table sizes) with two vectorized passes, and is trivially a pure
    function of the table — no zlib-version dependence at all."""
    img = np.ascontiguousarray(freq.astype("<u2")).view(np.uint8)
    if img.size == 0:
        return 8
    if _TABLE_PROBE_ZLIB:
        # A/B validation fallback (ADVICE r4): the MEASURED Z_RLE size
        # the analytic model was fitted against.  Env-gated because it
        # costs ~3.5 ms/block at order-3 table sizes and ties output
        # bytes to the zlib build; use it to re-check order picks when
        # new corpora land (CLAUDE.md note), not in production.
        co = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_RLE)
        return len(co.compress(img.tobytes()) + co.flush()) + 8
    ch = img[1:] != img[:-1]
    nruns = int(np.count_nonzero(ch)) + 1
    # run lengths via change positions; literals = first byte of each
    # run + the tail of runs shorter than 3; tokens = ceil(len/258)
    idx = np.flatnonzero(ch)
    starts = np.empty(nruns, np.int64)
    starts[0] = 0
    starts[1:] = idx + 1
    ends = np.empty(nruns, np.int64)
    ends[:-1] = idx + 1
    ends[-1] = img.size
    rl = ends - starts
    lits = int(np.minimum(rl, 2).sum())
    toks = int(np.ceil((rl[rl >= 3] - 1) / 258.0).sum())
    return int(0.66 * lits + 0.5 * toks) + 16


def _trial_cost(counts: np.ndarray, order: int, scale: float = 1.0) -> float:
    """Total coded bytes under a static table built from ``counts``:
    data bits with the ACTUAL normalized frequencies + table bytes.
    ``scale`` extrapolates sample data bits to the full block (the table
    bytes are a per-block constant and are NOT scaled)."""
    C = n_contexts(order)
    freq, _ = entropy.host_normalize(counts, C, N_SYMS)
    cs = counts.reshape(C, N_SYMS)
    nz = (cs > 0) & (freq > 0)
    bits = (cs[nz] * (rans.PROB_BITS - np.log2(freq[nz]))).sum()
    return bits * scale / 8.0 + _table_cost_bytes(freq)


#: rows used by the order auto-selection trial.  The trial only COMPARES
#: two context models; a 16k-row sample decides that as reliably as the
#: full block while the full histogram pass is paid once, for the chosen
#: order only.  Deterministic (first rows of the sorted block), so
#: output bytes stay a pure function of (block content, config).
_AUTO_SAMPLE_ROWS = 16384


def _auto_order(qual: np.ndarray, lengths: np.ndarray, L: int,
                perm: Optional[np.ndarray] = None,
                qual_map: Optional[np.ndarray] = None) -> int:
    """Per-block order auto-selection (order=0): table-aware trial cost
    for orders 1, 2 and 3 on a deterministic row sample (the first
    sample rows of the SORTED frame, whether materialized or via
    ``perm``); ties favor the smaller-numbered (smaller-table) model."""
    B = lengths.shape[0]
    ns = min(B, _AUTO_SAMPLE_ROWS)
    ls = lengths[:ns]
    if _NATIVE_Q and hasattr(_native, "qual_hist3"):
        counts = _native.qual_hist3(
            qual, ls, L, None if perm is None else perm[:ns], qual_map)
    else:
        qs = qual[:ns] if perm is None else qual[perm[:ns]]
        if qual_map is not None:
            qs = qual_map[qs]
        counts = []
        for o in (1, 2, 3):
            sym, ctx, _ = _sym_ctx_np(qs, ls, o)
            idx = ctx.reshape(-1).astype(np.int64) * N_SYMS \
                + sym.reshape(-1)
            counts.append(np.bincount(idx,
                                      minlength=n_contexts(o) * N_SYMS))
    scale = B / ns
    costs = {o: _trial_cost(c, o, scale)
             for o, c in zip((1, 2, 3), counts)}
    return min((1, 2, 3), key=lambda o: (costs[o], o))


def decode_host(enc: EncodedQuals, lengths: np.ndarray) -> np.ndarray:
    """Host-side quality decode; same output as :func:`decode`."""
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    if lengths.shape[0] != enc.B:
        raise ValueError("corrupt quality stream: lengths/B mismatch")
    N = enc.states.shape[0]
    T, B, L, order = enc.T, enc.B, enc.L, enc.order
    k = T // L
    cum = entropy.freq_to_cum(enc.freq)
    if _NATIVE_Q and hasattr(_native, "rans_decode_lanes2"):
        # two-level tables: no 12.5MB flat LUT build (that cost more
        # than the decode itself) and no DRAM-latency load per symbol
        return _native.rans_decode_lanes2(enc.states, enc.words,
                                          enc.counts, enc.freq, cum,
                                          np.asarray(lengths), B, L, T,
                                          order)
    lut = entropy.build_decode_lut(enc.freq, cum)
    if _NATIVE_Q:
        return _native.rans_decode_lanes(enc.states, enc.words,
                                         enc.counts, lut,
                                         np.asarray(lengths), B, L, T,
                                         order)
    counts = enc.counts.astype(np.int64)
    W = max(int(counts.max()), 1) if N else 1
    words = np.zeros((N, W + 1), np.uint16)
    fill = np.arange(W)[None, :] < counts[:, None]
    words[:, :W][fill] = enc.words
    lengths = np.asarray(lengths)

    col_t = np.tile(np.arange(L, dtype=np.int32), k)        # [T]
    read_of_t = np.repeat(np.arange(k, dtype=np.int64), L)  # [T]
    lanes = np.arange(N, dtype=np.int64)
    x = enc.states.astype(np.uint32).copy()
    cursor = np.zeros(N, np.int64)
    prev1 = np.zeros(N, np.uint32)
    prev2 = np.zeros(N, np.uint32)
    syms = np.zeros((T, N), np.uint32)
    lane_len = lengths[(lanes[None, :] * k + read_of_t[:, None])]  # [T, N]
    for t in range(T):
        colv = int(col_t[t])
        validt = colv < lane_len[t]
        pb = np.uint32(min(colv // 4, _POS_BUCKETS32 - 1)) if order == 3 \
            else np.uint32(min(colv // 16, _POS_BUCKETS - 1))
        ctx = _ctx_from_np(prev1, prev2, pb, colv == 0, colv == 1,
                           validt, order)
        slot = x & np.uint32(4095)
        e = lut[ctx.astype(np.int64) * 4096 + slot]
        s = e >> np.uint32(24)
        f = ((e >> np.uint32(12)) & np.uint32(4095)) + np.uint32(1)
        cm = e & np.uint32(4095)
        x = f * (x >> np.uint32(12)) + slot - cm
        need = x < np.uint32(1 << 16)
        w = words[lanes, np.minimum(cursor, W)]
        x = np.where(need, (x << np.uint32(16)) | w.astype(np.uint32), x)
        cursor += need
        syms[t] = s
        prev2 = prev1
        prev1 = s
    grid = syms.T.reshape(B, L)
    col = np.arange(L, dtype=np.int32)[None, :]
    valid = col < lengths[:, None]
    return np.where(valid, grid + QUAL_OFFSET, 0).astype(np.uint8)
