"""Sequence stream payload (port of ``scalce_tpu/streams/seqs.py``).

The side-stream rANS coders, :func:`payload` and :func:`parse` are the
reference's with its ``models/entropy.py`` (which reaches jax) replaced
by the port's entropy module; the helpers below are verbatim copies of
the reference's, on the port's copy of the native C library.  Output
bytes are the reference's (pinned by tests/test_torch_quality.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from scalce_tpu_torch import container
from scalce_tpu_torch.models import entropy

# ---------------------------------------------------------------------------
# helpers: copies of scalce_tpu/streams/seqs.py's (only the imports differ)

try:
    from scalce_tpu_torch import native as _native
    _NATIVE = _native.AVAILABLE and hasattr(_native, "reconstruct_delta")
except Exception:  # pragma: no cover
    _native = None
    _NATIVE = False


def unpack2bit_np(words: np.ndarray, n: int) -> np.ndarray:
    """uint32 words -> first n 2-bit codes (big-endian in-word)."""
    if _NATIVE and hasattr(_native, "unpack2bit"):
        return _native.unpack2bit(np.ascontiguousarray(words))[:n]
    shifts = (2 * np.arange(15, -1, -1)).astype(np.uint32)
    codes = ((words[:, None] >> shifts) & 3).astype(np.uint8).reshape(-1)
    return codes[:n]


#: literal rANS lane span (fixed so decode derives the lane count)
_T_LIT = 4096
_LIT_CTX = 17       # 0 = tail padding; 1 + prev1*4 + prev2 otherwise


def _lit_ctx_grid(flat: np.ndarray, n_lits: int, N: int) -> np.ndarray:
    g = flat.reshape(N, _T_LIT)
    p1 = np.zeros_like(g)
    p1[:, 1:] = g[:, :-1]
    p2 = np.zeros_like(g)
    p2[:, 2:] = g[:, :-2]
    valid = np.arange(N * _T_LIT).reshape(N, _T_LIT) < n_lits
    return np.where(valid,
                    1 + p1.astype(np.int32) * 4 + p2.astype(np.int32),
                    0).astype(np.uint16).reshape(-1)


#: mask-byte rANS lane span / context count (ctx = 1 + prev byte,
#: ctx 0 = tail padding)
_T_MASK = 4096
_MASK_CTX = 257


def _mask_ctx_grid(flat: np.ndarray, nb: int, N: int) -> np.ndarray:
    g = flat.reshape(N, _T_MASK)
    p1 = np.zeros_like(g)
    p1[:, 1:] = g[:, :-1]
    valid = np.arange(N * _T_MASK).reshape(N, _T_MASK) < nb
    return np.where(valid, 1 + p1.astype(np.int32), 0).astype(
        np.int64).reshape(-1)


def _perm_bits(n: int) -> int:
    """Fixed width for permutation entries: ceil(log2(n)), min 1."""
    return max(1, int(n - 1).bit_length()) if n > 1 else 1


def _bitpack_u32(vals: np.ndarray, k: int) -> np.ndarray:
    if _NATIVE and hasattr(_native, "bitpack_u32"):
        return _native.bitpack_u32(vals, k)
    n = vals.shape[0]
    shifts = np.arange(k, dtype=np.uint32)
    bits = ((vals.astype(np.uint32)[:, None] >> shifts[None, :])
            & 1).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little")


def _bitunpack_u32(packed: np.ndarray, n: int, k: int) -> np.ndarray:
    if _NATIVE and hasattr(_native, "bitunpack_u32"):
        return _native.bitunpack_u32(packed, n, k)
    shifts = np.arange(k, dtype=np.uint32)
    ub = np.unpackbits(packed, bitorder="little")[: n * k].reshape(n, k)
    return (ub.astype(np.uint32) << shifts[None, :]).sum(
        axis=1, dtype=np.uint32)


def _pack2bit_np(codes: np.ndarray) -> np.ndarray:
    """Host 2-bit pack (pack_bases_u32 layout); codes length % 16 == 0."""
    if _NATIVE and hasattr(_native, "pack2bit"):
        return _native.pack2bit(codes)
    grouped = codes.reshape(-1, 16).astype(np.uint32)
    shifts = (2 * np.arange(15, -1, -1)).astype(np.uint32)
    return (grouped << shifts).sum(axis=1, dtype=np.uint32)


def _zigzag16(x: np.ndarray) -> np.ndarray:
    xi = x.astype(np.int32)
    return (((xi << 1) ^ (xi >> 15)) & 0xFFFF).astype(np.uint16)


def _unzigzag16(z: np.ndarray) -> np.ndarray:
    zi = z.astype(np.uint16).astype(np.int32)
    return ((zi >> 1) ^ -(zi & 1)).astype(np.int16)


def _cell_shifts(shifts: np.ndarray, lens: np.ndarray,
                 L: int) -> np.ndarray:
    """Per-cell copy shift matrix (broadcastable [n, 1] or full [n, L]).

    v4-v6: one shift per read.  v7 long-read multi-anchor: ``shifts``
    is [n, nseg] and column c of a length-``len`` read uses segment
    ``min(c*nseg//len, nseg-1)``.  Correctness rests on the ENCODER'S
    MASK CONSTRUCTION (encode.py _assemble_long ``seg_of``) using this
    exact column map — which it does; the anchor-selection partition in
    ``segment_minimizer_keys`` intentionally differs at non-divisible
    lengths and is only an alignment hint (see its docstring)."""
    if shifts.ndim == 1:
        return shifts[:, None]
    n, nseg = shifts.shape
    col = np.arange(L, dtype=np.int64)[None, :]
    seg = np.minimum((col * nseg) // np.maximum(lens[:, None], 1),
                     nseg - 1)
    return np.take_along_axis(shifts, seg, axis=1)


def _validate(a, n: int, B: int, L: int, n_lits: int,
              deep: bool = True) -> None:
    """Bounds-check container-supplied fields BEFORE they reach the
    reconstruction loop — a corrupt/truncated/malicious block must
    raise, not read/write out of bounds.

    ``deep=False`` (native path) skips the O(n*L) matrix checks — the
    checked native loop enforces copy bounds per element and the caller
    verifies literal-count equality; only the cheap O(n) field checks
    run here."""
    if not (0 <= n <= B):
        raise ValueError("corrupt .scalcer block: n_reads out of range")
    lens = a["lengths"].astype(np.int64)
    shifts = a["shifts"].astype(np.int64)
    pred_k = a["pred_k"].astype(np.int64)
    if lens.shape[0] != n or shifts.shape[0] != n or pred_k.shape[0] != n:
        raise ValueError("corrupt .scalcer block: field length mismatch")
    if shifts.ndim not in (1, 2):
        raise ValueError("corrupt .scalcer block: shifts rank")
    # mask_bits must be exactly [n, L/8]: a smaller array would broadcast
    # through the checks below but stride out of bounds in the native
    # reconstruction loop
    if a["mask_bits"].ndim != 2 or a["mask_bits"].shape != (n, L // 8):
        raise ValueError("corrupt .scalcer block: mask_bits shape mismatch")
    # exceptions: positions must index inside the block's base grid and
    # pair 1:1 with replacement bytes (u64 >= 2^63 would go negative in
    # int64 downstream and index from the end)
    exc_pos = a["exc_pos"]
    if exc_pos.shape[0] != a["exc_byte"].shape[0]:
        raise ValueError("corrupt .scalcer block: exception arrays disagree")
    if exc_pos.size and int(exc_pos.max()) >= n * L:
        raise ValueError("corrupt .scalcer block: exception position out "
                         "of range")
    if lens.size and (lens.max() > L or lens.min() < 0):
        raise ValueError("corrupt .scalcer block: read length > max")
    if n and (np.abs(shifts) >= L).any():
        raise ValueError("corrupt .scalcer block: shift out of range")
    if deep:
        bits = np.unpackbits(a["mask_bits"], axis=1,
                             bitorder="little")[:, :L]
        rows = np.arange(n)
        # a row that copies anything must have its predecessor INSIDE
        # the block: source row = i - 1 - pred_k >= 0  <=>  pred_k < i
        has_mask = bits.any(axis=1) if n else np.zeros(0, bool)
        if n and ((pred_k < 0) | ((pred_k >= rows) & has_mask)).any():
            raise ValueError("corrupt .scalcer block: predecessor before "
                             "block start")
        col = np.arange(L)[None, :]
        if n and (bits & (col >= lens[:, None])).any():
            raise ValueError("corrupt .scalcer block: mask past read "
                             "length")
        # masked source columns must be in-bounds
        if n:
            src = col + _cell_shifts(shifts, lens, L)
            if (bits & ((src < 0) | (src >= L))).any():
                raise ValueError("corrupt .scalcer block: copy source out "
                                 "of bounds")
        need = int(lens.sum() - bits.sum())
        if n_lits != need or n_lits < 0:
            raise ValueError("corrupt .scalcer block: literal count "
                             "mismatch")
    else:
        # native path: per-element copy bounds + exact literal count are
        # enforced inside reconstruct_delta_checked; only the allocation
        # bound is needed before decoding the literal stream
        if n_lits < 0 or n_lits > int(lens.sum()):
            raise ValueError("corrupt .scalcer block: literal count "
                             "mismatch")
        # the checked loop IGNORES mask bits past each row's length, so
        # without this the native path would ACCEPT blocks the numpy
        # fallback rejects — acceptance must not depend on whether a C
        # compiler was available (packed-byte check, no O(n*L) unpack)
        if n:
            mb = a["mask_bits"]
            if _NATIVE and hasattr(_native, "mask_tail_check"):
                bad = _native.mask_tail_check(mb, lens)
            else:
                byte_idx = np.arange(L // 8, dtype=np.int64)[None, :]
                bad = bool(mb[byte_idx >= (lens[:, None] + 7) // 8].any())
                rem = (lens % 8).astype(np.int64)
                part = rem != 0
                if not bad and part.any():
                    rows = np.flatnonzero(part)
                    tail = mb[rows, lens[rows] // 8]
                    keep = ((0xFF << rem[rows]) & 0xFF).astype(np.uint8)
                    bad = bool((tail & keep).any())
            if bad:
                raise ValueError("corrupt .scalcer block: mask past read "
                                 "length")
    lit_mode = int(a["lit_mode"][0]) if "lit_mode" in a else 0
    if lit_mode == 0:
        if a["lit_packed"].shape[0] < (n_lits + 15) // 16:
            raise ValueError("corrupt .scalcer block: literal stream short")
    else:
        for f in ("lit_freq", "lit_states", "lit_counts", "lit_words"):
            if f not in a:
                raise ValueError(f"corrupt .scalcer block: missing {f}")
        # deeper lit_* consistency checks live in _decode_lits_rans
    perm = a["perm"].astype(np.int64)
    if perm.shape[0] != n or (n and (perm.min() < 0 or perm.max() >= n)):
        raise ValueError("corrupt .scalcer block: bad permutation")
    if a["rc_bits"].shape[0] < (n + 7) // 8:
        raise ValueError("corrupt .scalcer block: rc bits short")


def _reconstruct(mask_bits: np.ndarray, shifts: np.ndarray,
                 pred_k: np.ndarray, lits: np.ndarray, lens: np.ndarray,
                 L: int, out: np.ndarray) -> None:
    n = len(lens)
    if n == 0:
        return
    # the checked C loop's shift field is i16; v6 long-read blocks pass
    # wide (i64) shifts and take the numpy fallback, whose bounds come
    # from the deep _validate pass the caller already ran
    if _NATIVE and shifts.dtype == np.int16:
        got = _native.reconstruct_delta_checked(
            np.ascontiguousarray(mask_bits), np.ascontiguousarray(shifts),
            np.ascontiguousarray(pred_k), np.ascontiguousarray(lits),
            lens, L, out)
        if got != lits.shape[0]:
            raise ValueError("corrupt .scalcer block: out-of-bounds copy "
                             "or literal count mismatch")
        return
    # NumPy fallback: vectorized within each row, sequential across rows
    bits = np.unpackbits(mask_bits, axis=1, bitorder="little")[:, :L]
    nseg = shifts.shape[1] if shifts.ndim == 2 else 1
    lit_off = 0
    for i in range(n):
        l = int(lens[i])
        m = bits[i, :l].astype(bool)
        k = int(m.sum())
        row = out[i]
        if k:
            dst = np.flatnonzero(m)
            if nseg > 1:
                seg = np.minimum(dst * nseg // max(l, 1), nseg - 1)
                src_cols = dst + shifts[i][seg]
            else:
                src_cols = dst + int(shifts[i])
            row[dst] = out[i - 1 - int(pred_k[i]), src_cols]
        nm = np.flatnonzero(~m)
        row[nm] = lits[lit_off:lit_off + l - k]
        lit_off += l - k


# ---------------------------------------------------------------------------
# the coders, payload and parse


def _host_rans_encode(idx: np.ndarray, freq: np.ndarray, cum: np.ndarray,
                      T: int):
    """NumPy u32 rANS encoder over flat ``ctx*n_syms + sym`` indices
    (copy of ``scalce_tpu/streams/qualities.py::_host_rans_encode``, the
    coders' fallback when the native library is missing)."""
    S = idx.shape[0]
    N = S // T
    f_all = freq.reshape(-1)[idx].reshape(N, T).astype(np.uint32)
    c_all = cum.reshape(-1)[idx].reshape(N, T).astype(np.uint32)
    x = np.full(N, 1 << 16, np.uint32)
    words = np.zeros((T, N), np.uint16)
    emits = np.zeros((T, N), bool)
    for t in range(T - 1, -1, -1):
        f = f_all[:, t]
        cm = c_all[:, t]
        emit = (x >> 20) >= f
        words[t] = (x & 0xFFFF).astype(np.uint16)
        x = np.where(emit, x >> 16, x)
        q = x // f
        r = x - q * f
        x = (q << np.uint32(12)) + r + cm
        emits[t] = emit
    return x, words, emits


def _decode_lanes_np(x: np.ndarray, wcounts: np.ndarray, words: np.ndarray,
                     lut: np.ndarray, n: int, T: int, ctx_fn) -> np.ndarray:
    """NumPy lane decoder shared by the literal and mask coders'
    fallbacks: ``ctx_fn(t, validt, prev1, prev2)`` gives each lane's
    context at step t."""
    N = x.shape[0]
    x = x.astype(np.uint32).copy()
    W = int(wcounts.max()) if N else 0
    wpad = np.zeros((N, W + 1), np.uint16)
    fill = np.arange(W)[None, :] < wcounts[:, None]
    wpad[:, :W][fill] = words
    cursor = np.zeros(N, np.int64)
    prev1 = np.zeros(N, np.uint32)
    prev2 = np.zeros(N, np.uint32)
    out = np.zeros(N * T, np.uint8)
    lanes = np.arange(N)
    base = lanes * T
    for t in range(T):
        validt = base + t < n
        c = ctx_fn(t, validt, prev1, prev2)
        slot = x & np.uint32(4095)
        e = lut[c * 4096 + slot]
        s = e >> np.uint32(24)
        f = ((e >> np.uint32(12)) & np.uint32(4095)) + np.uint32(1)
        cm = e & np.uint32(4095)
        x = f * (x >> np.uint32(12)) + slot - cm
        need = x < np.uint32(1 << 16)
        w = wpad[lanes, np.minimum(cursor, W)]
        x = np.where(need, (x << np.uint32(16)) | w.astype(np.uint32), x)
        cursor += need
        out[base + t] = np.where(validt, s, 0)
        prev2 = prev1
        prev1 = s.astype(np.uint32)
    return out[:n]


def _encode_lits_rans(lits: np.ndarray, n_lits: int):
    """Order-2 base-context rANS over the literal stream, or None when
    raw 2-bit packing is estimated smaller (decided from the histogram;
    a pure function of block content)."""
    if n_lits == 0:
        return None
    N = (n_lits + _T_LIT - 1) // _T_LIT
    native_path = _NATIVE and hasattr(_native, "rans_encode_lits")
    if native_path:
        counts = _native.lit_hist(lits[:n_lits], n_lits, N, _T_LIT)
    else:
        flat = np.zeros(N * _T_LIT, np.uint8)
        flat[:n_lits] = lits[:n_lits]
        ctx = _lit_ctx_grid(flat, n_lits, N)
        idx = ctx.astype(np.int64) * 4 + flat
        counts = np.bincount(idx, minlength=_LIT_CTX * 4)
    freq, cum = entropy.host_normalize(counts, _LIT_CTX, 4)
    cs = counts.reshape(_LIT_CTX, 4)
    fr = freq.reshape(_LIT_CTX, 4)
    nz = (cs > 0) & (fr > 0)
    bits = float((cs[nz] * (12.0 - np.log2(fr[nz]))).sum())
    est = bits / 8.0 + N * 6 + freq.astype(np.uint16).nbytes
    if est >= ((n_lits + 15) // 16) * 4:
        return None
    if native_path:
        states, wcounts, words = _native.rans_encode_lits(
            lits[:n_lits], n_lits, N, _T_LIT, freq, cum)
    elif _NATIVE and hasattr(_native, "rans_encode_lanes"):
        states, wcounts, words = _native.rans_encode_lanes(
            flat, ctx, freq, cum, N, _T_LIT, 4)
    else:
        states, wgrid, emits = _host_rans_encode(idx, freq, cum, _T_LIT)
        wt, et = wgrid.T, emits.T
        wcounts = et.sum(axis=1).astype(np.int64)
        words = wt[et]
    return (freq.astype(np.uint16), states, wcounts.astype(np.uint16),
            words)


def _decode_lits_rans(a: Dict[str, np.ndarray], n_lits: int) -> np.ndarray:
    freq = a["lit_freq"].astype(np.uint32)
    if freq.shape != (_LIT_CTX, 4) or (freq.sum(axis=1) != 4096).any():
        raise ValueError("corrupt .scalcer block: bad literal freq table")
    N = (n_lits + _T_LIT - 1) // _T_LIT
    states = a["lit_states"]
    wcounts = a["lit_counts"].astype(np.int64)
    words = a["lit_words"]
    if states.shape[0] != N or wcounts.shape[0] != N:
        raise ValueError("corrupt .scalcer block: literal lane mismatch")
    if int(wcounts.sum()) != words.shape[0] or (wcounts > _T_LIT).any():
        raise ValueError("corrupt .scalcer block: literal word mismatch")
    lut = entropy.build_decode_lut(freq, entropy.freq_to_cum(freq))
    if _NATIVE and hasattr(_native, "rans_decode_lits"):
        return _native.rans_decode_lits(states, words, wcounts, lut,
                                        n_lits, N, _T_LIT)
    return _decode_lanes_np(
        states, wcounts, words, lut, n_lits, _T_LIT,
        lambda t, v, p1, p2: np.where(v, 1 + p1 * 4 + p2, 0).astype(
            np.int64))


def _encode_mask_rans(mb: np.ndarray, backend: str,
                      sample_cap: int = 1 << 18):
    """Order-1 byte-context rANS over copy-mask (or side-stream) bytes,
    or None when the generic backend wins (compared against the backend
    size of a prefix sample; a pure function of content and config)."""
    from scalce_tpu_torch.io.backend import compress_bytes
    nb = mb.shape[0]
    if nb == 0:
        return None
    N = (nb + _T_MASK - 1) // _T_MASK
    native_path = _NATIVE and hasattr(_native, "rans_encode_mask")
    if native_path:
        counts = _native.mask_hist(mb, nb, N, _T_MASK)
    else:
        flat = np.zeros(N * _T_MASK, np.uint8)
        flat[:nb] = mb
        ctx = _mask_ctx_grid(flat, nb, N)
        idx = ctx * 256 + flat
        counts = np.bincount(idx, minlength=_MASK_CTX * 256)
    freq, cum = entropy.host_normalize(counts, _MASK_CTX, 256)
    cs = counts.reshape(_MASK_CTX, 256)
    fr = freq.reshape(_MASK_CTX, 256)
    nz = (cs > 0) & (fr > 0)
    bits = float((cs[nz] * (12.0 - np.log2(fr[nz]))).sum())
    import zlib
    table = len(zlib.compress(fr.astype("<u2").tobytes(), 1))
    est = bits / 8.0 + N * 6 + table
    sample = mb[:sample_cap]
    scale = nb / sample.shape[0]
    alt = min(int(len(compress_bytes(sample.tobytes(), backend, 3))
                  * scale), nb)
    if est >= alt:
        return None
    if native_path:
        states, wcounts, words = _native.rans_encode_mask(
            mb, nb, N, _T_MASK, freq, cum)
    else:
        states, wgrid, emits = _host_rans_encode(idx, freq, cum, _T_MASK)
        wt, et = wgrid.T, emits.T
        wcounts = et.sum(axis=1).astype(np.int64)
        words = wt[et]
    return (freq.astype(np.uint16), states, wcounts.astype(np.uint16),
            words)


def _decode_mask_rans(a: Dict[str, np.ndarray], nb: int,
                      prefix: str = "mask") -> np.ndarray:
    """Decode one order-1 byte-context rANS stream (``prefix`` selects
    the field family: mask, shv, pkv)."""
    freq = a[f"{prefix}_freq"].astype(np.uint32)
    if freq.size != _MASK_CTX * 256:
        raise ValueError(f"corrupt .scalcer block: bad {prefix} freq table")
    N = (nb + _T_MASK - 1) // _T_MASK
    states = a[f"{prefix}_states"]
    wcounts = a[f"{prefix}_counts"].astype(np.int64)
    words = a[f"{prefix}_words"]
    if states.ndim != 1 or states.shape[0] != N or wcounts.shape[0] != N:
        raise ValueError(f"corrupt .scalcer block: {prefix} lane mismatch")
    if int(wcounts.sum()) != words.shape[0] or (wcounts > _T_MASK).any():
        raise ValueError(f"corrupt .scalcer block: {prefix} word mismatch")
    cum = entropy.freq_to_cum(freq.reshape(_MASK_CTX, 256))
    if _NATIVE and hasattr(_native, "rans_decode_mask"):
        lut = _native.build_flat_lut(freq, cum, _MASK_CTX, 256)
        return _native.rans_decode_mask(states, words, wcounts, lut,
                                        nb, N, _T_MASK)
    lut = entropy.build_decode_lut(freq.reshape(_MASK_CTX, 256),
                                   cum.reshape(_MASK_CTX, 256))
    return _decode_lanes_np(
        states, wcounts, words, lut, nb, _T_MASK,
        lambda t, v, p1, p2: np.where(v, 1 + (p1 if t >= 1 else 0),
                                      0).astype(np.int64))


def _try_side_rans(arrays: Dict[str, np.ndarray], prefix: str,
                   stream: np.ndarray, backend: str) -> bool:
    """Per-block trial of the order-1 byte rANS for a delta side-stream;
    on a win its four coder fields replace the raw array."""
    enc = _encode_mask_rans(np.ascontiguousarray(stream), backend)
    if enc is None:
        arrays[f"{prefix}_mode"] = np.asarray([0], np.uint8)
        return False
    freq, states, wcounts, words = enc
    arrays[f"{prefix}_mode"] = np.asarray([1], np.uint8)
    arrays[f"{prefix}_freq"] = freq
    arrays[f"{prefix}_states"] = states
    arrays[f"{prefix}_counts"] = wcounts
    arrays[f"{prefix}_words"] = words
    return True


def payload(delta: Dict[str, np.ndarray], lengths: np.ndarray, n_reads: int,
            exc_pos: np.ndarray, exc_byte: np.ndarray,
            perm: np.ndarray, level: int = 6, backend: str = "gz") -> bytes:
    """Delta payload of one block; the literals are the device
    placement's ``lit_packed`` words or the host match's ``lits`` bytes
    (the same bytes out either way).  Short reads carry one i16 shift per
    read (the ``shv`` planes); long reads (container v6/v7) carry i32
    shifts, ``[n, nseg]`` of them under v7's multi-anchor delta, as four
    zig-zag byte planes (``shv4``)."""
    n_lits = int(delta["n_lits"])
    mb = np.ascontiguousarray(delta["mask_bits"][:n_reads])
    arrays = {
        "n_reads": np.asarray([n_reads], np.int64),
        "n_lits": np.asarray([n_lits], np.int64),
        "rc_bits": delta["rc_bits"][: (n_reads + 7) // 8],
        "lengths": lengths[:n_reads].astype(
            np.uint16 if mb.shape[1] * 8 <= 65535 else np.uint32),
        "exc_pos": exc_pos.astype(np.uint64),
        "exc_byte": exc_byte.astype(np.uint8),
        "perm_pk": _bitpack_u32(perm[:n_reads].astype(np.uint32),
                                _perm_bits(n_reads)),
    }
    if "lits" in delta:
        lits = delta["lits"]
    elif n_lits:
        lits = unpack2bit_np(delta["lit_packed"].astype(np.uint32), n_lits)
    else:
        lits = np.zeros(0, np.uint8)
    enc = _encode_lits_rans(lits, n_lits) if n_lits else None
    if enc is not None:
        freq, states, wcounts, words = enc
        arrays["lit_mode"] = np.asarray([1], np.uint8)
        arrays["lit_freq"] = freq
        arrays["lit_states"] = states
        arrays["lit_counts"] = wcounts
        arrays["lit_words"] = words
    else:
        arrays["lit_mode"] = np.asarray([0], np.uint8)
        if "lit_packed" in delta:
            arrays["lit_packed"] = delta["lit_packed"]
        else:
            padded = np.zeros(((n_lits + 15) // 16) * 16, np.uint8)
            padded[:n_lits] = lits[:n_lits]
            arrays["lit_packed"] = _pack2bit_np(padded)
    sh = np.ascontiguousarray(delta["shifts"][:n_reads])
    if sh.ndim == 2:
        # v7 multi-anchor: nseg shifts per read, one read-major stream
        arrays["nseg"] = np.asarray([sh.shape[1]], np.int64)
        sh = np.ascontiguousarray(sh.reshape(-1))
    if sh.dtype.itemsize > 2:
        # long reads: minimizer-anchored shifts exceed i16
        zi = sh.astype(np.int64)
        zz32 = (((zi << 1) ^ (zi >> 63)) & 0xFFFFFFFF).astype(np.uint32)
        sh_stream = np.concatenate(
            [((zz32 >> (8 * p)) & 0xFF).astype(np.uint8)
             for p in range(4)])
        if not _try_side_rans(arrays, "shv4", sh_stream, backend):
            arrays["shv4_planes"] = sh_stream
    else:
        zz = _zigzag16(sh)
        sh_stream = np.concatenate([(zz & 0xFF).astype(np.uint8),
                                    (zz >> 8).astype(np.uint8)])
        if not _try_side_rans(arrays, "shv", sh_stream, backend):
            arrays["shv_planes"] = sh_stream
    pk = np.ascontiguousarray(delta["pred_k"][:n_reads])
    if not _try_side_rans(arrays, "pkv", pk.astype(np.uint8, copy=False),
                          backend):
        arrays["pred_k"] = pk
    menc = _encode_mask_rans(mb.reshape(-1), backend, sample_cap=1 << 16)
    if menc is not None:
        mfreq, mstates, mwcounts, mwords = menc
        arrays["mask_mode"] = np.asarray([1], np.uint8)
        arrays["mask_freq"] = mfreq
        arrays["mask_states"] = mstates
        arrays["mask_counts"] = mwcounts
        arrays["mask_words"] = mwords
    else:
        arrays["mask_mode"] = np.asarray([0], np.uint8)
        arrays["mask_bits"] = mb
    return container.pack_arrays(
        arrays, deflate={"mask_bits": 3, "mask_freq": 3,
                         "mask_counts": 3, "shifts": 3, "pred_k": 3,
                         "shv_freq": 3, "shv_counts": 3,
                         "shv_planes": 3,
                         "shv4_freq": 3, "shv4_counts": 3,
                         "shv4_planes": 3,
                         "pkv_freq": 3, "pkv_counts": 3,
                         "rc_bits": 3, "lengths": 3, "exc_pos": 3,
                         "exc_byte": 3, "perm_pk": 1},
        level=level, backend=backend)


def parse_fields(blob: bytes, B: int, L: int, delta_device: bool = False):
    """Everything of :func:`parse` but the reconstruction (host arrays
    only): ``(fields, lengths i32 [B], n_reads, exc_pos, exc_byte, perm,
    rc bool [B])``, ``fields`` the validated delta products of the
    ``n_reads`` rows (``mask_bits``, ``shifts`` i64, ``pred_k`` u8,
    ``lits`` u8, and ``native``: the checked native walk applies).  The
    deep validation runs when ``delta_device`` or the native walk cannot
    (the reference's rule): the device reconstruction's gathers are
    unchecked, so a corrupt block raises ``ValueError`` here.  Reads
    every layout the reference writes, long-read (v6/v7) blocks too."""
    a = container.unpack_arrays(blob)
    n = int(a["n_reads"][0])
    n_lits = int(a["n_lits"][0])
    if not (0 <= n <= B):
        raise ValueError("corrupt .scalcer block: n_reads out of range")
    if "perm" not in a:
        k = _perm_bits(n)
        pk = a.get("perm_pk")
        if pk is None or pk.ndim != 1 or pk.shape[0] < (n * k + 7) // 8:
            raise ValueError("corrupt .scalcer block: permutation short")
        a["perm"] = _bitunpack_u32(pk, n, k)
    if "shifts" not in a and ("shv4_mode" in a or "shv4_planes" in a):
        # long reads: four zig-zag u32 planes; v7 stores nseg shifts per
        # read ([n, nseg] after the reshape)
        nseg = int(a["nseg"][0]) if "nseg" in a else 1
        if not (1 <= nseg <= 256):
            raise ValueError("corrupt .scalcer block: nseg out of range")
        ns = n * nseg
        if int(a["shv4_mode"][0]) if "shv4_mode" in a else 0:
            sb = _decode_mask_rans(a, 4 * ns, prefix="shv4")
        else:
            sb = a["shv4_planes"]
            if sb.ndim != 1 or sb.shape[0] < 4 * ns:
                raise ValueError("corrupt .scalcer block: shifts planes "
                                 "short")
        zz = np.zeros(ns, np.uint32)
        for p in range(4):
            zz |= sb[p * ns:(p + 1) * ns].astype(np.uint32) << np.uint32(
                8 * p)
        zi = zz.astype(np.int64)
        sh = (zi >> 1) ^ -(zi & 1)
        a["shifts"] = sh.reshape(n, nseg) if nseg > 1 else sh
    if "shifts" not in a:
        if int(a["shv_mode"][0]) if "shv_mode" in a else 0:
            sb = _decode_mask_rans(a, 2 * n, prefix="shv")
        elif "shv_planes" in a:
            sb = a["shv_planes"]
            if sb.ndim != 1 or sb.shape[0] < 2 * n:
                raise ValueError("corrupt .scalcer block: shifts planes "
                                 "short")
        else:
            raise ValueError("corrupt .scalcer block: shifts missing")
        zz = (sb[:n].astype(np.uint16)
              | (sb[n:2 * n].astype(np.uint16) << 8))
        a["shifts"] = _unzigzag16(zz)
    if "pred_k" not in a:
        if int(a["pkv_mode"][0]) if "pkv_mode" in a else 0:
            a["pred_k"] = _decode_mask_rans(a, n, prefix="pkv")
        else:
            raise ValueError("corrupt .scalcer block: pred_k missing")
    if "mask_bits" not in a:
        if int(a["mask_mode"][0]) if "mask_mode" in a else 0:
            for fld in ("mask_freq", "mask_states", "mask_counts",
                        "mask_words"):
                if fld not in a:
                    raise ValueError(
                        f"corrupt .scalcer block: missing {fld}")
            a["mask_bits"] = _decode_mask_rans(
                a, n * (L // 8)).reshape(n, L // 8)
        else:
            raise ValueError("corrupt .scalcer block: mask stream "
                             "missing")
    sh64 = a["shifts"].astype(np.int64)
    fits16 = n == 0 or (sh64.ndim == 1
                        and int(np.abs(sh64).max()) < (1 << 15))
    use_native = _NATIVE and fits16
    _validate(a, n, B, L, n_lits, deep=delta_device or not use_native)
    if int(a["lit_mode"][0]) if "lit_mode" in a else 0:
        lits = _decode_lits_rans(a, n_lits)
    else:
        lits = unpack2bit_np(a["lit_packed"].astype(np.uint32), n_lits)
    lengths = np.zeros(B, np.int32)
    lengths[:n] = a["lengths"].astype(np.int32)
    rc = np.zeros(B, bool)
    rc[:n] = np.unpackbits(a["rc_bits"], bitorder="little")[:n].astype(bool)
    fields = {"mask_bits": a["mask_bits"], "shifts": sh64,
              "pred_k": a["pred_k"].astype(np.uint8), "lits": lits,
              "native": use_native}
    return fields, lengths, n, a["exc_pos"].astype(np.int64), \
        a["exc_byte"], a["perm"].astype(np.int64), rc


def parse(blob: bytes, B: int, L: int, delta_device: bool = False,
          device="cpu"
          ) -> Tuple[np.ndarray, np.ndarray, int, np.ndarray, np.ndarray,
                     np.ndarray, np.ndarray]:
    """Payload -> (codes u8 [B, L] (canonical orientation), lengths i32
    [B], n_reads, exc_pos, exc_byte, perm, rc bool [B]): by the serial
    host delta walk, or with ``delta_device`` by pointer doubling on
    ``device`` (``ops/delta_decode.py``, blocking; the same bytes)."""
    fields, lengths, n, *rest = parse_fields(blob, B, L, delta_device)
    codes = np.zeros((B, L), np.uint8)
    sh = fields["shifts"]
    if delta_device and sh.ndim == 2:
        raise ValueError("--delta-device does not support v7 long-read "
                         "multi-anchor blocks (host walk only)")
    if delta_device:
        from scalce_tpu_torch.ops import delta_decode
        delta_decode.reconstruct_device(
            fields["mask_bits"], sh.astype(np.int32),
            fields["pred_k"].astype(np.int32), fields["lits"], lengths[:n],
            B, L, codes, device)
    else:
        _reconstruct(fields["mask_bits"],
                     sh.astype(np.int16) if fields["native"] else sh,
                     fields["pred_k"], fields["lits"],
                     lengths[:n].astype(np.int64), L, codes)
    return (codes, lengths, n, *rest)
