# Copy of scalce_tpu/native/__init__.py; it builds into
# scalce_tpu_torch/_build/ (the only change).
"""ctypes binding for the native host library (see host_ops.c).

Compiled on first import with the system C compiler (no pip, no
pybind11); a missing/failed toolchain degrades gracefully to the NumPy
fallbacks in ``io/fastq.py`` (``AVAILABLE`` stays False).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np
from numpy.ctypeslib import ndpointer

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "host_ops.c")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")


def _isa_tag() -> str:
    """Fingerprint of the build machine's ISA.  -march=native bakes this
    host's vector extensions into the .so; on a shared checkout (NFS,
    multi-host runs) another machine must not load it — a narrower CPU
    would SIGILL on the first native call."""
    import hashlib
    import platform
    desc = platform.machine()
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    desc += line.decode("ascii", "replace")
                    break
    except OSError:
        desc += platform.processor() or ""
    # sha256: md5 raises at import time on FIPS-enforcing hosts, which
    # would defeat this module's graceful degradation
    return hashlib.sha256(desc.encode()).hexdigest()[:10]


_SO = os.path.join(
    _BUILD, f"_host_ops_{sys.implementation.cache_tag}_{_isa_tag()}.so")

_lib: Optional[ctypes.CDLL] = None
AVAILABLE = False


def _build() -> bool:
    if os.path.exists(_SO) and os.path.getmtime(_SO) > os.path.getmtime(_SRC):
        return True
    cc = os.environ.get("CC", "cc")
    tmp = None
    try:
        # build into a temp file then atomically rename (parallel-safe)
        os.makedirs(_BUILD, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        subprocess.run(
            [cc, "-O3", "-march=native", "-shared", "-fPIC",
             "-fvisibility=hidden", "-o", tmp, _SRC],
            check=True, capture_output=True)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.CalledProcessError):
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return False


_i64p = ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _bind() -> None:
    global _lib, AVAILABLE
    if not _build():
        return
    lib = ctypes.CDLL(_SO)
    lib.ragged_gather_u8.argtypes = [_u8p, _i64p, _i64p, ctypes.c_int64,
                                     _u8p]
    lib.ragged_gather_u8.restype = None
    lib.ragged_scatter_u8.argtypes = [_u8p, _i64p, _u8p, _i64p,
                                      ctypes.c_int64]
    lib.ragged_scatter_u8.restype = None
    lib.fill_block.argtypes = [_u8p, _i64p, _u8p, _i64p, _i64p,
                               ctypes.c_int64, ctypes.c_int64, _u8p, _u8p,
                               _u8p, _i64p, _u8p, ctypes.c_int64]
    lib.fill_block.restype = ctypes.c_int64
    lib.pack2bit_u32.argtypes = [_u8p, ctypes.c_int64,
                                 ndpointer(np.uint32,
                                           flags="C_CONTIGUOUS")]
    lib.pack2bit_u32.restype = None
    lib.reconstruct_delta.argtypes = [_u8p,
                                      ndpointer(np.int16,
                                                flags="C_CONTIGUOUS"),
                                      _u8p, _u8p, _i64p, ctypes.c_int64,
                                      ctypes.c_int64, _u8p]
    lib.reconstruct_delta.restype = None
    lib.render_fastq.argtypes = [_u8p, _u8p, _i64p, ctypes.c_int64,
                                 ctypes.c_int64, _u8p, _i64p,
                                 ctypes.c_void_p, ctypes.c_void_p,
                                 _u8p, _i64p]
    lib.render_fastq.restype = None
    lib.render_fastq2.argtypes = [_u8p, _u8p, _u8p, _i64p,
                                  ctypes.c_int64, ctypes.c_int64,
                                  _u8p, _i64p,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  _u8p, _i64p]
    lib.render_fastq2.restype = None
    _u16p = ndpointer(np.uint16, flags="C_CONTIGUOUS")
    _u32p = ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.qual_sym_ctx_hist.argtypes = [_u8p, _i64p, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64,
                                      _u8p, _u16p, _i64p]
    lib.qual_sym_ctx_hist.restype = None
    lib.rans_encode_lanes.argtypes = [_u8p, _u16p, _u32p, _u32p,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64,
                                      _u32p, _i64p, _u16p]
    lib.rans_encode_lanes.restype = ctypes.c_int64
    lib.unpack2bit_u32.argtypes = [ndpointer(np.uint32,
                                             flags="C_CONTIGUOUS"),
                                   ctypes.c_int64, _u8p]
    lib.unpack2bit_u32.restype = None
    lib.delta_match.argtypes = [_u8p,
                                ndpointer(np.uint32, flags="C_CONTIGUOUS"),
                                ndpointer(np.int32, flags="C_CONTIGUOUS"),
                                _i64p, ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int64, _u8p,
                                ndpointer(np.int16, flags="C_CONTIGUOUS"),
                                _u8p, _u8p]
    lib.delta_match.restype = ctypes.c_int64
    lib.delta_match_runs.argtypes = [_u8p, _u8p,
                                     ndpointer(np.int32,
                                               flags="C_CONTIGUOUS"),
                                     _i64p, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, _u8p,
                                     ndpointer(np.int16,
                                               flags="C_CONTIGUOUS"),
                                     _u8p, _u8p]
    lib.delta_match_runs.restype = ctypes.c_int64
    lib.gather_orient.argtypes = [_u8p, _i64p, _u8p, _i64p,
                                  ctypes.c_int64, ctypes.c_int64, _u8p]
    lib.gather_orient.restype = None
    lib.find_line_starts.argtypes = [_u8p, ctypes.c_int64, _i64p]
    lib.find_line_starts.restype = ctypes.c_int64
    lib.analyze_names.argtypes = [_u8p, _i64p, ctypes.c_int64, _u8p,
                                  ctypes.c_int64, _u8p,
                                  ndpointer(np.uint32,
                                            flags="C_CONTIGUOUS"),
                                  _i64p, _u8p]
    lib.analyze_names.restype = ctypes.c_int64
    lib.parse_into_block.argtypes = [
        _u8p, _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, _u8p, _u8p, _u8p,
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
        _u8p, _i64p, _u8p, _i64p, _i64p, _u8p,
        ctypes.c_int64, ctypes.c_int64, _i64p]
    lib.parse_into_block.restype = ctypes.c_int64
    lib.count_newlines.argtypes = [_u8p, ctypes.c_int64]
    lib.count_newlines.restype = ctypes.c_int64
    lib.bitpack_u32.argtypes = [_u32p, ctypes.c_int64, ctypes.c_int64,
                                _u8p]
    lib.bitpack_u32.restype = None
    lib.bitunpack_u32.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64,
                                  _u32p]
    lib.bitunpack_u32.restype = None
    lib.qual_hist3.argtypes = [_u8p, _i64p, _i64p, _u8p, ctypes.c_int64,
                               ctypes.c_int64, _u32p, _u32p, _u32p]
    lib.qual_hist3.restype = None
    lib.qual_hist_one.argtypes = [_u8p, _i64p, _i64p, _u8p,
                                  ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int64, _u32p]
    lib.qual_hist_one.restype = None
    lib.permute_rows_u8.argtypes = [_u8p, _i64p, ctypes.c_int64,
                                    ctypes.c_int64, _u8p]
    lib.permute_rows_u8.restype = None
    lib.mask_tail_check.argtypes = [_u8p, _i64p, ctypes.c_int64,
                                    ctypes.c_int64]
    lib.mask_tail_check.restype = ctypes.c_int64
    lib.join_fields.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                ctypes.POINTER(ctypes.c_void_p),
                                _u8p, ctypes.c_int64, _u8p,
                                ctypes.c_int64, _i64p, _u8p]
    lib.join_fields.restype = None
    lib.build_rcp44.argtypes = [_u32p, ctypes.c_int64,
                                ndpointer(np.uint64, flags="C_CONTIGUOUS")]
    lib.build_rcp44.restype = None
    lib.rans_encode_qual.argtypes = [_u8p, _i64p, _i64p, _u8p, _u8p,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int64,
                                     _u32p, _i64p, _u16p]
    lib.rans_encode_qual.restype = ctypes.c_int64
    lib.build_enc_table.argtypes = [_u32p, _u32p, ctypes.c_int64, _u8p]
    lib.build_enc_table.restype = None
    try:
        # 16-lane AVX-512 encoder — only exported when the .so was
        # built on a machine with AVX512F+DQ (the ISA-tagged cache key
        # guarantees build machine == run machine)
        lib.rans_encode_qual_v.argtypes = [_u8p, _i64p, _i64p, _u8p,
                                           _u32p, _u32p,
                                           ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_int64, ctypes.c_int64,
                                           _u32p, _i64p, _u16p]
        lib.rans_encode_qual_v.restype = ctypes.c_int64
        lib.rans_decode_lanes_v.argtypes = [_u32p, _u16p, _i64p, _u16p,
                                            _u16p, _i64p, ctypes.c_int64,
                                            ctypes.c_int64,
                                            ctypes.c_int64,
                                            ctypes.c_int64,
                                            ctypes.c_int64, _u8p]
        lib.rans_decode_lanes_v.restype = ctypes.c_int64
        lib.rans_encode_mask_v.argtypes = [_u8p, ctypes.c_int64,
                                           ctypes.c_int64,
                                           ctypes.c_int64, _u32p, _u32p,
                                           _u32p, _i64p, _u16p]
        lib.rans_encode_mask_v.restype = ctypes.c_int64
        lib.rans_decode_mask_v.argtypes = [_u32p, _u16p, _i64p, _u32p,
                                           ctypes.c_int64,
                                           ctypes.c_int64,
                                           ctypes.c_int64, _u8p]
        lib.rans_decode_mask_v.restype = None
    except AttributeError:
        pass
    lib.rans_decode_lanes.argtypes = [_u32p, _u16p, _i64p, _u32p, _i64p,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64,
                                      _u8p]
    lib.rans_decode_lanes.restype = None
    lib.build_sym8.argtypes = [_u16p, ctypes.c_int64, ctypes.c_int64,
                               _u8p]
    lib.build_sym8.restype = None
    lib.core_match_block.argtypes = [_u8p, _i64p, _i64p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_uint32,
                                     _u32p,
                                     ndpointer(np.int32,
                                               flags="C_CONTIGUOUS"),
                                     _u8p, _i64p]
    lib.core_match_block.restype = ctypes.c_int64
    lib.rans_decode_lanes2.argtypes = [_u32p, _u16p, _i64p, _u8p, _u16p,
                                       _u16p, _i64p, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int64, _u8p]
    lib.rans_decode_lanes2.restype = None
    lib.lit_hist.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64,
                             ctypes.c_int64, _i64p]
    lib.lit_hist.restype = None
    lib.rans_encode_lits.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, _u32p, _u32p,
                                     ndpointer(np.uint64,
                                               flags="C_CONTIGUOUS"),
                                     _u32p, _i64p, _u16p]
    lib.rans_encode_lits.restype = ctypes.c_int64
    lib.mask_hist.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int64, _i64p]
    lib.mask_hist.restype = None
    lib.rans_encode_mask.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, _u32p, _u32p,
                                     ndpointer(np.uint64,
                                               flags="C_CONTIGUOUS"),
                                     _u32p, _i64p, _u16p]
    lib.rans_encode_mask.restype = ctypes.c_int64
    lib.rans_decode_mask.argtypes = [_u32p, _u16p, _i64p, _u32p,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, _u8p]
    lib.rans_decode_mask.restype = None
    lib.build_flat_lut.argtypes = [_u32p, _u32p, ctypes.c_int64,
                                   ctypes.c_int64, _u32p]
    lib.build_flat_lut.restype = None
    lib.host_normalize_tbl.argtypes = [
        ndpointer(np.int32, flags="C_CONTIGUOUS"), ctypes.c_int64,
        ctypes.c_int64, _u32p, _u32p]
    lib.host_normalize_tbl.restype = None
    lib.rans_decode_lits.argtypes = [_u32p, _u16p, _i64p, _u32p,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64, _u8p]
    lib.rans_decode_lits.restype = None
    lib.rc_flip_rows.argtypes = [_u8p, _i64p, _u8p, ctypes.c_int64,
                                 ctypes.c_int64]
    lib.rc_flip_rows.restype = None
    lib.reconstruct_delta_checked.argtypes = [
        _u8p, ndpointer(np.int16, flags="C_CONTIGUOUS"), _u8p, _u8p,
        ctypes.c_int64, _i64p, ctypes.c_int64, ctypes.c_int64, _u8p]
    lib.reconstruct_delta_checked.restype = ctypes.c_int64
    lib.dec_lens_i64.argtypes = [_i64p, ctypes.c_int64, _i64p]
    lib.dec_lens_i64.restype = None
    lib.render_ints_i64.argtypes = [_i64p, ctypes.c_int64, _i64p, _u8p]
    lib.render_ints_i64.restype = None
    _lib = lib
    AVAILABLE = True


_bind()


def ragged_gather_u8(buf: np.ndarray, starts: np.ndarray,
                     lens: np.ndarray) -> np.ndarray:
    out = np.empty(int(lens.sum()), np.uint8)
    _lib.ragged_gather_u8(buf, np.ascontiguousarray(starts),
                          np.ascontiguousarray(lens), len(starts), out)
    return out


def ragged_scatter_u8(dst: np.ndarray, dst_starts: np.ndarray,
                      src: np.ndarray, lens: np.ndarray) -> None:
    _lib.ragged_scatter_u8(dst, np.ascontiguousarray(dst_starts),
                           np.ascontiguousarray(src),
                           np.ascontiguousarray(lens), len(dst_starts))


def fill_block(seq_buf: np.ndarray, seq_starts: np.ndarray,
               qual_buf: np.ndarray, qual_starts: np.ndarray,
               lens: np.ndarray, L: int,
               base2code: np.ndarray, seq_out: np.ndarray,
               qual_out: np.ndarray):
    """Returns (exc_pos, exc_byte); grows the exception buffer on demand."""
    n = len(lens)
    cap = 1024
    while True:
        exc_pos = np.empty(cap, np.int64)
        exc_byte = np.empty(cap, np.uint8)
        got = _lib.fill_block(np.ascontiguousarray(seq_buf),
                              np.ascontiguousarray(seq_starts),
                              np.ascontiguousarray(qual_buf),
                              np.ascontiguousarray(qual_starts),
                              np.ascontiguousarray(lens), n, L,
                              base2code, seq_out.reshape(-1),
                              qual_out.reshape(-1), exc_pos, exc_byte, cap)
        if got >= 0:
            return exc_pos[:got], exc_byte[:got]
        cap *= 8


def bitpack_u32(vals: np.ndarray, k: int) -> np.ndarray:
    """LSB-first fixed-width pack of u32 values into bytes."""
    n = vals.shape[0]
    out = np.zeros((n * k + 7) // 8, np.uint8)
    _lib.bitpack_u32(np.ascontiguousarray(vals.astype(np.uint32)),
                     n, k, out)
    return out


def bitunpack_u32(packed: np.ndarray, n: int, k: int) -> np.ndarray:
    vals = np.empty(n, np.uint32)
    _lib.bitunpack_u32(np.ascontiguousarray(packed), n, k, vals)
    return vals


def pack2bit(codes: np.ndarray) -> np.ndarray:
    """codes uint8 [..., n*16] -> uint32 [..., n], big-endian in-word."""
    flat = np.ascontiguousarray(codes).reshape(-1)
    n_words = flat.size // 16
    out = np.empty(n_words, np.uint32)
    _lib.pack2bit_u32(flat, n_words, out)
    return out.reshape(codes.shape[:-1] + (codes.shape[-1] // 16,))


def reconstruct_delta(mask_bits: np.ndarray, shifts: np.ndarray,
                      pred_k: np.ndarray, lits: np.ndarray,
                      lens: np.ndarray, L: int,
                      out: np.ndarray) -> None:
    _lib.reconstruct_delta(mask_bits, shifts, pred_k,
                           np.ascontiguousarray(lits),
                           np.ascontiguousarray(lens), len(lens), L,
                           out.reshape(-1))


def reconstruct_delta_checked(mask_bits: np.ndarray, shifts: np.ndarray,
                              pred_k: np.ndarray, lits: np.ndarray,
                              lens: np.ndarray, L: int,
                              out: np.ndarray) -> int:
    """Checked variant: returns literals consumed, or -1 on any
    out-of-bounds copy (caller raises on -1 or != n_lits)."""
    return int(_lib.reconstruct_delta_checked(
        np.ascontiguousarray(mask_bits), np.ascontiguousarray(shifts),
        np.ascontiguousarray(pred_k), np.ascontiguousarray(lits),
        lits.shape[0], np.ascontiguousarray(lens), len(lens), L,
        out.reshape(-1)))


def qual_sym_ctx_hist(qual: np.ndarray, lengths: np.ndarray, L: int,
                      order: int, n_ctx: int):
    """One-pass sym/ctx grids + (ctx, sym) histogram."""
    B = len(lengths)
    sym = np.empty(B * L, np.uint8)
    ctx = np.empty(B * L, np.uint16)
    counts = np.zeros(n_ctx * 94, np.int64)
    _lib.qual_sym_ctx_hist(np.ascontiguousarray(qual).reshape(-1),
                           np.ascontiguousarray(lengths.astype(np.int64)),
                           B, L, order, sym, ctx, counts)
    return sym, ctx, counts


def rans_encode_lanes(sym: np.ndarray, ctx: np.ndarray, freq: np.ndarray,
                      cum: np.ndarray, N: int, T: int, n_syms: int = 94):
    states = np.empty(N, np.uint32)
    wcounts = np.empty(N, np.int64)
    words_cat = np.empty(N * T, np.uint16)
    total = _lib.rans_encode_lanes(sym, ctx,
                                   np.ascontiguousarray(
                                       freq.reshape(-1).astype(np.uint32)),
                                   np.ascontiguousarray(
                                       cum.reshape(-1).astype(np.uint32)),
                                   N, T, n_syms, states, wcounts, words_cat)
    if total < 0:      # heap scratch alloc failed (long-read T)
        raise MemoryError("rans_encode_lanes scratch allocation failed")
    return states, wcounts, words_cat[:total].copy()


def unpack2bit(words: np.ndarray) -> np.ndarray:
    """uint32 [..., n] -> uint8 [..., n*16] 2-bit codes (pack2bit inverse)."""
    flat = np.ascontiguousarray(words).reshape(-1)
    out = np.empty(flat.size * 16, np.uint8)
    _lib.unpack2bit_u32(flat, flat.size, out)
    return out.reshape(words.shape[:-1] + (words.shape[-1] * 16,))


def delta_match(codes: np.ndarray, ck: np.ndarray, cp: np.ndarray,
                lens: np.ndarray, K: int = 4):
    """Best-of-K aligned-predecessor delta over the sorted block.

    Returns (mask_bits u8 [n, L/8], shifts i16 [n], pred_k u8 [n],
    lits u8 [n_lits]) — byte-identical to the device _delta_seq."""
    n, L = codes.shape
    mask_bits = np.empty((n, L // 8), np.uint8)
    shifts = np.empty(n, np.int16)
    pred_k = np.empty(n, np.uint8)
    lits = np.empty(n * L, np.uint8)
    n_lits = _lib.delta_match(np.ascontiguousarray(codes).reshape(-1),
                              np.ascontiguousarray(ck.astype(np.uint32)),
                              np.ascontiguousarray(cp.astype(np.int32)),
                              np.ascontiguousarray(lens.astype(np.int64)),
                              n, L, K, mask_bits.reshape(-1), shifts,
                              pred_k, lits)
    return mask_bits, shifts, pred_k, lits[:n_lits].copy()


def parse_into_block(buf, starts, line0: int, n_rec: int, row0: int,
                     L: int, base2code, seq_out, qual_out, lens_out,
                     name_cat, name_lens, plus_cat, plus_lens,
                     exc_pos, exc_byte, exc_start: int, meta):
    """Raw binding for the direct bundle->block parse (host_ops.c);
    returns the C status code.  io/fastq.py owns the retry/erroring."""
    return int(_lib.parse_into_block(
        buf, starts, line0, n_rec, row0, L, base2code,
        seq_out.reshape(-1), qual_out.reshape(-1), lens_out,
        name_cat, name_lens, plus_cat, plus_lens,
        exc_pos, exc_byte, exc_start, len(exc_pos), meta))


_MAX_NAME_FIELDS = 63


def analyze_names(cat: np.ndarray, offsets: np.ndarray, n: int,
                  sep_lut: np.ndarray):
    """One-pass structured-name analysis (see host_ops.c).  Returns
    ``(sep_bytes, field_lens [n, k+1], vals [k+1, n], flags [k+1])``
    or None when the records do not share one separator pattern.

    CONTRACT: ``vals[f]`` is defined ONLY where ``flags[f] & 1`` (field
    still numeric).  The C side stops writing a field's vals the moment
    its numeric flag dies, leaving the rest of that row uninitialized —
    callers must gate every vals read on the flag (streams/names.py
    does)."""
    sep_bytes = np.empty(_MAX_NAME_FIELDS, np.uint8)
    # worst-case k discovered from record 0 inside C; allocate for max
    field_lens = np.empty(n * (_MAX_NAME_FIELDS + 1), np.uint32)
    vals = np.empty((_MAX_NAME_FIELDS + 1) * n, np.int64)
    flags = np.empty(_MAX_NAME_FIELDS + 1, np.uint8)
    k = int(_lib.analyze_names(cat, np.ascontiguousarray(offsets), n,
                               sep_lut, _MAX_NAME_FIELDS, sep_bytes,
                               field_lens, vals, flags))
    if k < 0:
        return None
    nf = k + 1
    return (sep_bytes[:k].copy(),
            field_lens[: n * nf].reshape(n, nf),
            vals[: nf * n].reshape(nf, n),
            flags[:nf])


def line_starts(buf: np.ndarray) -> np.ndarray:
    """``[0, i+1 for every newline i]`` over a u8 buffer (memchr scan;
    the parser's replacement for eq+flatnonzero)."""
    n = int(_lib.count_newlines(buf, buf.size))
    out = np.empty(n + 1, np.int64)
    cnt = _lib.find_line_starts(buf, buf.size, out)
    return out[:cnt]


def core_match_block(codes: np.ndarray, lengths: np.ndarray,
                     exc_pos: np.ndarray, n: int, k: int, seed: int):
    """Host placement of the canonical core matcher + bucket sort
    (host_ops.c) — bit-identical to the device stage A.  Returns
    (ck u32 [n], cp i32 [n], rc u8 [n], perm i64 [n]) in ORIGINAL row
    order (perm = sorted order of the n real rows)."""
    L = codes.shape[1]
    ck = np.empty(n, np.uint32)
    cp = np.empty(n, np.int32)
    rc = np.empty(n, np.uint8)
    perm = np.empty(n, np.int64)
    rcode = _lib.core_match_block(
        np.ascontiguousarray(codes).reshape(-1),
        np.ascontiguousarray(lengths.astype(np.int64)),
        np.ascontiguousarray(exc_pos.astype(np.int64)),
        len(exc_pos), n, L, k, seed & 0xFFFFFFFF, ck, cp, rc, perm)
    if rcode != 0:
        raise MemoryError("core_match_block allocation failed")
    return ck, cp, rc, perm


def gather_orient(codes: np.ndarray, perm: np.ndarray, rc: np.ndarray,
                  lens: np.ndarray) -> np.ndarray:
    """Sorted, strand-oriented code rows from the ORIGINAL-order block:
    ``out[i] = revcomp(codes[perm[i]])`` if ``rc[i]`` else the row
    verbatim — the host half of the slim-download encode path."""
    n = len(perm)
    L = codes.shape[1]
    out = np.empty((n, L), np.uint8)
    _lib.gather_orient(np.ascontiguousarray(codes).reshape(-1),
                       np.ascontiguousarray(perm.astype(np.int64)),
                       np.ascontiguousarray(rc.astype(np.uint8)),
                       np.ascontiguousarray(lens.astype(np.int64)),
                       n, L, out.reshape(-1))
    return out


def delta_match_runs(codes: np.ndarray, bnd: np.ndarray, cp: np.ndarray,
                     lens: np.ndarray, K: int = 4):
    """``delta_match`` with bucket runs given as boundary BITS (bnd u8
    [n], 1 = first row of its bucket run / NO_CORE row) instead of core
    ids — the slim-download variant for the sorted mate-1 frame."""
    n, L = codes.shape
    mask_bits = np.empty((n, L // 8), np.uint8)
    shifts = np.empty(n, np.int16)
    pred_k = np.empty(n, np.uint8)
    lits = np.empty(n * L, np.uint8)
    n_lits = _lib.delta_match_runs(
        np.ascontiguousarray(codes).reshape(-1),
        np.ascontiguousarray(bnd.astype(np.uint8)),
        np.ascontiguousarray(cp.astype(np.int32)),
        np.ascontiguousarray(lens.astype(np.int64)),
        n, L, K, mask_bits.reshape(-1), shifts, pred_k, lits)
    return mask_bits, shifts, pred_k, lits[:n_lits].copy()



_IDENT_QMAP = np.arange(256, dtype=np.uint8)
_IDENT_PERM_CACHE: dict = {}


def _ident_perm(B: int) -> np.ndarray:
    p = _IDENT_PERM_CACHE.get(B)
    if p is None:
        p = np.arange(B, dtype=np.int64)
        if len(_IDENT_PERM_CACHE) < 8:      # bounded (few block shapes)
            _IDENT_PERM_CACHE[B] = p
    return p


def _perm_or_ident(perm, B: int) -> np.ndarray:
    if perm is None:
        return _ident_perm(B)
    return np.ascontiguousarray(perm, dtype=np.int64)


def _qmap_or_ident(qmap) -> np.ndarray:
    if qmap is None:
        return _IDENT_QMAP
    return np.ascontiguousarray(qmap, dtype=np.uint8)


def qual_hist3(qual: np.ndarray, lengths: np.ndarray, L: int,
               perm=None, qmap=None):
    """One pass over the quality grid -> (counts_order1, counts_order2,
    counts_order3) for the order auto-selection trial."""
    B = len(lengths)
    # u32 counters: half the cache footprint of the hot scatter adds
    # (a block holds < 2^32 symbols by config); widened on return
    counts1 = np.zeros(761 * 94, np.uint32)     # n_contexts(1) * N_SYMS
    counts2 = np.zeros(1401 * 94, np.uint32)    # n_contexts(2) * N_SYMS
    counts3 = np.zeros(3041 * 94, np.uint32)    # n_contexts(3) * N_SYMS
    _lib.qual_hist3(np.ascontiguousarray(qual).reshape(-1),
                    np.ascontiguousarray(lengths.astype(np.int64)),
                    _perm_or_ident(perm, B), _qmap_or_ident(qmap),
                    B, L, counts1, counts2, counts3)
    return (counts1.astype(np.int64), counts2.astype(np.int64),
            counts3.astype(np.int64))


def qual_hist_one(qual: np.ndarray, lengths: np.ndarray, L: int,
                  order: int, n_ctx: int, perm=None, qmap=None):
    """Single-order (ctx,sym) histogram over the quality grid.

    ``perm`` indirects rows (the sorted-frame permutation, fused into
    the row walk); ``qmap`` is the 256-byte quality remap LUT."""
    B = len(lengths)
    counts = np.zeros(n_ctx * 94, np.uint32)
    _lib.qual_hist_one(np.ascontiguousarray(qual).reshape(-1),
                       np.ascontiguousarray(lengths.astype(np.int64)),
                       _perm_or_ident(perm, B), _qmap_or_ident(qmap),
                       B, L, order, counts)
    return counts.astype(np.int64)


def join_fields(cols, seps: np.ndarray, n: int,
                out_off: np.ndarray) -> np.ndarray:
    """cols: list of (cat u8, offsets i64, is_const).  Returns the joined
    record bytes sized out_off[-1]; callers validate offsets vs cats."""
    nf = len(cols)
    cats = (ctypes.c_void_p * nf)()
    offs = (ctypes.c_void_p * nf)()
    keep = []
    is_const = np.zeros(nf, np.uint8)
    for i, (cat, off, const) in enumerate(cols):
        cat = np.ascontiguousarray(cat, dtype=np.uint8)
        off = np.ascontiguousarray(off, dtype=np.int64)
        keep.append((cat, off))
        cats[i] = cat.ctypes.data
        offs[i] = off.ctypes.data
        is_const[i] = 1 if const else 0
    out = np.empty(int(out_off[-1]), np.uint8)
    _lib.join_fields(cats, offs, is_const, nf,
                     np.ascontiguousarray(seps, dtype=np.uint8), n,
                     np.ascontiguousarray(out_off, dtype=np.int64),
                     out)
    return out


def mask_tail_check(mb: np.ndarray, lens: np.ndarray) -> bool:
    """True iff any mask bit sits at/past its row's length (corrupt)."""
    n, stride = mb.shape
    return bool(_lib.mask_tail_check(
        np.ascontiguousarray(mb).reshape(-1),
        np.ascontiguousarray(lens, dtype=np.int64), n, stride))


def permute_rows_u8(src: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """dst[i] = src[perm[i]] via a scatter copy (sequential reads)."""
    B, L = src.shape
    p = np.ascontiguousarray(perm, dtype=np.int64)
    inv = np.empty(B, np.int64)
    inv[p] = np.arange(B, dtype=np.int64)
    dst = np.empty_like(src)
    _lib.permute_rows_u8(np.ascontiguousarray(src).reshape(-1), inv,
                         B, L, dst.reshape(-1))
    return dst


def rans_encode_qual(qual: np.ndarray, lengths: np.ndarray,
                     freq: np.ndarray, cum: np.ndarray, T: int, order: int,
                     perm=None, qmap=None):
    """Grid-direct quality encode (inline contexts, reciprocal divide);
    byte-identical to rans_encode_lanes over qual_sym_ctx_hist grids.
    ``perm``/``qmap`` fuse the row permute and lossy remap into the
    coder's own row copy (see host_ops.c clamp_sym_m)."""
    B, L = qual.shape
    N = B * L // T
    f32 = np.ascontiguousarray(freq.reshape(-1).astype(np.uint32))
    c32 = np.ascontiguousarray(cum.reshape(-1).astype(np.uint32))
    states = np.empty(N, np.uint32)
    wcounts = np.empty(N, np.int64)
    words_cat = np.empty(N * T, np.uint16)
    q8 = np.ascontiguousarray(qual).reshape(-1)
    l64 = np.ascontiguousarray(lengths.astype(np.int64))
    p64 = _perm_or_ident(perm, B)
    m8 = _qmap_or_ident(qmap)
    if hasattr(_lib, "rans_encode_qual_v"):
        # AVX-512 16-lane path; bit-identical (pinned by tests)
        total = _lib.rans_encode_qual_v(q8, l64, p64, m8, f32, c32,
                                        B, L, T, order, states, wcounts,
                                        words_cat)
    else:
        tab = np.empty(f32.shape[0] * 16, np.uint8)  # packed enc_entry[]
        _lib.build_enc_table(f32, c32, f32.shape[0], tab)
        total = _lib.rans_encode_qual(q8, l64, p64, m8, tab, B, L, T,
                                      order, states, wcounts, words_cat)
    if total < 0:
        raise MemoryError("rans_encode_qual scratch allocation failed")
    return states, wcounts, words_cat[:total].copy()


def lit_hist(lits: np.ndarray, n_lits: int, N: int, T: int) -> np.ndarray:
    counts = np.zeros(17 * 4, np.int64)
    _lib.lit_hist(np.ascontiguousarray(lits), n_lits, N, T, counts)
    return counts


def rans_encode_lits(lits: np.ndarray, n_lits: int, N: int, T: int,
                     freq: np.ndarray, cum: np.ndarray):
    f32 = np.ascontiguousarray(freq.reshape(-1).astype(np.uint32))
    c32 = np.ascontiguousarray(cum.reshape(-1).astype(np.uint32))
    rcp = np.empty(f32.shape[0], np.uint64)
    _lib.build_rcp44(f32, f32.shape[0], rcp)
    states = np.empty(N, np.uint32)
    wcounts = np.empty(N, np.int64)
    words_cat = np.empty(N * T, np.uint16)
    total = _lib.rans_encode_lits(np.ascontiguousarray(lits), n_lits, N, T,
                                  f32, c32, rcp, states, wcounts, words_cat)
    return states, wcounts, words_cat[:total].copy()


def mask_hist(b: np.ndarray, nb: int, N: int, T: int) -> np.ndarray:
    counts = np.zeros(257 * 256, np.int64)
    _lib.mask_hist(np.ascontiguousarray(b), nb, N, T, counts)
    return counts


def rans_encode_mask(b: np.ndarray, nb: int, N: int, T: int,
                     freq: np.ndarray, cum: np.ndarray):
    f32 = np.ascontiguousarray(freq.reshape(-1).astype(np.uint32))
    c32 = np.ascontiguousarray(cum.reshape(-1).astype(np.uint32))
    states = np.empty(N, np.uint32)
    wcounts = np.empty(N, np.int64)
    words_cat = np.empty(N * T, np.uint16)
    b8 = np.ascontiguousarray(b)
    if hasattr(_lib, "rans_encode_mask_v"):
        total = _lib.rans_encode_mask_v(b8, nb, N, T, f32, c32,
                                        states, wcounts, words_cat)
    else:
        rcp = np.empty(f32.shape[0], np.uint64)
        _lib.build_rcp44(f32, f32.shape[0], rcp)
        total = _lib.rans_encode_mask(b8, nb, N, T, f32, c32, rcp,
                                      states, wcounts, words_cat)
    if total < 0:
        raise MemoryError("rans_encode_mask scratch allocation failed")
    return states, wcounts, words_cat[:total].copy()


def host_normalize_tbl(counts: np.ndarray, n_ctx: int, n_syms: int):
    """C mirror of entropy.host_normalize — bit-identical (same IEEE
    f32/i32 ops in the same order; pinned by test), one pass instead of
    numpy's ~10 (the order auto-trial normalizes three tables per
    block)."""
    freq = np.empty(n_ctx * n_syms, np.uint32)
    cum = np.empty(n_ctx * n_syms, np.uint32)
    _lib.host_normalize_tbl(
        np.ascontiguousarray(counts.reshape(-1).astype(np.int32)),
        n_ctx, n_syms, freq, cum)
    return freq.reshape(n_ctx, n_syms), cum.reshape(n_ctx, n_syms)


def build_flat_lut(freq: np.ndarray, cum: np.ndarray, n_ctx: int,
                   n_syms: int) -> np.ndarray:
    """C run-fill flat decode LUT (numpy repeat costs 100s of ms at
    quality-table sizes)."""
    lut = np.empty(n_ctx * 4096, np.uint32)
    _lib.build_flat_lut(
        np.ascontiguousarray(freq.reshape(-1).astype(np.uint32)),
        np.ascontiguousarray(cum.reshape(-1).astype(np.uint32)),
        n_ctx, n_syms, lut)
    return lut


def rans_decode_mask(states: np.ndarray, words_cat: np.ndarray,
                     wcounts: np.ndarray, decode_lut: np.ndarray,
                     nb: int, N: int, T: int) -> np.ndarray:
    out = np.zeros(nb, np.uint8)
    s32 = np.ascontiguousarray(states.astype(np.uint32))
    wc64 = np.ascontiguousarray(wcounts.astype(np.int64))
    if hasattr(_lib, "rans_decode_mask_v"):
        wpad = np.empty(words_cat.shape[0] + 1, np.uint16)
        wpad[:-1] = words_cat
        wpad[-1] = 0
        _lib.rans_decode_mask_v(s32, wpad, wc64, decode_lut, nb, N, T,
                                out)
        return out
    _lib.rans_decode_mask(s32, np.ascontiguousarray(words_cat), wc64,
                          decode_lut, nb, N, T, out)
    return out


def rans_decode_lits(states: np.ndarray, words_cat: np.ndarray,
                     wcounts: np.ndarray, decode_lut: np.ndarray,
                     n_lits: int, N: int, T: int) -> np.ndarray:
    out = np.zeros(n_lits, np.uint8)
    _lib.rans_decode_lits(np.ascontiguousarray(states.astype(np.uint32)),
                          np.ascontiguousarray(words_cat),
                          np.ascontiguousarray(wcounts.astype(np.int64)),
                          decode_lut, n_lits, N, T, out)
    return out


def rans_decode_lanes2(states: np.ndarray, words_cat: np.ndarray,
                       wcounts: np.ndarray, freq: np.ndarray,
                       cum: np.ndarray, lengths: np.ndarray, B: int,
                       L: int, T: int, order: int) -> np.ndarray:
    """Two-level-table quality decode (no 12.5MB flat LUT; see
    host_ops.c).  Bit-identical output to rans_decode_lanes."""
    C, S = freq.shape
    f16 = np.ascontiguousarray(freq.astype(np.uint16)).reshape(-1)
    c16 = np.ascontiguousarray(cum.astype(np.uint16)).reshape(-1)
    qual = np.empty(B * L, np.uint8)
    if hasattr(_lib, "rans_decode_lanes_v"):
        # AVX-512 32-lane path; bit-identical (pinned by tests).  The
        # word gather does 32-bit loads, so pad the u16 stream by one.
        wpad = np.empty(words_cat.shape[0] + 1, np.uint16)
        wpad[:-1] = words_cat
        wpad[-1] = 0
        rc = _lib.rans_decode_lanes_v(
            np.ascontiguousarray(states.astype(np.uint32)), wpad,
            np.ascontiguousarray(wcounts.astype(np.int64)), f16, c16,
            np.ascontiguousarray(lengths.astype(np.int64)), B, L, T,
            order, C, qual)
        if rc < 0:
            raise MemoryError("rans_decode_lanes_v LUT allocation failed")
        return qual.reshape(B, L)
    sym8 = np.empty(C * 256, np.uint8)
    _lib.build_sym8(c16, C, S, sym8)
    _lib.rans_decode_lanes2(
        np.ascontiguousarray(states.astype(np.uint32)),
        np.ascontiguousarray(words_cat),
        np.ascontiguousarray(wcounts.astype(np.int64)), sym8, f16, c16,
        np.ascontiguousarray(lengths.astype(np.int64)), B, L, T, order,
        qual)
    return qual.reshape(B, L)


def rans_decode_lanes(states: np.ndarray, words_cat: np.ndarray,
                      wcounts: np.ndarray, decode_lut: np.ndarray,
                      lengths: np.ndarray, B: int, L: int, T: int,
                      order: int) -> np.ndarray:
    qual = np.empty(B * L, np.uint8)
    _lib.rans_decode_lanes(np.ascontiguousarray(states.astype(np.uint32)),
                           np.ascontiguousarray(words_cat),
                           np.ascontiguousarray(wcounts.astype(np.int64)),
                           decode_lut,
                           np.ascontiguousarray(lengths.astype(np.int64)),
                           B, L, T, order, qual)
    return qual.reshape(B, L)


def rc_flip_rows(seq: np.ndarray, lens: np.ndarray,
                 rc: np.ndarray) -> None:
    """In-place reverse-complement of rows where rc[i] is set."""
    n, L = seq.shape
    _lib.rc_flip_rows(seq.reshape(-1), np.ascontiguousarray(
        lens.astype(np.int64)), np.ascontiguousarray(
        rc.astype(np.uint8)), n, L)


def render_ints_i64(vals: np.ndarray):
    """Non-negative int64 column -> (cat u8, offsets i64) decimal ASCII."""
    v = np.ascontiguousarray(vals.astype(np.int64))
    n = v.shape[0]
    lens = np.empty(n, np.int64)
    _lib.dec_lens_i64(v, n, lens)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    out = np.empty(int(offs[-1]), np.uint8)
    _lib.render_ints_i64(v, n, offs, out)
    return out, offs


def render_fastq2(codes: np.ndarray, code2base: np.ndarray,
                  qual: np.ndarray, lens: np.ndarray, L: int,
                  name_cat: np.ndarray, name_off: np.ndarray,
                  plus_cat: Optional[np.ndarray],
                  plus_off: Optional[np.ndarray],
                  out: np.ndarray, rec_off: np.ndarray) -> None:
    """render_fastq with in-copy code->base translation (no 13MB
    intermediate bases array)."""
    n = len(lens)
    pc = plus_cat.ctypes.data if plus_cat is not None else None
    po = plus_off.ctypes.data if plus_off is not None else None
    _lib.render_fastq2(codes.reshape(-1), code2base, qual.reshape(-1),
                       np.ascontiguousarray(lens), n, L,
                       np.ascontiguousarray(name_cat),
                       np.ascontiguousarray(name_off), pc, po,
                       out, np.ascontiguousarray(rec_off))


def render_fastq(bases: np.ndarray, qual: np.ndarray, lens: np.ndarray,
                 L: int, name_cat: np.ndarray, name_off: np.ndarray,
                 plus_cat: Optional[np.ndarray],
                 plus_off: Optional[np.ndarray],
                 out: np.ndarray, rec_off: np.ndarray) -> None:
    n = len(lens)
    pc = plus_cat.ctypes.data if plus_cat is not None else None
    po = plus_off.ctypes.data if plus_off is not None else None
    _lib.render_fastq(bases.reshape(-1), qual.reshape(-1),
                      np.ascontiguousarray(lens), n, L,
                      np.ascontiguousarray(name_cat),
                      np.ascontiguousarray(name_off), pc, po,
                      out, np.ascontiguousarray(rec_off))
