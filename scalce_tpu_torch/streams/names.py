# Copy of scalce_tpu/streams/names.py (only the imports differ).
"""Name stream codec.

The reference tokenizes read names, stores constant fields once,
delta-encodes numeric fields, or discards names entirely and regenerates
``<library>.N`` under ``-n`` [REF: scalce names path — UNVERIFIED;
SURVEY.md §2 "Name codec"].

Names are ragged ASCII — a host-side stream by design (SURVEY.md §3:
"names are ragged ASCII — host path first").  This module implements:

  * template mode (``-n``): store nothing; decode regenerates
    ``lib.1``, ``lib.2``, … in output order.
  * tokenized mode: vectorized field split on separators; per-field
    columns are stored as (a) nothing if constant across the block,
    (b) zig-zag deltas if numeric, (c) raw bytes otherwise — then
    deflated.  Falls back to raw+deflate when records disagree on
    field structure.

All vector ops are whole-block NumPy — no per-record Python loops.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from scalce_tpu_torch import container
from scalce_tpu_torch.io.fastq import Ragged, lens_to_offsets, ragged_gather

_SEPS = b" ./:=_-#"          # field separators, kept verbatim in output

_SEP_LUT = np.zeros(256, bool)       # byte -> is-separator (O(1) lookup;
_SEP_LUT[list(_SEPS)] = True         # np.isin costs ~30ms on a 2MB cat)


def _split_fields(names: Ragged) -> Optional[Tuple[np.ndarray, List[Ragged]]]:
    """Split every name into fields at separator bytes.

    Returns (sep_pattern_ok, fields) where fields[i] is the Ragged batch
    of the i-th field across all records — only when every record has
    the SAME separator sequence (count + bytes + positions pattern);
    otherwise None (caller falls back to raw mode).
    """
    cat, offsets = names.cat, names.offsets
    n = len(names)
    if n == 0 or len(cat) == 0:
        return None
    is_sep = _SEP_LUT[cat]
    sep_idx = np.flatnonzero(is_sep)
    # record id of every separator
    rec_of = np.searchsorted(offsets, sep_idx, side="right") - 1
    seps_per_rec = np.bincount(rec_of, minlength=n)
    if not (seps_per_rec == seps_per_rec[0]).all():
        return None
    k = int(seps_per_rec[0])
    if k == 0:
        fields = [names]
        return np.empty((n, 0), np.uint8), fields
    sep_bytes = cat[sep_idx].reshape(n, k)
    if not (sep_bytes == sep_bytes[0]).all():
        return None
    # field i of record r: between sep i-1 and sep i (rel. to record)
    sep_pos = sep_idx.reshape(n, k)
    starts = np.concatenate([offsets[:-1, None], sep_pos + 1], axis=1)
    ends = np.concatenate([sep_pos, offsets[1:, None]], axis=1)
    fields = []
    for i in range(k + 1):
        lens = (ends[:, i] - starts[:, i]).astype(np.int64)
        fields.append(Ragged(ragged_gather(cat, starts[:, i], lens),
                             lens_to_offsets(lens)))
    return sep_bytes, fields


def _numeric_column(f: Ragged) -> Optional[np.ndarray]:
    """Parse a field as non-negative decimal ints, vectorized; None if not
    numeric or has leading zeros (which wouldn't round-trip)."""
    lens = f.lens
    if len(f) == 0 or (lens == 0).any() or (lens > 18).any():
        return None
    cat = f.cat
    if not ((cat >= ord("0")) & (cat <= ord("9"))).all():
        return None
    # leading zeros break re-rendering
    first = f.cat[f.offsets[:-1]]
    if ((first == ord("0")) & (lens > 1)).any():
        return None
    # horner, vectorized over the ragged cat; exact int64 segment sums
    # via reduceat (np.add.at is ~10x slower on this shape)
    digits = (cat - ord("0")).astype(np.int64)
    off = f.offsets[:-1]
    pos_in_rec = np.arange(len(cat), dtype=np.int64) - np.repeat(off, lens)
    p10 = 10 ** (np.repeat(lens, lens) - 1 - pos_in_rec)
    return np.add.reduceat(digits * p10, off)


def _zigzag(d: np.ndarray) -> np.ndarray:
    return ((d << 1) ^ (d >> 63)).astype(np.uint64)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.uint64)
    return ((z >> np.uint64(1)) ^ (np.uint64(0) - (z & np.uint64(1)))
            ).astype(np.int64)


def _encode_fields_native(names: Ragged, n: int,
                          arrays: Dict[str, np.ndarray],
                          deflate: Dict[str, int]) -> bool:
    """One-pass native analysis producing the SAME arrays as the numpy
    path (const > numeric > raw per field); False -> caller falls back."""
    if n == 0 or names.cat.size == 0:
        return False          # numpy path also treats these as raw mode
    try:
        from scalce_tpu_torch import native
        if not native.AVAILABLE or not hasattr(native, "analyze_names"):
            return False
        res = native.analyze_names(names.cat, names.offsets, n,
                                   _SEP_LUT.view(np.uint8))
    except Exception:
        return False
    if res is None:
        return False
    sep_bytes, field_lens, vals, flags = res
    nf = field_lens.shape[1]
    arrays["mode"] = np.asarray([1], np.uint8)
    arrays["seps"] = sep_bytes
    arrays["n_fields"] = np.asarray([nf], np.int64)
    # field start offsets: offsets[r] + sum of earlier lens + i seps
    starts = None
    f0_start = names.offsets[0]
    lens0 = field_lens[0].astype(np.int64)
    f0_starts = f0_start + np.concatenate(
        ([0], np.cumsum(lens0[:-1] + 1)))
    for i in range(nf):
        lens = field_lens[:, i].astype(np.int64)
        if flags[i] & 2:                       # const
            s = int(f0_starts[i])
            arrays[f"f{i}_const"] = names.cat[s: s + int(lens0[i])].copy()
        elif flags[i] & 1:                     # numeric
            col = vals[i]
            delta = np.diff(col, prepend=col[0])
            delta[0] = col[0]
            arrays[f"f{i}_num"] = _zigzag(delta)
            # level 3 beats level 6 on zig-zag delta columns in BOTH
            # size and speed (measured: 0.115MB/3.0ms vs 0.140MB/10.8ms
            # on the bench's running-index field)
            deflate[f"f{i}_num"] = 3
        else:                                  # raw
            if starts is None:
                fl = field_lens.astype(np.int64)
                starts = (names.offsets[:-1, None]
                          + np.concatenate(
                              [np.zeros((n, 1), np.int64),
                               np.cumsum(fl[:, :-1] + 1, axis=1)],
                              axis=1))
            arrays[f"f{i}_cat"] = ragged_gather(names.cat,
                                                starts[:, i], lens)
            arrays[f"f{i}_lens"] = lens.astype(np.uint32)
            deflate[f"f{i}_cat"] = 6
            deflate[f"f{i}_lens"] = 6
    return True


def encode(names: Ragged, n_reads: int, level: int = 6,
           backend: str = "gz") -> bytes:
    """Tokenized name payload for one block (names already reordered)."""
    names = Ragged(names.cat[: int(names.offsets[n_reads])],
                   names.offsets[: n_reads + 1].copy())
    arrays: Dict[str, np.ndarray] = {
        "n": np.asarray([n_reads], np.int64)}
    deflate: Dict[str, int] = {}
    if _encode_fields_native(names, n_reads, arrays, deflate):
        return container.pack_arrays(arrays, deflate=deflate, level=level,
                                     backend=backend)
    split = _split_fields(names)
    if split is None:
        arrays["mode"] = np.asarray([0], np.uint8)
        arrays["raw_cat"] = names.cat
        arrays["raw_lens"] = names.lens.astype(np.uint32)
        deflate["raw_cat"] = 6
        deflate["raw_lens"] = 6
    else:
        sep_bytes, fields = split
        arrays["mode"] = np.asarray([1], np.uint8)
        arrays["seps"] = sep_bytes[0] if len(sep_bytes) else \
            np.empty(0, np.uint8)
        arrays["n_fields"] = np.asarray([len(fields)], np.int64)
        for i, f in enumerate(fields):
            col = _numeric_column(f)
            lens = f.lens
            const = (len(f) > 0 and (lens == lens[0]).all()
                     and (np.all(f.cat.reshape(len(f), -1)
                                 == f.cat[: lens[0]][None, :])
                          if lens[0] > 0 else True))
            if const:
                arrays[f"f{i}_const"] = f.cat[: int(lens[0])].copy()
            elif col is not None:
                delta = np.diff(col, prepend=col[0])
                delta[0] = col[0]
                arrays[f"f{i}_num"] = _zigzag(delta)
                deflate[f"f{i}_num"] = 3
            else:
                arrays[f"f{i}_cat"] = f.cat
                arrays[f"f{i}_lens"] = lens.astype(np.uint32)
                deflate[f"f{i}_cat"] = 6
                deflate[f"f{i}_lens"] = 6
    return container.pack_arrays(arrays, deflate=deflate, level=level,
                                 backend=backend)


def decode(blob: bytes) -> Ragged:
    a = container.unpack_arrays(blob)
    n = int(a["n"][0])
    if int(a["mode"][0]) == 0:
        lens = a["raw_lens"].astype(np.int64)
        if int(lens.sum()) != a["raw_cat"].size or (lens < 0).any():
            raise ValueError("corrupt name stream: raw lens mismatch")
        return Ragged(a["raw_cat"].copy(), lens_to_offsets(lens))
    seps = a["seps"]
    k = int(a["n_fields"][0])
    try:
        from scalce_tpu_torch import native as _nat
        nat_join = _nat.AVAILABLE and hasattr(_nat, "join_fields")
    except Exception:  # pragma: no cover
        nat_join = False
    if nat_join and n > 0:
        # (cat, offsets, is_const) triples; const fields are NOT tiled —
        # the native join re-reads their single value per record
        cols2 = []
        rec_lens = np.full(n, max(k - 1, 0), np.int64)   # separators
        for i in range(k):
            if f"f{i}_num" in a:
                vals = np.cumsum(_unzigzag(a[f"f{i}_num"]))
                if vals.shape[0] != n:
                    raise ValueError("corrupt name stream: column length")
                strs = _render_ints(vals)
                cols2.append((strs.cat, strs.offsets, False))
                rec_lens += strs.lens
            elif f"f{i}_const" in a:
                c = a[f"f{i}_const"]
                cols2.append((c, np.asarray([0, c.size], np.int64), True))
                rec_lens += c.size
            else:
                lens = a[f"f{i}_lens"].astype(np.int64)
                cat = a[f"f{i}_cat"]
                if (lens.shape[0] != n or (lens < 0).any()
                        or int(lens.sum()) != cat.size):
                    raise ValueError("corrupt name stream: column length")
                cols2.append((cat, lens_to_offsets(lens), False))
                rec_lens += lens
        if seps.size < max(k - 1, 0):
            raise ValueError("corrupt name stream: separators short")
        off = lens_to_offsets(rec_lens)
        out = _nat.join_fields(cols2, seps, n, off)
        return Ragged(out, off)
    cols: List[Ragged] = []
    for i in range(k):
        if f"f{i}_num" in a:
            delta = _unzigzag(a[f"f{i}_num"])
            vals = np.cumsum(delta)
            strs = _render_ints(vals)
            cols.append(strs)
        elif f"f{i}_const" in a:
            c = a[f"f{i}_const"]
            lens = np.full(n, len(c), np.int64)
            cols.append(Ragged(np.tile(c, n), lens_to_offsets(lens)))
        else:
            lens = a[f"f{i}_lens"].astype(np.int64)
            cols.append(Ragged(a[f"f{i}_cat"].copy(), lens_to_offsets(lens)))
    return _join_fields(cols, seps, n)


def _render_ints(vals: np.ndarray) -> Ragged:
    """int64 column -> decimal ASCII, vectorized."""
    n = len(vals)
    if n == 0:
        return Ragged(np.empty(0, np.uint8), np.zeros(1, np.int64))
    from scalce_tpu_torch import native
    if native.AVAILABLE and vals.min() >= 0:
        cat, off = native.render_ints_i64(vals)
        return Ragged(cat, off)
    lens = np.char.str_len(vals.astype("U")).astype(np.int64)
    total = int(lens.sum())
    out = np.zeros(total, np.uint8)
    off = lens_to_offsets(lens)
    rec = np.repeat(np.arange(n), lens)
    pos = np.arange(total, dtype=np.int64) - np.repeat(off[:-1], lens)
    p10 = 10 ** (np.repeat(lens, lens) - 1 - pos)
    out[:] = (vals[rec] // p10) % 10 + ord("0")
    return Ragged(out, off)


def _join_fields(cols: List[Ragged], seps: np.ndarray, n: int) -> Ragged:
    k = len(seps)
    field_lens = np.stack([c.lens for c in cols], axis=1)  # [n, k+1]
    rec_lens = field_lens.sum(axis=1) + k
    off = lens_to_offsets(rec_lens)
    out = np.zeros(int(off[-1]), np.uint8)
    from scalce_tpu_torch.io.fastq import ragged_scatter
    cursor = off[:-1].copy()
    for i, c in enumerate(cols):
        ragged_scatter(out, cursor, c.cat, c.lens)
        cursor = cursor + c.lens
        if i < k:
            out[cursor] = seps[i]
            cursor = cursor + 1
    return Ragged(out, off)


def template_names(lib: str, start: int, count: int) -> Ragged:
    """Regenerated ``lib.N`` names for template mode (``-n``)."""
    vals = np.arange(start, start + count, dtype=np.int64)
    nums = _render_ints(vals)
    prefix = np.frombuffer(f"{lib}.".encode(), np.uint8)
    lens = nums.lens + len(prefix)
    off = lens_to_offsets(lens)
    out = np.zeros(int(off[-1]), np.uint8)
    from scalce_tpu_torch.io.fastq import ragged_scatter
    ragged_scatter(out, off[:-1],
                   np.tile(prefix, count), np.full(count, len(prefix),
                                                   np.int64))
    ragged_scatter(out, off[:-1] + len(prefix), nums.cat, nums.lens)
    return Ragged(out, off)
