# Frozen copy of synth_fastq from scalce_tpu_torch/utils/synth.py, which
# is itself a copy of scalce_tpu/utils/synth.py.  Differences: the decimal
# renderer and the ragged copies below are plain numpy (no native
# library), and ``first_index`` (default 1, the original's) numbers the
# names.  A test holds it to the original byte for byte.
"""Seeded synthetic FASTQ records, the benchmark's own generator: it
imports nothing of the program, so a change to the program cannot change
the benchmark's inputs."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _render_int_column(vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Non-negative int column -> (concatenated decimal ASCII, lengths)."""
    vals = vals.astype(np.int64)
    lens = np.ones(len(vals), np.int64)
    for k in range(1, 19):
        lens += vals >= 10 ** k
    total = int(lens.sum())
    off = np.zeros(len(vals) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    rec = np.repeat(np.arange(len(vals)), lens)
    pos = np.arange(total, dtype=np.int64) - np.repeat(off[:-1], lens)
    p10 = 10 ** (np.repeat(lens, lens) - 1 - pos)
    cat = ((vals[rec] // p10) % 10 + ord("0")).astype(np.uint8)
    return cat, lens


def ragged_gather(buf: np.ndarray, starts: np.ndarray,
                  lens: np.ndarray) -> np.ndarray:
    """Concatenate ``buf[starts[i]:starts[i]+lens[i]]``."""
    total = int(lens.sum())
    if total == 0:
        return buf[:0]
    off = np.concatenate(([0], np.cumsum(lens)[:-1]))
    idx = np.repeat(starts - off, lens) + np.arange(total, dtype=np.int64)
    return buf[idx]


def ragged_scatter(dst: np.ndarray, dst_starts: np.ndarray,
                   src_cat: np.ndarray, lens: np.ndarray) -> None:
    """Inverse of :func:`ragged_gather`: write concatenated rows into dst."""
    total = int(lens.sum())
    if total == 0:
        return
    off = np.concatenate(([0], np.cumsum(lens)[:-1]))
    idx = np.repeat(dst_starts - off, lens) + np.arange(total, dtype=np.int64)
    dst[idx] = src_cat


def synth_fastq(n_reads: int, read_len: int = 100, *, seed: int = 0,
                genome_len: int = 100_000, n_rate: float = 0.002,
                var_len: bool = False, qual_model: str = "illumina",
                name_style: str = "sra", rc_rate: float = 0.0,
                mate: Optional[int] = None,
                genome: Optional[np.ndarray] = None,
                first_index: int = 1) -> bytes:
    """Generate a FASTQ payload as bytes (vectorized).  ``first_index``
    numbers the first record's name (the rest follow it); 1 gives the
    original's bytes.

    qual_model:
      "illumina" — position-dependent mean with noise (pre-binning
                   platforms; near worst case for the quality coder)
      "hiseq"    — cycle-correlated pre-binning profile: per-CYCLE
                   systematic anomalies (a handful of columns are
                   consistently worse across ALL reads — chemistry /
                   phasing-reset artifacts), position-dependent
                   variance, end-of-read degradation, AR(1) residual.
                   The column-specific structure is what fine position
                   contexts (order 3, col/4 buckets) capture and the
                   coarse col/16 buckets smear (VERDICT r3 #4).
      "binned"   — RTA3-style 4-level binning (modern Illumina)
      "uniform"  — uniform random over the full range (incompressible)
      "const"    — constant 'I'
    """
    rng = np.random.default_rng(seed)
    L = read_len
    if genome is None:
        genome_len = max(genome_len, L + 1)  # genome must fit one read
        genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    else:
        genome = np.asarray(genome, np.uint8)
        genome_len = len(genome)
    starts = rng.integers(0, genome_len - L, size=n_reads)
    if var_len:
        # lengths in [max(20, L/2), L]; short reads (L <= 20) still get
        # variation from [max(1, L/2), L] instead of degenerating to L
        lo = max(20, L // 2) if L > 20 else max(1, L // 2)
        lens = rng.integers(lo, L + 1, size=n_reads)
    else:
        lens = np.full(n_reads, L, dtype=np.int64)

    # bases [n, L] then masked to lens
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    err = rng.random((n_reads, L)) < 0.005
    codes = np.where(err, rng.integers(0, 4, size=(n_reads, L),
                                       dtype=np.uint8), codes)
    if rc_rate > 0:
        # sample both strands, as real sequencers do
        flip = rng.random(n_reads) < rc_rate
        src = lens[:, None] - 1 - np.arange(L)[None, :]
        rc_codes = 3 - np.take_along_axis(codes, np.maximum(src, 0), axis=1)
        rc_codes = np.where(src >= 0, rc_codes, 0).astype(np.uint8)
        codes = np.where(flip[:, None], rc_codes, codes)
    bases = _BASES[codes]
    if n_rate > 0:
        nmask = rng.random((n_reads, L)) < n_rate
        bases = np.where(nmask, np.uint8(ord("N")), bases)

    if qual_model == "illumina":
        # Pre-binning Illumina structure: position-dependent mean with
        # 3'-end degradation, a per-read quality offset (good/bad
        # clusters), an AR(1) walk along the read (serial correlation —
        # what the reference's adaptive order-k AC exploits), and rare
        # low-quality bursts.  iid noise would make qualities
        # memoryless given position, which no real instrument is.
        pos_mean = 38.0 - 12.0 * (np.arange(L) / max(L - 1, 1)) ** 2
        read_off = rng.normal(0, 2.0, size=(n_reads, 1))
        rho = 0.85
        # AR walk transposed ([L, n]) so each step is a contiguous row
        innov = rng.normal(0, 3.0 * np.sqrt(1 - rho * rho),
                           size=(L, n_reads))
        e = np.empty((L, n_reads))
        e[0] = innov[0] / np.sqrt(1 - rho * rho)
        for j in range(1, L):
            np.multiply(e[j - 1], rho, out=e[j])
            e[j] += innov[j]
        q = pos_mean[None, :] + read_off + e.T
        # bursts: ~2% of reads get one 5-20bp stretch pulled toward Q2
        n_burst = int(n_reads * 0.02)
        if n_burst:
            rows = rng.choice(n_reads, size=n_burst, replace=False)
            bstart = rng.integers(0, max(L - 5, 1), size=n_burst)
            blen = rng.integers(5, 21, size=n_burst)
            bcol = np.arange(L)[None, :]
            hit = (bcol >= bstart[:, None]) & (bcol < (bstart + blen)[:, None])
            q[rows] = np.where(hit, q[rows] - 25.0, q[rows])
        q = np.clip(q, 2, 40)
        qual = (q.astype(np.int64) + 33).astype(np.uint8)
    elif qual_model == "hiseq":
        # cycle-correlated profile: the information the order-3 model's
        # fine (col/4) position buckets can use lives in COLUMN
        # structure shared by every read of the run
        frac = np.arange(L) / max(L - 1, 1)
        pos_mean = 37.0 - 9.0 * frac ** 2
        # per-cycle systematic anomalies: ~L/12 columns consistently
        # depressed (phasing resets / chemistry refills); fixed per seed
        n_anom = max(1, L // 12)
        anom_cols = rng.choice(L, size=n_anom, replace=False)
        anom_depth = rng.uniform(4.0, 10.0, size=n_anom)
        pos_mean = pos_mean.copy()
        pos_mean[anom_cols] -= anom_depth
        # position-dependent variance: clean early cycles, noisy late
        pos_sd = 1.2 + 2.8 * frac
        read_off = rng.normal(0, 1.5, size=(n_reads, 1))
        rho = 0.8
        innov = rng.normal(0, 1.0, size=(L, n_reads))
        e = np.empty((L, n_reads))
        e[0] = innov[0]
        for j in range(1, L):
            np.multiply(e[j - 1], rho, out=e[j])
            e[j] += innov[j] * np.sqrt(1 - rho * rho)
        q = pos_mean[None, :] + read_off + e.T * pos_sd[None, :]
        q = np.clip(q, 2, 40)
        qual = (q.astype(np.int64) + 33).astype(np.uint8)
    elif qual_model == "binned":
        # modern Illumina bins: {2, 12, 23, 37}, heavily skewed to Q37
        levels = np.array([2, 12, 23, 37])
        probs = np.array([0.02, 0.03, 0.10, 0.85])
        q = rng.choice(levels, size=(n_reads, L), p=probs)
        qual = (q + 33).astype(np.uint8)
    elif qual_model == "uniform":
        qual = rng.integers(33, 74, size=(n_reads, L)).astype(np.uint8)
    else:
        qual = np.full((n_reads, L), ord("I"), np.uint8)

    # names as (cat, lens)
    idx = np.arange(first_index, first_index + n_reads, dtype=np.int64)
    if name_style == "sra":
        # SRR000001.{i} {i} length={len}
        n1c, n1l = _render_int_column(idx)
        n2c, n2l = _render_int_column(lens)
        pre = np.frombuffer(b"SRR000001.", np.uint8)
        mid = np.frombuffer(b" ", np.uint8)
        tail = np.frombuffer(b" length=", np.uint8)
        parts_lens = [np.full(n_reads, len(pre), np.int64), n1l,
                      np.full(n_reads, 1, np.int64), n1l,
                      np.full(n_reads, len(tail), np.int64), n2l]
        parts_cats = [np.tile(pre, n_reads), n1c,
                      np.tile(mid, n_reads), n1c,
                      np.tile(tail, n_reads), n2c]
    elif name_style == "illumina":
        tile = 1101 + (idx - 1) % 16
        x = 1000 + (idx - 1) * 7 % 20000
        y = 2000 + (idx - 1) * 13 % 20000
        m = mate if mate is not None else 1
        tc, tl = _render_int_column(tile)
        xc, xl = _render_int_column(x)
        yc, yl = _render_int_column(y)
        pre = np.frombuffer(b"MACHINE1:42:FLOWCELL:1:", np.uint8)
        colon = np.frombuffer(b":", np.uint8)
        tail = np.frombuffer(f" {m}:N:0:ACGTACGT".encode(), np.uint8)
        parts_lens = [np.full(n_reads, len(pre), np.int64), tl,
                      np.full(n_reads, 1, np.int64), xl,
                      np.full(n_reads, 1, np.int64), yl,
                      np.full(n_reads, len(tail), np.int64)]
        parts_cats = [np.tile(pre, n_reads), tc,
                      np.tile(colon, n_reads), xc,
                      np.tile(colon, n_reads), yc,
                      np.tile(tail, n_reads)]
    else:
        ic, il = _render_int_column(idx - 1)
        pre = np.frombuffer(b"read", np.uint8)
        parts_lens = [np.full(n_reads, len(pre), np.int64), il]
        parts_cats = [np.tile(pre, n_reads), ic]

    name_lens = np.sum(parts_lens, axis=0)
    # record = '@' name '\n' seq '\n' '+' '\n' qual '\n'
    rec_lens = 1 + name_lens + 1 + lens + 3 + lens + 1
    rec_off = np.zeros(n_reads + 1, np.int64)
    np.cumsum(rec_lens, out=rec_off[1:])
    out = np.empty(int(rec_off[-1]), np.uint8)

    cursor = rec_off[:-1].copy()
    out[cursor] = ord("@")
    cursor += 1
    for pl_, pc in zip(parts_lens, parts_cats):
        ragged_scatter(out, cursor, pc, pl_)
        cursor = cursor + pl_
    out[cursor] = 10
    cursor += 1
    seq_starts = np.arange(n_reads, dtype=np.int64) * L
    ragged_scatter(out, cursor, ragged_gather(bases.reshape(-1), seq_starts,
                                              lens), lens)
    cursor = cursor + lens
    out[cursor] = 10
    out[cursor + 1] = ord("+")
    out[cursor + 2] = 10
    cursor = cursor + 3
    ragged_scatter(out, cursor, ragged_gather(qual.reshape(-1), seq_starts,
                                              lens), lens)
    out[cursor + lens] = 10
    return out.tobytes()
