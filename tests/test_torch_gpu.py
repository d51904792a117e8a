"""scalce_tpu_torch's CUDA kernels against their plain torch versions,
and the card's compress (single-device and data-parallel; single-end,
paired and lossy) against the CPU's, on small and awkward shapes.

These need a CUDA card and skip without one.  They import no jax, so on
a machine with the card but without jax they run as

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from scalce_tpu_torch.models import entropy
from scalce_tpu_torch.ops import compact, core_match, core_rank, \
    delta_seq, hist, histogram, rans, \
    rans_decode, rans_encode, rans_encode_flat
from scalce_tpu_torch.streams import qualities

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _narrowed(encoded):
    """An encoder's plain ``(states, words, emits)`` with the int32 words
    narrowed to the int16 holding their u16 bits, as the kernels write
    them."""
    states, words, emits = encoded
    return states, words.to(torch.int16), emits


@pytest.mark.parametrize("B,L,k", [(1, 12, 12), (1, 128, 12), (37, 101, 12),
                                   (1000, 128, 12), (513, 200, 15),
                                   (300, 160, 4), (64, 17, 16),
                                   (257, 131, 1)])
def test_core_rank_kernel(cuda, B, L, k):
    """K1 from the codes against its plain version: one read, rows not a
    multiple of 4 or 16 bytes, rows longer than a warp's 128 bytes,
    rank ties (homopolymers), empty and short reads, all-N reads."""
    rng = np.random.default_rng(B + L + k)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[: B // 3, : L // 2] = 2                  # ties inside rows
    lengths = rng.integers(0, L + 1, B)
    lengths[B // 2:: 7] = 0                        # empty reads
    lengths[B // 2 + 1:: 7] = k - 1                # shorter than k
    exc = rng.random((B, L)) < 0.02
    exc[B // 5:: 11] = True                        # all-N reads
    args = [torch.from_numpy(a).to(cuda) for a in (codes, exc, lengths)]
    _equal(core_rank.core_rank_codes(*args, k, 0x5CA1CE),
           core_rank.core_rank_codes_plain(*args, k, 0x5CA1CE))


def test_core_rank_kernel_rejects_bad_k(cuda):
    codes = torch.zeros((4, 16), dtype=torch.uint8, device=cuda)
    exc = torch.zeros((4, 16), dtype=torch.bool, device=cuda)
    lengths = torch.full((4,), 16, device=cuda)
    for k in (0, 17):
        with pytest.raises(ValueError):
            core_rank.core_rank_codes(codes, exc, lengths, k, 1)


def _pass_a_inputs(cuda, B, L, seed, n_empty=3):
    """Ragged qualities whose first ``n_empty`` reads are empty."""
    rng = np.random.default_rng(seed)
    walk = np.clip(np.cumsum(rng.integers(-2, 3, (B, L)), axis=1) + 38,
                   2, 80) + 33
    walk[:, :: 9] = rng.integers(0, 256, walk[:, :: 9].shape)  # any byte
    lengths = rng.integers(1, L + 1, B).astype(np.int32)
    lengths[:n_empty] = 0
    return (torch.from_numpy(walk.astype(np.uint8)).to(cuda),
            torch.from_numpy(lengths).to(cuda))


def _lossy_map(cuda):
    """A -p 30 map (models/lossy.py) from a walk histogram."""
    from scalce_tpu_torch.models import lossy
    hist = np.bincount(np.clip(np.arange(2, 81), 0, 93), minlength=94)
    return torch.from_numpy(lossy.build_quant_map(hist * 7, 30)).to(cuda)


def _grids(cuda, order, B, L, seed, n_empty=3):
    qual, lengths = _pass_a_inputs(cuda, B, L, seed, n_empty)
    return qualities.sym_ctx_hist(qual, lengths, order), lengths


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("B,L", [(1, 128), (300, 101), (300, 128),
                                 (300, 160), (257, 200)])
@pytest.mark.parametrize("mode", ["hist", "lut", "grids"])
def test_hist_kernel(cuda, order, B, L, mode):
    """K2 (pass A from the quality bytes) against its plain version:
    lossless or through a -p 30 LUT, with or without the histogram."""
    qual, lengths = _pass_a_inputs(cuda, B, L, order * L + B)
    qmap = _lossy_map(cuda) if mode == "lut" else None
    histogram = mode != "grids"
    got = qualities.sym_ctx_hist(qual, lengths, order, qmap, histogram)
    want = qualities.sym_ctx_hist_plain(qual, lengths, order, qmap,
                                        histogram)
    _equal(got[:2], want[:2])
    if histogram:
        _equal(got[2:], want[2:])
        R, PB, _ = qualities._slab_spec(order)
        _equal(got[2:], (hist.hist_ctx_plain(got[0], got[1], R, PB),))
    else:
        assert got[2] is None and want[2] is None


def _encode_blocks(cuda, order, D, B, L, T_target, seed, empty_lane=False):
    """D blocks' grids encoded by K3 (each against its plain version),
    then K4's inputs."""
    T = qualities.pick_T(B, L, T_target)
    encs, lens = [], []
    for d in range(D):
        # with empty_lane, lane 0 of block 0 holds only empty reads: its
        # word stream is empty
        (sym, ctx, counts), lengths = _grids(
            cuda, order, B, L, seed + d,
            n_empty=T // L if empty_lane and d == 0 else 3)
        freq, cum = entropy.device_normalize(
            counts, qualities.n_contexts(order), qualities.N_SYMS)
        want = rans_encode.encode_scan_plain(sym, ctx, freq, cum, T, order)
        out = rans_encode.encode_scan(sym, ctx, freq, cum, T, order)
        assert want[1].dtype == torch.int32
        _equal(out, _narrowed(want))
        packed, wc = rans.compact_emissions(out[1], out[2])
        if empty_lane and d == 0:
            assert int(wc[0]) == 0
        encs.append(qualities.finish_encoded(freq, out[0], packed, wc, B, L,
                                             T, order))
        lens.append(lengths.cpu().numpy())
    return qualities.decode_inputs(encs, lens, cuda), T


def _check_decode(x, order, T, L):
    args = (x["states"], x["words"], x["freq"], x["lengths"], order, T, L)
    want = rans_decode.decode_quals_plain(*args)
    assert want.dtype == torch.uint8
    assert torch.equal(rans_decode.decode_quals(*args), want)
    # every byte of the grid is written: none of the fill survives
    launch, out = rans_decode.prepare(*args)
    out.fill_(7)
    launch()
    assert torch.equal(out, want)
    assert torch.equal(rans_decode.decode_scan(*args),
                       rans_decode.decode_scan_plain(*args))


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("D", [1, 4])
def test_rans_encode_and_decode_kernels(cuda, order, D):
    """Ragged lengths, all-padding reads, lane 0 of block 0 with no
    words; K3 and K4 (decode_quals and decode_scan) exactly equal to
    their plain versions."""
    B, L = 512, 64
    x, T = _encode_blocks(cuda, order, D, B, L, 1024, 10 * order,
                          empty_lane=True)
    _check_decode(x, order, T, L)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_rans_kernels_unaligned_lanes(cuda, order):
    """L = 101 and T = 404 (qual_T_target 512): T % 16 != 0, so lane
    starts are not 16-byte aligned and the decode's head and tail bytes
    go out one at a time; L is odd, so K3 loads cell by cell."""
    B, L = 400, 101
    x, T = _encode_blocks(cuda, order, 3, B, L, 512, 50 + order)
    assert T == 404
    _check_decode(x, order, T, L)


def test_reciprocal_divide_is_exact(cuda):
    """K3's reciprocal divide over every f in 1..4096 at x = k*f - 1,
    k*f and (f << 20) - 1, and at 10**6 random (x, f) with x < f << 20."""
    f = np.arange(1, 4097, dtype=np.int64)
    ks = np.array([1, 2, 3, 5, 255, 256, 4097, 65535, 65537,
                   (1 << 20) - 1], np.int64)
    xs = np.concatenate([(ks[:, None] * f[None, :] - 1).reshape(-1),
                         (ks[:, None] * f[None, :]).reshape(-1),
                         (f << 20) - 1, np.zeros(1, np.int64)])
    fs = np.concatenate([np.tile(f, 2 * len(ks)), f, [1]])
    rng = np.random.default_rng(11)
    fr = rng.integers(1, 4097, 10 ** 6)
    xr = (rng.random(10 ** 6) * (fr << 20)).astype(np.int64)
    xs, fs = np.concatenate([xs, xr]), np.concatenate([fs, fr])
    assert (xs < fs << 20).all() and (xs >= 0).all()
    q, r = rans_encode.divmod_recip(torch.from_numpy(xs).to(cuda),
                                    torch.from_numpy(fs).to(cuda))
    np.testing.assert_array_equal(q.cpu().numpy(), xs // fs)
    np.testing.assert_array_equal(r.cpu().numpy(), xs % fs)


@pytest.mark.parametrize("S,n_cells", [(1, 3), (777, 94), (100_003, 71_534),
                                       (3_000_001, 286_136), (200_000, 95)])
def test_histogram_kernel(cuda, S, n_cells):
    """The flat entry on int64 indices: shared-memory tables up to
    102,400 cells, global atomics above."""
    rng = np.random.default_rng(S)
    idx = rng.integers(0, n_cells, S)
    idx[: S // 4] = 0                     # one hot cell, as padding is
    idx[S // 4: S // 3] = n_cells - 1     # a run of another
    idx = torch.from_numpy(idx).to(cuda)
    got = histogram.histogram(idx, n_cells)
    assert got.dtype == torch.int32
    assert torch.equal(got, histogram.histogram_plain(idx, n_cells))
    assert int(got.sum()) == S


@pytest.mark.parametrize("T,N", [(1, 1), (64, 1000), (2048, 333), (7, 50)])
def test_rans_encode_flat_kernel(cuda, T, N):
    """K5 on one block of random cells (a full-mass row, f = 4096), even
    and odd T: ``rans.rans_encode`` on the card equals the Pallas
    contract on the gathered (f, cum)."""
    rng = np.random.default_rng(T + N)
    n_ctx, n_syms = 20, 94
    sym = rng.integers(0, n_syms, T * N)
    ctx = rng.integers(0, n_ctx, T * N)
    sym[ctx == 0] = 0                     # a full-mass row, f = 4096
    counts = np.zeros((n_ctx, n_syms), np.int64)
    np.add.at(counts, (ctx, sym), 1)
    freq, cum = entropy.device_normalize(torch.from_numpy(counts.reshape(-1)),
                                         n_ctx, n_syms)
    args = (torch.from_numpy(sym).to(cuda), torch.from_numpy(ctx).to(cuda),
            freq.reshape(-1).to(cuda), cum.reshape(-1).to(cuda), n_syms, T)
    _equal(rans.rans_encode(*args),
           _narrowed(rans_encode_flat.encode_scan_flat_plain(
               *rans.gather_tables(*args))))


def _group_grids(cuda, order, D, B, L, seed):
    """D blocks' grids from ragged qualities (K2 on the card), stacked as
    a data-parallel device's share, with their histograms."""
    grids = [_grids(cuda, order, B, L, seed + d)[0] for d in range(D)]
    sym = torch.stack([g[0] for g in grids])
    ctx = torch.stack([g[1] for g in grids])
    return sym, ctx, torch.stack([g[2] for g in grids])


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("B,L", [(300, 128), (257, 160), (64, 101)])
def test_grid_histogram_kernel(cuda, order, D, B, L):
    """K6 from D blocks' grids (shared-memory tables at order 1, global
    at orders 2 and 3) against its plain version and against each
    block's K2 histogram."""
    sym, ctx, counts = _group_grids(cuda, order, D, B, L, 7 * order + D)
    C = qualities.n_contexts(order)
    got = histogram.grid_histogram(sym, ctx, C, qualities.N_SYMS)
    assert got.dtype == torch.int32
    _equal((got,), (histogram.grid_histogram_plain(sym, ctx, C,
                                                   qualities.N_SYMS),))
    _equal((got.reshape(D, -1),), (counts,))
    assert torch.equal(qualities.group_histogram(sym, ctx, order),
                       counts)


@pytest.mark.parametrize("n_ctx", [761, 3041])
def test_grid_histogram_kernel_hot_cell(cuda, n_ctx):
    """Every cell of two 2^23-cell blocks in one non-padding cell, but a
    stripe of padding and of another cell: 137 tiles per block, so some
    CTAs count more than 65,535 of the hot cell between launches; its
    count must be exact (u16 counters are flushed per tile)."""
    S, n_syms = 1 << 23, 94
    sym = torch.full((2, S), 7, dtype=torch.int64, device=cuda)
    ctx = torch.full((2, S), 5, dtype=torch.int64, device=cuda)
    ctx[:, ::97] = 0
    sym[:, ::97] = 0
    ctx[1, 1::3] = 6
    got = histogram.grid_histogram(sym, ctx, n_ctx, n_syms)
    want = histogram.grid_histogram_plain(sym, ctx, n_ctx, n_syms)
    _equal((got,), (want,))
    assert int(want[5 * n_syms + 7]) > 8 * 65535
    assert int(got.sum()) == 2 * S


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("B,L,T_target", [(512, 128, 2048), (300, 160, 512),
                                          (64, 101, 64)])
def test_encode_grids_kernel(cuda, order, D, B, L, T_target):
    """K5 from D blocks' grids against their own tables (the
    data-parallel pass B) against its plain version; L = 101 with T = 101
    takes the kernel's single-cell loads."""
    sym, ctx, counts = _group_grids(cuda, order, D, B, L, 3 * order + D)
    C = qualities.n_contexts(order)
    freq, cum = entropy.device_normalize(counts, C, qualities.N_SYMS)
    T = qualities.pick_T(B, L, T_target)
    _equal(rans_encode_flat.encode_grids(sym, ctx, freq, cum, T),
           _narrowed(rans_encode_flat.encode_grids_plain(sym, ctx, freq,
                                                         cum, T)))
    # and each block's stream is its single-block pass B's (K3)
    got = qualities.group_encode(sym, ctx, counts, T, order)
    for d in range(D):
        one = qualities.encode_from_grids(sym[d], ctx[d], counts[d], B, L,
                                          order, T_target)
        enc = qualities.finish_encoded(got[0][d], got[1][d], got[2][d],
                                       got[3][d], B, L, T, order)
        for field in ("freq", "states", "counts", "words"):
            np.testing.assert_array_equal(getattr(enc, field),
                                          getattr(one, field))


def _delta_block(seed, B, L, max_len, n_reads, case):
    """Stage A's outputs for a sorted block (``tests/test_torch_delta_seq.
    py::delta_block``'s shapes): reads of up to ``max_len`` bases from a
    genome of 3L in core buckets of 1-7 rows, 5% substitutions, padding
    rows past ``n_reads``; ``ties`` repeats each read once, ``no_core``
    puts a third of the rows at NO_CORE, ``all_literal`` gives each row
    its own core, ``edge_shift`` alternates cp between 0 and L - 1 at full
    length, ``one_bucket`` puts every row in one bucket (it straddles
    each tile boundary of the kernel's plan), ``literal_tile`` gives the
    plan's second tile of rows their own cores."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 3 * L)
    bucket = np.cumsum(rng.integers(0, 7, B) == 0)
    if case == "one_bucket":
        bucket[:] = 0
    anchor = rng.integers(L, 2 * L, bucket[-1] + 1)
    ln = rng.integers(0, max_len + 1, B)
    cp = np.minimum(rng.integers(0, L, B), np.maximum(ln - 1, 0))
    if case == "edge_shift":
        ln[:] = L
        cp = np.where(np.arange(B) % 2, L - 1, 0)
    ck = bucket.astype(np.int64) * 7919 + 5
    if case == "no_core":
        ck[rng.random(B) < 1 / 3] = core_match.NO_CORE
    if case == "all_literal":
        ck = np.arange(B, dtype=np.int64)
    if case == "literal_tile":
        R = delta_seq.tile_plan(L // 16).rows
        ck[R:2 * R] = 1 << 40 | np.arange(R, 2 * R)
    start = anchor[bucket] - cp
    codes = genome[start[:, None] + np.arange(L)[None, :]].astype(np.uint8)
    mut = rng.random((B, L)) < 0.05
    codes[mut] = rng.integers(0, 4, int(mut.sum()))
    if case == "ties":
        for a in (codes, ln, cp, ck):
            a[1::2] = a[::2][: B // 2]
    codes[np.arange(L)[None, :] >= ln[:, None]] = 0
    ln[n_reads:], ck[n_reads:], cp[n_reads:] = 0, core_match.NO_CORE, 0
    codes[n_reads:] = 0
    return codes, ln.astype(np.int64), ck, cp.astype(np.int64)


@pytest.mark.parametrize("B,L,max_len,case,n_reads", [
    (1, 16, 16, "random", 1), (300, 112, 101, "random", 300),
    (257, 160, 160, "random", 250), (4096, 128, 128, "random", 4000),
    (64, 32752, 32752, "random", 64), (4096, 128, 128, "ties", 4096),
    (4096, 128, 128, "no_core", 4096), (4096, 128, 128, "all_literal", 4096),
    (1024, 128, 128, "edge_shift", 1024),
    (64, 32752, 32752, "edge_shift", 60),
    (513, 128, 128, "random", 513), (4096, 128, 128, "one_bucket", 4096),
    (600, 16, 16, "one_bucket", 600), (700, 144, 144, "random", 650),
    (300, 528, 528, "one_bucket", 290), (40, 32752, 32752, "one_bucket", 40),
    (1024, 128, 128, "literal_tile", 1024),
    (1024, 128, 128, "random", 700)])
def test_delta_seq_kernel(cuda, B, L, max_len, case, n_reads):
    """K7 against its plain version, every output exact (the literal
    words after the download's narrowing to int32): one read, reads of
    up to 101 bases in 112 columns, W = L/16 below, at and far above a
    warp's 32 words (L = 32752, W = 2047), padding rows, ties, NO_CORE,
    all-literal rows, shifts of +-(L-1).  At the tile plan's edges: B
    one row past a multiple of the tile (a last tile of 1 row), a core
    bucket across every tile boundary (candidates in the halo rows), W =
    1, 9, 33 and 2047 (a row's group loops over its words), a tile of
    all-literal rows between matched ones, a last tile of padding rows
    only.  Every output byte is written (the launch alone over outputs
    filled with junk)."""
    rows = delta_seq.tile_plan(L // 16).rows
    if (B, case) == (513, "random"):
        assert B % rows == 1
    if case == "one_bucket":
        assert B > rows
    if n_reads == 700:
        assert B - n_reads >= rows
    arrays = _delta_block(B + L, B, L, max_len, n_reads, case)
    args = [torch.from_numpy(a).to(cuda) for a in arrays] + [n_reads]
    want = delta_seq.delta_seq_plain(*args)
    want["lit_packed"] = want["lit_packed"].to(torch.int32)
    got = delta_seq.delta_seq(*args)
    assert got.keys() == want.keys()
    for name in want:
        _equal((got[name],), (want[name],))
    launch, out = delta_seq.prepare(*args)
    for name in ("mask_bits", "shifts", "pred_k", "lit_packed"):
        out[name].fill_(0x5A)
    launch()
    for name in want:
        _equal((out[name],), (want[name],))
    if case == "edge_shift":
        assert {-(L - 1), L - 1} <= set(want["shifts"].tolist())
    if case == "all_literal":
        assert int(want["n_lits"]) == int(arrays[1].sum())
    if case == "literal_tile":
        bits = want["mask_bits"]
        assert bits[:rows].any() and not bits[rows:2 * rows].any()


def _emissions(cuda, T, N, words=None):
    """Random int16 words (the u16 bits K3 and K5 write, the top bit set
    in half of them) and emits ``[T, N]`` on the card, each lane at its
    own emit rate, lane 0 emitting at every step and lane N-1 at none
    (when N > 1)."""
    rng = np.random.default_rng(T + N)
    if words is None:
        words = torch.empty((T, N), dtype=torch.int16, device=cuda)
    words.copy_(torch.from_numpy(rng.integers(0, 1 << 16, (T, N)).astype(
        np.uint16).view(np.int16)))
    emits = torch.from_numpy(rng.random((T, N)) < rng.random(N)[None, :])
    emits[:, 0] = True
    emits[:, -1] = N == 1
    return words, emits.to(cuda)


def _check_compact(words, emits):
    """K8 (the wrapper, then a launch over junk-filled outputs, so every
    byte must be written) against its plain version on the same int16
    words and on the plain encoders' int32 form narrowed."""
    T, N = words.shape
    want = compact.compact_emissions_plain(words, emits)
    wide_p, wide_c = compact.compact_emissions_plain(
        words.to(torch.int32) & 0xFFFF, emits)
    _equal((wide_p.to(torch.int16), wide_c), want)
    _equal(rans.compact_emissions(words, emits), want)
    launch, out = compact.prepare(words, emits)
    out[0].fill_(-1)
    out[1].fill_(-1)
    launch()
    _equal(out, want)
    assert int(want[1][0]) == T and (N == 1 or int(want[1][-1]) == 0)


@pytest.mark.parametrize("T,N", [
    (1, 1), (7, 50), (2048, 333), (2048, 16384),
    # the strip is 64 lanes (4 warps of 16), a chunk 32 steps: N on both
    # sides of the strip (63, 65, 127, 129 and 72 take the scalar path,
    # N % 16 != 0), T below, at and off the chunk, a strip with one live
    # warp (80), and the group's width
    (31, 64), (32, 63), (33, 65), (100, 128), (64, 127), (96, 129),
    (33, 72), (1000, 80), (2048, 65536)])
def test_compact_kernel(cuda, T, N):
    """K8 against its plain version on int16 words (the download's
    form): words with the top bit set, lane 0 emitting at every step,
    lane N-1 at none; the zeros past each lane's count written over
    junk."""
    _check_compact(*_emissions(cuda, T, N))


def test_compact_kernel_unaligned_base(cuda):
    """Words 2 bytes past a 16-byte boundary take the scalar path even
    at N % 16 == 0."""
    T, N = 96, 128
    store = torch.empty(T * N + 1, dtype=torch.int16, device=cuda)
    words = store[1:].view(T, N)
    assert words.data_ptr() % 16 == 2
    _check_compact(*_emissions(cuda, T, N, words))


def test_card_data_parallel_matches_cpu(cuda, tmp_path):
    """Every visible card, two blocks each, plus a tail group: the same
    payloads as the CPU's single-device encoder, and the same triplet
    from the data-parallel driver."""
    import scalce_tpu_torch
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.io import fastq
    from scalce_tpu_torch.utils.synth import synth_fastq
    from scalce_tpu_torch.parallel import mesh
    from scalce_tpu_torch.pipeline.encode import BlockEncoder
    src = os.path.join(tmp_path, "in.fastq")
    with open(src, "wb") as f:
        f.write(synth_fastq(3000, 100, seed=2, var_len=True, n_rate=0.01))
    kw = dict(block_reads=256, max_read_len=128, core_on_device=True,
              delta_on_device=True, qual_on_device=True,
              qual_context_order=1, backend="gz", threads=1)
    cfg = Config(inputs=(src,), **kw)
    blocks = list(fastq.iter_blocks(src, 256, 128))
    senc = mesh.ShardedEncoder(cfg, "cuda", group=2)
    got = []
    items = [(b,) for b in blocks]
    for i in range(0, len(items), senc.D):
        got += [eb for eb, in senc.encode(items[i:i + senc.D])]
    want = [eb for eb, in BlockEncoder(cfg, "cpu").encode(items)]
    assert [g.payloads for g in got] == [w.payloads for w in want]
    outs = {}
    for dev, dp in (("cpu", False), ("cuda", True)):
        prefix = os.path.join(tmp_path, dev)
        scalce_tpu_torch.compress(Config(inputs=(src,), output=prefix,
                                         data_parallel=dp, **kw), dev)
        outs[dev] = [open(f"{prefix}.00.scalce{s}", "rb").read()
                     for s in "nrq"]
    assert outs["cpu"] == outs["cuda"]


def test_card_data_parallel_qual_device_every_card(cuda, tmp_path):
    """``--data-parallel --qual-device --qual-order 1`` over every visible
    card (two groups a card and a tail block), profiled: the one-card
    triplet byte for byte, a ``--qual-device`` round trip, the blocks of
    full and tail groups counted, and each card's device time given to
    the stages adding up, per card, to the trace's events on that card
    and, over the cards, to the time per stage."""
    import glob
    import json
    import scalce_tpu_torch
    from scalce_tpu_torch import timing
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.utils.synth import synth_fastq
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards or more")
    data = synth_fastq(2 * n * 1024 + 300, 100, seed=19, var_len=True,
                       n_rate=0.01, genome_len=200_000)
    src = os.path.join(tmp_path, "in.fastq")
    with open(src, "wb") as f:
        f.write(data)
    kw = dict(block_reads=1024, max_read_len=128, core_on_device=True,
              delta_on_device=True, qual_on_device=True,
              qual_context_order=1, backend="gz", threads=4)
    one = os.path.join(tmp_path, "one")
    scalce_tpu_torch.compress(Config(inputs=(src,), output=one, **kw),
                              "cuda:0")
    dp = os.path.join(tmp_path, "dp")
    cfg = Config(inputs=(src,), output=dp, data_parallel=True, **kw)
    scalce_tpu_torch.compress(cfg, "cuda")          # builds the kernels
    with timing.profile(str(tmp_path / "t"), "cuda"):
        stats = scalce_tpu_torch.compress(cfg, "cuda")
        for i in range(n):
            torch.cuda.synchronize(i)
    assert stats.device == ",".join(f"cuda:{i}" for i in range(n))
    got, want = ([open(f"{p}.00.scalce{s}", "rb").read() for s in "nrq"]
                 for p in (dp, one))
    assert got == want
    counters = timing.counters()
    assert counters["compress"]["grouped_blocks"] == 2 * n
    assert counters["compress"]["tail_blocks"] == 1
    by_card, by_stage = counters["device_us_by_card"], counters["device_us"]
    assert set(by_card) == set(range(n))
    summed = {}
    for per in by_card.values():
        assert per.get("stage A+B", 0) > 0 and per.get("pass B", 0) > 0
        for name, t in per.items():
            summed[name] = summed.get(name, 0.0) + t
    assert summed == pytest.approx(by_stage) and set(summed) == set(by_stage)
    (path,) = glob.glob(str(tmp_path / "t" / "*.trace.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    for card, per in by_card.items():
        on_card = sum(e["dur"] for e in events
                      if int(e.get("args", {}).get("device", -1)) == card)
        assert sum(per.values()) == pytest.approx(on_card, rel=0.005), card
    scalce_tpu_torch.decompress(Config(
        mode="decompress", inputs=(dp + ".00.scalcen",),
        output=os.path.join(tmp_path, "d"), keep_order=True,
        qual_on_device=True), "cuda")
    assert open(os.path.join(tmp_path, "d.fastq"), "rb").read() == data


def test_card_compress_matches_cpu(cuda, tmp_path):
    import scalce_tpu_torch
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.utils.synth import synth_fastq
    data = synth_fastq(2500, 100, seed=1, var_len=True, n_rate=0.01)
    src = os.path.join(tmp_path, "in.fastq")
    with open(src, "wb") as f:
        f.write(data)
    kw = dict(block_reads=1024, max_read_len=128, core_on_device=True,
              delta_on_device=True, qual_on_device=True,
              qual_context_order=1, backend="gz", threads=1)
    outs = {}
    for dev in ("cpu", "cuda"):
        prefix = os.path.join(tmp_path, dev)
        scalce_tpu_torch.compress(Config(inputs=(src,), output=prefix, **kw),
                                  dev)
        outs[dev] = [open(f"{prefix}.00.scalce{s}", "rb").read()
                     for s in "nrq"]
    assert outs["cpu"] == outs["cuda"]
    scalce_tpu_torch.decompress(Config(
        mode="decompress", inputs=(os.path.join(tmp_path, "cuda.00.scalcen"),),
        output=os.path.join(tmp_path, "d"), keep_order=True,
        qual_on_device=True), "cuda")
    assert open(os.path.join(tmp_path, "d.fastq"), "rb").read() == data


@pytest.mark.parametrize("lossy_pct", [0, 30])
@pytest.mark.parametrize("data_parallel", [False, True])
def test_card_paired_matches_cpu(cuda, tmp_path, lossy_pct, data_parallel):
    """A ragged pair with N bases, lossless or lossy: the card (one
    device, or every card in groups with a tail group) writes the CPU's
    single-device _1/_2 triplets, and the card's keep-order decompress
    gives the CPU's FASTQ pair."""
    import scalce_tpu_torch
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.utils.synth import synth_pair
    mates = synth_pair(1300, 100, seed=6, var_len=True, n_rate=0.01)
    paths = tuple(os.path.join(tmp_path, f"m{m}.fastq") for m in (1, 2))
    for path, data in zip(paths, mates):
        with open(path, "wb") as f:
            f.write(data)
    kw = dict(inputs=paths, paired=True, block_reads=256, max_read_len=128,
              core_on_device=True, delta_on_device=True, qual_on_device=True,
              qual_context_order=1, backend="gz", threads=1,
              lossy_pct=lossy_pct, sample_size=300)
    outs = {}
    for dev, dp in (("cpu", False), ("cuda", data_parallel)):
        prefix = os.path.join(tmp_path, dev)
        scalce_tpu_torch.compress(Config(output=prefix, data_parallel=dp,
                                         **kw), dev)
        outs[dev] = [open(f"{prefix}.00_{m}.scalce{s}", "rb").read()
                     for m in (1, 2) for s in "nrq"]
        scalce_tpu_torch.decompress(Config(
            mode="decompress", inputs=(prefix + ".00_2.scalcen",),
            output=prefix + "_d", keep_order=True, qual_on_device=True), dev)
        outs[dev + "_d"] = [open(f"{prefix}_d_{m}.fastq", "rb").read()
                            for m in (1, 2)]
    assert outs["cpu"] == outs["cuda"]
    assert outs["cpu_d"] == outs["cuda_d"]
    assert (outs["cuda_d"] == list(mates)) == (lossy_pct == 0)


def test_card_lossy_hist_allreduce(cuda):
    """Every card, two blocks each: the summed K6 histograms equal a
    numpy bincount of the valid cells."""
    from scalce_tpu_torch.parallel import mesh
    cards = mesh.local_mesh(device="cuda")
    rng = np.random.default_rng(8)
    D, B, L = 2 * len(cards), 300, 160
    qual = rng.integers(33, 127, (D, B, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, (D, B)).astype(np.int32)
    got = mesh.lossy_hist_allreduce(qual, lengths, cards)
    assert got.device == cards[0] and got.dtype == torch.int32
    valid = np.arange(L)[None, None, :] < lengths[:, :, None]
    want = np.bincount(np.clip(qual.astype(np.int64) - 33, 0, 93)[valid],
                       minlength=94)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def _bounded(fn, *args, timeout: float = 120):
    """``fn(*args)`` on a thread joined within ``timeout`` seconds: its
    result, or its exception raised here; fails on expiry."""
    import threading
    out = {}

    def run():
        try:
            out["value"] = fn(*args)
        except BaseException as e:       # handed to the test thread
            out["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{fn.__name__} still running after {timeout} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _pipeline_inputs(tmp_path, paired):
    from scalce_tpu_torch.utils.synth import synth_fastq, synth_pair
    datas = synth_pair(9 * 256 + 70, 100, seed=12, var_len=True,
                       n_rate=0.01) if paired else (
        synth_fastq(9 * 256 + 70, 100, seed=11, var_len=True, n_rate=0.01),)
    paths = tuple(os.path.join(tmp_path, f"in{i}.fastq")
                  for i in range(len(datas)))
    for path, data in zip(paths, datas):
        with open(path, "wb") as f:
            f.write(data)
    return paths, datas


@pytest.mark.parametrize("case", ["single", "paired", "data_parallel"])
def test_card_pipelined_matches_one_thread(cuda, tmp_path, case):
    """10 blocks (more than -T 4 keeps pending) on the card at -T 1 and
    -T 4, and on the CPU: the same triplets, and keep-order decompress
    at -T 4 gives the input back."""
    import glob
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.pipeline import driver
    paths, datas = _pipeline_inputs(tmp_path, case == "paired")
    kw = dict(inputs=paths, paired=case == "paired", block_reads=256,
              max_read_len=128, core_on_device=True, delta_on_device=True,
              qual_on_device=True, qual_context_order=1, backend="gz",
              data_parallel=case == "data_parallel")
    outs = {}
    for dev, t in (("cuda", 1), ("cuda", 4), ("cpu", 1)):
        prefix = os.path.join(tmp_path, f"{dev}{t}")
        _bounded(driver.compress, Config(output=prefix, threads=t, **kw), dev)
        outs[dev, t] = [open(p, "rb").read() for p in
                        sorted(glob.glob(prefix + ".*.scalce[nrq]"))]
    assert outs["cuda", 1] == outs["cuda", 4] == outs["cpu", 1]
    first = ".00_1.scalcen" if case == "paired" else ".00.scalcen"
    out = os.path.join(tmp_path, "d")
    _bounded(driver.decompress, Config(
        mode="decompress", inputs=(os.path.join(tmp_path, "cuda4") + first,),
        output=out, keep_order=True, qual_on_device=True, threads=4), "cuda")
    got = [open(p, "rb").read() for p in (
        [f"{out}_{m}.fastq" for m in (1, 2)] if case == "paired"
        else [out + ".fastq"])]
    assert got == list(datas)


def test_card_transfers_are_page_locked(cuda, tmp_path):
    """The block upload's staging tensors, the block's downloads and the
    K4 grid's download are in page-locked host memory."""
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.io import fastq
    from scalce_tpu_torch.pipeline.encode import BlockEncoder
    (path,), _ = _pipeline_inputs(tmp_path, False)
    block = next(fastq.iter_blocks(path, 256, 128))
    enc = BlockEncoder(Config(inputs=(path,), block_reads=256,
                              max_read_len=128, core_on_device=True,
                              delta_on_device=True, qual_on_device=True,
                              qual_context_order=1), cuda)
    staged = enc.upload([(block,)])
    assert set(staged[0][0].host) == {"seq", "len", "exc", "qual"}
    assert all(h.is_pinned() for h in staged[0][0].host.values())
    fetched = enc.dispatch([(block,)], staged)[0][0].wait()
    assert {"perm", "lit_packed", "packed", "wcounts"} <= set(fetched)
    assert all(torch.from_numpy(a).is_pinned() for a in fetched.values())
    ((eb,),) = enc.encode([(block,)])
    enc_q = qualities.parse(eb.payloads["q"])
    grid = qualities.decode_batch_dispatch([enc_q], [fetched["len_s"]],
                                           enc.link).wait()["qual"]
    assert torch.from_numpy(grid).is_pinned()


def test_card_kernel_error_propagates(cuda, tmp_path, monkeypatch):
    """A kernel launch that fails in the middle of a -T 4 compress raises
    out of the driver, and every thread the driver started stops."""
    import threading
    import time
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.ops import _cuda
    from scalce_tpu_torch.pipeline import driver
    (path,), _ = _pipeline_inputs(tmp_path, False)
    launch = _cuda.launch
    calls = []

    def failing(name, *a):
        if name == "scalce_hist_ctx":
            calls.append(name)
            if len(calls) == 4:
                raise RuntimeError("scalce_hist_ctx: CUDA error 700")
        return launch(name, *a)
    monkeypatch.setattr(_cuda, "launch", failing)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _bounded(driver.compress, Config(
            inputs=(path,), output=os.path.join(tmp_path, "o"), threads=4,
            block_reads=256, max_read_len=128, core_on_device=True,
            delta_on_device=True, qual_on_device=True, qual_context_order=1,
            backend="gz"), "cuda")
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.02)
    assert threading.active_count() <= before


def test_card_pipeline_never_blocks_on_the_card(cuda, tmp_path):
    """A -T 4 compress and --qual-device decompress under
    ``torch.cuda.set_sync_debug_mode("error")``: no operation that waits
    for the card (a pageable copy, ``.item()``, ``.cpu()``, a stream
    synchronize) runs on any thread; the host halves wait on the
    downloads' events only."""
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.pipeline import driver
    paths, datas = _pipeline_inputs(tmp_path, False)
    kw = dict(block_reads=256, max_read_len=128, core_on_device=True,
              delta_on_device=True, qual_on_device=True,
              qual_context_order=1, backend="gz", threads=4)
    out = os.path.join(tmp_path, "o")
    torch.cuda.set_sync_debug_mode("error")
    try:
        _bounded(driver.compress, Config(inputs=paths, output=out, **kw),
                 "cuda")
        _bounded(driver.decompress, Config(
            mode="decompress", inputs=(out + ".00.scalcen",),
            output=os.path.join(tmp_path, "d"), keep_order=True,
            qual_on_device=True, threads=4), "cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert open(os.path.join(tmp_path, "d.fastq"), "rb").read() == datas[0]


@pytest.mark.parametrize("mode", ["lut", "lcp"])
@pytest.mark.parametrize("B,L,k", [(1000, 128, 12), (513, 101, 10),
                                   (300, 160, 8), (1, 12, 12)])
def test_core_rank_lut_kernel(cuda, mode, B, L, k):
    """K1's rank-LUT variant against its plain version: ragged rows with
    N bases, homopolymer runs (the tables' demoted classes and ties),
    empty and short reads."""
    from scalce_tpu_torch.models import core_dict
    lut = (core_dict.build_rank_lut if mode == "lut"
           else core_dict.build_rank_lut_lcp)(k, 0x5CA1CE)
    rng = np.random.default_rng(B + L + k)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[: B // 3, : L // 2] = 1
    lengths = rng.integers(0, L + 1, B)
    lengths[B // 2:: 7] = 0
    lengths[B // 2 + 1:: 7] = k - 1
    exc = rng.random((B, L)) < 0.02
    args = [torch.from_numpy(a).to(cuda) for a in (codes, exc, lengths)]
    t = torch.from_numpy(lut.view(np.int32)).to(cuda)
    launches = core_rank.core_rank_codes.launches
    _equal(core_rank.core_rank_codes(*args, k, 0, t),
           core_rank.core_rank_codes_plain(*args, k, 0, t))
    assert core_rank.core_rank_codes.launches == launches + 1


def test_core_rank_lut_kernel_rejects_bad_tables(cuda):
    codes = torch.zeros((4, 16), dtype=torch.uint8, device=cuda)
    exc = torch.zeros((4, 16), dtype=torch.bool, device=cuda)
    lengths = torch.full((4,), 16, device=cuda)
    for lut, k in ((torch.zeros(4 ** 6, dtype=torch.int32, device=cuda), 7),
                   (torch.zeros(4 ** 6, dtype=torch.int64, device=cuda), 6),
                   (torch.zeros(4 ** 6, dtype=torch.int32), 6),
                   (torch.zeros(4 ** 13, dtype=torch.int32, device=cuda),
                    13)):
        with pytest.raises((ValueError, TypeError)):
            core_rank.core_rank_codes(codes, exc, lengths, k, 0, lut)


def test_reconstruct_on_card_matches_host_walk(cuda, tmp_path):
    """``ops/delta_decode.py`` on the card equals the serial host walk on
    every block of a triplet with deep copy chains."""
    from scalce_tpu_torch import container
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.pipeline import driver
    from scalce_tpu_torch.streams import seqs
    from scalce_tpu_torch.utils.synth import synth_fastq
    src = os.path.join(tmp_path, "in.fastq")
    with open(src, "wb") as f:
        f.write(synth_fastq(5000, 100, seed=99, var_len=True, n_rate=0.01,
                            rc_rate=0.4, genome_len=4000))
    driver.compress(Config(inputs=(src,), output=os.path.join(tmp_path, "o"),
                           block_reads=2048, max_read_len=128, backend="gz",
                           core_on_device=False, delta_on_device=False),
                    "cpu")
    reader = container.TripletReader(os.path.join(tmp_path, "o.00.scalcen"))
    B, L = reader.meta["block_reads"], reader.meta["max_read_len"]
    for _, payloads in reader.iter_blocks():
        host = seqs.parse(payloads["r"], B, L)
        card = seqs.parse(payloads["r"], B, L, delta_device=True,
                          device=cuda)
        for h, c in zip(host, card):
            np.testing.assert_array_equal(h, c)


@pytest.mark.parametrize("case", ["host delta", "host delta pair",
                                  "host delta dp", "lut", "lcp host delta"])
def test_card_placements_match_cpu(cuda, tmp_path, case):
    """The new placements and dictionaries on the card write the CPU's
    triplets; --delta-device on the card gives the input back; nothing
    waits for the card on the way (sync debug mode "error")."""
    import glob
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.pipeline import driver
    paths, datas = _pipeline_inputs(tmp_path, "pair" in case)
    kw = dict(block_reads=256, max_read_len=128, backend="gz", threads=4,
              core_on_device=True, delta_on_device="host" not in case,
              data_parallel="dp" in case, paired="pair" in case,
              dict_mode="lcp" if "lcp" in case else
              "lut" if "lut" in case else "hash", core_k=12)
    outs = {}
    for dev in ("cpu", "cuda"):
        prefix = os.path.join(tmp_path, dev)
        if dev == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            stats = _bounded(driver.compress, Config(
                inputs=paths, output=prefix, **kw), dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert stats.placement == "device"
        outs[dev] = [open(p, "rb").read() for p in
                     sorted(glob.glob(prefix + ".*.scalce[nrq]"))]
    assert outs["cpu"] == outs["cuda"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = ".00_1.scalcen" if "pair" in case else ".00.scalcen"
        _bounded(driver.decompress, Config(
            mode="decompress", inputs=(os.path.join(tmp_path, "cuda")
                                       + first,),
            output=os.path.join(tmp_path, "d"), keep_order=True,
            delta_on_device=True, threads=4), "cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = [os.path.join(tmp_path, f"d_{m}.fastq") for m in (1, 2)] \
        if "pair" in case else [os.path.join(tmp_path, "d.fastq")]
    for path, data in zip(got, datas):
        assert open(path, "rb").read() == data


def test_card_host_core_allocates_nothing(cuda, tmp_path):
    """Host core on a CUDA device: the CPU's triplet, no K1 launch, no
    device memory."""
    import glob
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.pipeline import driver
    paths, _ = _pipeline_inputs(tmp_path, False)
    kw = dict(block_reads=256, max_read_len=128, backend="gz", threads=4,
              core_on_device=False, delta_on_device=False)
    outs = {}
    launches = core_rank.core_rank_codes.launches
    for dev in ("cpu", "cuda"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        prefix = os.path.join(tmp_path, dev)
        stats = _bounded(driver.compress, Config(inputs=paths, output=prefix,
                                                 **kw), dev)
        assert stats.placement == "host"
        assert torch.cuda.max_memory_allocated() == before
        outs[dev] = [open(p, "rb").read() for p in
                     sorted(glob.glob(prefix + ".*.scalce[nrq]"))]
    assert outs["cpu"] == outs["cuda"]
    assert core_rank.core_rank_codes.launches == launches


def test_card_long_reads_allocate_nothing(cuda, tmp_path):
    """Long reads with a CUDA device: the CPU's triplet, no kernel, no
    device memory; the keep-order decompress gives the input back."""
    import glob
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.pipeline import driver
    from scalce_tpu_torch.utils.longread import synth_long_fastq
    src = os.path.join(tmp_path, "long.fastq")
    data = synth_long_fastq(40, 20_000, 36_000, genome_len=100_000,
                            ins=0.001, dele=0.001, seed=3)
    with open(src, "wb") as f:
        f.write(data)
    kw = dict(block_reads=256, max_read_len=40_000, backend="gz", threads=4)
    outs = {}
    launches = core_rank.core_rank_codes.launches
    for dev in ("cpu", "cuda"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        prefix = os.path.join(tmp_path, dev)
        stats = driver.compress(Config(inputs=(src,), output=prefix, **kw),
                                dev)
        assert stats.placement == "host" and stats.device == "host"
        driver.decompress(Config(mode="decompress",
                                 inputs=(prefix + ".00.scalcen",),
                                 output=prefix + "_d", keep_order=True), dev)
        assert torch.cuda.max_memory_allocated() == before
        with open(prefix + "_d.fastq", "rb") as f:
            assert f.read() == data
        outs[dev] = [open(p, "rb").read() for p in
                     sorted(glob.glob(prefix + ".*.scalce[nrq]"))]
    assert outs["cpu"] == outs["cuda"]
    assert core_rank.core_rank_codes.launches == launches


@pytest.mark.parametrize("data_parallel", [False, True])
def test_card_hosts_merge_to_the_cpu_triplet(cuda, tmp_path, data_parallel):
    """Two simulated hosts on the card, each on its own blocks (under
    --data-parallel, groups of owned blocks), merged: the CPU's 1-host
    triplet."""
    import glob
    from scalce_tpu_torch.config import Config
    from scalce_tpu_torch.pipeline import driver
    paths, _ = _pipeline_inputs(tmp_path, False)
    kw = dict(block_reads=256, max_read_len=128, backend="gz", threads=2,
              qual_on_device=True, qual_context_order=1,
              core_on_device=True, delta_on_device=True, inputs=paths)
    one = os.path.join(tmp_path, "one")
    driver.compress(Config(output=one, **kw), "cpu")
    multi = os.path.join(tmp_path, "multi")
    for h in range(2):
        driver.compress(Config(output=multi, n_hosts=2, host_id=h,
                               data_parallel=data_parallel, **kw), "cuda")
    driver.merge_hosts(Config(output=multi, n_hosts=2, **kw))
    got, want = ([open(p, "rb").read() for p in
                  sorted(glob.glob(prefix + ".*.scalce[nrq]"))]
                 for prefix in (multi, one))
    assert len(got) == 3 and got == want


def test_card_profile_names_kernels_and_stages(cuda, tmp_path):
    """--profile on the card: the CLI's triplet equals the unprofiled
    one, and the trace holds K1-K3's kernels and the stage spans."""
    import glob
    import json
    from scalce_tpu_torch import cli, timing
    paths, _ = _pipeline_inputs(tmp_path, False)
    argv = [*paths, "--block-reads", "256", "--max-read-len", "128",
            "--qual-device", "--qual-order", "1", "-c", "gz", "-T", "2"]
    for name, extra in (("plain", []),
                        ("prof", ["--profile", str(tmp_path / "t")])):
        assert cli.main(argv + ["-o", str(tmp_path / name)] + extra) == 0
    got, want = ([open(p, "rb").read() for p in
                  sorted(glob.glob(str(tmp_path / name) + ".*.scalce[nrq]"))]
                 for name in ("prof", "plain"))
    assert got == want
    (trace,) = glob.glob(str(tmp_path / "t" / "*.trace.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kinds = {timing.device_event_kind(e["name"]) for e in events
             if e.get("cat") == "kernel"}
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"K1", "K2", "K3", "K7", "K8"} <= kinds
    assert {"parse FASTQ", "upload", "stage A", "stage B", "pass B",
            "download", "seqs.payload", "write"} <= spans
