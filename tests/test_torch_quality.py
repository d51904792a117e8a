"""scalce_tpu_torch quality path — pass A and K2, device_normalize, K3 +
compact_emissions, K4 — and the jax-free host copies (seqs, qualities
and entropy payload code) against scalce_tpu on the same inputs (JAX on
CPU, Pallas kernels in interpret mode).  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalce_tpu.models import entropy as ref_entropy
from scalce_tpu.models import lossy as ref_lossy
from scalce_tpu.ops import hist_pallas, rans_decode_pallas, rans_pallas
from scalce_tpu.ops import rans as ref_rans
from scalce_tpu.streams import qualities as ref_q
from scalce_tpu.streams import seqs as ref_seqs
from scalce_tpu_torch import convert
from scalce_tpu_torch.models import entropy
from scalce_tpu_torch.ops import hist, rans, rans_decode, rans_encode
from scalce_tpu_torch.streams import qualities, seqs

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)


def _quals(seed, B, L, lmin):
    """Serially correlated qualities (order-1/2 contexts matter) with
    ragged lengths; padding cells are 0."""
    rng = np.random.default_rng(seed)
    walk = np.clip(np.cumsum(rng.integers(-2, 3, (B, L)), axis=1) + 38,
                   2, 80) + 33
    lengths = rng.integers(lmin, L + 1, B).astype(np.int32)
    qual = np.where(np.arange(L)[None, :] < lengths[:, None], walk, 0)
    return qual.astype(np.uint8), lengths


def _torch(*arrays):
    return [convert.from_reference({"a": np.asarray(a)}, "cpu")["a"]
            for a in arrays]


@pytest.mark.parametrize("order", [1, 2, 3])
def test_pass_a_and_hist_match_reference(order):
    """Grids and histogram against sym_ctx_hist (.at[].add on CPU), and
    K2's plain version against the slab kernel in interpret mode on both
    of its regroup paths (128-wide and 160-wide grids)."""
    for B, L, lmin in ((96, 128, 40), (64, 160, 100)):
        qual, lengths = _quals(order * 10 + L, B, L, lmin)
        ref = ref_q.sym_ctx_hist(jnp.asarray(qual), jnp.asarray(lengths),
                                 order)
        got = qualities.sym_ctx_hist(*_torch(qual, lengths), order)
        for name, g, r in zip(("sym", "ctx", "counts"), got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=f"{name} B={B} L={L}")
        R, PB, cd = ref_q._slab_spec(order)
        slab = hist_pallas.hist_ctx_slab_pallas(ref[0], ref[1], R, PB, cd,
                                                n_syms=94, interpret=True)
        np.testing.assert_array_equal(
            hist.hist_ctx_plain(got[0], got[1], R, PB).numpy(),
            np.asarray(slab))


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("lossy,histogram", [(False, False), (True, True),
                                             (True, False)])
def test_sym_ctx_hist_lut_and_grids_only_match_reference(order, lossy,
                                                         histogram):
    """Pass A's entry point (on the CPU its plain version) with a lossy
    LUT and in grids-only mode against the reference's sym_ctx_hist of
    the remapped grid: ragged L = 101 with empty reads."""
    B = 96
    qual, lengths = _quals(40 + order, B, 101, 0)
    lengths[:3] = 0                           # empty reads
    qmap = None
    if lossy:
        qmap = ref_lossy.build_quant_map(
            ref_lossy.sample_histogram(qual, lengths, B), 30)
        assert not np.array_equal(qmap, ref_lossy.identity_map())
    ref = ref_q.sym_ctx_hist(jnp.asarray(qual if qmap is None
                                         else qmap[qual]),
                             jnp.asarray(lengths), order)
    got = qualities.sym_ctx_hist(
        *_torch(qual, lengths), order,
        None if qmap is None else torch.from_numpy(qmap), histogram)
    for name, g, r in zip(("sym", "ctx"), got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)
    if histogram:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    else:
        assert got[2] is None


def test_device_normalize_matches_reference():
    """Ties in the row maximum (first index wins), empty rows, single
    symbol rows and a near-overflow row, against the JAX and numpy
    normalizers."""
    rng = np.random.default_rng(4)
    C, S = 200, 94
    counts = rng.integers(0, 50, (C, S)) * (rng.random((C, S)) < 0.3)
    counts[0] = 0                                   # empty
    counts[1] = 0
    counts[1, 17] = 9                               # one symbol
    counts[2, [3, 40, 90]] = 77                     # tied maxima
    counts[3] = rng.integers(0, 1 << 16, S)         # large counts
    counts = counts.astype(np.int32).reshape(-1)
    f_ref, c_ref = ref_entropy.device_normalize(jnp.asarray(counts), C, S)
    f_np, c_np = ref_entropy.host_normalize_np(counts, C, S)
    f, c = entropy.device_normalize(torch.from_numpy(counts), C, S)
    for got, want in ((f, f_ref), (c, c_ref), (f, f_np), (c, c_np)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (f.numpy().sum(axis=1) == 4096).all()


@pytest.mark.parametrize("order", [1, 2, 3])
def test_encode_scan_matches_pallas_and_xla(order, monkeypatch):
    """K3's plain version + compact_emissions against the table-resident
    Mosaic encode (interpret mode, fed by build_encode_slabs) and the
    XLA scan, and the whole of pass B against encode_from_grids."""
    B, L = 128, 64
    qual, lengths = _quals(order, B, L, 30)
    sym, ctx, counts = ref_q.sym_ctx_hist(jnp.asarray(qual),
                                          jnp.asarray(lengths), order)
    freq, cum = ref_q._normalize_pass(counts, order)
    T = ref_q.pick_T(B, L, 256)
    states_r, packed_r, wc_r = ref_q._encode_pass(
        sym, ctx, freq.reshape(-1), cum.reshape(-1), T)
    R, PB, cd = ref_q._slab_spec(order)
    N = B * L // T
    pidx = jnp.where(ctx == 0, R, ctx.astype(jnp.int32) - 1
                     - jnp.minimum(jnp.arange(L)[None, :] // cd, PB - 1) * R)
    tbl = rans_pallas.build_encode_slabs(freq, cum, R, PB)
    monkeypatch.setattr(rans_pallas, "_NT", 128)
    monkeypatch.setattr(rans_pallas, "_TT", 64)
    st_k, w_k, e_k = rans_pallas.encode_scan_tbl_pallas(
        sym.astype(jnp.int32).reshape(N, T).T, pidx.reshape(N, T).T, tbl,
        T, L, cd, PB, interpret=True)
    packed_k, wc_k = ref_rans.compact_emissions(w_k, e_k)

    s, c, f, cm = _torch(sym, ctx, freq, cum)
    states, words, emits = rans_encode.encode_scan(s, c, f, cm, T, order)
    packed, wc = rans.compact_emissions(words, emits)
    np.testing.assert_array_equal(words.numpy(), np.asarray(w_k))
    np.testing.assert_array_equal(emits.numpy(), np.asarray(e_k))
    for got, want_k, want_r in ((states, st_k, states_r),
                                (packed, packed_k, packed_r),
                                (wc, wc_k, wc_r)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_k))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_r))

    enc_r = ref_q.encode_from_grids(sym, ctx, counts, B, L, order, 256)
    enc = qualities.encode_from_grids(s, c, _torch(counts)[0], B, L, order,
                                      256)
    for field in ("freq", "states", "counts", "words", "B", "L", "T",
                  "order"):
        np.testing.assert_array_equal(getattr(enc, field),
                                      getattr(enc_r, field), err_msg=field)
    assert qualities.payload(enc) == ref_q.payload(enc_r)
    back, back_r = qualities.parse(ref_q.payload(enc_r)), ref_q.parse(
        qualities.payload(enc))
    for field in ("freq", "states", "counts", "words"):
        np.testing.assert_array_equal(getattr(back, field),
                                      getattr(back_r, field))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_decode_scan_matches_pallas(order, monkeypatch):
    """K4's plain version against the Mosaic decode kernel (interpret
    mode) on D = 2 different blocks, several time tiles (T = 1024)."""
    B, L = 512, 32
    encs, lens = [], []
    for d in range(2):
        qual, lengths = _quals(20 + 2 * order + d, B, L, 8)
        encs.append(ref_q.encode(qual, lengths, order=order, T_target=1024))
        lens.append(lengths)
    x = qualities.decode_inputs(encs, lens, "cpu")
    T = encs[0].T
    monkeypatch.setattr(rans_decode_pallas, "_NT", 16)
    ref = rans_decode_pallas.decode_scan_pallas(
        jnp.asarray(x["states"].numpy().astype(np.uint32)),
        jnp.asarray(x["words"].numpy().astype(np.uint16)),
        jnp.asarray(x["freq"].numpy().astype(np.uint32)),
        jnp.asarray(x["lengths"].numpy()), order, T, L, interpret=True)
    got = rans_decode.decode_scan(x["states"], x["words"], x["freq"],
                                  x["lengths"], order, T, L)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    quals = qualities.decode_batch(encs, lens, "cpu")
    for d, enc in enumerate(encs):
        np.testing.assert_array_equal(quals[d],
                                      ref_q.decode_host(enc, lens[d]))


@pytest.mark.parametrize("native", [True, False])
def test_seqs_payload_parse_match_reference(native, tmp_path, monkeypatch):
    """The copied sequence payload coders against the originals on a
    real block's delta products, with the native library and on the
    numpy fallbacks."""
    import os
    from scalce_tpu_torch.config import Config
    from scalce_tpu.io import fastq
    from scalce_tpu.utils.synth import synth_fastq
    from scalce_tpu_torch.pipeline import encode
    if not native:
        monkeypatch.setattr(ref_seqs, "_NATIVE", False)
        monkeypatch.setattr(seqs, "_NATIVE", False)
    B, L = 1024, 128
    path = os.path.join(tmp_path, "in.fastq")
    with open(path, "wb") as f:
        f.write(synth_fastq(1000, 100, seed=5, genome_len=20_000,
                            var_len=True, n_rate=0.01))
    block = next(fastq.iter_blocks(path, B, L))
    cfg = Config(inputs=(path,), block_reads=B, max_read_len=L,
                 core_on_device=True, delta_on_device=True,
                 qual_on_device=True, qual_context_order=1)
    (perm, delta, len_s, *_), = encode.BlockEncoder(
        cfg, "cpu").encode_device((block,))
    delta_np = encode.download_delta(delta)
    args = (delta_np, len_s.numpy(), block.n_reads, block.exc_pos,
            block.exc_byte, perm.numpy())
    blob = seqs.payload(*args, backend="gz")
    assert blob == ref_seqs.payload(*args, backend="gz")
    got, want = seqs.parse(blob, B, L), ref_seqs.parse(blob, B, L)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_entropy_host_half_matches_reference():
    rng = np.random.default_rng(6)
    counts = (rng.integers(0, 300, (257, 256))
              * (rng.random((257, 256)) < 0.2)).reshape(-1)
    counts[:256] = 0                                 # an empty row
    f, c = entropy.host_normalize(counts, 257, 256)
    f_r, c_r = ref_entropy.host_normalize(counts, 257, 256)
    np.testing.assert_array_equal(f, f_r)
    np.testing.assert_array_equal(c, c_r)
    np.testing.assert_array_equal(entropy.host_normalize_np(counts, 257, 256)
                                  [0], f_r)
    np.testing.assert_array_equal(entropy.freq_to_cum(f),
                                  ref_entropy.freq_to_cum(f))
    np.testing.assert_array_equal(entropy.build_decode_lut(f, c),
                                  ref_entropy.build_decode_lut(f, c))
    blob = entropy.table_payload(f)
    assert blob == ref_entropy.table_payload(f)
    np.testing.assert_array_equal(entropy.payload_to_freq(blob, 257, 256),
                                  f)


def test_kernel_tables_match_cumulative_frequencies():
    """K3's and K4's staged tables (``rans.bucket_slabs`` layout): u16
    rows of exclusive cumulative frequencies ending in the total."""
    rng = np.random.default_rng(12)
    C, S, R = qualities.n_contexts(1), 94, 95
    counts = rng.integers(0, 500, (C, S)) * (rng.random((C, S)) < 0.3)
    counts[0] = 0
    counts[1, :] = 0
    counts[1, 93] = 5                         # all mass on the last symbol
    freq, cum = entropy.device_normalize(
        torch.from_numpy(counts.reshape(-1)), C, S)
    rows = rans.cum_rows(freq).numpy()

    def unslab(slabs, E):
        bucket = slabs[E:].reshape(-1, E, R).transpose(0, 2, 1)
        return np.concatenate([slabs[None, :E], bucket.reshape(-1, E)])
    tab = unslab(rans_encode.staged_table(freq, cum, 1).numpy(), 96)
    np.testing.assert_array_equal(tab[:, :S + 1], rows)
    assert (tab[:, S + 1] == 0).all() and (tab[:, S] == 4096).all()
    cum16 = rans_decode.staged_table(freq[None], 1)[0].numpy()
    np.testing.assert_array_equal(unslab(cum16, 96), tab)


def test_reciprocal_divide_formula_is_exact():
    """K3's multiply-high by ceil(2^44 / f) << 20, in numpy uint64: exact
    for every f in 1..4096 at x = k*f - 1, k*f, (f << 20) - 1 and random
    x below f << 20 (f = 1 is the kernel's special case)."""
    f = np.arange(2, 4097, dtype=np.uint64)
    M = (((np.uint64(1) << np.uint64(44)) + f - np.uint64(1)) // f) \
        << np.uint64(20)
    ks = np.array([1, 2, 3, 255, 4097, 65537, (1 << 20) - 1], np.uint64)
    rng = np.random.default_rng(13)
    xs = np.concatenate([ks[:, None] * f[None, :] - np.uint64(1),
                         ks[:, None] * f[None, :],
                         ((f << np.uint64(20)) - np.uint64(1))[None, :],
                         (rng.random((40, f.size)) * (f << np.uint64(20))
                          .astype(np.float64)).astype(np.uint64)])
    assert (xs < f << np.uint64(20)).all()
    mhi, mlo = M >> np.uint64(32), M & np.uint64(0xFFFFFFFF)
    hi = xs * mhi + ((xs * mlo) >> np.uint64(32))
    np.testing.assert_array_equal(hi >> np.uint64(32), xs // f)

