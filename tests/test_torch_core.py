"""scalce_tpu_torch bitops, core matcher (K1 plain version), sort keys
and reorder against scalce_tpu on the same inputs (JAX on CPU, Pallas in
interpret mode).  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalce_tpu.ops import bitops as ref_bitops
from scalce_tpu.ops import core_match as ref_cm
from scalce_tpu.ops import core_pallas
from scalce_tpu.ops import reorder as ref_reorder
from scalce_tpu_torch.ops import bitops, core_match, core_rank, reorder

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

K, SEED = 12, 0x5CA1CE


def _t(a):
    """numpy -> torch (u32 widened to int64, as the port carries it)."""
    a = np.array(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                            else a)


def _block(seed, B, L, ragged, k=K):
    """Reads sampled from a small genome (deep buckets), with exceptions,
    coreless rows (too short; all exceptions) and forced rank ties
    (homopolymers: every window ties; palindromes: the two strands tie)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 4 * L, dtype=np.uint8)
    starts = rng.integers(0, 3 * L, B)
    codes = genome[starts[:, None] + np.arange(L)[None, :]]
    lengths = (rng.integers(max(k - 2, 0), L + 1, B) if ragged
               else np.full(B, L - 3)).astype(np.int32)
    lengths[0] = k - 1                        # too short: no core
    codes[1] = 2                              # homopolymer ties
    codes[2] = np.resize([0, 1, 2, 3], L)     # ACGT...: revcomp == self
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 0
    exc = np.zeros((B, L), bool)
    exc[3, :] = True                          # all-N read: no core
    exc[rng.integers(4, B, 3 * B // 4), rng.integers(0, L, 3 * B // 4)] = True
    exc &= np.arange(L)[None, :] < lengths[:, None]
    return codes, lengths, exc


def test_bitops_match_reference():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    for seed in (0, SEED, 0xFFFFFFFF):
        np.testing.assert_array_equal(
            bitops.mix32(_t(x), seed).numpy(),
            np.asarray(ref_bitops.mix32(jnp.asarray(x), seed)))
    np.testing.assert_array_equal(
        bitops.rev_lanes_u32(_t(x)).numpy(),
        np.asarray(ref_bitops.rev_lanes_u32(jnp.asarray(x))))
    pop = np.array([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(bitops.popcount32(_t(x)).numpy(), pop)
    codes = rng.integers(0, 4, (8, 64), dtype=np.uint8)
    packed = bitops.pack_bases_u32(_t(codes))
    np.testing.assert_array_equal(
        packed.numpy(),
        np.asarray(ref_bitops.pack_bases_u32(jnp.asarray(codes), axis=1)))
    np.testing.assert_array_equal(bitops.unpack_bases_u32(packed).numpy(),
                                  codes)
    np.testing.assert_array_equal(
        bitops.from_u32_bits(bitops.to_u32_bits(_t(x))).numpy(), x)


@pytest.mark.parametrize("ragged", [False, True])
def test_kmers_invalid_revcomp_match_reference(ragged):
    codes, lengths, exc = _block(1, 64, 48, ragged)
    km = ref_cm.rolling_kmers(jnp.asarray(codes), K)
    np.testing.assert_array_equal(
        core_match.rolling_kmers(_t(codes), K).numpy(), np.asarray(km))
    np.testing.assert_array_equal(
        core_match.window_invalid(_t(exc), _t(lengths), K).numpy(),
        np.asarray(ref_cm.window_invalid(jnp.asarray(exc),
                                         jnp.asarray(lengths), K)))
    np.testing.assert_array_equal(
        core_match.revcomp_kmer(_t(np.asarray(km)), K).numpy(),
        np.asarray(ref_cm.revcomp_kmer(km, K)))
    np.testing.assert_array_equal(
        core_match.reverse_complement(_t(codes), _t(lengths)).numpy(),
        np.asarray(ref_cm.reverse_complement(jnp.asarray(codes),
                                             jnp.asarray(lengths))))


@pytest.mark.parametrize("L", [139, 48])
def test_rank_argmin_plain_matches_pallas_kernel(L):
    """K1's plain version against the Mosaic kernel in interpret mode.
    At P = L-k+1 = 128 the kernel pads nothing and all six outputs match
    on every row; at P = 37 its padded lanes move pfw/kr of coreless
    rows (masked downstream), so those rows compare on bf/br/pf/kf."""
    codes, lengths, exc = _block(2, 64, L, ragged=True)
    kmers = ref_cm.rolling_kmers(jnp.asarray(codes), K)
    invalid = ref_cm.window_invalid(jnp.asarray(exc), jnp.asarray(lengths),
                                    K)
    ref = [np.asarray(v) for v in core_pallas.rank_argmin_pallas(
        kmers, invalid, K, SEED, interpret=True)]
    got = [v.numpy() for v in core_rank.rank_argmin_plain(
        _t(np.asarray(kmers)), _t(np.asarray(invalid)), K, SEED)]
    has_core = ref[0] != 0xFFFFFFFF
    assert (~has_core).sum() >= 2 and has_core.sum() > 32
    for i, (g, r) in enumerate(zip(got, ref)):
        if L - K + 1 == 128 or i in (0, 1, 2, 4):
            np.testing.assert_array_equal(g, r, err_msg=f"output {i}")
        else:
            np.testing.assert_array_equal(g[has_core], r[has_core],
                                          err_msg=f"output {i}")


@pytest.mark.parametrize("k,L", [(4, 101), (15, 101), (15, 142), (12, 17)])
def test_core_rank_codes_matches_reference(k, L):
    """K1's entry point on the codes (on the CPU its plain version)
    against the reference's find_cores_canonical, and its six per-row
    values against the Mosaic kernel in interpret mode over the
    reference's k-mer grid: ragged reads, reads shorter than k, all-N
    rows, rank ties.  At P = L-k+1 = 128 the six match on every row;
    otherwise the kernel's padded lanes move pfw/kr of coreless rows
    (masked downstream), so those rows compare on bf/br/pf/kf."""
    codes, lengths, exc = _block(10 + k + L, 64, L, ragged=True, k=k)
    jc, jl, je = jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(exc)
    ref = ref_cm.find_cores_canonical(jc, jl, je, k, SEED)
    got = core_match.find_cores_canonical(_t(codes), _t(lengths), _t(exc),
                                          k, SEED)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=f"output {i}")
    pallas = [np.asarray(v) for v in core_pallas.rank_argmin_pallas(
        ref_cm.rolling_kmers(jc, k), ref_cm.window_invalid(je, jl, k), k,
        SEED, interpret=True)]
    six = [v.numpy() for v in core_rank.core_rank_codes(
        _t(codes), _t(exc), _t(lengths), k, SEED)]
    has_core = pallas[0] != 0xFFFFFFFF
    assert (~has_core).sum() >= 2 and has_core.sum() > 16
    for i, (g, r) in enumerate(zip(six, pallas)):
        if L - k + 1 == 128 or i in (0, 1, 2, 4):
            np.testing.assert_array_equal(g, r, err_msg=f"output {i}")
        else:
            np.testing.assert_array_equal(g[has_core], r[has_core],
                                          err_msg=f"output {i}")


@pytest.mark.parametrize("ragged", [False, True])
def test_find_cores_and_sort_match_reference(ragged):
    B, L = 128, 64
    codes, lengths, exc = _block(3, B, L, ragged)
    n_reads = B - 5                                  # padded tail rows
    ref = ref_cm.find_cores_canonical(jnp.asarray(codes),
                                      jnp.asarray(lengths),
                                      jnp.asarray(exc), K, SEED)
    got = core_match.find_cores_canonical(_t(codes), _t(lengths), _t(exc),
                                          K, SEED)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=f"output {i}")
    ck, cp, rc = (np.asarray(v) for v in ref[:3])
    assert (ck == 0xFFFFFFFF).sum() >= 2 and rc.any() and (~rc).any()
    assert not rc[2]                  # the palindrome's strand tie: forward

    keys_ref = ref_cm.build_sort_keys(ref[3], jnp.asarray(lengths), ref[0],
                                      ref[1], jnp.int32(n_reads))
    keys = core_match.build_sort_keys(got[3], _t(lengths), got[0], got[1],
                                      n_reads)
    for g, r in zip(keys, keys_ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    perm = reorder.sort_permutation(keys)
    np.testing.assert_array_equal(
        perm.numpy(), np.asarray(ref_reorder.sort_permutation(keys_ref)))
    inv = reorder.invert_permutation(perm)
    np.testing.assert_array_equal(
        inv.numpy(), np.asarray(ref_reorder.invert_permutation(
            jnp.asarray(perm.numpy().astype(np.int32)))))
    (codes_s,) = reorder.apply_permutation(perm, got[3])
    np.testing.assert_array_equal(codes_s[inv].numpy(), got[3].numpy())
