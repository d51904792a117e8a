"""scalce_tpu_torch's K7 and K8 plain versions against scalce_tpu's
functions (JAX on CPU), on inputs made with numpy from a seed; every
output is compared exactly.

K7: ``ops/delta_seq.py::delta_seq_plain`` against the reference's
``pipeline/encode.py::_delta_seq`` on sorted-looking blocks whose reads
come from a small genome, grouped in core buckets so that a predecessor's
shift really aligns it: ties between predecessors, NO_CORE rows,
all-literal rows, shifts of +-(L-1), padding rows past ``n_reads``, and
widths 16, 112 (reads of up to 101 bases), 128, 160 and 512 (the
reference's select-sum unrolls grow with W = L/16, so wider blocks are
left to the card's tests).  K8: ``ops/compact.py::compact_emissions_plain``
against the reference's ``ops/rans.py::compact_emissions``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalce_tpu.ops import rans as ref_rans
from scalce_tpu.pipeline import encode as ref_encode
from scalce_tpu_torch.ops import compact, core_match, delta_seq, rans
from scalce_tpu_torch.pipeline import encode

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

NO_CORE = core_match.NO_CORE


def delta_block(seed, B, L, max_len=None, n_reads=None, case="random"):
    """Stage A's outputs for a sorted block: reads of up to ``max_len``
    bases from a genome of 3L, in core buckets of 1-7 rows (the core at
    one genome position per bucket, ``cp`` the read's offset to it), 5%
    substitutions, codes 0 past each read's end; rows past ``n_reads``
    are padding (length 0, NO_CORE).  ``case`` crafts the block:
    ``ties`` repeats each read once (two equal predecessors), ``no_core``
    puts a third of the rows at NO_CORE, ``all_literal`` gives every row
    its own core, ``edge_shift`` alternates cp between 0 and L - 1 at full
    length (shifts of +-(L-1))."""
    rng = np.random.default_rng(seed)
    max_len = L if max_len is None else max_len
    n_reads = B if n_reads is None else n_reads
    genome = rng.integers(0, 4, 3 * L)
    bucket = np.cumsum(rng.integers(0, 7, B) == 0)
    anchor = rng.integers(L, 2 * L, bucket[-1] + 1)
    ln = rng.integers(0, max_len + 1, B)
    ln[: B // 9] = max_len
    cp = np.minimum(rng.integers(0, L, B), np.maximum(ln - 1, 0))
    if case == "edge_shift":
        ln[:] = L
        cp = np.where(np.arange(B) % 2, L - 1, 0)
    ck = bucket.astype(np.int64) * 7919 + 5
    if case == "no_core":
        ck[rng.random(B) < 1 / 3] = NO_CORE
    if case == "all_literal":
        ck = np.arange(B, dtype=np.int64)
    codes = np.zeros((B, L), np.uint8)
    for r in range(B):
        start = anchor[bucket[r]] - cp[r]
        codes[r, : ln[r]] = genome[start: start + ln[r]]
    mut = rng.random((B, L)) < 0.05
    codes[mut] = rng.integers(0, 4, int(mut.sum()))
    if case == "ties":
        codes[1::2], ln[1::2], cp[1::2], ck[1::2] = (codes[::2][: B // 2],
                                                     ln[::2][: B // 2],
                                                     cp[::2][: B // 2],
                                                     ck[::2][: B // 2])
    codes[np.arange(L)[None, :] >= ln[:, None]] = 0
    ln[n_reads:], ck[n_reads:], cp[n_reads:] = 0, NO_CORE, 0
    codes[n_reads:] = 0
    return codes, ln.astype(np.int64), ck, cp.astype(np.int64), n_reads


def _reference(codes, ln, ck, cp, n_reads):
    out = ref_encode._delta_seq(
        jnp.asarray(codes), jnp.asarray(ln.astype(np.int32)),
        jnp.asarray(ck.astype(np.uint32)), jnp.asarray(cp.astype(np.int32)),
        jnp.int32(n_reads))
    return {k: np.asarray(v) for k, v in out.items()}


def _torch(codes, ln, ck, cp):
    return [torch.from_numpy(a) for a in (codes, ln, ck, cp)]


DELTA_CASES = {
    "L16": dict(B=300, L=16),
    "L112, 101-base reads": dict(B=300, L=112, max_len=101),
    "L128": dict(B=512, L=128),
    "L160": dict(B=257, L=160),
    "L512": dict(B=96, L=512),
    "ties": dict(B=256, L=128, case="ties"),
    "no_core": dict(B=256, L=128, case="no_core"),
    "all_literal": dict(B=256, L=128, case="all_literal"),
    "edge_shift": dict(B=64, L=128, case="edge_shift"),
    "padding rows": dict(B=256, L=128, n_reads=200),
}


@pytest.mark.parametrize("case", list(DELTA_CASES))
def test_delta_seq_plain_matches_reference(case):
    kw = dict(DELTA_CASES[case])
    B, L = kw.pop("B"), kw.pop("L")
    codes, ln, ck, cp, n = delta_block(len(case), B, L, **kw)
    want = _reference(codes, ln, ck, cp, n)
    got = delta_seq.delta_seq_plain(*_torch(codes, ln, ck, cp), n)
    for name in ("mask_bits", "shifts", "pred_k", "lit_packed", "n_lits"):
        np.testing.assert_array_equal(got[name].numpy(), want[name],
                                      err_msg=name)
    shifts, pred_k = want["shifts"], want["pred_k"]
    if case == "ties":
        # each copy's twin is its nearest predecessor and wins the tie
        assert (pred_k[1::2] == 0).all() and (shifts[1::2] == 0).all()
    if case == "edge_shift":
        assert set(np.unique(shifts)) >= {-(L - 1), L - 1}
    if case == "all_literal":
        assert int(want["n_lits"]) == int(ln.sum())
        assert not want["mask_bits"].any()
    if case in ("L128", "no_core", "padding rows"):
        assert (pred_k > 0).any() and 0 < int(want["n_lits"]) < ln.sum()


def test_delta_seq_wrapper_on_cpu_takes_the_plain_version():
    """The public wrapper and ``encode._delta_seq`` on CPU tensors give
    the plain version's products and launch nothing."""
    codes, ln, ck, cp, n = delta_block(3, 200, 128, n_reads=190)
    args = (*_torch(codes, ln, ck, cp), n)
    before = delta_seq.delta_seq.launches
    want = delta_seq.delta_seq_plain(*args)
    for got in (delta_seq.delta_seq(*args), encode._delta_seq(*args)):
        assert got.keys() == want.keys()
        for name in want:
            assert torch.equal(got[name], want[name]), name
    assert delta_seq.delta_seq.launches == before


@pytest.mark.parametrize("W", [1, 7, 8, 10, 32, 33, 512, 2047])
def test_delta_seq_tile_plan(W):
    """The CUDA kernels' tile plan for W = L/16 words a row: at least one
    row a tile, both launches' shared bytes within a CTA's 232,448 on the
    H100, a power-of-two group of at most a warp that covers the row's
    words up to 32, and a tile of at least a warp's worth of words."""
    plan = delta_seq.tile_plan(W)
    assert plan.rows >= 1
    assert max(plan.match_smem, plan.place_smem) <= 232_448
    assert plan.group & (plan.group - 1) == 0
    assert min(W, 32) <= plan.group <= 32
    assert plan.rows * W >= 32
    assert plan.match_smem == (plan.rows + delta_seq.DELTA_K) * (4 * W + 16)


def _emissions(seed, T, N):
    """Random u16 words and emits ``[T, N]``, lane 0 emitting at every
    step and lane N-1 at none (when N > 1)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 16, (T, N)).astype(np.int32)
    emits = rng.random((T, N)) < rng.random(N)[None, :]
    emits[:, 0] = True
    if N > 1:
        emits[:, -1] = False
    return words, emits


@pytest.mark.parametrize("T,N", [(1, 1), (1, 45), (7, 50), (7, 333),
                                 (2048, 77),
                                 # the card's strip (64 lanes) and chunk
                                 # (32 steps): below, at and past each
                                 (31, 64), (32, 63), (33, 65), (64, 127),
                                 (96, 129)])
def test_compact_emissions_plain_matches_reference(T, N):
    """The plain version on the plain encoders' int32 words and on the
    int16 form the kernels K3 and K5 write (the u16 bits) both equal the
    reference's ``compact_emissions``, the int16 result read as u16."""
    words, emits = _emissions(T * 1000 + N, T, N)
    want_p, want_c = ref_rans.compact_emissions(jnp.asarray(words),
                                                jnp.asarray(emits))
    et = torch.from_numpy(emits)
    narrow = torch.from_numpy(words.astype(np.uint16).view(np.int16))
    for wt in (torch.from_numpy(words), narrow):
        got_p, got_c = compact.compact_emissions_plain(wt, et)
        assert got_p.dtype == wt.dtype
        np.testing.assert_array_equal(
            got_p.numpy().astype(np.int64) & 0xFFFF, np.asarray(want_p))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        assert got_c[0] == T and (N == 1 or got_c[-1] == 0)
        # the public function (also as rans.compact_emissions) on the CPU
        for fn in (compact.compact_emissions, rans.compact_emissions):
            p, c = fn(wt, et)
            assert torch.equal(p, got_p) and torch.equal(c, got_c)
