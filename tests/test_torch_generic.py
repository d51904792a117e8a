"""scalce_tpu_torch's generic coder API — K6 (``ops/histogram.py``,
``rans.context_histogram``) and K5 (``ops/rans_encode_flat.py``,
``rans.rans_encode``), one block or D blocks against their own tables —
against scalce_tpu's Pallas kernels in interpret mode and its XLA paths,
on the same numpy inputs.  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalce_tpu.models import entropy as ref_entropy
from scalce_tpu.ops import hist_pallas, rans_pallas
from scalce_tpu.ops import rans as ref_rans
from scalce_tpu_torch.ops import histogram, rans
from scalce_tpu_torch.ops.rans_encode_flat import (encode_grids,
                                                   encode_scan_flat_plain)

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)


#: awkward sizes: S not a tile multiple, cells not a multiple of the
#: kernel's lane factor, fewer cells than one lane row, one symbol
@pytest.mark.parametrize("S,n_ctx,n_syms", [
    (10_000, 761, 94), (16_384, 3041, 94), (777, 1, 94),
    (4096, 1401, 94), (1, 1, 3)])
def test_histogram_matches_pallas_and_scatter_add(S, n_ctx, n_syms):
    rng = np.random.default_rng(S)
    n_cells = n_ctx * n_syms
    sym = rng.integers(0, n_syms, S)
    ctx = rng.integers(0, n_ctx, S)
    ctx[: S // 4] = sym[: S // 4] = 0     # one hot cell, as padding is
    idx = ctx * n_syms + sym
    want = np.asarray(hist_pallas.histogram_pallas(
        jnp.asarray(idx, jnp.int32), n_cells, interpret=True))
    np.testing.assert_array_equal(
        want, np.bincount(idx, minlength=n_cells).astype(np.int32))
    got = histogram.histogram(torch.from_numpy(idx), n_cells)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        histogram.histogram_plain(torch.from_numpy(idx), n_cells).numpy(),
        want)
    got_ctx = rans.context_histogram(torch.from_numpy(sym),
                                     torch.from_numpy(ctx), n_ctx, n_syms)
    want_ctx = ref_rans.context_histogram(jnp.asarray(sym, jnp.uint32),
                                          jnp.asarray(ctx, jnp.uint32),
                                          n_ctx, n_syms)
    np.testing.assert_array_equal(got_ctx.numpy(), np.asarray(want_ctx))


@pytest.mark.parametrize("T,N", [(256, 384), (128, 128)])
def test_encode_scan_flat_matches_pallas_and_xla(T, N, monkeypatch):
    """K5's plain version and ``rans.rans_encode`` against
    ``encode_scan_pallas`` (interpret mode, 128 x 64 tiles) and the XLA
    scan, with a full-mass context (f = 4096: the renorm test must not
    overflow) and states that cross several tiles."""
    rng = np.random.default_rng(T + N)
    n_ctx, n_syms = 8, 16
    sym = rng.integers(0, n_syms, T * N)
    ctx = rng.integers(0, n_ctx, T * N)
    sym[ctx == 0] = 0                     # context 0: all mass on symbol 0
    counts = np.zeros((n_ctx, n_syms), np.int64)
    np.add.at(counts, (ctx, sym), 1)
    freq, cum = ref_entropy.device_normalize(
        jnp.asarray(counts.reshape(-1), jnp.int32), n_ctx, n_syms)
    flut, clut = freq.reshape(-1), cum.reshape(-1)
    assert int(freq[0, 0]) == 4096
    sym_j, ctx_j = jnp.asarray(sym, jnp.uint32), jnp.asarray(ctx, jnp.uint32)
    want_x = ref_rans.rans_encode(sym_j, ctx_j, flut, clut, n_syms, T)
    idx = ctx_j * jnp.uint32(n_syms) + sym_j
    monkeypatch.setattr(rans_pallas, "_NT", 128)
    monkeypatch.setattr(rans_pallas, "_TT", 64)
    want_p = rans_pallas.encode_scan_pallas(flut[idx].reshape(N, T).T,
                                            clut[idx].reshape(N, T).T,
                                            interpret=True)

    s, c = torch.from_numpy(sym), torch.from_numpy(ctx)
    f_t = torch.from_numpy(np.asarray(flut).astype(np.int64))
    c_t = torch.from_numpy(np.asarray(clut).astype(np.int64))
    f_all, c_all = rans.gather_tables(s, c, f_t, c_t, n_syms, T)
    np.testing.assert_array_equal(
        f_all.numpy(), np.asarray(flut[idx].reshape(N, T).T))
    for got in (encode_scan_flat_plain(f_all, c_all),
                encode_grids(s[None], c[None], f_t.reshape(1, n_ctx, n_syms),
                             c_t.reshape(1, n_ctx, n_syms), T),
                rans.rans_encode(s, c, f_t, c_t, n_syms, T)):
        states, words, emits = (g.numpy() for g in got)
        for want in (want_x, want_p):
            np.testing.assert_array_equal(states, np.asarray(want[0]))
            np.testing.assert_array_equal(emits, np.asarray(want[2]))
            e = np.asarray(want[2])
            np.testing.assert_array_equal(words[e], np.asarray(want[1])[e])


@pytest.mark.parametrize("D,T", [(1, 128), (3, 256), (4, 64)])
def test_grid_entries_match_the_reference_over_stacked_tables(D, T):
    """K6's grid_histogram and K5's encode_grids over D blocks' grids,
    each block against its own table, equal the reference's
    context_histogram and rans_encode over the stacked tables (the
    reference's generic data-parallel branch)."""
    rng = np.random.default_rng(D * T)
    n_ctx, n_syms, S = 12, 94, 2 * T
    sym = rng.integers(0, n_syms, (D, S))
    ctx = rng.integers(0, n_ctx, (D, S))
    sym[ctx == 0] = 0
    stacked = ctx + n_ctx * np.arange(D)[:, None]
    want_h = np.asarray(ref_rans.context_histogram(
        jnp.asarray(sym.reshape(-1), jnp.uint32),
        jnp.asarray(stacked.reshape(-1), jnp.uint32), D * n_ctx, n_syms))
    got_h = histogram.grid_histogram(torch.from_numpy(sym),
                                     torch.from_numpy(ctx), n_ctx, n_syms)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    freq, cum = ref_entropy.device_normalize(
        jnp.asarray(want_h, jnp.int32).reshape(D * n_ctx, n_syms)
        .reshape(-1), D * n_ctx, n_syms)
    want = ref_rans.rans_encode(jnp.asarray(sym.reshape(-1), jnp.uint32),
                                jnp.asarray(stacked.reshape(-1), jnp.uint32),
                                freq.reshape(-1), cum.reshape(-1), n_syms, T)
    tables = [torch.from_numpy(np.asarray(t).astype(np.int64)).reshape(
        D, n_ctx, n_syms) for t in (freq, cum)]
    states, words, emits = encode_grids(torch.from_numpy(sym),
                                        torch.from_numpy(ctx), *tables, T)
    np.testing.assert_array_equal(states.numpy(), np.asarray(want[0]))
    e = np.asarray(want[2])
    np.testing.assert_array_equal(emits.numpy(), e)
    np.testing.assert_array_equal(words.numpy()[e], np.asarray(want[1])[e])
