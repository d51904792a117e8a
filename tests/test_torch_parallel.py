"""scalce_tpu_torch's single-host data parallelism against scalce_tpu's
(JAX on the 8-device CPU mesh that conftest provides) and against the
port's own single-device path: payloads, triplets, and the sharded
stage 1 and quality encode leaf for leaf.  Every comparison is exact."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scalce_tpu
import scalce_tpu_torch
from portbench.reference import records as ref_records
from scalce_tpu.config import Config as RefConfig
from scalce_tpu.io import fastq
from scalce_tpu.models import lossy
from scalce_tpu.parallel import mesh as ref_mesh
from scalce_tpu.streams import qualities as ref_q
from scalce_tpu.utils.synth import synth_fastq
from scalce_tpu_torch import timing
from scalce_tpu_torch.config import Config
from scalce_tpu_torch.parallel import mesh
from scalce_tpu_torch.pipeline.encode import BlockEncoder
from scalce_tpu_torch.streams import qualities

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

SLICE = dict(block_reads=1 << 10, max_read_len=128, qual_T_target=2048,
             core_on_device=True, delta_on_device=True, qual_on_device=True,
             qual_context_order=1, dict_mode="hash", backend="gz",
             threads=1)


@pytest.fixture(scope="module")
def fastq_file(tmp_path_factory):
    """4.5 blocks of ragged reads with N bases."""
    d = str(tmp_path_factory.mktemp("dp"))
    src = os.path.join(d, "in.fastq")
    with open(src, "wb") as f:
        f.write(synth_fastq(4600, 100, seed=23, genome_len=50_000,
                            var_len=True, n_rate=0.01))
    cfg = Config(inputs=(src,), **SLICE)
    blocks = list(fastq.iter_blocks(src, cfg.block_reads, cfg.max_read_len))
    assert len(blocks) == 5 and blocks[-1].n_reads < cfg.block_reads
    return {"dir": d, "src": src, "cfg": cfg,
            "ref_cfg": RefConfig(inputs=(src,), **SLICE), "blocks": blocks}


def _triplet(prefix):
    out = {}
    for path in sorted(glob.glob(prefix + ".*.scalce[nrq]")):
        with open(path, "rb") as f:
            out[path[len(prefix):]] = f.read()
    return out


def test_sharded_encoder_matches_reference_and_single_device(fastq_file):
    """Two devices x group 2: one full group of 4 and a tail of 1."""
    cfg, blocks = fastq_file["cfg"], fastq_file["blocks"]
    senc = mesh.ShardedEncoder(cfg, "cpu", mesh=mesh.local_mesh(2, "cpu"),
                               group=2)
    ref = ref_mesh.ShardedEncoder(fastq_file["ref_cfg"], lossy.identity_map(),
                                  mesh=ref_mesh.local_mesh(2), group=2)
    assert senc.D == ref.D == 4
    items = [(b,) for b in blocks]
    got = [eb for eb, in senc.encode(items[:4]) + senc.encode(items[4:])]
    want = ref.encode_blocks(blocks[:4]) + ref.encode_blocks(blocks[4:])
    single = [eb for eb, in BlockEncoder(cfg, "cpu").encode(items)]
    for g, w, s in zip(got, want, single):
        assert g.block_id == w.block_id == s.block_id
        assert g.payloads == w.payloads == s.payloads


def test_data_parallel_driver_matches_reference(fastq_file, monkeypatch):
    """Both drivers over two devices (groups 2, 2 and a tail of 1) write
    the reference's single-device triplet."""
    d, src = fastq_file["dir"], fastq_file["src"]
    two, cpus = ref_mesh.local_mesh(2), mesh.local_mesh(2, "cpu")
    monkeypatch.setattr(ref_mesh, "local_mesh", lambda n=None: two)
    monkeypatch.setattr(mesh, "local_mesh", lambda n=None, device=None: cpus)
    outs = {}
    for name, pkg, dp in (("ref_dp", scalce_tpu, True),
                          ("ref_one", scalce_tpu, False),
                          ("port_dp", scalce_tpu_torch, True)):
        cfg = (RefConfig if pkg is scalce_tpu else Config)(
            inputs=(src,), output=os.path.join(d, name), data_parallel=dp,
            **SLICE)
        if pkg is scalce_tpu:
            pkg.compress(cfg)
        else:
            stats = pkg.compress(cfg, "cpu")
            assert stats.device == "cpu,cpu" and stats.n_blocks == 5
        outs[name] = _triplet(os.path.join(d, name))
    assert sorted(outs["port_dp"]) == [".00.scalcen", ".00.scalceq",
                                       ".00.scalcer"]
    assert outs["port_dp"] == outs["ref_dp"] == outs["ref_one"]


def test_data_parallel_cpu_device_is_one_device(fastq_file):
    """``--device cpu`` under --data-parallel is one device, group 1:
    every block runs the group path (K5/K6 plain versions), same
    triplet as the single-device driver, also when resuming."""
    d, src = fastq_file["dir"], fastq_file["src"]
    assert mesh.local_mesh(device="cpu") == [torch.device("cpu")]
    for name, dp in (("one", False), ("dp1", True)):
        scalce_tpu_torch.compress(Config(
            inputs=(src,), output=os.path.join(d, name), data_parallel=dp,
            **SLICE), "cpu")
    assert _triplet(os.path.join(d, "dp1")) == _triplet(os.path.join(d, "one"))


@pytest.mark.parametrize("block_reads,grouped,tail", [
    (512, 8, 1), (1024, 4, 1), (2048, 0, 3)])
def test_qual_device_data_parallel_over_four_devices(
        fastq_file, tmp_path, monkeypatch, block_reads, grouped, tail):
    """``--data-parallel --qual-device --qual-order 1`` over a mesh of
    four devices (groups of 4 and a tail, a tail alone): the one-device
    encoder's triplet byte for byte, a ``--qual-device`` decompress
    whose records are the input's under the plain reference, and the
    dispatch's counts of the blocks of full groups and of tail groups."""
    d, src = str(tmp_path), fastq_file["src"]
    four = [torch.device("cpu")] * 4
    monkeypatch.setattr(mesh, "local_mesh", lambda n=None, device=None: four)
    kw = {**SLICE, "block_reads": block_reads, "threads": 2}
    scalce_tpu_torch.compress(Config(inputs=(src,), output=os.path.join(
        d, "one"), **kw), "cpu")
    with timing.profile(os.path.join(d, "trace"), "cpu"):
        stats = scalce_tpu_torch.compress(Config(
            inputs=(src,), output=os.path.join(d, "dp4"), data_parallel=True,
            **kw), "cpu")
    assert stats.device == "cpu,cpu,cpu,cpu"
    assert stats.n_blocks == grouped + tail
    counts = timing.counters()["compress"]
    assert counts.get("grouped_blocks", 0) == grouped
    assert counts.get("tail_blocks", 0) == tail
    assert _triplet(os.path.join(d, "dp4")) == _triplet(os.path.join(d, "one"))
    scalce_tpu_torch.decompress(Config(
        mode="decompress", inputs=(os.path.join(d, "dp4.00.scalcen"),),
        output=os.path.join(d, "dec"), qual_on_device=True, threads=2), "cpu")
    with open(src, "rb") as f, open(os.path.join(d, "dec.fastq"), "rb") as g:
        want, got = ref_records.records([f.read()]), ref_records.records(
            [g.read()])
    assert len(got) == 4600 and ref_records.mismatched(want, got) == 0


def _stacked(blocks):
    """The reference's stacked stage-1 inputs of a group."""
    D = len(blocks)
    B, L = blocks[0].seq.shape
    exc = np.zeros((D, B, L), bool)
    for i, b in enumerate(blocks):
        exc[i].reshape(-1)[b.exc_pos] = True
    return (jnp.asarray(np.stack([b.seq for b in blocks])),
            jnp.asarray(np.stack([b.qual for b in blocks])),
            jnp.asarray(np.stack([b.lengths for b in blocks])),
            jnp.asarray(np.asarray([b.n_reads for b in blocks], np.int32)),
            jnp.asarray(exc))


def test_sharded_stages_match_reference_leaf_for_leaf(fastq_file):
    """Per device (two devices x group 2): stage 1's permutation, delta,
    lengths, grids and the one-launch group histogram, then the group
    quality encode's tables, states, packed words and counts, against
    make_sharded_stage1 / make_sharded_qual_encode."""
    cfg, blocks = fastq_file["cfg"], fastq_file["blocks"][:4]
    k, seed, order = cfg.core_k, cfg.dict_seed, cfg.qual_context_order
    B, L = blocks[0].seq.shape
    T = qualities.pick_T(B, L, cfg.qual_T_target)
    m = ref_mesh.local_mesh(2)
    perm_r, delta_r, len_r, sym_r, ctx_r, counts_r = \
        ref_mesh.make_sharded_stage1(m, k, seed, order)(
            *_stacked(blocks), jnp.arange(256, dtype=jnp.uint8),
            jnp.zeros(1, jnp.uint32))
    delta_r = {name: np.asarray(v) for name, v in delta_r.items()}
    C = qualities.n_contexts(order)
    enc_r = ref_mesh.make_sharded_qual_encode(m, C, qualities.N_SYMS, T,
                                              order)(sym_r, ctx_r, counts_r)
    enc_r = [np.asarray(x) for x in enc_r]
    assert T == ref_q.pick_T(B, L, cfg.qual_T_target)

    for dev in range(2):
        share = blocks[2 * dev:2 * dev + 2]
        pre = mesh.upload_blocks(share, "cpu")
        perm, delta, len_s, sym, ctx, counts = mesh.stage1(
            pre, [b.n_reads for b in share], k, seed, order)
        rows = slice(2 * dev, 2 * dev + 2)
        for j in range(2):
            r = 2 * dev + j
            np.testing.assert_array_equal(perm[j].numpy(),
                                          np.asarray(perm_r)[r])
            np.testing.assert_array_equal(len_s[j].numpy(),
                                          np.asarray(len_r)[r])
            for name, want in delta_r.items():
                np.testing.assert_array_equal(delta[j][name].numpy(),
                                              want[r], err_msg=name)
        for name, got, want in (("sym", sym, sym_r), ("ctx", ctx, ctx_r),
                                ("counts", counts, counts_r)):
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(want)[rows],
                                          err_msg=name)
        got_enc = qualities.group_encode(sym, ctx, counts, T, order)
        for name, got, want in zip(("freq", "states", "packed", "wcounts"),
                                   got_enc, enc_r):
            np.testing.assert_array_equal(got.numpy(), want[rows],
                                          err_msg=name)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_group_histogram_and_encode_match_per_block(order):
    """A group's one-launch histogram and encode equal each block's
    single-block K2 histogram and K3 pass B, at every context order."""
    rng = np.random.default_rng(order)
    D, B, L = 3, 64, 64
    walk = np.clip(np.cumsum(rng.integers(-2, 3, (D, B, L)), axis=2) + 38,
                   2, 80) + 33
    lengths = rng.integers(0, L + 1, (D, B)).astype(np.int32)
    grids = [qualities.sym_ctx_hist(torch.from_numpy(walk[d].astype(
        np.uint8)), torch.from_numpy(lengths[d]), order) for d in range(D)]
    sym = torch.stack([g[0] for g in grids])
    ctx = torch.stack([g[1] for g in grids])
    counts = qualities.group_histogram(sym, ctx, order)
    T = qualities.pick_T(B, L, 1024)
    freq, states, packed, wcounts = qualities.group_encode(sym, ctx, counts,
                                                           T, order)
    for d in range(D):
        one = grids[d][2]
        assert torch.equal(counts[d], one)
        enc = qualities.encode_from_grids(sym[d], ctx[d], one, B, L, order,
                                          1024)
        got = qualities.finish_encoded(freq[d], states[d], packed[d],
                                       wcounts[d], B, L, T, order)
        for field in ("freq", "states", "counts", "words"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(enc, field), err_msg=field)
