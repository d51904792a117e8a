"""The bare command's path: qualities coded on the host, each block at the
order its trial picks.  scalce_tpu_torch's CLI with its defaults writes
scalce_tpu's CLI triplet byte for byte and each decodes the other's; the
copied host codec (encode_host, _auto_order, decode_host, native and
numpy) equals the reference's; --data-parallel with host qualities gives
the single-device bytes; --stats-json carries the reference's keys."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import scalce_tpu
import scalce_tpu.cli as ref_cli
from scalce_tpu.config import Config as RefConfig
from scalce_tpu.models import lossy as ref_lossy
from scalce_tpu.parallel import mesh as ref_mesh
from scalce_tpu.pipeline import driver as ref_driver
from scalce_tpu.streams import qualities as ref_q
from scalce_tpu.utils.synth import synth_fastq
from scalce_tpu_torch import cli, container
from scalce_tpu_torch.config import Config
from scalce_tpu_torch.io import fastq
from scalce_tpu_torch.parallel import mesh
from scalce_tpu_torch.pipeline import driver
from scalce_tpu_torch.pipeline.encode import BlockEncoder
from scalce_tpu_torch.streams import qualities, qualities_host

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

#: 9000 HiSeq-profile reads in blocks of 4096: the trial picks order 3
#: for the two full blocks and order 1 for the 808-read tail
READS, BLOCK = 9000, 4096


def _triplet(prefix):
    out = {}
    for path in sorted(glob.glob(prefix + ".*.scalce[nrq]")):
        with open(path, "rb") as f:
            out[path[len(prefix):]] = f.read()
    return out


def _orders(prefix):
    reader = container.TripletReader(prefix + ".00.scalcen")
    return [qualities.parse(p["q"]).order for _, p in reader.iter_blocks()]


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """The file compressed by both CLIs with their defaults (gz)."""
    d = str(tmp_path_factory.mktemp("cli"))
    src = os.path.join(d, "in.fastq")
    data = synth_fastq(READS, 100, seed=5, qual_model="hiseq")
    with open(src, "wb") as f:
        f.write(data)
    args = [src, "-c", "gz", "--block-reads", str(BLOCK)]
    ref_cli.main(args + ["-o", os.path.join(d, "ref")])
    cli.main(args + ["-o", os.path.join(d, "port"), "--device", "cpu"])
    return {"dir": d, "src": src, "data": data}


def test_cli_defaults_write_the_reference_bytes(cli_files):
    d = cli_files["dir"]
    ref, port = _triplet(os.path.join(d, "ref")), \
        _triplet(os.path.join(d, "port"))
    assert sorted(port) == [".00.scalcen", ".00.scalceq", ".00.scalcer"]
    assert port == ref
    # auto-selection picked more than one order, within one decode group
    assert _orders(os.path.join(d, "port")) == [3, 3, 1]


@pytest.mark.parametrize("keep_order", [True, False])
def test_cli_defaults_cross_decode(cli_files, keep_order):
    """Each CLI's bare decompress (host quality decode) reads the other's
    triplet, whose group of blocks mixes orders; the port's device
    decode (--qual-device) gives the same bytes."""
    d = cli_files["dir"]
    ko = ["--keep-order"] if keep_order else []
    tag = "k" if keep_order else "r"
    ref_cli.main(["-d", os.path.join(d, "port.00.scalcen"), "-o",
                  os.path.join(d, "rd" + tag)] + ko)
    cli.main(["-d", os.path.join(d, "ref.00.scalcen"), "-o",
              os.path.join(d, "pd" + tag), "--device", "cpu"] + ko)
    cli.main(["-d", os.path.join(d, "ref.00.scalcen"), "-o",
              os.path.join(d, "qd" + tag), "--device", "cpu",
              "--qual-device"] + ko)
    outs = [open(os.path.join(d, name + tag + ".fastq"), "rb").read()
            for name in ("rd", "pd", "qd")]
    assert outs[0] == outs[1] == outs[2]
    assert (outs[0] == cli_files["data"]) == keep_order


def _one_block(path, data, B, L=128):
    with open(path, "wb") as f:
        f.write(data)
    (block,) = list(fastq.iter_blocks(path, B, L))
    return block


def _block(tmp_path, seed, B=2048):
    """One HiSeq-profile block with ragged lengths and N bases, and a
    permutation that moves every row."""
    block = _one_block(os.path.join(tmp_path, "b.fastq"), synth_fastq(
        B, 100, seed=seed, qual_model="hiseq", var_len=True, n_rate=0.01), B)
    perm = np.random.default_rng(seed).permutation(B).astype(np.int64)
    return block, perm, block.lengths[perm]


def _lossy_map(block):
    return ref_lossy.build_quant_map(ref_lossy.sample_histogram(
        block.qual, block.lengths, block.n_reads), 30)


def _equal_enc(got, want):
    for field in ("freq", "states", "counts", "words"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert (got.B, got.L, got.T, got.order) == \
        (want.B, want.L, want.T, want.order)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("order", [0, 1, 2, 3])
@pytest.mark.parametrize("lossy", [False, True])
def test_encode_host_matches_reference(order, lossy, native, monkeypatch,
                                       tmp_path):
    """encode_host through a sort permutation, lossless or through a -p
    30 map, native or numpy, at a fixed order or auto (0), equals the
    reference's; decode_host gives the sorted (mapped) qualities back."""
    block, perm, len_s = _block(tmp_path, order + 10 * lossy)
    qmap = _lossy_map(block) if lossy else None
    if not native:
        monkeypatch.setattr(qualities_host, "_NATIVE_Q", False)
        monkeypatch.setattr(ref_q, "_NATIVE_Q", False)
    got = qualities_host.encode_host(block.qual, len_s, order, 1024, qmap,
                                     perm)
    want = ref_q.encode_host(block.qual, len_s, order, 1024, qmap, perm)
    _equal_enc(got, want)
    back = qualities_host.decode_host(got, len_s)
    np.testing.assert_array_equal(back, ref_q.decode_host(want, len_s))
    sorted_q = (block.qual if qmap is None else qmap[block.qual])[perm]
    valid = np.arange(block.qual.shape[1])[None, :] < len_s[:, None]
    np.testing.assert_array_equal(back, np.where(valid, sorted_q, 0))


@pytest.mark.parametrize("native", [True, False])
def test_auto_order_matches_reference(native, monkeypatch, tmp_path):
    """The trial's pick on blocks whose best order is 1 (Illumina
    profile) and 3 (HiSeq), in the sorted frame or through ``perm``."""
    if not native:
        monkeypatch.setattr(qualities_host, "_NATIVE_Q", False)
        monkeypatch.setattr(ref_q, "_NATIVE_Q", False)
    picks = []
    for model in ("illumina", "hiseq"):
        b = _one_block(os.path.join(tmp_path, model + ".fastq"),
                       synth_fastq(BLOCK, 100, seed=3, qual_model=model),
                       BLOCK)
        perm = np.random.default_rng(1).permutation(BLOCK)
        for p in (None, perm):
            ln = b.lengths if p is None else b.lengths[p]
            got = qualities_host._auto_order(b.qual, ln, 128, p)
            assert got == ref_q._auto_order(b.qual, ln, 128, p)
            picks.append(got)
    assert picks == [1, 1, 3, 3]


def test_table_cost_matches_reference():
    rng = np.random.default_rng(4)
    for order in (1, 2, 3):
        counts = rng.integers(0, 30, qualities.n_contexts(order) * 94) * (
            rng.random(qualities.n_contexts(order) * 94) < 0.2)
        assert qualities_host._trial_cost(counts, order, 3.5) == \
            ref_q._trial_cost(counts, order, 3.5)


SLICE = dict(block_reads=1024, max_read_len=128, qual_T_target=2048,
             core_on_device=True, delta_on_device=True, dict_mode="hash",
             backend="gz", threads=1)


@pytest.mark.parametrize("lossy_pct", [0, 30])
def test_data_parallel_host_qualities_match_single_device(tmp_path,
                                                          lossy_pct):
    """Two devices x group 2 over 4.5 blocks (one group and a tail),
    host qualities at auto order: the ShardedEncoder's payloads equal
    the single-device encoder's and the reference's; the
    --data-parallel driver's triplet equals the reference's."""
    src = os.path.join(tmp_path, "in.fastq")
    with open(src, "wb") as f:
        f.write(synth_fastq(4600, 100, seed=31, genome_len=50_000,
                            var_len=True, n_rate=0.01, qual_model="hiseq"))
    kw = dict(SLICE, lossy_pct=lossy_pct, sample_size=1500)
    cfg = Config(inputs=(src,), **kw)
    blocks = list(fastq.iter_blocks(src, cfg.block_reads, cfg.max_read_len))
    qmap = ref_driver._lossy_preamble(RefConfig(inputs=(src,), **kw),
                                      iter(blocks))[0]
    senc = mesh.ShardedEncoder(cfg, "cpu", mesh=mesh.local_mesh(2, "cpu"),
                               group=2, qual_map=qmap)
    ref = ref_mesh.ShardedEncoder(RefConfig(inputs=(src,), **kw), qmap,
                                  mesh=ref_mesh.local_mesh(2), group=2)
    items = [(b,) for b in blocks]
    got = [eb for eb, in senc.encode(items[:4]) + senc.encode(items[4:])]
    want = ref.encode_blocks(blocks[:4]) + ref.encode_blocks(blocks[4:])
    single = [eb for eb, in BlockEncoder(cfg, "cpu", qmap).encode(items)]
    for g, w, s in zip(got, want, single):
        assert g.payloads == w.payloads == s.payloads
    outs = {}
    for name, dp in (("dp", True), ("one", False)):
        driver.compress(Config(inputs=(src,), output=os.path.join(
            tmp_path, name), data_parallel=dp, **kw), "cpu")
        outs[name] = _triplet(os.path.join(tmp_path, name))
    scalce_tpu.compress(RefConfig(inputs=(src,), output=os.path.join(
        tmp_path, "ref"), **kw))
    assert outs["dp"] == outs["one"] == _triplet(os.path.join(tmp_path,
                                                              "ref"))


def test_run_stats_keys_cover_the_reference(tmp_path):
    """--stats-json of a compress and a decompress: every key of the
    reference's record, plus ``device``; the stage seconds of the
    compress name the reference's stages."""
    src = os.path.join(tmp_path, "in.fastq")
    with open(src, "wb") as f:
        f.write(synth_fastq(1500, 100, seed=2))
    ref_keys = set(json.loads(ref_driver.RunStats(
        mode="compress", input_bytes=1, output_bytes=1,
        wall_s=1.0).to_json()))
    assert {"GBps", "stage_s", "placement", "ratio"} <= ref_keys
    prefix = os.path.join(tmp_path, "o")
    stats = driver.compress(Config(inputs=(src,), output=prefix, **SLICE),
                            "cpu")
    record = json.loads(stats.to_json())
    assert ref_keys | {"device"} == set(record)
    assert set(record["stage_s"]) == {"device_dispatch", "assemble"}
    assert record["placement"] == "device" and record["GBps"] > 0
    assert [f.name for f in dataclasses.fields(ref_driver.RunStats)] == [
        f.name for f in dataclasses.fields(driver.RunStats)
        if f.name != "device"]
    dstats = driver.decompress(Config(mode="decompress", inputs=(
        prefix + ".00.scalcen",), output=os.path.join(tmp_path, "d")),
        "cpu")
    assert (ref_keys - {"ratio"}) | {"device"} <= set(json.loads(
        dstats.to_json()))


def test_paired_data_parallel_host_qualities_match_reference(tmp_path,
                                                             monkeypatch):
    """A ragged lossy pair through --data-parallel over two devices (one
    group of 2 pairs and a tail pair), host qualities at auto order: the
    reference's _1/_2 triplets."""
    from scalce_tpu.utils.synth import synth_pair
    paths = tuple(os.path.join(tmp_path, f"m{m}.fastq") for m in (1, 2))
    for path, data in zip(paths, synth_pair(2600, 100, seed=6, var_len=True,
                                            n_rate=0.01)):
        with open(path, "wb") as f:
            f.write(data)
    kw = dict(SLICE, inputs=paths, paired=True, lossy_pct=30,
              sample_size=500)
    cpus = mesh.local_mesh(2, "cpu")
    monkeypatch.setattr(mesh, "local_mesh", lambda n=None, device=None: cpus)
    driver.compress(Config(output=os.path.join(tmp_path, "dp"),
                           data_parallel=True, **kw), "cpu")
    scalce_tpu.compress(RefConfig(output=os.path.join(tmp_path, "ref"), **kw))
    got = _triplet(os.path.join(tmp_path, "dp"))
    assert len(got) == 6
    assert got == _triplet(os.path.join(tmp_path, "ref"))
