"""Paired-end (-r) on the CPU: scalce_tpu_torch writes scalce_tpu's
``_1``/``_2`` triplets byte for byte (uniform and ragged reads with N
bases), the triplets cross-decode in both directions with the pairs in
sync, the data-parallel pair encoder equals the reference's and the
single device, the card-decode decompress finishes a block a task in
block order, a resumed paired compress gives the inputs back, and
mates that disagree on their blocks are refused."""

import glob
import os
import shutil
import threading
import time

import pytest
import torch

import scalce_tpu
import scalce_tpu_torch
from scalce_tpu.config import Config as RefConfig
from scalce_tpu.io import fastq
from scalce_tpu.models import lossy as ref_lossy
from scalce_tpu.parallel import mesh as ref_mesh
from scalce_tpu.pipeline import encode as ref_encode
from scalce_tpu.utils.synth import synth_pair
from scalce_tpu_torch import timing
from scalce_tpu_torch.config import Config
from scalce_tpu_torch.io import fastq as port_fastq
from scalce_tpu_torch.parallel import mesh
from scalce_tpu_torch.pipeline.encode import BlockEncoder

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

SLICE = dict(block_reads=1024, max_read_len=128, qual_T_target=2048,
             core_on_device=True, delta_on_device=True, qual_on_device=True,
             qual_context_order=1, dict_mode="hash", backend="gz",
             threads=1)

#: name -> synth_pair arguments
CASES = {"uniform": {}, "ragged": dict(var_len=True, n_rate=0.01)}

#: the bare command's qualities: the host codec, each block at the order
#: its trial picks
_HOST_Q = dict(qual_on_device=False, qual_context_order=0)
#: placement -> Config fields on top of SLICE
PLACEMENTS = {"device qualities": {}, "host qualities": _HOST_Q,
              "host delta": dict(_HOST_Q, delta_on_device=False),
              "host core": dict(_HOST_Q, delta_on_device=False,
                                core_on_device=False)}


def _triplets(prefix):
    out = {}
    for path in sorted(glob.glob(prefix + ".*.scalce[nrq]")):
        with open(path, "rb") as f:
            out[path[len(prefix):]] = f.read()
    return out


def _decompress(pkg, src, out, **kw):
    """Decompress the paired triplet ``src`` (named by ``src``'s file)
    -> (mate 1 bytes, mate 2 bytes)."""
    cfg = (RefConfig if pkg is scalce_tpu else Config)(
        mode="decompress", inputs=(src,), output=out, **kw)
    if pkg is scalce_tpu:
        scalce_tpu.decompress(cfg)
    else:
        scalce_tpu_torch.decompress(cfg, "cpu")
    return tuple(open(f"{out}_{m}.fastq", "rb").read() for m in (1, 2))


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request, tmp_path_factory):
    """2.5 blocks of 1024 reads per mate, compressed by both packages."""
    d = str(tmp_path_factory.mktemp(request.param))
    a, b = synth_pair(2560, 100, seed=31, genome_len=50_000,
                      **CASES[request.param])
    paths = (os.path.join(d, "a.fastq"), os.path.join(d, "b.fastq"))
    for p, data in zip(paths, (a, b)):
        with open(p, "wb") as f:
            f.write(data)
    ref, port = os.path.join(d, "ref"), os.path.join(d, "port")
    scalce_tpu.compress(RefConfig(inputs=paths, paired=True, output=ref,
                                  **SLICE))
    stats = scalce_tpu_torch.compress(Config(inputs=paths, paired=True,
                                             output=port, **SLICE), "cpu")
    assert stats.n_reads == 2 * 2560 and stats.n_blocks == 3
    return {"dir": d, "data": (a, b), "paths": paths, "ref": ref,
            "port": port}


def test_paired_compress_matches_reference_bytes(pair):
    ref, port = _triplets(pair["ref"]), _triplets(pair["port"])
    assert sorted(ref) == [f".00_{m}.scalce{s}" for m in (1, 2)
                           for s in "nqr"]
    assert port == ref


def test_paired_triplets_cross_decode(pair):
    """Keep-order decompress gives both inputs back, whichever package
    wrote the triplets and whichever mate's file names them."""
    d = pair["dir"]
    assert _decompress(scalce_tpu_torch, pair["ref"] + ".00_2.scalcen",
                       os.path.join(d, "a"), keep_order=True,
                       qual_on_device=True) == pair["data"]
    assert _decompress(scalce_tpu, pair["port"] + ".00_1.scalcen",
                       os.path.join(d, "b"), keep_order=True) == pair["data"]


def test_paired_reordered_decode_matches_reference(pair):
    """Without keep-order both mates come back in mate 1's sorted order,
    still in sync — the reference's bytes."""
    d = pair["dir"]
    got = _decompress(scalce_tpu_torch, pair["port"] + ".00_1.scalcen",
                      os.path.join(d, "c"), qual_on_device=True)
    want = _decompress(scalce_tpu, pair["ref"] + ".00_1.scalcen",
                       os.path.join(d, "e"))
    assert got == want and got != pair["data"]


def test_sharded_encoder_pairs_match_reference_and_single_device(pair):
    """Two CPU devices x group 2 over 5 pairs of 512-read blocks: one
    full group of 4 pairs and a tail of 1."""
    cfg = Config(inputs=pair["paths"], paired=True,
                 **{**SLICE, "block_reads": 512})
    pairs = list(fastq.iter_paired_blocks(*pair["paths"], 512, 128))
    assert len(pairs) == 5
    senc = mesh.ShardedEncoder(cfg, "cpu", mesh=mesh.local_mesh(2, "cpu"),
                               group=2)
    ref = ref_mesh.ShardedEncoder(
        RefConfig(inputs=pair["paths"], paired=True,
                  **{**SLICE, "block_reads": 512}),
        ref_lossy.identity_map(), mesh=ref_mesh.local_mesh(2), group=2)
    assert senc.D == ref.D == 4
    got = senc.encode(pairs[:4]) + senc.encode(pairs[4:])
    want = ref.encode_block_pairs(pairs[:4]) + ref.encode_block_pairs(
        pairs[4:])
    single = BlockEncoder(cfg, "cpu").encode(pairs)
    assert len(got) == len(want) == len(single) == 5
    for g, w, s in zip(got, want, single):
        for mate in (0, 1):
            assert g[mate].block_id == w[mate].block_id == s[mate].block_id
            assert g[mate].payloads == w[mate].payloads == s[mate].payloads


@pytest.fixture(scope="module")
def mates(tmp_path_factory):
    """One 1,024-read block a mate (ragged reads with N bases): the
    mates' paths and the pair of blocks."""
    d = str(tmp_path_factory.mktemp("mates"))
    paths = (os.path.join(d, "a.fastq"), os.path.join(d, "b.fastq"))
    for p, data in zip(paths, synth_pair(1024, 100, seed=37,
                                         genome_len=50_000, var_len=True,
                                         n_rate=0.01)):
        with open(p, "wb") as f:
            f.write(data)
    (item,) = fastq.iter_paired_blocks(*paths, 1024, 128)
    return paths, item


@pytest.mark.parametrize("n_mates", [1, 2])
@pytest.mark.parametrize("placement", list(PLACEMENTS))
def test_mates_follow_mate_one(mates, placement, n_mates):
    """The port's whole-item encode of one mate, or of a pair (mate 1
    sorts, mate 2 follows its permutation), under each placement equals
    the reference's ``encode_block`` or ``encode_block_pair``."""
    paths, pair = mates
    item = pair[:n_mates]
    kw = dict(inputs=paths[:n_mates], paired=n_mates == 2,
              **{**SLICE, **PLACEMENTS[placement]})
    enc = BlockEncoder(Config(**kw), "cpu")
    assert enc.placement == ("host" if placement == "host core"
                             else "device")
    ref = ref_encode.BlockEncoder(RefConfig(**kw))
    want = ref.encode_block_pair(*item) if n_mates == 2 \
        else (ref.encode_block(*item),)
    (got,) = enc.encode([item])
    assert len(got) == len(want) == n_mates
    for g, w in zip(got, want):
        assert g.block_id == w.block_id and g.n_reads == w.n_reads
        assert g.payloads == w.payloads


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """10 blocks of 256 pairs a mate (the last of 100): two decode groups
    of four and a tail group of two, compressed by the port."""
    d = str(tmp_path_factory.mktemp("groups"))
    data = synth_pair(9 * 256 + 100, 100, seed=37, genome_len=50_000,
                      var_len=True, n_rate=0.01)
    paths = (os.path.join(d, "a.fastq"), os.path.join(d, "b.fastq"))
    for p, x in zip(paths, data):
        with open(p, "wb") as f:
            f.write(x)
    stats = scalce_tpu_torch.compress(Config(
        inputs=paths, paired=True, output=os.path.join(d, "o"),
        **{**SLICE, "block_reads": 256}), "cpu")
    assert stats.n_blocks == 10
    return {"dir": d, "data": data, "src": os.path.join(d, "o.00_1.scalcen")}


@pytest.mark.parametrize("keep_order", [True, False])
def test_device_decode_finish_per_block_is_the_host_decode(groups,
                                                           keep_order):
    """At -T 4 the card-decode decompress, a finish task a block, writes
    the host decode's bytes; keep-order gives the input pairs back."""
    d = groups["dir"]
    tag = "k" if keep_order else "r"
    got, want = (_decompress(scalce_tpu_torch, groups["src"],
                             os.path.join(d, name + tag), threads=4,
                             keep_order=keep_order, qual_on_device=dev)
                 for name, dev in (("dev", True), ("host", False)))
    assert got == want
    assert (got == groups["data"]) == keep_order


def test_device_decode_counts_a_finish_task_a_block(groups, tmp_path):
    with timing.profile(str(tmp_path / "t"), "cpu"):
        _decompress(scalce_tpu_torch, groups["src"], str(tmp_path / "d"),
                    threads=4, keep_order=True, qual_on_device=True)
    counts = timing.counters()["decompress"]
    assert counts["finish_tasks"] == counts["finish_blocks"] == 10 * 2


def test_device_decode_keeps_block_order_when_block_0_renders_last(
        groups, tmp_path, monkeypatch):
    """The first render sleeps while the other blocks' tasks finish: the
    writes still come in block order."""
    render = port_fastq.render_fastq_records
    first = threading.Lock()

    def slow_first(*args):
        if first.acquire(blocking=False):
            time.sleep(0.5)
        return render(*args)
    monkeypatch.setattr(port_fastq, "render_fastq_records", slow_first)
    assert _decompress(scalce_tpu_torch, groups["src"], str(tmp_path / "d"),
                       threads=4, keep_order=True,
                       qual_on_device=True) == groups["data"]
    assert first.locked()


@pytest.mark.parametrize("torn", [(1, 2), (2,)])
def test_paired_resume(tmp_path, torn):
    """A crash tears the tail of both mates, or of mate 2 only (mate 1
    keeps its complete part): resume cuts both back to the blocks both
    hold, encodes onward, and keep-order decompress gives the inputs
    back."""
    a, b = synth_pair(3000, 100, seed=91)
    paths = (str(tmp_path / "a.fastq"), str(tmp_path / "b.fastq"))
    for p, data in zip(paths, (a, b)):
        with open(p, "wb") as f:
            f.write(data)
    base = dict(inputs=paths, paired=True, output=str(tmp_path / "o"),
                **SLICE)
    scalce_tpu_torch.compress(Config(**base), "cpu")
    whole = _triplets(str(tmp_path / "o"))
    for m in torn:
        for ext in (".scalcen", ".scalcer", ".scalceq"):
            p = tmp_path / f"o.00_{m}{ext}"
            p.write_bytes(p.read_bytes()[:-50])
    stats = scalce_tpu_torch.compress(Config(resume=True, **base), "cpu")
    assert 0 < stats.n_blocks < 3
    assert _triplets(str(tmp_path / "o")) == whole
    assert _decompress(scalce_tpu_torch, str(tmp_path / "o.00_1.scalcen"),
                       str(tmp_path / "d"), keep_order=True,
                       qual_on_device=True) == (a, b)


def test_paired_decompress_rejects_mates_that_disagree(tmp_path):
    """A mate-2 triplet with fewer blocks than mate 1's raises (the
    reference's decoder stops at the shorter mate without an error)."""
    for name, n in (("long", 2500), ("short", 1500)):
        paths = (str(tmp_path / f"{name}1.fastq"),
                 str(tmp_path / f"{name}2.fastq"))
        for p, data in zip(paths, synth_pair(n, 100, seed=95)):
            with open(p, "wb") as f:
                f.write(data)
        scalce_tpu_torch.compress(Config(inputs=paths, paired=True,
                                         output=str(tmp_path / name),
                                         **SLICE), "cpu")
    for ext in (".scalcen", ".scalcer", ".scalceq"):
        shutil.copy(tmp_path / f"short.00_2{ext}", tmp_path / f"long.00_2{ext}")
    with pytest.raises(ValueError, match="mate triplets disagree"):
        _decompress(scalce_tpu_torch, str(tmp_path / "long.00_1.scalcen"),
                    str(tmp_path / "d"), keep_order=True, qual_on_device=True)
