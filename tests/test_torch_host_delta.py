"""The host delta match (``BlockEncoder._assemble_hd`` and
``_assemble_hc``): its spans and counter in a profiled compress under
each placement, single-end and paired, the link probe's span, and its
products against the plain version of the device delta
(``ops/delta_seq.py::delta_seq_plain``) on the same sorted rows."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from scalce_tpu_torch import cli, timing
from scalce_tpu_torch.config import Config
from scalce_tpu_torch.io import fastq
from scalce_tpu_torch.ops.delta_seq import delta_seq_plain
from scalce_tpu_torch.pipeline import driver, encode
from scalce_tpu_torch.pipeline.encode import BlockEncoder
from scalce_tpu_torch.streams.seqs import unpack2bit_np
from scalce_tpu_torch.utils.synth import synth_fastq, synth_pair

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

#: host qualities (every host placement needs them), gz, two workers
BASE = dict(block_reads=1024, backend="gz", threads=2,
            qual_on_device=False, qual_context_order=0)
PLACEMENTS = {"auto": dict(core_on_device=None, delta_on_device=False),
              "host core": dict(core_on_device=False, delta_on_device=False),
              "device": dict(core_on_device=True, delta_on_device=True)}
HALVES = {"gather orient", "delta match"}


def _genome(seed, n=6000):
    """A short genome: a block of 1024 reads of 101 bp covers it 17x, so
    the sorted core runs are several reads long."""
    return np.random.default_rng(seed).integers(0, 4, n, dtype=np.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A bact-shaped single-end file (3 blocks) and pair (2 blocks a
    mate): 101 bp, both strands, rare N bases."""
    d = tmp_path_factory.mktemp("host_delta")
    kw = dict(genome=_genome(7), rc_rate=0.5, n_rate=0.001)
    out = {"single": (str(d / "in.fastq"),),
           "pair": (str(d / "m1.fastq"), str(d / "m2.fastq"))}
    for path, data in zip(out["single"] + out["pair"],
                          (synth_fastq(2500, 101, seed=11, **kw),)
                          + synth_pair(2048, 101, seed=12, **kw)):
        with open(path, "wb") as f:
            f.write(data)
    return {**out, "dir": str(d)}


def _spans(trace_dir):
    (path,) = glob.glob(os.path.join(trace_dir, "*.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}


def _triplet(prefix):
    out = {}
    for path in sorted(glob.glob(prefix + ".*.scalce[nrq]")):
        with open(path, "rb") as f:
            out[path[len(prefix):]] = f.read()
    return out


@pytest.mark.parametrize("which", ["single", "pair"])
@pytest.mark.parametrize("placement", list(PLACEMENTS))
def test_host_delta_spans_and_counter(files, monkeypatch, placement, which):
    """A profiled compress: AUTO on a fast link and host core match every
    mate block on the host (``host delta`` holding ``gather orient`` and
    ``delta match``, ``host_delta_blocks`` the blocks times the mates);
    the device delta matches none there.  The triplet is the device
    placement's."""
    monkeypatch.setattr(encode, "device_link_mbps", lambda dev: 5000.0)
    inputs, d = files[which], files["dir"]
    kw = dict(BASE, paired=which == "pair")
    tag = f"{placement.replace(' ', '_')}_{which}"
    prof = os.path.join(d, "prof_" + tag)
    with timing.profile(prof, "cpu"):
        stats = driver.compress(Config(inputs=inputs, output=os.path.join(
            d, tag), **kw, **PLACEMENTS[placement]), "cpu")
    got = timing.counters()["compress"].get("host_delta_blocks", 0)
    spans = _spans(prof)
    mates = len(inputs)
    assert stats.n_blocks == (3 if which == "single" else 2)
    if placement == "device":
        assert got == 0 and not ({"host delta"} | HALVES) & spans
        assert "stage B" in spans
    else:
        assert got == stats.n_blocks * mates
        assert {"host delta"} | HALVES <= spans
        assert stats.placement == ("host" if placement == "host core"
                                   else "device")
    dev = os.path.join(d, "dev_" + tag)
    driver.compress(Config(inputs=inputs, output=dev, **kw,
                           **PLACEMENTS["device"]), "cpu")
    assert _triplet(os.path.join(d, tag)) == _triplet(dev)


def test_link_probe_span_in_a_profiled_cli_compress(files, monkeypatch):
    """``--core-placement auto --profile``: the probe, run afresh, is one
    ``link probe`` span in the compress's trace, and the delta is
    matched on the host after it."""
    monkeypatch.setattr(encode, "_LINK_MBPS", {})
    d, (src,) = files["dir"], files["single"]
    prof = os.path.join(d, "prof_cli")
    assert cli.main(["--device", "cpu", "-c", "gz", "--block-reads", "1024",
                     "-T", "2", "--core-placement", "auto", "--profile",
                     prof, "-o", os.path.join(d, "cli"), src]) == 0
    assert {"link probe", "host delta"} | HALVES <= _spans(prof)
    assert list(encode._LINK_MBPS.values())[0] > 0
    assert timing.counters()["compress"]["host_delta_blocks"] == 3


def _item(tmp_path, seed, mates):
    """The first block of a seeded 101-bp file (``mates`` 2: a pair's
    first item) drawn from a short genome."""
    kw = dict(genome=_genome(seed), rc_rate=0.5, n_rate=0.001)
    datas = (synth_fastq(1024, 101, seed=seed, **kw),) if mates == 1 \
        else synth_pair(1024, 101, seed=seed, **kw)
    paths = [str(tmp_path / f"m{i}.fastq") for i in range(mates)]
    for p, x in zip(paths, datas):
        with open(p, "wb") as f:
            f.write(x)
    it = fastq.iter_blocks(paths[0], 1024, 128) if mates == 1 else \
        fastq.iter_paired_blocks(*paths, 1024, 128)
    item = next(iter(it))
    return (item,) if mates == 1 else tuple(item)


@pytest.mark.parametrize("seed", [5, 6])
@pytest.mark.parametrize("mate", [1, 2])
def test_assemble_hd_matches_plain_delta(tmp_path, monkeypatch, mate, seed):
    """``_assemble_hd``'s mask bits, shifts, predecessors and literals on
    one block equal the plain device delta's on the same sorted rows
    (stage A of the same upload): mate 1 through ``delta_match_runs``
    over its core runs, a following mate through ``delta_match`` over
    its core ids in mate 1's order."""
    item = _item(tmp_path, seed, mate)
    cfg = Config(inputs=("x", "y")[:mate], block_reads=1024,
                 max_read_len=128, backend="gz", threads=1,
                 qual_on_device=False, qual_context_order=0,
                 core_on_device=True, delta_on_device=False,
                 paired=mate == 2)
    enc = BlockEncoder(cfg, "cpu")
    assert enc.host_delta and not enc.host_core
    got = []

    def assemble(block, perm_np, len_np, delta_np, enc_q=None):
        got.append(delta_np)
        return None, perm_np
    monkeypatch.setattr(enc, "_assemble", assemble)
    enc.assemble([item], enc.dispatch([item]))
    assert len(got) == mate
    perm = None
    for block, host in zip(item, got):
        x = enc._upload(block).wait()
        perm, codes_s, _, len_s, ck_s, cp_s, _ = encode._device_stage_a(
            x["seq"], None, x["len"], block.n_reads, x["exc"], cfg.core_k,
            cfg.dict_seed, None, perm)
        want = {k: v.numpy() for k, v in delta_seq_plain(
            codes_s, len_s, ck_s, cp_s, block.n_reads).items()}
        n = block.n_reads
        for k in ("mask_bits", "shifts", "pred_k"):
            np.testing.assert_array_equal(host[k], want[k][:n], err_msg=k)
        assert host["n_lits"] == int(want["n_lits"])
        np.testing.assert_array_equal(host["lits"], unpack2bit_np(
            want["lit_packed"].astype(np.uint32), host["n_lits"]))
    # mate 1's runs are long: the match copies most of its bases
    first = item[0]
    assert got[0]["n_lits"] < 0.5 * int(first.lengths[:first.n_reads].sum())
