"""Long reads (max_read_len > 32752, container v7) in scalce_tpu_torch
against scalce_tpu: the minimizer keys, single-end and paired triplets
(substitutions, indels that make the segments re-anchor, no overlap,
100 kbp reads), decodes across the two packages, the bare command on a
long-read file (it compresses on the host, as the reference's does),
the device placements' refusals, and a long-read encoder that touches
no device."""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

import scalce_tpu.cli as ref_cli
from scalce_tpu.config import Config as RefConfig
from scalce_tpu.ops import minimizer as ref_minimizer
from scalce_tpu.pipeline import driver as ref_driver
from scalce_tpu_torch import cli
from scalce_tpu_torch.config import Config
from scalce_tpu_torch.io import fastq
from scalce_tpu_torch.ops import minimizer
from scalce_tpu_torch.pipeline import driver, encode
from scalce_tpu_torch.pipeline.decode import BlockDecoder
from scalce_tpu_torch.streams import seqs
from scalce_tpu_torch.utils.longread import synth_long_fastq

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

L = 40_000
BASE = dict(block_reads=256, max_read_len=L, backend="gz",
            qual_context_order=0)

#: name -> (synth_long_fastq arguments, Config changes)
FILES = {
    # 48 reads of 20-40 kbp at ~12x, 0.5% substitutions
    "sub": (dict(n_reads=48, min_len=20_000, max_len=L, genome_len=120_000,
                 sub=0.005, seed=5), {}),
    # 0.25% insertions and deletions: the segments re-anchor
    "indel": (dict(n_reads=48, min_len=20_000, max_len=38_000,
                   genome_len=100_000, sub=0.0025, ins=0.00125,
                   dele=0.00125, seed=6), {}),
    # no two reads overlap (each from its own stretch of genome)
    "no overlap": (dict(n_reads=12, min_len=20_000, max_len=30_000,
                        genome_len=20_000_000, seed=7), {}),
    # 60-100 kbp reads: u32 lengths in the payload
    "100 kbp": (dict(n_reads=12, min_len=60_000, max_len=100_000,
                     genome_len=200_000, seed=8),
                dict(max_read_len=100_000)),
}


def _triplet(prefix):
    out = {}
    for path in sorted(glob.glob(prefix + ".*.scalce[nrq]")):
        with open(path, "rb") as f:
            out[path[len(prefix):]] = f.read()
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("longread"))
    out = {"dir": d}
    for name, (synth_kw, _) in FILES.items():
        path = os.path.join(d, name.replace(" ", "_") + ".fastq")
        with open(path, "wb") as f:
            f.write(synth_long_fastq(**synth_kw))
        out[name] = path
    return out


def _both(d, name, inputs, **kw):
    """Compress ``inputs`` with each package; returns the two prefixes."""
    ref = os.path.join(d, "ref_" + name)
    port = os.path.join(d, "port_" + name)
    ref_driver.compress(RefConfig(inputs=inputs, output=ref, **kw))
    driver.compress(Config(inputs=inputs, output=port, **kw), "cpu")
    return ref, port


@pytest.mark.parametrize("seed,n,width", [(0, 20, 300), (1, 7, 5000),
                                          (2, 3, 10)])
def test_minimizer_keys_match_reference(seed, n, width):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, width)).astype(np.uint8)
    lengths = rng.integers(0, width + 1, n)
    for tile in (1 << 16, 64):
        got = minimizer.minimizer_keys(codes, lengths, tile=tile)
        want = ref_minimizer.minimizer_keys(codes, lengths, tile=tile)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("nseg", [4, 32])
def test_segment_minimizer_keys_match_reference(nseg):
    rng = np.random.default_rng(nseg)
    codes = rng.integers(0, 4, (9, 4000)).astype(np.uint8)
    lengths = rng.integers(0, 4001, 9)
    got = minimizer.segment_minimizer_keys(codes, lengths, nseg, tile=1000)
    want = ref_minimizer.segment_minimizer_keys(codes, lengths, nseg,
                                                tile=1000)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(minimizer.mix32_np(codes[0]),
                                  ref_minimizer.mix32_np(codes[0]))


@pytest.mark.parametrize("name", sorted(FILES))
def test_single_end_triplet_matches_reference(files, name):
    """The port writes the reference's v7 triplet, and keep-order
    decompress gives the input back."""
    kw = {**BASE, **FILES[name][1], "threads": 2}
    ref, port = _both(files["dir"], name, (files[name],), **kw)
    got = _triplet(port)
    assert len(got) == 3 and got == _triplet(ref)
    out = os.path.join(files["dir"], "dec_" + name.replace(" ", "_"))
    driver.decompress(Config(mode="decompress",
                             inputs=(port + ".00.scalcen",), output=out,
                             keep_order=True), "cpu")
    with open(out + ".fastq", "rb") as a, open(files[name], "rb") as b:
        assert a.read() == b.read()


def test_indel_reads_re_anchor(files):
    """On the indel file the multi-anchor delta copies from the
    predecessor at two or more shifts within a read (its segments
    re-anchored after an indel), and the sequence stream beats the
    2-bit floor."""
    path = files["indel"]
    block = next(fastq.iter_blocks(path, BASE["block_reads"], L))
    enc = encode.BlockEncoder(Config(inputs=(path,), **BASE), "cpu")
    eb, _ = enc._assemble_long(block)
    fields = seqs.parse_fields(eb.payloads["r"], BASE["block_reads"], L)[0]
    sh = fields["shifts"]
    assert sh.ndim == 2 and sh.shape[1] >= 4
    re_anchored = sum(len(set(row[row != 0].tolist())) >= 2 for row in sh)
    assert re_anchored >= 10, re_anchored
    bases = int(block.lengths[:block.n_reads].sum())
    assert len(eb.payloads["r"]) * 1.08 < bases / 4


def test_no_overlap_and_identity_order(files):
    """Reads that overlap nothing are all literals; a block with fewer
    than two minimizer keys keeps the identity order."""
    path = files["no overlap"]
    block = next(fastq.iter_blocks(path, BASE["block_reads"], L))
    enc = encode.BlockEncoder(Config(inputs=(path,), **BASE), "cpu")
    fields = seqs.parse_fields(enc._assemble_long(block)[0].payloads["r"],
                               BASE["block_reads"], L)[0]
    assert len(fields["lits"]) == int(block.lengths[:block.n_reads].sum())
    assert enc._long_order(block).tolist() != list(range(block.n_reads))
    block.lengths[1:] = minimizer.K - 1      # one read holds a k-mer
    np.testing.assert_array_equal(enc._long_order(block),
                                  np.arange(block.n_reads))


def test_paired_triplets_match_reference(files, tmp_path):
    """Mate 2 follows mate 1's minimizer order: the reference's _1/_2
    triplets, and the pair decodes in keep-order."""
    rng = np.random.default_rng(9)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 80_000)]
    width = 33_008
    mates = ([], [])
    for i in range(24):
        ln = int(rng.integers(width // 2, width + 1))
        s = int(rng.integers(0, len(genome) - ln - 500))
        s2 = s + int(rng.integers(100, 500))
        for m, (a, b) in enumerate(((s, s + ln),
                                    (s2, min(s2 + ln, len(genome))))):
            q = (rng.integers(20, 40, b - a) + 33).astype(np.uint8)
            mates[m].append(b"@p%d/%d\n%s\n+\n%s\n" % (
                i, m + 1, genome[a:b].tobytes(), q.tobytes()))
    paths = tuple(str(tmp_path / f"m{m}.fastq") for m in (1, 2))
    for path, recs in zip(paths, mates):
        with open(path, "wb") as f:
            f.write(b"".join(recs))
    ref, port = _both(str(tmp_path), "pair", paths, paired=True,
                      **{**BASE, "max_read_len": width})
    got = _triplet(port)
    assert len(got) == 6 and got == _triplet(ref)
    driver.decompress(Config(mode="decompress",
                             inputs=(port + ".00_2.scalcen",),
                             output=str(tmp_path / "d"), keep_order=True),
                      "cpu")
    for m, path in zip((1, 2), paths):
        with open(tmp_path / f"d_{m}.fastq", "rb") as a, \
                open(path, "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("keep_order", [True, False])
def test_cross_decode(files, keep_order):
    """Each package decodes the other's long-read triplet to the same
    FASTQ (in keep-order: the input)."""
    d = files["dir"]
    if "cross" not in files:
        files["cross"] = _both(d, "cross", (files["sub"],), **BASE)
    ref, port = files["cross"]
    tag = "k" if keep_order else "r"
    outs = []
    for prefix, fn in ((ref, lambda c: driver.decompress(c, "cpu")),
                       (port, lambda c: ref_driver.decompress(
                           RefConfig(**dataclasses.asdict(c))))):
        out = f"{prefix}_{tag}"
        fn(Config(mode="decompress", inputs=(prefix + ".00.scalcen",),
                  output=out, keep_order=keep_order))
        with open(out + ".fastq", "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
    if keep_order:
        with open(files["sub"], "rb") as f:
            assert outs[0] == f.read()


def test_bare_command_compresses_long_reads_on_the_host(files, tmp_path):
    """The bare command on a 40 kbp file writes the reference CLI's
    triplet: the width resolves to a long read's before any device
    default is applied (before this, the port's device defaults made
    Config refuse the file)."""
    argv = [files["sub"], "-c", "gz", "--block-reads", "256", "-T", "2"]
    assert ref_cli.main(argv + ["-o", str(tmp_path / "r")]) == 0
    assert cli.main(["--device", "cpu", *argv, "-o",
                     str(tmp_path / "p")]) == 0
    got = _triplet(str(tmp_path / "p"))
    assert len(got) == 3 and got == _triplet(str(tmp_path / "r"))
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        [files["sub"], "--block-reads", "256"]))
    assert cfg.max_read_len == L
    assert cfg.core_on_device is None and cfg.delta_on_device is False


@pytest.mark.parametrize("flags", [
    ["--core-placement", "device"], ["--delta-device"],
    ["--qual-device", "--qual-order", "1"], ["--data-parallel"],
    ["--core-placement", "device", "--max-read-len", str(L)]])
def test_device_placements_on_long_reads_raise(files, tmp_path, flags):
    """An explicit device placement or --data-parallel on a long-read
    file raises the reference's ValueError, in both packages."""
    argv = [files["sub"], "-c", "gz", "--block-reads", "256", *flags]
    with pytest.raises(ValueError, match="long-read"):
        cli.main(["--device", "cpu", *argv, "-o", str(tmp_path / "p")])
    with pytest.raises(ValueError, match="long-read"):
        ref_cli.main([*argv, "-o", str(tmp_path / "r")])
    assert not glob.glob(str(tmp_path / "p*"))


def test_long_mode_touches_no_device(files):
    """A long-read encoder makes no Link, uploads nothing and runs no
    link probe; the driver gives it no upload stage and places it on
    the host.  Decompress under --delta-device refuses the file."""
    cfg = Config(inputs=(files["sub"],), core_on_device=None, **BASE)
    enc = encode.BlockEncoder(cfg, "cpu")
    assert enc.long_mode and enc.on_host and enc.link is None
    assert enc.qual_map is None and enc.rank_lut_np is None
    assert enc.placement == "host"
    block = next(fastq.iter_blocks(files["sub"], 256, L))
    assert enc.upload([(block,)]) is None
    assert enc.dispatch([(block,)]) == [[encode.LONG]]
    assert enc.dispatch([(block, block)]) == [[encode.LONG, encode.LONG]]
    run = driver._encoder(cfg, "cpu", None)
    assert run.devices == [] and run.D == 1 and run.on_host
    assert run.placement == "host"
    meta = {"block_reads": 256, "max_read_len": L}
    with pytest.raises(ValueError, match="long-read"):
        BlockDecoder(meta, "cpu", delta_on_device=True)
