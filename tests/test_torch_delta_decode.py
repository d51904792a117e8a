"""``-d --delta-device``: scalce_tpu_torch's pointer-doubling
reconstruction (ops/delta_decode.py) against the serial host walk and
scalce_tpu's reconstruct_device, the split parse against scalce_tpu's
seqs.parse, the pipelined decompress giving the input back, and a
corrupt chain refused before any reconstruction."""

import os

import numpy as np
import pytest
import torch

import scalce_tpu
from scalce_tpu.config import Config as RefConfig
from scalce_tpu.ops import delta_decode as ref_delta_decode
from scalce_tpu.streams import seqs as ref_seqs
from scalce_tpu.utils.synth import synth_fastq, synth_pair
from scalce_tpu_torch import cli, container
from scalce_tpu_torch.config import Config
from scalce_tpu_torch.ops import delta_decode
from scalce_tpu_torch.pipeline import driver
from scalce_tpu_torch.streams import seqs

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)


def _chains(seed, B=256, L=64, n=200):
    """Valid delta fields of ``n`` rows with long copy chains: most
    cells copy from one of the four rows above at a small shift."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(L // 2, L + 1, n).astype(np.int32)
    lens[::13] = 0
    pred_k = rng.integers(0, 4, n)
    shifts = rng.integers(-3, 4, n)
    bits = np.zeros((n, L), bool)
    col = np.arange(L)
    for i in range(n):
        if i - 1 - pred_k[i] < 0:
            continue
        src = col + shifts[i]
        ok = (src >= 0) & (src < L) & (col < lens[i])
        bits[i] = ok & (rng.random(L) < 0.9)
    mask_bits = np.packbits(bits, axis=1, bitorder="little")
    lits = rng.integers(0, 4, int(lens.sum() - bits.sum())).astype(np.uint8)
    return mask_bits, shifts, pred_k, lits, lens, B, L


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reconstruct_matches_host_walk_and_reference(seed):
    mb, sh, pk, lits, lens, B, L = _chains(seed)
    host = np.zeros((B, L), np.uint8)
    seqs._reconstruct(mb, sh.astype(np.int16), pk.astype(np.uint8), lits,
                      lens.astype(np.int64), L, host)
    got = np.zeros((B, L), np.uint8)
    delta_decode.reconstruct_device(mb, sh.astype(np.int32),
                                    pk.astype(np.int32), lits, lens, B, L,
                                    got)
    want = np.zeros((B, L), np.uint8)
    ref_delta_decode.reconstruct_device(mb, sh.astype(np.int32),
                                        pk.astype(np.int32), lits, lens, B,
                                        L, want)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, want)


def test_reconstruct_of_an_all_copy_block_has_no_literal():
    """No literal at all (every cell of row 0 empty, the rest copies of
    nothing): zeros, as the host walk gives."""
    B, L = 8, 32
    lens = np.zeros(B, np.int32)
    out = np.ones((B, L), np.uint8)
    delta_decode.reconstruct_device(np.zeros((B, L // 8), np.uint8),
                                    np.zeros(B, np.int32),
                                    np.zeros(B, np.int32),
                                    np.zeros(0, np.uint8), lens, B, L, out)
    assert not out.any()


@pytest.fixture(scope="module")
def triplet(tmp_path_factory):
    """tests/test_roundtrip.py's --delta-device case: deep chains from a
    low-complexity genome, N bases, both strands (host core, as there)."""
    d = str(tmp_path_factory.mktemp("delta"))
    src = os.path.join(d, "in.fastq")
    data = synth_fastq(4096, 100, seed=99, var_len=True, n_rate=0.01,
                       rc_rate=0.4, genome_len=4000)
    with open(src, "wb") as f:
        f.write(data)
    scalce_tpu.compress(RefConfig(inputs=(src,), output=os.path.join(d, "o"),
                                  block_reads=1024, core_on_device=False,
                                  backend="gz"))
    return {"dir": d, "data": data, "src": src,
            "path": os.path.join(d, "o.00.scalcen")}


def test_parse_matches_reference(triplet):
    """seqs.parse (host walk and delta_device) and parse_fields equal
    scalce_tpu's seqs.parse on every block."""
    reader = container.TripletReader(triplet["path"])
    B, L = reader.meta["block_reads"], reader.meta["max_read_len"]
    for _, payloads in reader.iter_blocks():
        want = ref_seqs.parse(payloads["r"], B, L)
        for dev in (False, True):
            got = seqs.parse(payloads["r"], B, L, delta_device=dev)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        fields, *rest = seqs.parse_fields(payloads["r"], B, L, True)
        for g, w in zip(rest, want[1:]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("threads", [1, 4])
def test_delta_device_decode_gives_the_input_back(triplet, threads,
                                                  monkeypatch):
    """The pipelined decompress with --delta-device: one reconstruction
    per block, queued on the main thread; the host walk's bytes."""
    calls = []
    real = delta_decode.reconstruct
    monkeypatch.setattr(delta_decode, "reconstruct",
                        lambda *a: calls.append(1) or real(*a))
    d = triplet["dir"]
    outs = {}
    for tag, dev in (("host", False), ("dev", True)):
        out = os.path.join(d, f"{tag}{threads}")
        driver.decompress(Config(mode="decompress", inputs=(triplet["path"],),
                                 output=out, keep_order=True,
                                 delta_on_device=dev, threads=threads),
                          "cpu")
        with open(out + ".fastq", "rb") as f:
            outs[tag] = f.read()
    assert outs["dev"] == outs["host"] == triplet["data"]
    assert len(calls) == 4


def test_cli_delta_device_paired(tmp_path):
    """``-d --delta-device`` through the port's CLI on a pair."""
    mates = [os.path.join(tmp_path, f"m{m}.fastq") for m in (1, 2)]
    datas = synth_pair(1500, 100, seed=5, var_len=True, n_rate=0.01)
    for path, data in zip(mates, datas):
        with open(path, "wb") as f:
            f.write(data)
    out = os.path.join(tmp_path, "p")
    cli.main(["--device", "cpu", "-c", "gz", "--block-reads", "1024", "-r",
              "-o", out, *mates])
    cli.main(["--device", "cpu", "-d", "--delta-device", "--keep-order",
              "-o", out + "d", out + ".00_1.scalcen"])
    for m, data in zip((1, 2), datas):
        with open(f"{out}d_{m}.fastq", "rb") as f:
            assert f.read() == data


def test_corrupt_chain_raises_before_any_reconstruction(triplet, tmp_path,
                                                        monkeypatch):
    """tests/test_roundtrip.py's corrupt chain (a shift that sends a
    masked copy out of the row, as the legacy raw-i16 array): the deep
    validation raises ValueError on the host, and no reconstruction is
    queued, so no gather can index out of range on a card."""
    src = os.path.join(tmp_path, "in.fastq")
    with open(src, "wb") as f:
        f.write(synth_fastq(256, 64, seed=5))
    scalce_tpu.compress(RefConfig(inputs=(src,), output=os.path.join(
        tmp_path, "o"), block_reads=256, core_on_device=False, backend="gz"))
    reader = container.TripletReader(os.path.join(tmp_path, "o.00.scalcen"))
    (bid, payloads), = list(reader.iter_blocks())
    a = container.unpack_arrays(payloads["r"])
    B, L = reader.meta["block_reads"], reader.meta["max_read_len"]
    n = int(a["n_reads"][0])
    bad = {k: v for k, v in a.items() if not k.startswith("shv")}
    bad["shifts"] = np.full(n, L - 1, np.int16)
    blob = container.pack_arrays(bad)
    calls = []
    monkeypatch.setattr(delta_decode, "reconstruct",
                        lambda *a: calls.append(1))
    for fn in (lambda: seqs.parse(blob, B, L, delta_device=True),
               lambda: seqs.parse_fields(blob, B, L, delta_device=True)):
        with pytest.raises(ValueError, match="out of bounds"):
            fn()
    with pytest.raises(ValueError):
        ref_seqs.parse(blob, B, L, delta_device=True)
    # the same block through the pipelined decompress
    w = container.TripletWriter(os.path.join(tmp_path, "bad"), reader.meta)
    w.add_block(bid, {**payloads, "r": blob}, n)
    w.close()
    with pytest.raises(ValueError, match="out of bounds"):
        driver.decompress(Config(
            mode="decompress", inputs=(os.path.join(tmp_path,
                                                    "bad.00.scalcen"),),
            output=os.path.join(tmp_path, "bad_out"), delta_on_device=True,
            threads=2), "cpu")
    assert calls == []
