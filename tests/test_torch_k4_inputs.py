"""The card-decode decompress's K4 input build on the host: the native
row copy of :func:`scalce_tpu_torch.io.fastq.ragged_scatter` on rows of
any dtype against its NumPy fallback, ``decode_inputs_host`` at a pair
block's shape against the same build on the fallback, and its span and
counters in a profiled paired round trip on the CPU."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from scalce_tpu_torch import cli, native, timing
from scalce_tpu_torch.io import fastq
from scalce_tpu_torch.streams import qualities
from scalce_tpu_torch.utils.synth import synth_pair

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

#: rows as (dst_starts, lens) into a destination of 64 items
ROWS = {
    "zero_length_rows": ([0, 5, 5, 20, 40], [3, 0, 7, 0, 9]),
    "no_rows_to_copy": ([3, 60], [0, 0]),
    "one_row": ([11], [17]),
    "unsorted_starts": ([40, 2, 25, 13], [6, 9, 11, 4]),
    "last_row_ends_the_buffer": ([0, 30, 57], [10, 5, 7]),
}


def _rows(case, dtype, seed=0):
    starts, lens = (np.asarray(x, np.int64) for x in ROWS[case])
    info = np.iinfo(dtype)
    src = np.random.default_rng(seed).integers(
        info.min, info.max, int(lens.sum()), endpoint=True, dtype=dtype)
    return starts, src, lens


def _fallback(dst, starts, src, lens, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(fastq, "_NATIVE", False)
        assert fastq.ragged_scatter(dst, starts, src, lens) is False
    return dst


@pytest.mark.parametrize("case", sorted(ROWS))
@pytest.mark.parametrize("dtype", [np.uint16, np.int16, np.int32,
                                   np.uint8])
def test_ragged_scatter_native_equals_fallback(dtype, case, monkeypatch):
    """Rows of one dtype in dst and src take the native copy (uint8 as
    before; with no words to copy, nothing is called) and write what the
    NumPy fallback writes, around a background that stays."""
    assert native.AVAILABLE
    starts, src, lens = _rows(case, dtype)
    calls = []
    copy = native.ragged_scatter_u8
    monkeypatch.setattr(native, "ragged_scatter_u8",
                        lambda *a: calls.append(a) or copy(*a))
    got = np.full(64, 7, dtype)
    assert fastq.ragged_scatter(got, starts, src, lens) is True
    assert len(calls) == int(lens.sum() > 0)
    want = _fallback(np.full(64, 7, dtype), starts, src, lens, monkeypatch)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("case", sorted(ROWS))
@pytest.mark.parametrize("layout", ["strided_dst", "dtype_mismatch"])
def test_ragged_scatter_other_layouts_take_the_fallback(layout, case,
                                                        monkeypatch):
    """A non-contiguous dst, or a src of another dtype, is placed by the
    fallback, with the result of the fallback forced."""
    starts, src, lens = _rows(case, np.uint16, seed=1)
    if layout == "dtype_mismatch":
        src = src.astype(np.int32)
    monkeypatch.setattr(native, "ragged_scatter_u8", None)   # never called
    base, base_f = np.zeros((64, 2), np.uint16), np.zeros((64, 2), np.uint16)
    dst, dst_f = ((b[:, 0] if layout == "strided_dst" else b.reshape(-1))
                  for b in (base, base_f))
    assert fastq.ragged_scatter(dst, starts, src, lens) is False
    _fallback(dst_f, starts, src, lens, monkeypatch)
    assert base.tobytes() == base_f.tobytes()


def _pair_block_encs(seed, D=4):
    """D synthetic blocks at a pair block's shape (B = 262144, L = 101,
    T = 1616, order 1): 280-350 words a lane, random words and tables."""
    B, L, T = 262144, 101, 1616
    N = B * L // T
    rng = np.random.default_rng(seed)
    encs = []
    for _ in range(D):
        counts = rng.integers(280, 351, N).astype(np.int32)
        encs.append(qualities.EncodedQuals(
            freq=rng.integers(0, 4096, (8 * 95 + 1) * qualities.N_SYMS,
                              dtype=np.uint32),
            states=rng.integers(0, 1 << 32, N, dtype=np.uint32),
            counts=counts,
            words=rng.integers(0, 1 << 16, int(counts.sum()),
                               dtype=np.uint16),
            B=B, L=L, T=T, order=1))
    lens = [rng.integers(50, L + 1, B).astype(np.int32) for _ in range(D)]
    return encs, lens


def test_decode_inputs_host_at_pair_block_shape(tmp_path, monkeypatch):
    """A group of four pair-cell blocks: every array of the native build
    is byte-identical to the fallback's, and the build counts four
    blocks, all native."""
    encs, lens = _pair_block_encs(23)
    with timing.profile(str(tmp_path / "t"), "cpu"):
        timing.begin("decompress")
        got = qualities.decode_inputs_host(encs, lens)
    counts = timing.counters()["decompress"]
    assert counts["k4_input_blocks"] == counts["k4_input_native_blocks"] == 4
    with monkeypatch.context() as m:
        m.setattr(fastq, "_NATIVE", False)
        want = qualities.decode_inputs_host(encs, lens)
    assert got.keys() == want.keys()
    assert got["words"].shape == (4, 16384, 404)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def _spans(trace_dir):
    (path,) = glob.glob(os.path.join(trace_dir, "*.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "user_annotation"}


def test_pair_card_decode_traces_its_k4_inputs(tmp_path):
    """A paired round trip with the qualities on the device (the CPU
    here): the profiled decompress holds the span ``K4 inputs`` and
    counts every mate's block, each copied natively; keep-order gives the
    pair back."""
    data = synth_pair(700, 100, seed=41, genome_len=30_000, var_len=True,
                      n_rate=0.01)
    mates = [str(tmp_path / f"m{m}.fastq") for m in (1, 2)]
    for p, x in zip(mates, data):
        with open(p, "wb") as f:
            f.write(x)
    base = ["--device", "cpu", "--qual-device", "-T", "2"]
    assert cli.main(base + ["-c", "gz", "-r", "--qual-order", "1",
                            "--block-reads", "256", "-o",
                            str(tmp_path / "p"), *mates]) == 0
    prof = str(tmp_path / "prof")
    assert cli.main(base + ["-d", "--keep-order", "-o", str(tmp_path / "d"),
                            "--profile", prof,
                            str(tmp_path / "p.00_1.scalcen")]) == 0
    assert {"K4 inputs", "quality decode"} <= _spans(prof)
    counts = timing.counters()
    assert counts["decompress"]["k4_input_blocks"] == 3 * 2
    assert counts["decompress"]["k4_input_native_blocks"] == 3 * 2
    for m, x in zip((1, 2), data):
        with open(tmp_path / f"d_{m}.fastq", "rb") as f:
            assert f.read() == x
