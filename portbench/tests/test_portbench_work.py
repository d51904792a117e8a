"""Each kernel's work count against shapes counted by hand."""

import pytest

from portbench import layers, manifest

COUNTS = {"reads": 4, "bases": 400, "kmer_windows": 356,
          "qual_symbols": 400}
STREAMS = {"n": 10, "r": 100, "q": 150}
# bytes, counted by hand: 400 bases at 2 bits, 4-byte ranks of 4 reads,
# 400 quality bytes, 150 bytes of the quality stream
WANT = {"K1": 100 + 16, "K2": 400, "K3": 400 + 150, "K4": 150 + 400,
        "K5": 400 + 150, "K6": 400, "K7": 100, "K8": 300}
SIDE = {"K4": "decompress"}


@pytest.mark.parametrize("k", sorted(WANT))
def test_bytes(k):
    work = manifest.load_module("work", k)
    assert work.bytes_moved(COUNTS, STREAMS) == WANT[k]
    assert work.SIDE == SIDE.get(k, "compress")


def test_input_counts():
    rec = b"@a\n%s\n+\n%s\n"
    data = rec % (b"A" * 20, b"I" * 20) + rec % (b"C" * 5, b"I" * 5)
    c = layers.input_counts([data, data], core_k=12)
    assert c == {"reads": 4, "bases": 50, "kmer_windows": 18,
                 "qual_symbols": 50}
