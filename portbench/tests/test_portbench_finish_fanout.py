"""The reader ``finish_fanout_share`` on hand-made counters: finish tasks
per hundred finished blocks of the decompress calls, and None where
either counter is absent (as in a program that does not count them)."""

import pytest

from portbench import layers, manifest
from portbench import trace as tr


def _ctx():
    """One decompress call of 8 blocks; the reader reads only counters."""
    return layers.Context(
        trace=tr.from_events([]), windows={"decompress": [(0.0, 400.0)]},
        calls={"decompress": 1}, blocks={"decompress": 8},
        counts={"reads": 10, "bases": 1000, "kmer_windows": 900,
                "qual_symbols": 1000},
        stream_bytes={"n": 5, "r": 250, "q": 500})


@pytest.fixture
def timing():
    from scalce_tpu_torch import timing
    return timing


@pytest.mark.parametrize("counts, want", [
    ({}, None), ({"finish_tasks": 8}, None), ({"finish_blocks": 8}, None),
    ({"finish_tasks": 8, "finish_blocks": 8}, 100.0),
    ({"finish_tasks": 2, "finish_blocks": 8}, 25.0)])
def test_finish_fanout_share(counts, want, timing, monkeypatch):
    """Only the decompress side's counters count; no ``counters`` at
    all gives None."""
    read = manifest.load_module("metrics", "finish_fanout_share").read
    monkeypatch.setattr(timing, "counters", lambda: {
        "compress": {"finish_tasks": 1, "finish_blocks": 4},
        "decompress": counts})
    assert read(_ctx()) == want
    monkeypatch.delattr(timing, "counters")
    assert read(_ctx()) is None
