"""The readers of the card-decode decompress's K4 input build, on
hand-made spans and counters: ``k4_inputs_ms_per_block.decompress``
(the span ``K4 inputs`` inside the decompress calls, per block) and
``k4_input_native_share`` (the counters ``k4_input_native_blocks`` over
``k4_input_blocks``), each None where its span or counters are absent
(as in a program that does not record them)."""

import pytest

from portbench import layers, manifest
from portbench import trace as tr

SPAN = "K4 inputs"


def _ev(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def _ctx(spans=(), blocks=5):
    """A compress call at 0-400 us and a decompress call at 500-900;
    each ``(name, start, dur, tid)`` a span."""
    events = [_ev("portbench.compress", 0, 400),
              _ev("portbench.decompress", 500, 400)]
    events += [_ev(name, ts, dur, tid) for name, ts, dur, tid in spans]
    return layers.Context(
        trace=tr.from_events(events),
        windows={"compress": [(0.0, 400.0)], "decompress": [(500.0, 900.0)]},
        calls={"compress": 1, "decompress": 1},
        blocks={"compress": 4, "decompress": blocks},
        counts={"reads": 10, "bases": 1000, "kmer_windows": 900,
                "qual_symbols": 1000},
        stream_bytes={"n": 5, "r": 250, "q": 500})


@pytest.mark.parametrize("spans, blocks, want", [
    # two groups on the main thread, one on another thread; one outside
    ([(SPAN, 510, 30, 1), (SPAN, 600, 10, 1), (SPAN, 700, 20, 2),
      (SPAN, 950, 50, 1)], 5, 0.060 / 5),
    ([(SPAN, 510, 30, 1)], 2, 0.030 / 2),
    ([], 5, None),                                  # absent
    ([("wait finish", 510, 30, 1)], 5, None),       # another span only
    ([(SPAN, 100, 30, 1)], 5, None),                # in the compress only
    ([(SPAN, 510, 0, 1)], 5, None),                 # zero time
    ([(SPAN, 510, 30, 1)], 0, None),                # zero blocks
])
def test_k4_inputs_ms_per_block(spans, blocks, want):
    read = manifest.load_module("metrics",
                                "k4_inputs_ms_per_block.decompress").read
    got = read(_ctx(spans, blocks))
    assert got == (None if want is None else pytest.approx(want))


@pytest.fixture
def timing():
    from scalce_tpu_torch import timing
    return timing


@pytest.mark.parametrize("counts, want", [
    ({}, None),
    ({"k4_input_blocks": 8}, None),
    ({"k4_input_native_blocks": 8}, None),
    ({"k4_input_blocks": 0, "k4_input_native_blocks": 0}, None),
    ({"k4_input_blocks": 8, "k4_input_native_blocks": 8}, 100.0),
    ({"k4_input_blocks": 8, "k4_input_native_blocks": 2}, 25.0),
    ({"k4_input_blocks": 8, "k4_input_native_blocks": 0}, 0.0)])
def test_k4_input_native_share(counts, want, timing, monkeypatch):
    """Only the decompress side's counters count; no ``counters`` at
    all gives None."""
    read = manifest.load_module("metrics", "k4_input_native_share").read
    monkeypatch.setattr(timing, "counters", lambda: {
        "compress": {"k4_input_blocks": 4, "k4_input_native_blocks": 1},
        "decompress": counts})
    assert read(_ctx()) == want
    monkeypatch.delattr(timing, "counters")
    assert read(_ctx()) is None
