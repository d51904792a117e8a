"""The readers of the program's wait spans, host quality decode span,
device time per stage and counters, on a hand-made trace and counters
dict: each gives its value, and None where its span or counter is
absent (as in a program that does not record it)."""

import pytest

from portbench import layers, manifest
from portbench import trace as tr

#: a span's reader -> (span, side)
SPANS = {
    "wait_input_ms_per_block.compress": ("wait input", "compress"),
    "wait_assemble_ms_per_block.compress": ("wait assemble", "compress"),
    "wait_download_ms_per_block.compress": ("wait download", "compress"),
    "wait_parse_ms_per_block.decompress": ("wait parse", "decompress"),
    "wait_finish_ms_per_block.decompress": ("wait finish", "decompress"),
    "qual_host_decode_ms_per_block": ("quality decode (host)",
                                      "decompress"),
}
COUNTERS = {"compress": {"h2d_bytes": 6_000_000, "d2h_bytes": 9_000_000,
                         "literals": 250},
            "decompress": {"h2d_bytes": 1},
            "device_us": {"stage A": 1200.0, "stage B": 800.0,
                          "no stage": 5.0}}
#: a counter's reader -> its value from COUNTERS and the context below
#: (2 compress calls of 1000 bases, 4 compress blocks)
READ = {"stage_a_device_ms_per_block": 1200.0 / 1e3 / 4,
        "stage_b_device_ms_per_block": 800.0 / 1e3 / 4,
        "h2d_MB_per_block.compress": 6.0 / 4,
        "d2h_MB_per_block.compress": 9.0 / 4,
        "seq_literal_share": 100.0 * 250 / 2000}


def _ev(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def _ctx(spans=()):
    """Two calls a side; each ``(span, side)`` 40 us inside its side's
    call and 50 outside."""
    events = [_ev("portbench.compress", 0, 400),
              _ev("portbench.decompress", 500, 400)]
    for i, (name, side) in enumerate(spans):
        base = 0 if side == "compress" else 500
        events += [_ev(name, base + 10, 30, tid=2 + i),
                   _ev(name, base + 100, 10, tid=2 + i),
                   _ev(name, base + 450, 50, tid=2 + i)]
    return layers.Context(
        trace=tr.from_events(events),
        windows={"compress": [(0.0, 400.0)], "decompress": [(500.0, 900.0)]},
        calls={"compress": 2, "decompress": 2},
        blocks={"compress": 4, "decompress": 5},
        counts={"reads": 10, "bases": 1000, "kmer_windows": 900,
                "qual_symbols": 1000},
        stream_bytes={"n": 5, "r": 250, "q": 500})


@pytest.fixture
def timing():
    from scalce_tpu_torch import timing
    return timing


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_readers(metric):
    span, side = SPANS[metric]
    blocks = 4 if side == "compress" else 5
    read = manifest.load_module("metrics", metric).read
    assert read(_ctx([(span, side)])) == pytest.approx(0.040 / blocks)
    assert read(_ctx([v for v in SPANS.values() if v[0] != span])) is None


@pytest.mark.parametrize("metric", sorted(READ))
def test_counter_readers(metric, timing, monkeypatch):
    read = manifest.load_module("metrics", metric).read
    monkeypatch.setattr(timing, "counters", lambda: COUNTERS)
    assert read(_ctx()) == pytest.approx(READ[metric])
    monkeypatch.setattr(timing, "counters", lambda: {
        "decompress": COUNTERS["compress"], "device_us": {"no stage": 1.0}})
    assert read(_ctx()) is None
    monkeypatch.setattr(timing, "counters", lambda: {})
    assert read(_ctx()) is None
    monkeypatch.delattr(timing, "counters")
    assert read(_ctx()) is None
