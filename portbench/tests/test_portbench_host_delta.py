"""The host-delta cell ``se101-auto.bact`` and its readers: the spans
``host delta``, ``gather orient`` and ``delta match`` inside the compress
calls, per block, and the counter ``host_delta_blocks`` over the window's
blocks, each read from a hand-made trace and None where its span or
counter is absent (as in a program that does not record it); the cell as
the manifest resolves it; on the CPU at a small size, a traced run that
takes the host match in every block, the control, and a triplet equal
to the device-delta cell's for the same input."""

import filecmp
import glob
import os
import time

import pytest

from portbench import cell, control, layers, manifest
from portbench import trace as tr
from portbench.gen import traffic

CELL = "se101-auto.bact"
SMALL = {"reads": 4096, "compress": {"block_reads": 1024}}
SEED = 2**33 + 24
#: a span's reader -> its span (compress side)
SPANS = {"host_delta_ms_per_block": "host delta",
         "gather_orient_ms_per_block": "gather orient",
         "delta_match_ms_per_block": "delta match"}
SHARE = "host_delta_block_share"


def _ev(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def _ctx(spans=(), blocks=4):
    """A compress call at 0-400 us and a decompress call at 500-900;
    each ``(name, start, dur, tid)`` a span."""
    events = [_ev("portbench.compress", 0, 400),
              _ev("portbench.decompress", 500, 400)]
    events += [_ev(name, ts, dur, tid) for name, ts, dur, tid in spans]
    return layers.Context(
        trace=tr.from_events(events),
        windows={"compress": [(0.0, 400.0)], "decompress": [(500.0, 900.0)]},
        calls={"compress": 1, "decompress": 1},
        blocks={"compress": blocks, "decompress": 5},
        counts={"reads": 10, "bases": 1000, "kmer_windows": 900,
                "qual_symbols": 1000},
        stream_bytes={"n": 5, "r": 250, "q": 500})


def _nested(ts, gather, match, tid):
    """One block's ``host delta`` span holding its two halves."""
    return [("host delta", ts, gather + match, tid),
            ("gather orient", ts, gather, tid),
            ("delta match", ts + gather, match, tid)]


#: two blocks on two workers, one before the compress call
TRACE = _nested(10, 20, 30, 2) + _nested(100, 5, 45, 3) \
    + _nested(-80, 10, 10, 2)


@pytest.mark.parametrize("metric, spans, blocks, want", [
    ("host_delta_ms_per_block", TRACE, 4, (50 + 50) / 1e3 / 4),
    ("gather_orient_ms_per_block", TRACE, 4, (20 + 5) / 1e3 / 4),
    ("delta_match_ms_per_block", TRACE, 4, (30 + 45) / 1e3 / 4),
    ("delta_match_ms_per_block", TRACE, 2, (30 + 45) / 1e3 / 2),
    ("host_delta_ms_per_block", [], 4, None),             # absent
    ("gather_orient_ms_per_block", _nested(-80, 10, 10, 2), 4, None),
    ("delta_match_ms_per_block",                          # decompress only
     [("delta match", 600, 30, 1)], 4, None),
    ("host_delta_ms_per_block", [("host core", 10, 30, 1)], 4, None),
    ("gather_orient_ms_per_block", TRACE, 0, None),       # zero blocks
])
def test_span_readers(metric, spans, blocks, want):
    read = manifest.load_module("metrics", metric).read
    got = read(_ctx(spans, blocks))
    assert got == (None if want is None else pytest.approx(want))


@pytest.fixture
def timing():
    from scalce_tpu_torch import timing
    return timing


@pytest.mark.parametrize("counts, blocks, want", [
    ({"host_delta_blocks": 4}, 4, 100.0),
    ({"host_delta_blocks": 8}, 4, 200.0),        # a pair's two mates
    ({"host_delta_blocks": 1, "literals": 9}, 4, 25.0),
    ({"host_delta_blocks": 0}, 4, 0.0),
    ({}, 4, None),                               # absent: the parent
    ({"literals": 9}, 4, None),
    ({"host_delta_blocks": 4}, 0, None),         # zero blocks
])
def test_host_delta_block_share(counts, blocks, want, timing, monkeypatch):
    """Only the compress side's counter counts; no ``counters`` at all
    gives None."""
    read = manifest.load_module("metrics", SHARE).read
    monkeypatch.setattr(timing, "counters", lambda: {
        "compress": counts, "decompress": {"host_delta_blocks": 3}})
    assert read(_ctx(blocks=blocks)) == want
    monkeypatch.delattr(timing, "counters")
    assert read(_ctx(blocks=blocks)) is None


def test_manifest_resolves_the_cell():
    """``ratio`` and ``setup_s`` end to end, the four host-delta readers
    per layer, and a configuration that is ``se101-bare``'s but for the
    placement (AUTO cores, host delta)."""
    c = manifest.cell(CELL)
    assert c.chips == 1
    assert {m["name"] for m in c.end_to_end} == {"ratio", "setup_s"}
    assert {m["name"] for m in c.per_layer} == set(SPANS) | {SHARE}
    assert {m["layer"] for m in c.per_layer} == {"host delta"}
    bare = manifest.cell("se101-bare.bact")
    assert c.traffic == bare.traffic
    assert c.config["compress"] == {**bare.config["compress"],
                                    "core_on_device": None,
                                    "delta_on_device": False}
    assert c.config["decompress"] == bare.config["decompress"]
    assert c.config["input_reads"] == bare.config["input_reads"]


def test_traced_run_takes_the_host_match():
    """The cell on the CPU at a small size: correct, every block's delta
    matched on the host, each reader a value, the two halves inside
    ``host delta``."""
    r = cell.run(CELL, SEED, 0.01, True, "cpu", time.monotonic(), SMALL)
    assert r["correct"] and r["failed"] == 0, r
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(got) == set(SPANS) | {SHARE}
    assert got[SHARE] == 100.0
    assert 0 < got["gather_orient_ms_per_block"] \
        + got["delta_match_ms_per_block"] <= got["host_delta_ms_per_block"]


def test_control_fails_sound_passes():
    for row in control.readings(CELL, [SEED, SEED + 1], "cpu", SMALL):
        assert row["sound"] == {"mismatched_records": 0,
                                "compress_not_on_device": 0}
        assert row["control"]["mismatched_records"] > 0


def test_triplet_equals_the_device_delta_cells(tmp_path):
    """The same input under ``se101-auto`` and ``se101-bare``: the same
    triplet, byte for byte."""
    prefixes = []
    for name in (CELL, "se101-bare.bact"):
        d = str(tmp_path / name)
        os.makedirs(d)
        runner = cell.Runner(manifest.cell(name), d, "cpu", SMALL)
        runner.write_inputs(traffic.make_files(
            manifest.cell(name).traffic, SEED, False, SMALL["reads"]))
        runner.compress(cell._span_factory(False))
        prefixes.append(runner.prefix)
    names = [sorted(os.path.basename(p) for p in glob.glob(x + ".*"))
             for x in prefixes]
    assert names[0] == names[1] and len(names[0]) == 3
    for n in names[0]:
        assert filecmp.cmp(os.path.join(os.path.dirname(prefixes[0]), n),
                           os.path.join(os.path.dirname(prefixes[1]), n),
                           shallow=False), n
