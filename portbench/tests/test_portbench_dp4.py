"""The four-card cell ``se101-qdev-dp4.bact`` on the CPU at a small size:
its readers of the program's per-card device time and group counters
on hand-made counters (each its value, and None where the counter is
absent, as in a program that does not record it), a traced run over a
mesh of four CPU devices, and the control."""

import time

import pytest

from portbench import cell, control, layers, manifest
from portbench import trace as tr
from scalce_tpu_torch.parallel import mesh

CELL = "se101-qdev-dp4.bact"
SMALL = {"reads": 4096, "compress": {"block_reads": 512}}
SEED = 2**33 + 19

COUNTERS = {
    "compress": {"grouped_blocks": 6, "tail_blocks": 2},
    "device_us": {"stage A+B": 4000.0, "pass B": 1000.0,
                  "quality decode": 900.0, "upload": 400.0,
                  "download": 600.0, "no stage": 5.0},
    "device_us_by_card": {
        0: {"stage A+B": 1300.0, "pass B": 250.0, "upload": 100.0,
            "download": 150.0, "quality decode": 900.0, "no stage": 5.0},
        1: {"stage A+B": 900.0, "pass B": 250.0, "upload": 100.0,
            "download": 150.0},
        2: {"stage A+B": 900.0, "pass B": 250.0, "upload": 100.0,
            "download": 150.0},
        3: {"stage A+B": 900.0, "pass B": 250.0, "upload": 100.0,
            "download": 150.0}}}
#: per card over the group's stages: 1800, 1400, 1400, 1400 (mean 1500)
READ = {"stage_ab_device_ms_per_block": 4000.0 / 1e3 / 8,
        "pass_b_device_ms_per_block": 1000.0 / 1e3 / 8,
        "qual_decode_device_ms_per_block": 900.0 / 1e3 / 10,
        "card_busy_imbalance.compress": 100.0 * (1800.0 / 1500.0 - 1.0),
        "grouped_block_share": 100.0 * 6 / 8}


def _ctx():
    return layers.Context(
        trace=tr.from_events([]),
        windows={"compress": [(0.0, 400.0)], "decompress": [(500.0, 900.0)]},
        calls={"compress": 1, "decompress": 1},
        blocks={"compress": 8, "decompress": 10},
        counts={"reads": 10, "bases": 1000, "kmer_windows": 900,
                "qual_symbols": 1000},
        stream_bytes={"n": 5, "r": 250, "q": 500})


@pytest.fixture
def timing():
    from scalce_tpu_torch import timing
    return timing


def test_the_cell_reads_its_new_metrics():
    names = {m["name"] for m in manifest.cell(CELL).per_layer}
    assert set(READ) <= names
    assert manifest.cell(CELL).chips == 4


@pytest.mark.parametrize("metric", sorted(READ))
def test_counter_readers(metric, timing, monkeypatch):
    read = manifest.load_module("metrics", metric).read
    monkeypatch.setattr(timing, "counters", lambda: COUNTERS)
    assert read(_ctx()) == pytest.approx(READ[metric])
    # the parent's counters: per stage, without the new keys or stages
    monkeypatch.setattr(timing, "counters", lambda: {
        "compress": {"h2d_bytes": 1}, "device_us": {"stage A": 1.0}})
    assert read(_ctx()) is None
    monkeypatch.setattr(timing, "counters", lambda: {})
    assert read(_ctx()) is None
    monkeypatch.delattr(timing, "counters")
    assert read(_ctx()) is None


def test_imbalance_is_zero_on_even_cards(timing, monkeypatch):
    even = {c: {"stage A+B": 10.0, "pass B": 2.0} for c in range(4)}
    monkeypatch.setattr(timing, "counters",
                        lambda: {"device_us_by_card": even})
    read = manifest.load_module("metrics",
                                "card_busy_imbalance.compress").read
    assert read(_ctx()) == 0.0


def test_traced_run_over_four_devices(monkeypatch):
    """The cell on a mesh of four CPU devices: correct, every block in
    a full group."""
    four = [mesh.resolve_device("cpu")] * 4
    monkeypatch.setattr(mesh, "local_mesh", lambda n=None, device=None: four)
    r = cell.run(CELL, SEED, 0.01, True, "cpu", time.monotonic(), SMALL)
    assert r["correct"] and r["failed"] == 0, r
    assert r["metrics"]["grouped_block_share"]["value"] == 100.0


def test_control_fails_sound_passes():
    for row in control.readings(CELL, [SEED, SEED + 1], "cpu", SMALL):
        assert row["sound"] == {"mismatched_records": 0,
                                "compress_not_on_device": 0}
        assert row["control"]["mismatched_records"] > 0
