"""The check on the CPU at a small size, the harness's look for a card
skipped: sound runs are correct, the control (the lossy quality map the
program has) and each fault planted under the timed path are not."""

import time

import pytest
import torch

from portbench import cell, control, manifest
from scalce_tpu_torch.io import fastq
from scalce_tpu_torch.parallel import mesh
from scalce_tpu_torch.pipeline import driver, encode

SMALL = {"reads": 4096, "compress": {"block_reads": 1024}}
SEED = 2**33 + 11
#: the pair cell (``-r --qual-device``): the harness's pair path
PAIR = "pe101-qdev.human"


def _run(name, overrides=SMALL):
    return cell.run(name, SEED, 0.01, False, "cpu", time.monotonic(),
                    overrides)


def _checks(r):
    return {k: v["value"] for k, v in r["checks"].items()}


@pytest.mark.parametrize("name", ["se101-bare.bact", PAIR])
def test_control_fails_sound_passes(name):
    rows = control.readings(name, [SEED, SEED + 1, SEED + 2], "cpu", SMALL)
    for row in rows:
        assert row["sound"] == {"mismatched_records": 0,
                                "compress_not_on_device": 0}
        assert row["control"]["mismatched_records"] > 0


def test_sound_run_is_correct():
    r = _run("se101-bare.bact")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in manifest.cell(
        "se101-bare.bact").end_to_end} == {"ratio", "setup_s"}


def _wrap_render(monkeypatch, change):
    real = fastq.render_fastq_records
    n = [0]

    def render(*a, **kw):
        out = real(*a, **kw)
        n[0] += 1
        return change(None if out is None else bytes(out), n[0])
    monkeypatch.setattr(fastq, "render_fastq_records", render)


def _flip(out, i):
    """The first record's first base changed."""
    if out is None:
        return out
    lines = out.split(b"\n")
    seq = bytearray(lines[1])
    seq[0] = ord("C") if seq[0] != ord("C") else ord("A")
    lines[1] = bytes(seq)
    return b"\n".join(lines)


def _half(out, i):
    """Every second render left out."""
    return out if i % 2 else None


def _write_nothing(monkeypatch):
    monkeypatch.setattr(driver, "_run_decode_pipeline",
                        lambda items, decs, outs, workers, stats: None)


def test_answer_altered_where_produced(monkeypatch):
    _wrap_render(monkeypatch, _flip)
    r = _run("se101-bare.bact")
    assert not r["correct"] and _checks(r)["mismatched_records"] >= 2


def test_half_the_batch_left_out(monkeypatch):
    _wrap_render(monkeypatch, _half)
    r = _run("se101-bare.human")
    assert not r["correct"] and r["failed"] > 0
    assert _checks(r)["mismatched_records"] >= 4096 // 2


def test_state_returned_unchanged(monkeypatch):
    """A decompress that writes nothing: its output is its state as it
    found it."""
    _write_nothing(monkeypatch)
    r = _run("se101-bare.bact")
    assert not r["correct"] and _checks(r)["mismatched_records"] >= 4096


def test_mates_out_of_lockstep(monkeypatch):
    def rotate(out, i):
        if out is None or b" 2:N:0:" not in out[:200]:
            return out
        recs = out.split(b"\n")[:-1]
        recs = recs[4:] + recs[:4]
        return b"\n".join(recs) + b"\n"
    _wrap_render(monkeypatch, rotate)
    r = _run(PAIR)
    assert not r["correct"] and _checks(r)["mismatched_records"] > 0


#: the faults above, each planted under the pair cell's timed path
PAIR_FAULTS = {
    "answer_altered": lambda mp: _wrap_render(mp, _flip),
    "half_the_batch": lambda mp: _wrap_render(mp, _half),
    "state_unchanged": _write_nothing,
}


@pytest.mark.parametrize("fault", sorted(PAIR_FAULTS))
def test_faults_in_the_pair_cell(monkeypatch, fault):
    """The pair cell decodes its qualities on the device and renders
    each mate apart: each fault there fails the check too."""
    PAIR_FAULTS[fault](monkeypatch)
    r = _run(PAIR)
    assert not r["correct"] and r["failed"] > 0
    assert _checks(r)["mismatched_records"] > 0


def test_a_cards_share_left_out(monkeypatch):
    """The data-parallel path (``--data-parallel --qual-device``) over
    four devices, the CPU four times: the host leaves out the second
    device's share of each group."""
    monkeypatch.setattr(mesh, "local_mesh", lambda n=None, device="cuda":
                        [torch.device("cpu")] * 4)
    real = mesh.ShardedEncoder.assemble

    def assemble(self, blocks, fetched):
        out = real(self, blocks, fetched)
        g = len(blocks) // 4
        return out[:g] + out[2 * g:] if g else out
    monkeypatch.setattr(mesh.ShardedEncoder, "assemble", assemble)
    dp = {"data_parallel": True, "core_on_device": True,
          "delta_on_device": True, "qual_on_device": True,
          "qual_context_order": 1}
    r = _run("se101-bare.bact",
             {**SMALL, "compress": {**SMALL["compress"], **dp}})
    assert not r["correct"] and _checks(r)["mismatched_records"] > 0


def test_cores_off_the_device(monkeypatch):
    real = encode.BlockEncoder.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        self.placement = "host"
    monkeypatch.setattr(encode.BlockEncoder, "__init__", init)
    r = _run("se101-bare.bact")
    assert not r["correct"] and _checks(r)["compress_not_on_device"] > 0


class _FourCards(cell.Runner):
    """The program on the CPU, the harness seeing four cards that each
    hold memory from the warm-up; ``busy`` lists the cards that the
    window's calls allocate on."""
    busy = (0, 1, 2, 3)

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.cards = ["card0", "card1", "card2", "card3"]
        self.calls = 0

    def sync(self):
        self.calls += 1

    def open_cards(self):
        pass

    def reset_peaks(self):
        pass

    def peak_bytes(self):
        return [1 << 20] * 4

    def allocations(self):
        return [self.calls if i in self.busy else 1 for i in range(4)]

    def kind(self):
        return "four cards"


@pytest.mark.parametrize("busy,idle", [((0, 1, 2, 3), 0), ((0,), 3)])
def test_every_group_on_one_card(monkeypatch, busy, idle):
    """A card that the window gives no work fails the check, though it
    holds memory from the warm-up."""
    monkeypatch.setattr(_FourCards, "busy", busy)
    monkeypatch.setattr(cell, "Runner", _FourCards)
    r = _run("se101-bare.bact")
    assert _checks(r)["cards_without_work"] == idle
    assert r["correct"] == (idle == 0)
