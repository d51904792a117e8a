"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import math
import os
import re

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state_size|"
                   r"head|expansion|experts_per_tok)")


@pytest.fixture(scope="module")
def bench():
    return manifest.benchmark()


def _line(text, n=200):
    return isinstance(text, str) and 1 <= len(text) <= n \
        and "\n" not in text and "\t" not in text


def test_keys_and_sizes(bench):
    assert set(bench) == TOP
    path = os.path.join(manifest.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 \
        and bench["run_seconds"] == int(bench["run_seconds"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(manifest.ROOT, p))
    assert len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert 1 <= len(bench["configs"]) <= 24
    assert 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128


def test_names_units_and_entries(bench):
    names = {}
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.setdefault(kind, set()).add(e["name"])
        assert len(names[kind]) == len(bench[kind]), kind
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        conf = manifest.load_json(os.path.join(manifest.ROOT, c["file"]))
        assert conf["name"] == c["name"]
        for k in c["reduced"]:
            assert k in conf, k
    assert len({c["file"] for c in bench["configs"]}) == len(
        bench["configs"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_cells(bench):
    configs = {c["name"] for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = manifest.cell(w["name"], bench)
        assert cell.chips == cell.config["chips"] == w["chips"]
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
    assert configs == {w["config"] for w in bench["workloads"]}
    n4 = sum(w["chips"] == 4 for w in bench["workloads"])
    assert n4 <= max(1, math.floor(0.25 * len(bench["workloads"])))


def test_every_moves_is_reported_where_read(bench):
    for m in bench["per_layer"]:
        cells = m.get("workloads", [w["name"] for w in bench["workloads"]])
        for name in cells:
            cell = manifest.cell(name, bench)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}, (
                m["name"], name)


def test_files_found_by_name(bench):
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(
            manifest.HERE, "traffic", w["traffic"] + ".json"))
    layers = {}
    for m in bench["per_layer"]:
        mod = manifest.load_module("metrics", m["name"])
        assert callable(mod.read)
        layers.setdefault(m["layer"], set()).add(m["source"])
        if m["name"].endswith("_roofline"):
            work = manifest.load_module("work", m["name"][:-len(
                "_roofline")])
            assert work.SIDE in ("compress", "decompress")
            assert isinstance(work.KERNEL, str) and work.KERNEL


def test_command_runs_the_harness(bench):
    assert bench["command"][-1] == "portbench/run.py"
    assert bench["paths"] == ["portbench"]
    with open(os.path.join(manifest.ROOT, "BENCHMARK.json")) as f:
        json.load(f)
