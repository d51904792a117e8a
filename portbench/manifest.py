"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file
``configs/<config>.json`` gives the command (the port's ``Config``
fields of the compress and of the decompress), the chips and the
input's scale, and a traffic mix, ``traffic/<traffic>.json``, the
shape of the reads.  A per-layer metric is read by
``metrics/<name>.py``, a kernel's work is counted by ``work/<K>.py``.
Nothing here names a cell, a mix or a metric: a new one is new files and
new entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
#: the checkout's root, which holds BENCHMARK.json and the program
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict              # configs/<config>.json
    traffic: Dict             # traffic/<traffic>.json
    end_to_end: List[Dict]    # the entries this cell reports
    per_layer: List[Dict]


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Dict = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files and the
    metrics it reports; KeyError when no cell has that name."""
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    (w,) = found
    (conf,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    # a per-layer metric without a workloads key is read wherever the
    # end-to-end metric it moves is reported
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return Cell(name, int(w["chips"]), load_json(os.path.join(
        ROOT, conf["file"])), load_json(os.path.join(
            HERE, "traffic", w["traffic"] + ".json")), e2e, layer)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, loaded by path
    (a metric's name may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
