"""What a run loads and when it refuses to give a result: no card, a
checkout without the program, a module of JAX or of its package."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from portbench import cell, manifest

ROOT = manifest.ROOT
RUN = os.path.join("portbench", "run.py")


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_result(stdout):
    for line in stdout.strip().splitlines()[-1:]:
        try:
            return "correct" in json.loads(line)
        except ValueError:
            return False
    return False


def test_no_card_no_result():
    p = _run([RUN, "--workload", "se101-bare.bact", "--seed", "1",
              "--seconds", "1", "--trace", "0"], ROOT)
    assert p.returncode != 0 and not _has_result(p.stdout)
    assert "CUDA card" in p.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run([RUN, "--workload", "se101-bare.bact", "--seed", "1",
              "--seconds", "1", "--trace", "0"], str(tmp_path))
    assert p.returncode != 0 and not _has_result(p.stdout)


_PROBE = textwrap.dedent("""
    import json, sys, time
    sys.path.insert(0, {root!r})
    {body}
    print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""")


def _loaded(body):
    p = _run(["-c", _PROBE.format(root=ROOT, body=body)], ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """Everything ``run.py`` imports, and what the program loads in a
    whole (small, CPU) run of every cell and of the control."""
    body = textwrap.dedent("""
        import importlib.util
        spec = importlib.util.spec_from_file_location("run", "portbench/run.py")
        importlib.util.module_from_spec(spec)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        from portbench import cell, control, manifest
        ov = {"reads": 2048, "compress": {"block_reads": 512}}
        for w in manifest.benchmark()["workloads"]:
            r = cell.run(w["name"], 5, 0.01, True, "cpu", time.monotonic(), ov)
            assert r["correct"], r
        control.readings("se101-bare.bact", [6], "cpu", ov)
    """)
    loaded = _loaded(body)
    assert "scalce_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & set(cell.BANNED), loaded & set(cell.BANNED)


def test_reference_loads_neither_package():
    loaded = _loaded(textwrap.dedent("""
        from portbench.reference import records
        records.mismatched(records.records([b"@a\\nA\\n+\\nI\\n"]), [])
    """))
    assert not loaded & (set(cell.BANNED) | {"scalce_tpu_torch", "torch"})


def test_banned_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "scalce_tpu_torchlike", sys)
    assert cell.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert cell.banned_modules() == ["jaxlib"]


@pytest.mark.gpu
def test_a_cell_on_the_card():
    """One short run of a one-card cell: a result, and it is correct."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, RUN, "--workload", "se101-bare.bact",
                        "--seed", "2147483653", "--seconds", "2",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["busy_s"] > 0
    assert list(r)[-1] == "checks"
