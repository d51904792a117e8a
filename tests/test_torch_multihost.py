"""Multi-host compress in scalce_tpu_torch, simulated as one driver run
per host in one process (the counterpart of tests/test_multihost.py):
every host's share merged by ``driver.merge_hosts`` equals scalce_tpu's
1-host triplet byte for byte, at part sizes 0 and 120,000, paired,
lossy, under --data-parallel on a 2-device CPU mesh, after a torn write
resumed per host, and through the CLI's --merge-hosts; a missing host's
blocks are detected."""

import glob
import os

import pytest
import torch

import scalce_tpu.cli as ref_cli
from scalce_tpu.config import Config as RefConfig
from scalce_tpu.pipeline import driver as ref_driver
from scalce_tpu.utils.synth import synth_fastq, synth_pair
from scalce_tpu_torch import cli
from scalce_tpu_torch.config import Config
from scalce_tpu_torch.parallel import mesh
from scalce_tpu_torch.pipeline import driver

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

#: the port's bare-command placements (device cores and delta, host
#: qualities at the trial's order), gz, small blocks
BASE = dict(mode="compress", block_reads=1 << 10, backend="gz",
            core_on_device=True, delta_on_device=True, threads=2)


def _triplet(prefix):
    out = {}
    for path in sorted(glob.glob(prefix + ".*.scalce[nrq]")):
        with open(path, "rb") as f:
            out[path[len(prefix):]] = f.read()
    return out


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _hosts(tmp_path, name, n_hosts, inputs, merge=True, **kw):
    """Each host's compress into ``name``, then the merge; returns the
    merged prefix and the hosts' RunStats."""
    out = str(tmp_path / name)
    stats = [driver.compress(Config(inputs=inputs, output=out,
                                    n_hosts=n_hosts, host_id=h, **kw), "cpu")
             for h in range(n_hosts)]
    if merge:
        driver.merge_hosts(Config(inputs=inputs, output=out,
                                  n_hosts=n_hosts, **kw))
    return out, stats


def _reference(tmp_path, inputs, **kw):
    out = str(tmp_path / "ref")
    ref_driver.compress(RefConfig(inputs=inputs, output=out, **kw))
    return _triplet(out)


@pytest.mark.parametrize("part_size", [0, 120_000])
def test_three_hosts_merge_to_the_reference_triplet(tmp_path, part_size):
    src = _write(tmp_path, "in.fastq", synth_fastq(
        7000, 100, seed=40, var_len=True, n_rate=0.003))
    kw = dict(BASE, part_size=part_size)
    merged, stats = _hosts(tmp_path, "multi", 3, (src,), **kw)
    assert [s.n_blocks for s in stats] == [3, 2, 2]
    assert sum(s.n_reads for s in stats) == 7000
    want = _reference(tmp_path, (src,), **kw)
    got = _triplet(merged)
    assert (len(got) > 3) == (part_size > 0)
    assert got == want
    assert not glob.glob(str(tmp_path / "multi.host*"))


def test_merge_detects_missing_host_blocks(tmp_path):
    src = _write(tmp_path, "in.fastq", synth_fastq(4000, 100, seed=41))
    out = str(tmp_path / "m")
    driver.compress(Config(inputs=(src,), output=out, n_hosts=2, host_id=0,
                           **BASE), "cpu")
    with pytest.raises((ValueError, FileNotFoundError)):
        driver.merge_hosts(Config(inputs=(src,), output=out, n_hosts=2,
                                  **BASE))


def test_resume_per_host_after_torn_write(tmp_path):
    """Host 0's triplet torn mid-block: --resume on host 0 keeps its
    durable blocks and redoes the rest, and the merge is the reference's
    1-host triplet."""
    src = _write(tmp_path, "in.fastq", synth_fastq(
        5000, 100, seed=50, var_len=True))
    out, (first, _) = _hosts(tmp_path, "multi", 2, (src,), merge=False,
                             **BASE)
    assert first.n_blocks == 3
    for ext, cut in ((".scalcer", 300), (".scalceq", 40)):
        path = f"{out}.host0.00{ext}"
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[:-cut])
    again = driver.compress(Config(inputs=(src,), output=out, n_hosts=2,
                                   host_id=0, resume=True, **BASE), "cpu")
    assert 1 <= again.n_blocks < 3
    driver.merge_hosts(Config(inputs=(src,), output=out, n_hosts=2, **BASE))
    assert _triplet(out) == _reference(tmp_path, (src,), **BASE)
    driver.decompress(Config(mode="decompress", inputs=(out + ".00.scalcen",),
                             output=str(tmp_path / "d"), keep_order=True),
                      "cpu")
    with open(tmp_path / "d.fastq", "rb") as a, open(src, "rb") as b:
        assert a.read() == b.read()


def test_paired_two_hosts(tmp_path):
    mates = tuple(_write(tmp_path, f"m{m}.fastq", data) for m, data in
                  zip((1, 2), synth_pair(5000, 100, seed=70)))
    kw = dict(BASE, paired=True)
    merged, _ = _hosts(tmp_path, "multi", 2, mates, **kw)
    got = _triplet(merged)
    assert len(got) == 6 and got == _reference(tmp_path, mates, **kw)


def test_lossy_three_hosts(tmp_path):
    """Every host samples the same first reads (ownership is chosen
    after the lossy preamble), so the maps and the merge agree."""
    src = _write(tmp_path, "in.fastq", synth_fastq(
        6000, 100, seed=44, var_len=True, qual_model="illumina"))
    kw = dict(BASE, lossy_pct=30, sample_size=2000)
    merged, _ = _hosts(tmp_path, "multi", 3, (src,), **kw)
    assert _triplet(merged) == _reference(tmp_path, (src,), **kw)


def test_data_parallel_two_hosts_on_two_devices(tmp_path, monkeypatch):
    """Each host runs --data-parallel over a 2-device CPU mesh on its
    owned blocks only (groups of owned blocks), with the qualities on
    the device (K5/K6's plain versions); the merge is the reference's
    plain single-device triplet."""
    src = _write(tmp_path, "in.fastq", synth_fastq(
        9000, 100, seed=55, var_len=True, n_rate=0.002, rc_rate=0.4))
    cpus = mesh.local_mesh(2, "cpu")
    monkeypatch.setattr(mesh, "local_mesh", lambda n=None, device=None: cpus)
    kw = dict(BASE, block_reads=1 << 9, qual_on_device=True,
              qual_context_order=1)
    merged, stats = _hosts(tmp_path, "dp", 2, (src,), data_parallel=True,
                           **kw)
    assert all(s.device == "cpu,cpu" for s in stats)
    assert [s.n_blocks for s in stats] == [9, 9]
    assert _triplet(merged) == _reference(tmp_path, (src,), **kw)


def test_cli_merge_hosts(tmp_path):
    """--n-hosts/--host-id runs and --merge-hosts through the port's CLI
    give the reference CLI's 1-host triplet, which decompresses."""
    src = _write(tmp_path, "in.fastq", synth_fastq(3000, 100, seed=80))
    argv = [src, "-c", "gz", "--block-reads", "1024", "-T", "2"]
    for h in range(2):
        assert cli.main(["--device", "cpu", *argv, "-o", str(tmp_path / "m"),
                         "--n-hosts", "2", "--host-id", str(h)]) == 0
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["in.fastq"] + [f"m.host{h}.00.scalce{s}"
                        for h in range(2) for s in "nrq"])
    assert cli.main(["--device", "cpu", *argv, "-o", str(tmp_path / "m"),
                     "--n-hosts", "2", "--merge-hosts"]) == 0
    assert ref_cli.main([*argv, "-o", str(tmp_path / "r")]) == 0
    assert _triplet(str(tmp_path / "m")) == _triplet(str(tmp_path / "r"))
    assert cli.main(["--device", "cpu", "-d", "--keep-order",
                     str(tmp_path / "m.00.scalcen"), "-o",
                     str(tmp_path / "d")]) == 0
    with open(tmp_path / "d.fastq", "rb") as a, open(src, "rb") as b:
        assert a.read() == b.read()
