"""Real multi-process runs of scalce_tpu_torch over torch.distributed
(gloo on localhost): two ranks of ``python -m
scalce_tpu_torch.parallel.multihost --device cpu`` write, after rank
0's merge, scalce_tpu's single-host triplet byte for byte, lossless and
lossy; in child code the barrier orders the ranks' writes, mismatched
barriers raise on every rank, and the histogram all-reduce sums every
rank's histogram.  One process needs no process group."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from scalce_tpu.config import Config as RefConfig
from scalce_tpu.pipeline import driver as ref_driver
from scalce_tpu.utils.synth import synth_fastq
from scalce_tpu_torch.parallel import distributed

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 1024
#: seconds a child may take before the test fails (a rendezvous that
#: never completes times out inside the child first)
CHILD_TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _launch(tmp, argv_of_rank, n=2):
    """Start ``n`` ranks (``argv_of_rank(rank, port)``), wait for all,
    fail with the log of the first that failed."""
    port = _free_port()
    procs = []
    for rank in range(n):
        log = open(os.path.join(tmp, f"rank{rank}.log"), "wb")
        procs.append((subprocess.Popen(argv_of_rank(rank, port), cwd=REPO,
                                       env=_env(), stdout=log, stderr=log),
                      log))
    failed = None
    for rank, (proc, log) in enumerate(procs):
        try:
            rc = proc.wait(timeout=CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        log.close()
        if rc != 0 and failed is None:
            with open(log.name, "rb") as f:
                failed = (rank, rc, f.read()[-3000:].decode(errors="replace"))
    if failed is not None:
        pytest.fail("rank {} exited {}:\n{}".format(*failed))


def _triplet(prefix):
    out = {}
    for ext in (".scalcen", ".scalcer", ".scalceq"):
        with open(f"{prefix}.00{ext}", "rb") as f:
            out[ext] = f.read()
    return out


@pytest.mark.parametrize("lossy", [0, 30], ids=["lossless", "lossy30"])
def test_two_ranks_match_single_host(tmp_path, lossy):
    tmp = str(tmp_path)
    src = os.path.join(tmp, "in.fastq")
    with open(src, "wb") as f:
        f.write(synth_fastq(4 * BLOCK, 100, seed=33, var_len=True,
                            n_rate=0.005))
    out = os.path.join(tmp, "mh")
    flags = ["--block-reads", str(BLOCK), "-c", "gz", "-T", "1",
             "-p", str(lossy)]
    _launch(tmp, lambda rank, port: [
        sys.executable, "-m", "scalce_tpu_torch.parallel.multihost", src,
        "-o", out, "--coordinator", f"localhost:{port}", "--num-processes",
        "2", "--process-id", str(rank), "--device", "cpu", *flags])
    ref = os.path.join(tmp, "ref")
    ref_driver.compress(RefConfig(inputs=(src,), output=ref, block_reads=BLOCK,
                                  lossy_pct=lossy, backend="gz",
                                  core_on_device=True, delta_on_device=True))
    assert _triplet(out) == _triplet(ref)
    assert not [p for p in os.listdir(tmp) if ".host" in p]
    for rank in range(2):
        with open(os.path.join(tmp, f"rank{rank}.log")) as f:
            assert f"host {rank}: 2 blocks" in f.read()


PROBE = textwrap.dedent("""
    import os, sys, time
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from scalce_tpu_torch.parallel import distributed
    tmp, port, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
    topo = distributed.init_multihost(f"localhost:{port}", 2, rank,
                                      timeout_s=120)
    try:
        assert (topo.host_id, topo.n_hosts) == (rank, 2), topo
        # barrier: rank 1 writes late; after the barrier both see both
        if rank == 1:
            time.sleep(1.5)
        open(os.path.join(tmp, f"pre_{rank}"), "w").close()
        distributed.barrier(7)
        seen = sorted(p for p in os.listdir(tmp) if p.startswith("pre_"))
        with open(os.path.join(tmp, f"post_{rank}"), "w") as f:
            f.write(",".join(seen))
        # the histogram all-reduce: rank r holds (r + 1) * (i + 1)
        local = (rank + 1) * np.arange(1, 95, dtype=np.int64)
        got = distributed.global_quality_histogram(local)
        np.save(os.path.join(tmp, f"hist_{rank}.npy"), got)
        assert np.array_equal(local, (rank + 1) * np.arange(1, 95))
        # ranks at different barriers: every rank raises
        try:
            distributed.barrier(1 + rank)
        except RuntimeError as e:
            with open(os.path.join(tmp, f"mismatch_{rank}"), "w") as f:
                f.write(str(e))
    finally:
        distributed.shutdown()
""")


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("probe"))
    _launch(tmp, lambda rank, port: [sys.executable, "-c", PROBE, tmp,
                                     str(port), str(rank)])
    return tmp


def test_barrier_orders_cross_process_writes(probe):
    """Each rank writes pre_RANK before the barrier (rank 1 1.5 s late);
    after it, each rank sees both files."""
    for rank in range(2):
        with open(os.path.join(probe, f"post_{rank}")) as f:
            assert f.read().split(",") == ["pre_0", "pre_1"]


def test_global_histogram_is_a_true_all_reduce(probe):
    want = 3 * np.arange(1, 95, dtype=np.int64)        # (1 + 2) * (i + 1)
    for rank in range(2):
        got = np.load(os.path.join(probe, f"hist_{rank}.npy"))
        assert got.dtype == np.int64 and np.array_equal(got, want)


def test_mismatched_barriers_raise_on_every_rank(probe):
    for rank in range(2):
        with open(os.path.join(probe, f"mismatch_{rank}")) as f:
            assert "different barriers (1 to 2)" in f.read()


def test_single_process_needs_no_group():
    """One process: no process group, the barrier returns, the
    histogram is the local one."""
    topo = distributed.init_multihost()
    assert (topo.host_id, topo.n_hosts) == (0, 1)
    assert topo.n_local_devices == topo.n_global_devices \
        == torch.cuda.device_count()
    distributed.barrier()
    distributed.barrier(5)
    local = np.arange(94, dtype=np.int64)
    assert distributed.global_quality_histogram(local) is local
    assert not torch.distributed.is_initialized()
