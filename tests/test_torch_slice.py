"""The ported slice end to end on the CPU: scalce_tpu_torch.compress must
write scalce_tpu.compress's triplet byte for byte (same FASTQ, same
full-device Config), triplets must cross-decode in both directions, and
a round trip must import no jax."""

import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import scalce_tpu
import scalce_tpu_torch
from scalce_tpu.config import Config as RefConfig
from scalce_tpu.utils.synth import synth_fastq, synth_pair
from scalce_tpu_torch import convert
from scalce_tpu_torch.config import Config
from scalce_tpu_torch.pipeline.encode import BlockEncoder

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE = dict(block_reads=1024, max_read_len=128, qual_T_target=2048,
             core_on_device=True, delta_on_device=True, qual_on_device=True,
             qual_context_order=1, dict_mode="hash", backend="gz",
             threads=1)


def _triplet(prefix):
    out = {}
    for path in sorted(glob.glob(prefix + ".*.scalce[nrq]")):
        with open(path, "rb") as f:
            out[path[len(prefix):]] = f.read()
    return out


def _decompress(pkg, src, out, **kw):
    cfg = (RefConfig if pkg is scalce_tpu else Config)(
        mode="decompress", inputs=(src + ".00.scalcen",), output=out, **kw)
    if pkg is scalce_tpu:
        scalce_tpu.decompress(cfg)
    else:
        scalce_tpu_torch.decompress(cfg, "cpu")
    with open(out + ".fastq", "rb") as f:
        return f.read()


#: name -> (synth_fastq arguments, Config changes)
CASES = {
    "uniform": (dict(read_len=100), {}),
    "ragged": (dict(read_len=100, var_len=True, n_rate=0.01), {}),
    # 151 bp HiSeq-profile reads: AUTO width (160), order 3
    "hiseq151": (dict(read_len=151, var_len=True, qual_model="hiseq"),
                 dict(max_read_len=0, qual_context_order=3)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def files(request, tmp_path_factory):
    """2.5 blocks of 1024 reads, compressed by both packages."""
    d = str(tmp_path_factory.mktemp(request.param))
    synth, change = CASES[request.param]
    data = synth_fastq(2560, seed=17, genome_len=50_000, **synth)
    src = os.path.join(d, "in.fastq")
    with open(src, "wb") as f:
        f.write(data)
    ref, port = os.path.join(d, "ref"), os.path.join(d, "port")
    kw = {**SLICE, **change}
    scalce_tpu.compress(RefConfig(inputs=(src,), output=ref, **kw))
    scalce_tpu_torch.compress(Config(inputs=(src,), output=port, **kw),
                              "cpu")
    return {"dir": d, "data": data, "ref": ref, "port": port}


def test_compress_matches_reference_bytes(files):
    ref, port = _triplet(files["ref"]), _triplet(files["port"])
    assert sorted(ref) == [".00.scalcen", ".00.scalceq", ".00.scalcer"]
    assert port == ref


def test_triplets_cross_decode(files):
    d = files["dir"]
    assert _decompress(scalce_tpu_torch, files["ref"], os.path.join(d, "a"),
                       keep_order=True, qual_on_device=True) == files["data"]
    assert _decompress(scalce_tpu, files["port"], os.path.join(d, "b"),
                       keep_order=True) == files["data"]


def test_reordered_decode_matches_reference(files):
    """Without keep-order the reads come back in sorted order, names
    re-aligned — the reference's bytes."""
    d = files["dir"]
    got = _decompress(scalce_tpu_torch, files["port"], os.path.join(d, "c"),
                      qual_on_device=True)
    want = _decompress(scalce_tpu, files["ref"], os.path.join(d, "e"))
    assert got == want and got != files["data"]


def test_cli_round_trip_imports_no_jax(tmp_path):
    src = os.path.join(tmp_path, "in.fastq")
    with open(src, "wb") as f:
        f.write(synth_fastq(600, 100, seed=3, var_len=True, n_rate=0.01))
    mates = [os.path.join(tmp_path, f"m{m}.fastq") for m in (1, 2)]
    for path, data in zip(mates, synth_pair(600, 100, seed=4)):
        with open(path, "wb") as f:
            f.write(data)
    script = textwrap.dedent(f"""
        import sys
        import scalce_tpu_torch.parallel.mesh
        from scalce_tpu_torch.cli import main
        out = {str(tmp_path)!r}
        main(["--device", "cpu", "--block-reads", "256", "-c", "gz",
              "-o", out + "/o", {src!r}])
        main(["--device", "cpu", "--data-parallel", "--block-reads", "256",
              "-c", "gz", "-o", out + "/p", {src!r}])
        main(["--device", "cpu", "-d", "--keep-order", "-o", out + "/d",
              out + "/o.00.scalcen"])
        main(["--device", "cpu", "-r", "--block-reads", "256", "-c", "gz",
              "-o", out + "/r", *{mates!r}])
        main(["--device", "cpu", "-d", "--keep-order", "-o", out + "/rd",
              out + "/r.00_1.scalcen"])
        main(["--device", "cpu", "-p", "30", "-S", "300", "--block-reads",
              "256", "-c", "gz", "-o", out + "/l", {src!r}])
        main(["--device", "cpu", "-d", "--keep-order", "-o", out + "/ld",
              out + "/l.00.scalcen"])
        assert "jax" not in sys.modules, "jax was imported"
        assert open(out + "/d.fastq", "rb").read() == open({src!r},
                                                           "rb").read()
        for s in "nrq":
            assert open(out + "/o.00.scalce" + s, "rb").read() == \\
                open(out + "/p.00.scalce" + s, "rb").read()
        for m, path in zip((1, 2), {mates!r}):
            assert open(out + f"/rd_{{m}}.fastq", "rb").read() == \\
                open(path, "rb").read()
        lossy = open(out + "/ld.fastq", "rb").read().split(b"\\n")
        exact = open({src!r}, "rb").read().split(b"\\n")
        assert len(lossy) == len(exact) and lossy != exact
        assert [x for i, x in enumerate(lossy) if i % 4 != 3] == \\
            [x for i, x in enumerate(exact) if i % 4 != 3]
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["OMP_NUM_THREADS"] = "1"      # as torch.set_num_threads above
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


#: what is left outside: the Configs that the reference itself refuses
#: (long reads with a device placement or --data-parallel, a host id
#: outside the job, widths the container cannot hold); the port's own
#: gaps (long reads, multi-host) are ported and tested in
#: tests/test_torch_longread.py and tests/test_torch_multihost.py
HOST = dict(qual_on_device=False, delta_on_device=False)
LONG = dict(max_read_len=32768, block_reads=256)


@pytest.mark.parametrize("change", [
    dict(LONG),
    dict(LONG, core_on_device=None, qual_context_order=0,
         qual_on_device=False, delta_on_device=True),
    {**LONG, **HOST, "core_on_device": None, "qual_on_device": True},
    {**LONG, **HOST, "core_on_device": None, "data_parallel": True},
    dict(HOST, core_on_device=None, n_hosts=2, host_id=2),
    dict(n_hosts=3, host_id=-1),
    dict(max_read_len=32768, block_reads=1 << 16, **HOST,
         core_on_device=False),
    dict(HOST, max_read_len=40008, block_reads=256, core_on_device=False),
    dict(HOST, max_read_len=(1 << 20) + 16, block_reads=256,
         core_on_device=False)])
def test_configs_outside_the_slice_raise(change):
    """Each raises the reference's ValueError, word for word."""
    kw = {**SLICE, "inputs": ("in.fastq",), **change}
    with pytest.raises(ValueError) as want:
        RefConfig(**kw)
    with pytest.raises(ValueError) as got:
        BlockEncoder(Config(**kw), "cpu")
    assert str(got.value) == str(want.value)


def test_devices_are_explicit():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BlockEncoder(Config(inputs=("x",), **SLICE), "cuda")


def test_convert_round_trip():
    rng = np.random.default_rng(0)
    arrays = {"u32": rng.integers(0, 1 << 32, 9, dtype=np.uint64).astype(
        np.uint32), "u16": np.array([0, 65535], np.uint16),
        "i32": np.array([-5, 7], np.int32), "b": np.array([True, False])}
    t = convert.from_reference(arrays, "cpu")
    assert t["u32"].dtype == torch.int64 and t["u16"].dtype == torch.int32
    back = convert.to_numpy(t, {k: a.dtype for k, a in arrays.items()})
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype
        np.testing.assert_array_equal(back[k], a)
