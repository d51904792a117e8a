"""The pipelined drivers on the CPU: ``-T`` changes no byte.  Compress at
``threads`` 1, 2 and 4 writes scalce_tpu's ``threads=1`` triplet (full
device, the bare command, ``-r``, ``-p 30``, ``--data-parallel``), also
with recycled blocks poisoned; decompress gives the same FASTQ at 1 and
4 threads, also from a card-decode group whose blocks mix quality
orders (a K4 launch a block); the copied CLI surface (``-B`` parts, ``-n`` template names,
stdin, ``-o -``, resume) round-trips at ``-T 4`` as scalce_tpu's does;
and a failure on any thread raises out of the driver with every thread
it started stopped.

Each test that starts threads runs them under :func:`_bounded`: a hang
fails the test after a minute instead of holding the whole run."""

import glob
import io
import os
import sys
import threading
import time

import pytest
import torch

import scalce_tpu
import scalce_tpu.cli as ref_cli
from scalce_tpu.config import Config as RefConfig
from scalce_tpu.utils.synth import synth_fastq, synth_pair
from scalce_tpu_torch import cli, container
from scalce_tpu_torch.config import Config
from scalce_tpu_torch.io import fastq
from scalce_tpu_torch.pipeline import driver, threads
from scalce_tpu_torch.streams import qualities

# xdist runs test files side by side on the CPU: one intra-op thread
# per worker keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

#: 8 full blocks and a tail: more blocks than -T 4 keeps pending (6)
B = 1 << 10
READS = 8 * B + 300
SLICE = dict(block_reads=B, max_read_len=128, qual_T_target=256,
             core_on_device=True, delta_on_device=True, qual_on_device=True,
             qual_context_order=1, dict_mode="hash", backend="gz")
#: the bare command's flags (the CLIs' quality defaults)
BARE = ["-c", "gz", "--block-reads", str(B)]
#: compress cases: Config changes on top of SLICE (None: the bare CLI)
CASES = {"device": {}, "bare": None, "paired": {"paired": True},
         "lossy": {"lossy_pct": 30, "sample_size": 3000},
         "dp": {"data_parallel": True}}


def _bounded(fn, *args, timeout: float = 60, **kw):
    """``fn(*args, **kw)`` on a thread joined within ``timeout`` seconds:
    its result, or its exception raised here; fails on expiry."""
    out = {}

    def run():
        try:
            out["value"] = fn(*args, **kw)
        except BaseException as e:       # handed to the test thread
            out["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{fn.__name__} still running after {timeout} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _threads_back_to(n: int, timeout: float = 10) -> None:
    deadline = time.monotonic() + timeout
    while threading.active_count() > n and time.monotonic() < deadline:
        time.sleep(0.02)
    assert threading.active_count() <= n, threading.enumerate()


def _triplet(prefix):
    out = {}
    for path in sorted(glob.glob(prefix + ".*.scalce[nrq]")):
        with open(path, "rb") as f:
            out[path[len(prefix):]] = f.read()
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A ragged single-end file with N bases and a pair, each of 9
    blocks, and scalce_tpu's threads=1 triplet of each case (made when a
    test first asks for it)."""
    d = str(tmp_path_factory.mktemp("pipeline"))
    single = synth_fastq(READS, 100, seed=17, genome_len=50_000,
                         var_len=True, n_rate=0.01)
    mates = synth_pair(READS, 100, seed=31, genome_len=50_000,
                       var_len=True, n_rate=0.01)
    paths = {"single": (os.path.join(d, "in.fastq"),),
             "pair": (os.path.join(d, "m1.fastq"), os.path.join(d, "m2.fastq"))}
    for path, data in zip(paths["single"] + paths["pair"], (single, *mates)):
        with open(path, "wb") as f:
            f.write(data)
    return {"dir": d, "single": single, "pair": mates, "paths": paths,
            "ref": {}}


def _inputs(files, case):
    return files["paths"]["pair" if case == "paired" else "single"]


def _compress(files, case, out, threads_, device="cpu"):
    """The port's compress of ``case`` at ``threads_`` workers."""
    if CASES[case] is None:
        cli.main([*_inputs(files, case), *BARE, "-T", str(threads_), "-o",
                  out, "--device", device])
    else:
        driver.compress(Config(inputs=_inputs(files, case), output=out,
                               threads=threads_, **SLICE, **CASES[case]),
                        device)
    return _triplet(out)


def _reference(files, case):
    """scalce_tpu's threads=1 triplet of ``case``."""
    if case not in files["ref"]:
        out = os.path.join(files["dir"], "ref_" + case)
        if CASES[case] is None:
            ref_cli.main([*_inputs(files, case), *BARE, "-T", "1", "-o",
                          out])
        else:
            scalce_tpu.compress(RefConfig(inputs=_inputs(files, case),
                                          output=out, threads=1, **SLICE,
                                          **CASES[case]))
        files["ref"][case] = _triplet(out)
    return files["ref"][case]


@pytest.mark.parametrize("threads_", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_triplet_is_the_references_at_every_thread_count(files, case,
                                                          threads_):
    got = _bounded(_compress, files, case,
                   os.path.join(files["dir"], f"{case}_T{threads_}"),
                   threads_)
    want = _reference(files, case)
    assert len(want) == (6 if case == "paired" else 3)
    assert got == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_poisoned_recycling_changes_no_byte(files, case, monkeypatch):
    """Recycled blocks overwritten with 0xAB: nothing reads a block's
    parsed arrays after the host half that recycles it."""
    monkeypatch.setattr(fastq, "_POISON_RECYCLE", True)
    got = _bounded(_compress, files, case,
                   os.path.join(files["dir"], f"{case}_poison"), 4)
    assert got == _reference(files, case)


@pytest.mark.parametrize("qual_device", [False, True])
@pytest.mark.parametrize("keep_order", [True, False])
@pytest.mark.parametrize("case", ["device", "paired"])
def test_decompress_is_the_same_at_every_thread_count(files, case,
                                                       keep_order,
                                                       qual_device):
    """Single and paired, keep-order and reordered, host and device
    quality decode: the FASTQ at -T 1 and -T 4 is identical, keep-order
    gives the inputs back, and reordered is scalce_tpu's."""
    d = files["dir"]
    src = os.path.join(d, "dec_" + case)
    if not os.path.exists(src + ".00.scalcen") \
            and not os.path.exists(src + ".00_1.scalcen"):
        _bounded(_compress, files, case, src, 4)
    first = src + (".00_1.scalcen" if case == "paired" else ".00.scalcen")
    tag = f"{case}_{int(keep_order)}{int(qual_device)}"
    outs = {}
    for t in (1, 4):
        out = os.path.join(d, f"d_{tag}_T{t}")
        _bounded(driver.decompress, Config(
            mode="decompress", inputs=(first,), output=out,
            keep_order=keep_order, qual_on_device=qual_device, threads=t),
            "cpu")
        outs[t] = tuple(_read(p) for p in (
            [f"{out}_{m}.fastq" for m in (1, 2)] if case == "paired"
            else [out + ".fastq"]))
    assert outs[1] == outs[4]
    want = files["pair"] if case == "paired" else (files["single"],)
    if keep_order:
        assert outs[4] == tuple(want)
    else:
        ref = os.path.join(d, f"rd_{tag}")
        scalce_tpu.decompress(RefConfig(mode="decompress", inputs=(first,),
                                        output=ref, threads=1))
        assert outs[4] == tuple(_read(p) for p in (
            [f"{ref}_{m}.fastq" for m in (1, 2)] if case == "paired"
            else [ref + ".fastq"]))


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """9000 HiSeq-profile reads compressed by the bare CLI in blocks of
    4096: the order trial picks 3, 3 and 1, so the one decode group's
    quality streams differ in order."""
    d = str(tmp_path_factory.mktemp("mixed"))
    src, out = os.path.join(d, "in.fastq"), os.path.join(d, "o")
    data = synth_fastq(9000, 100, seed=5, qual_model="hiseq")
    with open(src, "wb") as f:
        f.write(data)
    _bounded(cli.main, [src, "-c", "gz", "--block-reads", "4096", "-T", "4",
                        "-o", out, "--device", "cpu"])
    reader = container.TripletReader(out + ".00.scalcen")
    assert [qualities.parse(p["q"]).order
            for _, p in reader.iter_blocks()] == [3, 3, 1]
    return {"dir": d, "src": out + ".00.scalcen", "data": data}


@pytest.mark.parametrize("delta_device", [False, True])
def test_mixed_order_group_decodes_on_the_card_a_block_a_launch(
        mixed, delta_device):
    """-d --qual-device at -T 4 on a group that mixes orders: a K4 launch
    and a finish task a block (with --delta-device each task waits for
    its own codes) give the input back."""
    out = os.path.join(mixed["dir"], f"d{int(delta_device)}")
    _bounded(cli.main, ["-d", mixed["src"], "-o", out, "--keep-order",
                        "--qual-device", "-T", "4", "--device", "cpu"]
             + (["--delta-device"] if delta_device else []))
    assert _read(out + ".fastq") == mixed["data"]


# ---------------------------------------------------------------------------
# the copied CLI surface at -T 4 against scalce_tpu's


def _both_clis(args_in, args_out_ref, args_out_port, stdin=None,
               monkeypatch=None):
    """Run scalce_tpu's CLI (-T 1) and the port's (-T 4, on the CPU)."""
    for main, extra in ((ref_cli.main, ["-T", "1", *args_out_ref]),
                        (cli.main, ["-T", "4", "--device", "cpu",
                                    *args_out_port])):
        if stdin is not None:
            monkeypatch.setattr(sys, "stdin",
                                type("In", (), {"buffer": io.BytesIO(stdin)}))
        _bounded(main, [*args_in, *extra])


def _decoded_by_both(monkeypatch, triplet_file, tag, keep_order=True):
    """The FASTQ each CLI's -d writes for ``triplet_file``."""
    d = os.path.dirname(triplet_file)
    ko = ["--keep-order"] if keep_order else []
    ref, port = (os.path.join(d, f"{tag}_{w}") for w in ("rd", "pd"))
    _both_clis(["-d", triplet_file, *ko], ["-o", ref], ["-o", port],
               monkeypatch=monkeypatch)
    return _read(ref + ".fastq"), _read(port + ".fastq")


def test_parts_round_trip(files, monkeypatch):
    """-B: the triplet rolls over into parts; decompress reads them all."""
    d, src = files["dir"], files["paths"]["single"][0]
    ref, port = os.path.join(d, "parts_ref"), os.path.join(d, "parts_port")
    _both_clis([src, *BARE, "-B", "60k"], ["-o", ref], ["-o", port])
    got = _triplet(port)
    assert got == _triplet(ref) and ".01.scalcen" in got
    ref_fq, port_fq = _decoded_by_both(monkeypatch, port + ".00.scalcen",
                                       "parts")
    assert port_fq == ref_fq == files["single"]


@pytest.mark.parametrize("keep_order", [True, False])
def test_template_names_round_trip(files, monkeypatch, keep_order):
    """-n lib: names are not stored; each block's template names start
    where the blocks before it end, on whichever worker finishes it."""
    d, src = files["dir"], files["paths"]["single"][0]
    ref, port = (os.path.join(d, f"names{int(keep_order)}_{w}")
                 for w in ("ref", "port"))
    _both_clis([src, *BARE, "-n", "lib"], ["-o", ref], ["-o", port])
    assert _triplet(port) == _triplet(ref)
    ref_fq, port_fq = _decoded_by_both(monkeypatch, port + ".00.scalcen",
                                       f"names{int(keep_order)}", keep_order)
    assert port_fq == ref_fq
    assert port_fq.count(b"@lib.") == READS
    assert (f"@lib.{READS}\n".encode() in port_fq)


def test_stdin_and_stdout(files, monkeypatch):
    """Compress from stdin (``-``), decompress to stdout (``-o -``)."""
    d = files["dir"]
    ref, port = os.path.join(d, "stdin_ref"), os.path.join(d, "stdin_port")
    _both_clis(["-", *BARE, "--max-read-len", "128"], ["-o", ref],
               ["-o", port], stdin=files["single"], monkeypatch=monkeypatch)
    assert _triplet(port) == _triplet(ref)
    got = {}
    for name, main, extra in (("ref", ref_cli.main, ["-T", "1"]),
                              ("port", cli.main,
                               ["-T", "4", "--device", "cpu"])):
        out = io.BytesIO()
        monkeypatch.setattr(sys, "stdout",
                            type("Out", (), {"buffer": out}))
        _bounded(main, ["-d", port + ".00.scalcen", "--keep-order", "-o",
                        "-", *extra])
        got[name] = out.getvalue()
    assert got["port"] == got["ref"] == files["single"]


def test_single_end_resume(files):
    """A crash tears every file's tail: resume at -T 4 keeps the durable
    blocks, encodes the rest, and writes the reference's triplet."""
    out = os.path.join(files["dir"], "resume")
    cfg = dict(inputs=files["paths"]["single"], output=out, threads=4,
               **SLICE)
    _bounded(driver.compress, Config(**cfg), "cpu")
    for ext in (".scalcen", ".scalcer", ".scalceq"):
        p = out + ".00" + ext
        with open(p, "rb") as f:
            data = f.read()
        with open(p, "wb") as f:
            f.write(data[:-50])
    stats = _bounded(driver.compress, Config(resume=True, **cfg), "cpu")
    assert 0 < stats.n_blocks < 9
    assert _triplet(out) == _reference(files, "device")


# ---------------------------------------------------------------------------
# failures: raised out of the driver, every thread stopped


def test_malformed_record_in_block_3_raises(tmp_path):
    lines = synth_fastq(6 * B, 100, seed=3).split(b"\n")
    lines[4 * (3 * B + 5) + 3] = lines[4 * (3 * B + 5) + 3][:40]
    src = os.path.join(tmp_path, "bad.fastq")
    with open(src, "wb") as f:
        f.write(b"\n".join(lines))
    before = threading.active_count()
    with pytest.raises(ValueError, match="malformed FASTQ"):
        _bounded(driver.compress, Config(inputs=(src,), output=os.path.join(
            tmp_path, "o"), threads=4, **SLICE), "cpu")
    _threads_back_to(before)


@pytest.mark.parametrize("threads_", [1, 4])
def test_failed_container_write_raises(files, monkeypatch, threads_):
    """An emit that raises (the first block's write, while the parse and
    upload threads wait on full queues) stops those threads and the
    assembly pool, though the exception that holds the driver's frames
    is still alive."""
    def failing(self, *a, **kw):
        raise OSError("disk full")
    monkeypatch.setattr(container.TripletWriter, "add_block", failing)
    before = threading.active_count()
    with pytest.raises(OSError, match="disk full"):
        _bounded(_compress, files, "device",
                 os.path.join(files["dir"], f"full{threads_}"), threads_)
    _threads_back_to(before)


def test_failed_output_write_raises(files, monkeypatch):
    """Decompress to an output whose writes fail: the writer thread's
    error raises out of decompress."""
    out = os.path.join(files["dir"], "wfail")
    _bounded(_compress, files, "device", out, 4)

    class Broken:
        def write(self, buf):
            raise OSError("broken pipe")

        def flush(self):
            pass
    monkeypatch.setattr(sys, "stdout", type("Out", (), {"buffer": Broken()}))
    before = threading.active_count()
    with pytest.raises(OSError, match="broken pipe"):
        _bounded(driver.decompress, Config(
            mode="decompress", inputs=(out + ".00.scalcen",), output="-",
            threads=4), "cpu")
    _threads_back_to(before)


def test_async_writer_error_surfaces_on_close():
    class Broken:
        def write(self, buf):
            raise OSError("no space")
    before = threading.active_count()
    writer = threads._AsyncWriter()
    writer.write(Broken(), b"x")
    with pytest.raises(OSError, match="no space"):
        _bounded(writer.close)
    _threads_back_to(before)


def test_prefetch_worker_stops_when_its_consumer_raises():
    def slow():
        for i in range(1000):
            time.sleep(0.005)
            yield i

    def consume():
        for i in threads._prefetch(slow(), depth=2):
            if i == 3:
                raise RuntimeError("consumer failed")
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="consumer failed"):
        _bounded(consume)
    _threads_back_to(before)
