"""One run of one cell: set-up, the measured window, the check.

Set-up (``setup_s``, from the process's start): the card, the program's
libraries, the cell's input made from the seed and written once under
``TMPDIR``, and a warm-up round trip of the whole input under the cell's
own Config, which also runs AUTO's link probe.

The window: a closed loop of round trips, one user compressing a file
and then decompressing it, until ``seconds`` have passed.  A round trip
is ``driver.compress`` from the FASTQ file into a triplet under
``TMPDIR`` and ``driver.decompress`` of that triplet into a file (a
pair's two files) whose path links to an anonymous file in memory, so
no decompressed FASTQ reaches the disk.  Each call's wall runs from the
call to its return with every card of the cell synchronized.  With ``trace`` the
window runs under the program's own profiler (``timing.profile``, which
also turns on its host spans), and the harness adds a span around the
window and around each call.

The check, once the window has closed: every decompress's output is
either byte for byte one that is judged, or is judged itself against the
plain reference (``reference/records.py``): the input's records as a
multiset, pairs as pairs.  Besides, every compress must have run its
cores on the device (``RunStats.placement``), and on a cell of several
chips every card must have had memory allocated on it in the window.

Beside the walls and both of the window's rates (also where the cell
reports a rate only per layer), standard error gives each call's CPU
seconds (all the process's threads) and, over the window, the process's
CPU seconds, the garbage collector's, and the seconds a fixed piece of
work on one thread takes once the window has closed.  They witness where a slow run's time
went (CPU seconds that rise with the walls: the host ran the same work
slower; that stay: the process waited), and no metric reads them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import glob
import hashlib
import os
import resource
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional

from portbench import layers, manifest
from portbench import trace as tr
from portbench.gen import traffic
from portbench.reference import records as ref

#: top-level modules no run may load (the JAX package is the port's
#: reference, and is never measured)
BANNED = ("jax", "jaxlib", "flax", "scalce_tpu")
#: Config fields that are not the command's: the harness sets them
_IO_FIELDS = ("inputs", "output", "mode")


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is banned, compared whole."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(BANNED))


class _MemFile:
    """An output file that lives in memory: ``path`` (where the program
    opens its output) is a link to an anonymous in-memory file
    (``memfd_create``), so a decompress writes its FASTQ as to a file,
    through the kernel, and nothing reaches the disk."""

    def __init__(self, path: str):
        self.fd = os.memfd_create("portbench-output", os.MFD_CLOEXEC)
        if os.path.lexists(path):
            os.remove(path)
        os.symlink(f"/proc/self/fd/{self.fd}", path)

    def close(self) -> bytes:
        """The bytes written, and the file's memory freed."""
        try:
            size = os.fstat(self.fd).st_size
            parts, off = [], 0
            while off < size:
                parts.append(os.pread(self.fd, min(size - off, 1 << 30),
                                      off))
                off += len(parts[-1])
            return b"".join(parts)
        finally:
            os.close(self.fd)


@dataclasses.dataclass
class Calls:
    """The window's calls: walls, bytes, and what the check needs."""
    compress_s: List[float] = dataclasses.field(default_factory=list)
    decompress_s: List[float] = dataclasses.field(default_factory=list)
    #: the process's CPU seconds (every thread) over each call's wall
    compress_cpu_s: List[float] = dataclasses.field(default_factory=list)
    decompress_cpu_s: List[float] = dataclasses.field(default_factory=list)
    input_bytes: List[int] = dataclasses.field(default_factory=list)
    triplet_bytes: List[int] = dataclasses.field(default_factory=list)
    output_bytes: List[int] = dataclasses.field(default_factory=list)
    placements: List[str] = dataclasses.field(default_factory=list)
    compress_blocks: List[int] = dataclasses.field(default_factory=list)
    decompress_blocks: List[int] = dataclasses.field(default_factory=list)
    #: the outputs that differ from every earlier one, each as bytes per
    #: mate, with the calls that gave it
    outputs: List[List[bytes]] = dataclasses.field(default_factory=list)
    output_calls: List[int] = dataclasses.field(default_factory=list)
    stream_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    errors: List[str] = dataclasses.field(default_factory=list)


class Runner:
    """The cell's Configs, files and devices, and one round trip."""

    def __init__(self, cell: manifest.Cell, tmp: str, device: str,
                 overrides: Optional[Dict] = None):
        import torch
        from scalce_tpu_torch.config import Config
        self.torch = torch
        self.device = device
        conf = cell.config
        self.paired = bool(conf["compress"].get("paired", False))
        ov = overrides or {}
        fields = {**conf["compress"], **ov.get("compress", {})}
        dfields = {**conf["decompress"], **ov.get("decompress", {})}
        for f in _IO_FIELDS:
            if f in fields or f in dfields:
                raise ValueError(f"config sets {f!r}, which the harness "
                                 "sets")
        mates = ("_1", "_2") if self.paired else ("",)
        self.inputs = tuple(os.path.join(tmp, f"in{m}.fastq") for m in mates)
        self.prefix = os.path.join(tmp, "out")
        first = ".00_1.scalcen" if self.paired else ".00.scalcen"
        self.ccfg = Config(mode="compress", inputs=self.inputs,
                           output=self.prefix, **fields)
        self.dcfg = Config(mode="decompress", inputs=(self.prefix + first,),
                           output=os.path.join(tmp, "dec"), **dfields)
        self.outputs = [os.path.join(tmp, f"dec{m}.fastq") for m in mates]
        if torch.device(device).type == "cuda":
            idx = torch.device(device).index
            self.cards = [torch.device("cuda", i) for i in (
                range(cell.chips) if idx is None else [idx])]
        else:
            self.cards = []

    def sync(self) -> None:
        for d in self.cards:
            self.torch.cuda.synchronize(d)

    def open_cards(self) -> None:
        """Each card's CUDA context, and the program's kernel library
        (built once a checkout)."""
        from scalce_tpu_torch.ops import _cuda
        if self.cards:
            for d in self.cards:
                self.torch.zeros(1, device=d)
            _cuda.library()

    def reset_peaks(self) -> None:
        for d in self.cards:
            self.torch.cuda.reset_peak_memory_stats(d)

    def allocations(self) -> List[int]:
        """Per card, the allocations asked of it so far (a count that
        only grows: a card that the window gives no work keeps it)."""
        return [self.torch.cuda.memory_stats(d).get(
            "allocation.all.allocated", 0) for d in self.cards]

    def kind(self) -> str:
        return (self.torch.cuda.get_device_name(self.cards[0])
                if self.cards else "cpu")

    def write_inputs(self, files: List[List[bytes]]) -> None:
        """Each mate's file from its chunks."""
        for path, chunks in zip(self.inputs, files):
            with open(path, "wb") as f:
                for c in chunks:
                    f.write(c)

    def _clear_triplet(self) -> None:
        for p in glob.glob(self.prefix + ".*"):
            os.remove(p)

    def compress(self, span: Callable):
        from scalce_tpu_torch.pipeline import driver
        self._clear_triplet()
        with span("portbench.compress"):
            c0, t0 = time.process_time(), time.perf_counter()
            stats = driver.compress(self.ccfg, self.device)
            self.sync()
            wall = time.perf_counter() - t0
            cpu = time.process_time() - c0
        triplet = sum(os.path.getsize(p)
                      for p in glob.glob(self.prefix + ".*"))
        return wall, cpu, stats, triplet

    def decompress(self, span: Callable):
        from scalce_tpu_torch.pipeline import driver
        sinks = [_MemFile(p) for p in self.outputs]
        try:
            with span("portbench.decompress"):
                c0, t0 = time.process_time(), time.perf_counter()
                stats = driver.decompress(self.dcfg, self.device)
                self.sync()
                wall = time.perf_counter() - t0
                cpu = time.process_time() - c0
        finally:
            outs = [s.close() for s in sinks]
        return wall, cpu, stats, outs

    def round_trip(self, calls: Calls, span: Callable) -> None:
        calls.attempted += 1
        wall, cpu, stats, triplet = self.compress(span)
        calls.compress_s.append(wall)
        calls.compress_cpu_s.append(cpu)
        calls.input_bytes.append(sum(os.path.getsize(p)
                                     for p in self.inputs))
        calls.triplet_bytes.append(triplet)
        calls.placements.append(stats.placement)
        calls.compress_blocks.append(stats.n_blocks)
        calls.stream_bytes = dict(stats.stream_bytes)
        calls.attempted += 1
        wall, cpu, stats, outs = self.decompress(span)
        calls.decompress_s.append(wall)
        calls.decompress_cpu_s.append(cpu)
        calls.output_bytes.append(sum(len(o) for o in outs))
        calls.decompress_blocks.append(stats.n_blocks)
        if outs not in calls.outputs:
            calls.outputs.append(outs)
        calls.output_calls.append(calls.outputs.index(outs))

    def peak_bytes(self) -> List[int]:
        return [self.torch.cuda.max_memory_allocated(d) for d in self.cards]


def _span_factory(on: bool):
    if not on:
        return lambda name: contextlib.nullcontext()
    import torch
    return torch.profiler.record_function


def _trace_metrics(cell, calls: Calls, path: str, window_s: float,
                   counts: Dict[str, int], chips: int):
    """The per-layer metrics, the device's busy seconds and the
    breakdown from the traced window's Chrome trace."""
    t = tr.load(path)
    (win,) = [(s.start, s.end) for s in t.named("portbench.window")]
    windows = {side: [(s.start, s.end) for s in t.named("portbench." + side)]
               for side in layers.SIDES}
    ctx = layers.Context(
        trace=t, windows=windows,
        calls={"compress": len(calls.compress_s),
               "decompress": len(calls.decompress_s)},
        blocks={"compress": sum(calls.compress_blocks),
                "decompress": sum(calls.decompress_blocks)},
        counts=counts, stream_bytes=calls.stream_bytes,
        nbytes={"compress": sum(calls.input_bytes),
                "decompress": sum(calls.output_bytes)})
    metrics = {}
    for m in cell.per_layer:
        value = manifest.load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    busy = tr.busy_by_device(t.device, [win])
    device = {"busy_s": sum(busy.values()) / 1e6 / chips,
              "window_s": window_s}
    breakdown = {"device_ops": tr.top_device_ops(t.device, win),
                 "idle_gaps": tr.idle_gaps(t, win)}
    return metrics, device, breakdown


def judge(input_files: List[List[bytes]], calls: Calls) -> int:
    """Each distinct output against the reference: the records it lacks
    or adds, summed over the calls that gave it (each such call counts
    as failed)."""
    want = ref.records([b"".join(chunks) for chunks in input_files])
    wrong = 0
    for i, outs in enumerate(calls.outputs):
        try:
            bad = ref.mismatched(want, ref.records(outs))
        except ValueError as e:
            print(f"[portbench] output {i} is not FASTQ: {e}",
                  file=sys.stderr)
            bad = len(want) + 1
        uses = calls.output_calls.count(i)
        wrong += bad * uses
        if bad:
            calls.failed += uses
    return wrong


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: str, t_start: float,
        overrides: Optional[Dict] = None) -> Dict:
    """One run of the cell; returns the result line's object (the
    program's faults make ``correct`` false, they do not raise)."""
    cell = manifest.cell(cell_name)
    tmp = tempfile.mkdtemp(prefix="portbench.")
    try:
        return _run(cell, seed, seconds, trace, device, t_start,
                    overrides or {}, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(cell, seed, seconds, trace, device, t_start, overrides, tmp):
    from scalce_tpu_torch import timing
    runner = Runner(cell, tmp, device, overrides)
    runner.open_cards()
    _note("libraries", t_start)
    t = time.monotonic()
    files = traffic.make_files(cell.traffic, seed, runner.paired,
                               overrides.get("reads")
                               or cell.config["input_reads"])
    t = _note("input made", t)
    runner.write_inputs(files)
    # warm-up: one whole round trip, so that the window's first calls
    # find every buffer, pool and page that the later ones do
    warm = Calls()
    runner.round_trip(warm, _span_factory(False))
    written = sum(warm.input_bytes) + sum(warm.triplet_bytes)
    _note("input written and warm-up", t)
    runner.sync()
    runner.reset_peaks()
    # the input's pages reach the disk now, not in the window (a
    # triplet is deleted at the next compress, a few seconds after its
    # write, so the window writes back nothing of the set-up's)
    os.sync()
    setup_s = time.monotonic() - t_start

    calls = Calls()
    trace_dir = os.path.join(tmp, "trace")
    span = _span_factory(trace)
    allocs = runner.allocations()
    host = _Host()
    with timing.profile(trace_dir if trace else None, device):
        with span("portbench.window"):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                try:
                    runner.round_trip(calls, span)
                except Exception:               # the program's fault
                    calls.failed += 1
                    calls.errors.append(traceback.format_exc())
                    break
            window_s = time.perf_counter() - t0
    host.close()
    idle_cards = sum(a == b for a, b in zip(runner.allocations(), allocs))
    t = _note(f"window ({calls.attempted} calls)", time.monotonic()
              - window_s)
    for what, vals in (("walls", (calls.compress_s, calls.decompress_s)),
                       ("cpu", (calls.compress_cpu_s,
                                calls.decompress_cpu_s))):
        print(f"[portbench] {what}, s: compress "
              + " ".join(f"{w:.3f}" for w in vals[0]) + "; decompress "
              + " ".join(f"{w:.3f}" for w in vals[1]), file=sys.stderr)
    print(f"[portbench] rates, MB/s: compress "
          f"{_rate(calls.input_bytes, calls.compress_s)} decompress "
          f"{_rate(calls.output_bytes, calls.decompress_s)}", file=sys.stderr)
    print(f"[portbench] host: {host.report()}", file=sys.stderr)
    peaks = runner.peak_bytes()
    written += sum(calls.triplet_bytes) + sum(
        os.path.getsize(p) for p in glob.glob(os.path.join(trace_dir, "*")))
    print(f"[portbench] wrote {written} bytes to files", file=sys.stderr)
    wrong = judge(files, calls)
    metrics = {}
    if not trace:
        values = {
            "compress_MBps": _rate(calls.input_bytes, calls.compress_s),
            "decompress_MBps": _rate(calls.output_bytes, calls.decompress_s),
            "ratio": (sum(calls.input_bytes) / sum(calls.triplet_bytes)
                      if sum(calls.triplet_bytes) else None),
            "setup_s": setup_s}
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if runner.cards else "cpu",
           "kind": runner.kind(),
           "count": len(runner.cards),
           "memory_peak_bytes": max(peaks) if peaks else 0}
    t = _note("judged", t)
    breakdown = None
    if trace and calls.compress_s:
        (path,) = glob.glob(os.path.join(trace_dir, "*.json"))
        counts = layers.input_counts([b"".join(f) for f in files],
                                     runner.ccfg.core_k)
        metrics, extra, breakdown = _trace_metrics(
            cell, calls, path, window_s, counts, max(1, len(runner.cards)))
        dev.update(extra)
        _note("trace read", t)
    # each a count that must not pass its limit
    checks = {
        "mismatched_records": [wrong, 0],
        "compress_not_on_device": [sum(p != "device"
                                       for p in calls.placements), 0],
        "calls_raised": [len(calls.errors), 0],
        "window_without_round_trip": [int(not calls.decompress_s), 0],
    }
    if len(runner.cards) > 1:
        checks["cards_without_work"] = [idle_cards, 0]
    for e in calls.errors:
        print(e, file=sys.stderr)
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": calls.attempted, "failed": calls.failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


class _Host:
    """What the host did from its making to ``close``: the process's
    CPU seconds and garbage collection."""

    def __init__(self):
        self.gc_s = 0.0
        self._gc_t0 = 0.0
        gc.callbacks.append(self._gc)
        self.t0, self.ru0 = time.perf_counter(), resource.getrusage(
            resource.RUSAGE_SELF)

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._gc_t0

    def close(self) -> None:
        gc.callbacks.remove(self._gc)
        self.t1, self.ru1 = time.perf_counter(), resource.getrusage(
            resource.RUSAGE_SELF)
        # a fixed piece of work on one thread, timed: the host's speed
        t = time.perf_counter()
        hashlib.sha256(bytes(64 << 20)).digest()
        self.probe_s = time.perf_counter() - t

    def report(self) -> str:
        wall = self.t1 - self.t0
        own = (self.ru1.ru_utime - self.ru0.ru_utime
               + self.ru1.ru_stime - self.ru0.ru_stime)
        return (f"window {wall:.3f} s; process cpu {own:.3f} s "
                f"(user {self.ru1.ru_utime - self.ru0.ru_utime:.3f}), "
                f"gc {self.gc_s:.3f} s; fixed work {self.probe_s:.4f} s")


def _note(what: str, since: float) -> float:
    now = time.monotonic()
    print(f"[portbench] {what}: {now - since:.3f} s", file=sys.stderr)
    return now


def _rate(nbytes: List[int], walls: List[float]) -> Optional[float]:
    return sum(nbytes) / sum(walls) / 1e6 if walls and sum(walls) else None
