"""Where the time goes: the walls and peak device memory of one compress
and one keep-order decompress through the port's drivers at ``-T 1``,
``-T 4`` and Config's default threads, and the device's busy share
under ``torch.profiler`` at ``-T 1`` and ``-T 4``, for a single-end file, a pair (``-r``), the single-end
file lossy (``-p 30``), the single-end file through
``--data-parallel`` (one group per block on one card), the single-end
file under the bare command's host qualities with the device, host
delta and host core placements, and its keep-order decompress with
``--delta-device``; and the
data-parallel pass B's two functions, ``qualities.group_histogram`` and
``qualities.group_encode``, each timed whole (what builds its kernel's
inputs included) on a group of 4 blocks and of 1.

    python -m scalce_tpu_torch.stage_profile     # repo root, on the card
    python -m scalce_tpu_torch.stage_profile --dp-cards   # on 4 cards

The inputs are ``chip_smoke.py``'s (phases 4, 7 and 8): the main file
(1,148,576 x 100 bp, ``synth_fastq(seed=42, genome_len=1_000_000,
n_rate=0.001)``) and a pair of such files (``synth_pair``, same
parameters), under the slice's Config (``threads=1``); :func:`profile`
also takes fewer reads and the CPU.  Runs, per case and in order: a
warm-up (first-use costs: library load, CUDA context); an untimed run
whose wall clock is the end-to-end number, then one at ``-T 4`` and one
at the default; on CUDA, a run under ``torch.profiler`` at ``-T 1`` and
one at ``-T 4``, whose device events give the busy time (the union of
their intervals) and the device time per kernel and per kind of copy
(to or from pageable or page-locked host memory).  Each decompress must
give the input bytes back (lossy: the names and sequences, and
qualities of the input's lengths).  The last line of the output is one
JSON object with every number printed.  To time a parent checkout, run
that checkout's own copy of the script from its root, in the same call.
``--dp-cards`` times the ``--data-parallel`` compress at ``-T 4`` over
every visible card against one card (:func:`dp_cards`).
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch

from scalce_tpu_torch.config import Config
from scalce_tpu_torch.utils.synth import synth_fastq, synth_pair
from scalce_tpu_torch.device import resolve_device
from scalce_tpu_torch.pipeline import driver

#: the port's hand-written kernels, by their CUDA function names (K7:
#: its match and literal-placement kernels)
PORT_KERNELS = {"K1": "core_rank_kernel", "K2": "hist_ctx_kernel",
                "K3": "rans_encode_kernel", "K4": "rans_decode_kernel",
                "K5": "rans_encode_flat_kernel", "K6": "histogram_kernel",
                "K7": "delta_seq_", "K8": "compact_kernel"}

#: the slice's configuration (chip_smoke.py's SLICE)
SLICE = dict(block_reads=1 << 18, max_read_len=128, qual_T_target=2048,
             core_on_device=True, delta_on_device=True, qual_on_device=True,
             qual_context_order=1, dict_mode="hash", backend="gz", threads=1)

#: the bare command's quality placement (host codec, per-block order)
_BARE = {"qual_on_device": False, "qual_context_order": 0}
#: the profiled cases: Config fields on top of SLICE (``decompress``: the
#: decompress Config's)
CASES = {"single": {}, "paired": {"paired": True}, "lossy": {"lossy_pct": 30},
         "dp": {"data_parallel": True}, "bare": _BARE,
         "host delta": {**_BARE, "delta_on_device": False},
         "host core": {**_BARE, "delta_on_device": False,
                       "core_on_device": False},
         "delta device": {"decompress": {"delta_on_device": True}}}


def _check(got: bytes, want: bytes, lossy: bool) -> None:
    """A keep-order decompress against its input: equal bytes, or under
    ``lossy`` equal names, sequences and '+' lines, and qualities of the
    input's lengths."""
    if not lossy:
        ok = got == want
    else:
        g, w = got.split(b"\n"), want.split(b"\n")
        ok = len(g) == len(w) and all(
            a == b if i % 4 != 3 else len(a) == len(b)
            for i, (a, b) in enumerate(zip(g, w)))
    if not ok:
        raise AssertionError("keep-order decompress != input")


def _run(tmp: str, case: str, srcs: Sequence[str], datas: Sequence[bytes],
         block_reads: int, device,
         threads: Optional[int] = 1) -> Dict[str, Dict]:
    """One compress and one keep-order decompress of ``case`` on
    ``threads`` workers (None: Config's default): each one's wall seconds
    and, on CUDA, its peak device memory."""
    extra = dict(CASES[case])
    dextra = extra.pop("decompress", {})
    out = os.path.join(tmp, case.replace(" ", "_"))
    dec = out + "_d"
    first = ".00_1.scalcen" if extra.get("paired") else ".00.scalcen"
    t = {} if threads is None else {"threads": threads}
    base = {k: v for k, v in SLICE.items() if k != "threads"}
    cfgs = {"compress": Config(inputs=tuple(srcs), output=out,
                               **{**base, "block_reads": block_reads, **t,
                                  **extra}),
            "decompress": Config(mode="decompress", inputs=(out + first,),
                                 output=dec, keep_order=True,
                                 qual_on_device=True, **t, **dextra)}
    result = {}
    for name, cfg in cfgs.items():
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        getattr(driver, name)(cfg, device)
        wall = time.perf_counter() - t0
        result[name] = {"wall_s": wall, "threads": cfg.threads}
        if device.type == "cuda":
            result[name]["peak_bytes"] = torch.cuda.max_memory_allocated(
                device)
    paths = [f"{dec}_{m}.fastq" for m in (1, 2)] if extra.get("paired") \
        else [dec + ".fastq"]
    for path, data in zip(paths, datas):
        with open(path, "rb") as fh:
            _check(fh.read(), data, bool(extra.get("lossy_pct")))
    return result


def _union_s(spans: List[tuple]) -> float:
    """Total length in seconds of the union of (start_us, end_us) spans."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def _kind(name: str) -> str:
    """Device event -> one of K1-K8, ``pageable copies`` (to or from
    pageable host memory), ``pinned copies`` (page-locked), ``other
    copies`` (device to device, memsets) or ``torch kernels``."""
    for k, fn in PORT_KERNELS.items():
        if fn in name:
            return k
    if name.startswith(("Memcpy", "Memset")):
        return "pageable copies" if "Pageable" in name else \
            "pinned copies" if "Pinned" in name else "other copies"
    return "torch kernels"


def device_busy(fn) -> Optional[Dict]:
    """Run ``fn()`` under ``torch.profiler``: its wall seconds, the
    device's busy seconds (the union of the device events' intervals),
    and device seconds by kind and by event name (the 12 largest, names
    cut to 80 characters); None if no device event was recorded."""
    from torch import profiler
    activities = [profiler.ProfilerActivity.CPU,
                  profiler.ProfilerActivity.CUDA]
    with profiler.profile(activities=activities, acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    spans, per_name, per_kind = [], {}, {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        spans.append((s, e))
        name, kind = ev.name[:80], _kind(ev.name)
        per_name[name] = per_name.get(name, 0.0) + (e - s) / 1e6
        per_kind[kind] = per_kind.get(kind, 0.0) + (e - s) / 1e6
    if not spans:
        return None
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_s": wall, "busy_s": _union_s(spans),
            "device_events": len(spans), "by_kind_s": per_kind,
            "top_device_s": dict(top)}


def _profiled(tmp, case, srcs, datas, block_reads, device,
              threads: int = 1) -> Optional[Dict]:
    """:func:`device_busy` of one compress + decompress of ``case``."""
    return device_busy(lambda: _run(tmp, case, srcs, datas, block_reads,
                                    device, threads=threads))


def dp_functions(path: str, device, iters: int = 10) -> Dict[str, float]:
    """ms per call of ``qualities.group_histogram`` and
    ``qualities.group_encode`` (CUDA events, ``iters`` calls after a
    warm-up) on the grids that ``mesh.stage1`` leaves for the first 4
    blocks of ``path`` and for its first block, under the slice's
    Config."""
    from scalce_tpu_torch.io import fastq
    from scalce_tpu_torch.parallel import mesh
    from scalce_tpu_torch.streams import qualities
    cfg = Config(inputs=(path,), **SLICE)
    blocks = fastq.iter_blocks(path, cfg.block_reads, cfg.max_read_len)
    group = [next(blocks) for _ in range(4)]
    blocks.close()
    B, L = group[0].seq.shape
    T = qualities.pick_T(B, L, cfg.qual_T_target)
    order = cfg.qual_context_order

    def ms(fn):
        fn()
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters

    out = {}
    for tag, share in (("4 blocks", group), ("1 block", group[:1])):
        _, _, _, sym, ctx, counts = mesh.stage1(
            mesh.upload_blocks(share, device), [b.n_reads for b in share],
            cfg.core_k, cfg.dict_seed, order)
        out[f"group_histogram, {tag}"] = ms(
            lambda: qualities.group_histogram(sym, ctx, order))
        out[f"group_encode, {tag}"] = ms(
            lambda: qualities.group_encode(sym, ctx, counts, T, order))
        del sym, ctx, counts
    return out


def dp_cards(reads: int = 1_148_576, turns: int = 2) -> Dict:
    """The ``--data-parallel`` compress of the main file (as
    :func:`profile` makes it) at ``-T 4`` over every visible card and
    over ``cuda:0`` alone, in turns (all, one, one, all, ...): each
    run's wall seconds; every triplet must equal the first."""
    card = "; ".join(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines())
    n = torch.cuda.device_count()
    walls: Dict[str, List[float]] = {"cuda": [], "cuda:0": []}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "main.fastq")
        with open(src, "wb") as fh:
            fh.write(synth_fastq(reads, 100, seed=42, genome_len=1_000_000,
                                 n_rate=0.001))
        want = None
        order = ["cuda", "cuda:0", "cuda:0", "cuda"] * turns
        for i, dev in enumerate(["cuda:0"] + order):     # first: warm-up
            out = os.path.join(tmp, f"dp{i}")
            t0 = time.perf_counter()
            driver.compress(Config(inputs=(src,), output=out,
                                   data_parallel=True,
                                   **{**SLICE, "threads": 4}), dev)
            for d in range(n):
                torch.cuda.synchronize(d)
            wall = time.perf_counter() - t0
            got = [open(p, "rb").read() for p in
                   sorted(glob.glob(out + ".*.scalce[nrq]"))]
            want = want or got
            if got != want:
                raise AssertionError(f"--data-parallel on {dev}: triplet "
                                     f"differs")
            if i:
                walls[dev].append(wall)
    for dev, ws in walls.items():
        cards = n if dev == "cuda" else 1
        print(f"--data-parallel -T 4 compress on {dev} ({cards} card(s)): "
              + ", ".join(f"{w:.3f}" for w in ws) + f" s ({card} x {n})")
    result = {"device": card, "cards": n, "reads": reads, "walls_s": walls}
    print(json.dumps(result))
    return result


def _report(case: str, res: Dict, card: str) -> None:
    """Print one case's walls and device busy share."""
    mb = res["input_bytes"] / 1e6
    for name in ("compress", "decompress"):
        walls = []
        for key in ("untimed", "untimed_T4", "untimed_Tdef"):
            r = res[key][name]
            peak = f", peak {r['peak_bytes'] / 2**30:.3f} GiB" \
                if "peak_bytes" in r else ""
            walls.append(f"-T {r['threads']} {r['wall_s']:.3f} s = "
                         f"{mb / r['wall_s']:.2f} MB/s{peak}")
        print(f"{case} {name}: {'; '.join(walls)} ({card})")
    for key, T in (("profiled", "untimed"), ("profiled_T4", "untimed_T4")):
        prof = res.get(key)
        if prof is not None:
            busy = prof["busy_s"]
            untimed = sum(r["wall_s"] for r in res[T].values())
            print(f"{case} {key} run {prof['wall_s']:.3f} s: device busy "
                  f"{busy:.4f} s = {100 * busy / prof['wall_s']:.1f}% of "
                  f"the profiled wall, {100 * busy / untimed:.1f}% of the "
                  f"untimed run's {untimed:.3f} s ({prof['device_events']} "
                  f"device events)")
            for name, s in sorted(prof["by_kind_s"].items()):
                print(f"    {s:8.4f} s  {name}")
            print("  largest device events:")
            for name, s in prof["top_device_s"].items():
                print(f"    {s:8.4f} s  {name}")
        elif key in res:
            print(f"{case} {key} run: no device events recorded (busy "
                  f"share not measured)")


def profile(device="cuda", reads: int = 1_148_576,
            block_reads: int = SLICE["block_reads"]) -> Dict:
    """Run the runs above for each case, print the walls and device
    time, return the numbers."""
    device = resolve_device(device)
    card = "cpu"
    if device.type == "cuda":       # name and power limit
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index}"],
            capture_output=True, text=True, check=True).stdout.strip()

    result = {"device": card, "reads": reads, "block_reads": block_reads,
              "cases": {}}
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(seed=42, genome_len=1_000_000, n_rate=0.001)
        files = {"main": [synth_fastq(reads, 100, **kw)],
                 "pair": list(synth_pair(reads, 100, **kw))}
        paths = {}
        for key, datas in files.items():
            paths[key] = [os.path.join(tmp, f"{key}{i}.fastq")
                          for i in range(len(datas))]
            for path, data in zip(paths[key], datas):
                with open(path, "wb") as fh:
                    fh.write(data)
        for case, extra in CASES.items():
            key = "pair" if extra.get("paired") else "main"
            args = (tmp, case, paths[key], files[key], block_reads, device)
            res = {"input_bytes": sum(map(len, files[key]))}
            _run(*args)                                       # warm-up
            res["untimed"] = _run(*args)
            res["untimed_T4"] = _run(*args, threads=4)
            res["untimed_Tdef"] = _run(*args, threads=None)
            if device.type == "cuda":
                res["profiled"] = _profiled(*args)
                res["profiled_T4"] = _profiled(*args, threads=4)
            result["cases"][case] = res
            _report(case, res, card)
        if device.type == "cuda":
            result["dp_functions_ms"] = dp_functions(paths["main"][0],
                                                     device)
            for name, t in result["dp_functions_ms"].items():
                print(f"{name}: {t:.3f} ms per call ({card})")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    import sys
    if sys.argv[1:] == ["--dp-cards"]:
        dp_cards()
    else:
        profile()
