"""Time K8 (``csrc/compact.cu``) at other strip widths and ring depths.

    python -m scalce_tpu_torch.compact_sweep      # on a card, seconds

Rebuilds ``csrc/compact.cu`` with ``kStrip`` (lanes per CTA) in {64, 128}
and ``kStages`` (chunks in the ring) in {4, 6, 8}, each into its own
library under ``_build/``, checks each against
``compact_emissions_plain`` and times its launch with CUDA events at the
main block (T = 2048, N = 16384) and K5's group of 4 blocks (N = 65536),
on random int16 words with each cell emitting at ``--share`` (default
0.125, the share ``chip_smoke.py`` phase 3 reads from K3's and K5's
words on its synthetic file).  Beside them: the bytes'
bound at 3.35 TB/s, a device copy of the inputs (the card's streaming
rate) and the ``torch.sort`` of the reference's packed key.  Prints one
JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import tempfile

import torch

from scalce_tpu_torch.ops import _cuda, compact

STRIPS = (64, 128)
STAGES = (4, 6, 8)
SHAPES = ((2048, 16384), (2048, 65536))


def build_variants(tmp: str) -> dict:
    """``{(strip, stages): ctypes function}``, all built at once."""
    src = open(os.path.join(_cuda.CSRC, "compact.cu")).read()
    procs = {}
    for strip in STRIPS:
        for stages in STAGES:
            text = re.sub(r"kStrip = \d+;", f"kStrip = {strip};", src)
            text = re.sub(r"kStages = \d+;", f"kStages = {stages};", text)
            cu = os.path.join(tmp, f"compact_{strip}_{stages}.cu")
            with open(cu, "w") as f:
                f.write(text)
            so = cu[:-3] + ".so"
            procs[strip, stages] = (so, subprocess.Popen(
                [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-I{_cuda.CSRC}",
                 "-shared", "-o", so, cu], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    fns = {}
    for key, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        fn = ctypes.CDLL(so).scalce_compact
        fn.argtypes = _cuda._SIGNATURES["scalce_compact"]
        fns[key] = fn
    return fns


def time_ms(fn, iters: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sweep(share: float = 0.125, seed: int = 1) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("compact_sweep: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    out = {"card": card, "share": share, "shapes": []}
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as tmp:
        fns = build_variants(tmp)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for T, N in SHAPES:
            words = torch.randint(-32768, 32768, (T, N), dtype=torch.int16,
                                  device=dev, generator=gen)
            emits = torch.rand((T, N), device=dev, generator=gen) < share
            want = compact.compact_emissions_plain(words, emits)
            packed = torch.empty((N, T), dtype=torch.int16, device=dev)
            counts = torch.empty(N, dtype=torch.int32, device=dev)
            row = {"T": T, "N": N, "bytes": 5 * T * N,
                   "bound_ms": 5 * T * N / 3.35e9, "kernel_ms": {}}
            for (strip, stages), fn in fns.items():
                def launch(fn=fn):
                    err = fn(words.data_ptr(), emits.data_ptr(), T, N,
                             packed.data_ptr(), counts.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"scalce_compact: error {err}")
                packed.fill_(-1)
                launch()
                if not (torch.equal(packed, want[0])
                        and torch.equal(counts, want[1])):
                    raise AssertionError(f"strip {strip}, {stages} stages "
                                         f"!= plain at T={T}, N={N}")
                row["kernel_ms"][f"strip {strip}, {stages} stages"] = \
                    time_ms(launch)
            w2, e2 = torch.empty_like(words), torch.empty_like(emits)
            row["copy_inputs_ms"] = time_ms(
                lambda: (w2.copy_(words), e2.copy_(emits)))
            et = emits.T
            key = torch.where(et, torch.cumsum(et, 1, dtype=torch.int32) - 1,
                              T)
            packed_key = (key << 16) | (words.T.to(torch.int32) & 0xFFFF)
            row["sort_ms"] = time_ms(lambda: torch.sort(packed_key, dim=1),
                                     10)
            out["shapes"].append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--share", type=float, default=0.125,
                   help="each cell's chance to emit (default 0.125)")
    sweep(p.parse_args().share)
