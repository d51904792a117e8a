"""Run one cell of the benchmark of ``scalce_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root, on a machine with the cell's cards.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number the check compared
beside its limit; the same numbers end standard error.  Without the
cards the cell asks for, or with a module of JAX or of its package
loaded once the window has closed, it prints no result and exits
non-zero.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import cell as cell_mod
    from portbench import manifest
    c = manifest.cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < c.chips:
        print(f"[portbench] {args.workload} needs {c.chips} CUDA card(s), "
              f"this machine has {have}: no result", file=sys.stderr)
        return 2
    device = "cuda:0" if c.chips == 1 else "cuda"
    result = cell_mod.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), device, T_START)
    found = cell_mod.banned_modules()
    if found:
        print(f"[portbench] loaded modules it must not: {found}: no result",
              file=sys.stderr)
        return 3
    for name, chk in result["checks"].items():
        print(f"check {name} {chk['value']} limit {chk['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
