"""The check's two readings for a cell, on several seeds in one process.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13

For each seed: the cell's input at its own size, then one round trip of
the program as the cell runs it (the sound reading), and one round trip
of the control: the same program with its lossy quality map switched on
(``-p``), the step below the lossless configuration that would tempt a
later change.  Each is judged as a run of the benchmark judges its
window (``cell.judge``); the last line of standard output is a JSON
object with both readings of each number compared, per seed.  The
benchmark's own runs never run this.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import cell as cell_mod  # noqa: E402
from portbench import manifest  # noqa: E402
from portbench.gen import traffic  # noqa: E402

#: the control's lossy map (percent): the smallest at which the map of
#: these qualities (Phred 2-40) merges values (v and v+1 merge once
#: pct/100 * v >= 1, that is from v = 34)
LOSSY_PCT = 3


def readings(cell_name: str, seeds, device: str, overrides=None):
    """Per seed ``{"seed", "sound": checks, "control": checks}``, each
    checks ``{"mismatched_records": n, "compress_not_on_device": n}``."""
    c = manifest.cell(cell_name)
    ov = dict(overrides or {})
    out = []
    tmp = tempfile.mkdtemp(prefix="portbench.control.")
    try:
        for seed in seeds:
            row = {"seed": seed}
            files = None
            for side, extra in (("sound", {}),
                                ("control", {"lossy_pct": LOSSY_PCT})):
                run_ov = {**ov, "compress": {**ov.get("compress", {}),
                                             **extra}}
                runner = cell_mod.Runner(c, tmp, device, run_ov)
                if files is None:
                    files = traffic.make_files(
                        c.traffic, seed, runner.paired,
                        ov.get("reads") or c.config["input_reads"])
                    runner.write_inputs(files)
                calls = cell_mod.Calls()
                runner.round_trip(calls, cell_mod._span_factory(False))
                row[side] = {"mismatched_records": cell_mod.judge(files,
                                                                  calls),
                             "compress_not_on_device": sum(
                                 p != "device" for p in calls.placements)}
            out.append(row)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    args = p.parse_args(argv)
    c = manifest.cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < c.chips:
        print(f"[portbench] {args.workload} needs {c.chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                    "cuda:0" if c.chips == 1 else "cuda")
    for r in rows:
        print(json.dumps(r), file=sys.stderr)
    print(json.dumps({"workload": args.workload, "lossy_pct": LOSSY_PCT,
                      "kind": torch.cuda.get_device_name(0),
                      "seconds": time.monotonic() - T_START,
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
