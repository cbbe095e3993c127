"""The readings that the limits of ``benchmarks/limits/<cell>.json`` are set
from: the program's numbers over many seeds (the lower readings) and the
control's (the upper ones), in one process.

    python3 benchmarks/control.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--seconds 3]

Each program seed is a run of the cell as the benchmark makes it, with a
short window.  Each control seed is the same run with the program's
answers replaced by the control's: the reference put in the program's
place and computed in bfloat16, the precision below the configuration's
float32 (``benchmarks/harness/check.control_answers``).  The benchmark's
own runs never run the control; ``benchmarks/tests/test_bench_control.py``
runs it at the cells' small sizes on the CPU.  Prints one JSON line per
run and, last, the largest program reading and the smallest control
reading (of the window's frames) of each number, beside the cell's limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seeds, seconds, device, control_dtype):
    from benchmarks.run import run_cell

    out = []
    for seed in seeds:
        result = run_cell(cell, seed, seconds, False, device, time.monotonic(),
                          control_dtype=control_dtype)
        numbers = {k: v["value"] for k, v in result["check"].items()}
        print(json.dumps({"seed": seed, "control": control_dtype is not None,
                          "correct": result["correct"], "numbers": numbers}), flush=True)
        out.append(numbers)
    return out


def by_kind(runs, pick, window_only=False):
    """``pick`` over each kind of number (the name before the dot); with
    ``window_only`` over the window's frames alone (the first frame of a
    load that starts at zero is all zeros, on both sides)."""
    kinds = {}
    for numbers in runs:
        for name, value in numbers.items():
            kind, frame = name.split(".")
            if not (window_only and frame == "start"):
                kinds.setdefault(kind, []).append(value)
    return {k: pick(v) for k, v in kinds.items()}


def main(argv=None) -> int:
    from benchmarks.harness.cells import resolve

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    cell = resolve(args.workload)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    program = readings(cell, seeds(args.seeds), args.seconds, device, None)
    control = readings(cell, seeds(args.control_seeds), args.seconds, device,
                       torch.bfloat16)
    lower = by_kind(program, max) if program else {}
    upper = by_kind(control, min, window_only=True) if control else {}
    print(json.dumps({"workload": cell.name, "lower": lower, "upper": upper,
                      "limits": {k: cell.limits[k] for k in lower | upper}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
