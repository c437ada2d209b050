"""Readings for the limits: the port's checked numbers and the control's.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Runs the cell once per seed in one process (a short window at the cell's
own load) and prints one JSON line per seed: the numbers the check
compares for the port (``numbers``) and for the control (``control``): the
reference itself, computed with TF32 on, in the port's place. The limits in
``limits/<cell>.json`` lie between the largest of the port's readings over
a dozen seeds and the smallest of the control's. A CUDA card only.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["USE_FLAX"] = "0"


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--faults", action="store_true",
                   help="also the numbers of the planted faults (bench.faults)")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    from portbench import bench

    for seed in args.seeds:
        res = bench.run_cell(args.workload, seed, args.seconds, False,
                             with_control=not args.no_control, with_faults=args.faults)
        line = {"seed": seed, "correct": res["correct"],
                "numbers": {k: c["value"] for k, c in res["checks"].items()},
                "control": res.get("control"), "faults": res.get("faults"),
                "metrics": res["metrics"],
                "memory_peak_bytes": res["device"]["memory_peak_bytes"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
