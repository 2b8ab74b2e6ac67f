#!/usr/bin/env python3
"""The numbers a cell's check compares, over many seeds in one process, for
the program or for the cell's control, at the cell's own sizes and load:

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 3 \
        [--control 1 | --fault <name>]

Prints one JSON line a seed: {"seed", "control", "fault", "units",
"checks": {name: value}, "notes": the driver's diagnostics}. The limits in
workloads/<cell>.json are set from these readings (PERF.md gives them); the
runs of run.py never call this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402  (portbench/run.py: its environment and paths)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", default=3.0, type=float)
    p.add_argument("--control", default=0, type=int, choices=(0, 1))
    p.add_argument("--fault", default=None,
                   help="a fault planted in the program (the drivers name theirs)")
    args = p.parse_args(argv)
    run.environment()
    import torch

    from portbench.harness import cell

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        notes = {}
        result, rows = cell.run(args.workload, seed, args.seconds, False, time.perf_counter(),
                                control=bool(args.control), fault=args.fault, notes=notes)
        print(json.dumps({"seed": seed, "control": args.control, "fault": args.fault,
                          "units": result["attempted"], "checks": {k: v for k, v, _ in rows},
                          "notes": notes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
