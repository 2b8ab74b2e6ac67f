#!/usr/bin/env python3
"""Run one cell of the benchmark of motionstyle_torch once, on the card(s)
of this machine:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device; with --trace 1 also breakdown; last, the numbers
compared with the plain reference beside their limits), and the last lines
of standard error are those numbers again. With --trace 0 the metrics are
the cell's end-to-end metrics, with --trace 1 its per-layer metrics.

Exits non-zero without a result when the machine has fewer CUDA devices
than the cell asks for, and when JAX, Flax or the JAX package `motionstyle`
were loaded. `--control 1` runs the cell's control in the program's place
(the int8 serving path for the inference cells, the float8 reference for
training), which has to come out not correct.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default=0, type=int, choices=(0, 1))
    p.add_argument("--control", default=0, type=int, choices=(0, 1))
    return p.parse_args(argv)


def environment() -> None:
    """Caches inside the checkout at fixed paths; one thread for host
    arithmetic; the byte-level tokenizer on both sides; no library loads
    JAX on its own."""
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"  # one process, few threads: steadier host times
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("CLIP_BPE_PATH", None)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    args = parse(argv)
    environment()
    import torch

    from portbench.harness import cell, registry

    chips = registry.cell(args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    result, rows = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START,
                            control=bool(args.control))
    loaded = cell.forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
