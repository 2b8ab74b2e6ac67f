#!/usr/bin/env python3
"""What the port's span recorder (motionstyle_torch/tracing.py) costs, whether
its clock lies over the card's, and where a benchmark cell's traced stretch
goes by the program's own spans, on one NVIDIA GPU:

    python3 profile_tracing.py [--n 1000000] [--reps 20]
    python3 profile_tracing.py --cell <name> --seed <n> [--seconds 10]

Without --cell:
1. Whether a torch.profiler session that records the card only
   (activities=[CUDA], as the benchmark's trace runs) sets the flag the
   recorder reads, and torch's C-side flag beside it.
2. What one span (`with tracing.span(...): pass`) and one counter add to
   the code around them, with no profiler session (recording off) and
   inside a CUDA-only session (recording on): the least of 5 timings of n
   passes less an empty loop's.
3. The clock: inside a CUDA-only session, `reps` spans each around one
   launch and a synchronise, of a spin kernel (torch.cuda._sleep, ~1 ms)
   and of a bf16 GEMM (8192^3, cuBLAS), after a 2 ms pause and back to
   back; in microseconds on the time.time_ns() clock the benchmark lays
   over kineto's device events (min, median, max over the spans): from the
   span's start to the host's return from the launch and to the first
   device event's start, and from the last device event's end to the
   span's end.

With --cell: one `--trace 1` run of the benchmark's cell (portbench/), and
then the program's spans in its traced stretch: each name's total and count
a unit, the training phases' sum against train.step and train.step against
the harness's portbench.step, the counters' sums, and the stretch's idle
device time by the innermost program span open at each gap's middle (else
the harness's span, else "harness loop").

Prints the card's name and power limit first, and one JSON line last.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import timeit
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from motionstyle_torch import tracing

PHASES = ("train.copy_in", "train.forward", "train.backward", "train.optimizer")


def added_ns(stmt: str, n: int) -> float:
    """What `stmt` adds to a loop, ns a pass: the least of 5 timings of n
    passes less the least of an empty loop's."""
    g = {"tracing": tracing}
    base = min(timeit.repeat("pass", number=n, repeat=5))
    return (min(timeit.repeat(stmt, globals=g, number=n, repeat=5)) - base) / n * 1e9


SPAN = 'with tracing.span("probe"): pass'
COUNT = 'tracing.count("probe", 1)'


def costs(n: int) -> dict:
    out = {}
    for _ in range(2):  # the second pass is kept: the first warms the interpreter
        out["span_off_ns"] = added_ns(SPAN, n)
        out["count_off_ns"] = added_ns(COUNT, n)
    with profile(activities=[ProfilerActivity.CUDA]):
        tracing.reset()
        out["span_on_ns"] = added_ns(SPAN, n // 10)
        tracing.reset()
        out["count_on_ns"] = added_ns(COUNT, n // 10)
    tracing.reset()
    return out


def device_intervals(prof) -> list:
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation())


def clock(kernel: str, reps: int, pause_s: float) -> dict:
    """Spans each around one launch and a synchronise: `sleep`, a spin
    kernel of about 1 ms (torch.cuda._sleep), or `gemm`, a bf16 GEMM of
    8192^3 through cuBLAS."""
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    launch = (lambda: torch.cuda._sleep(1_500_000)) if kernel == "sleep" else (lambda: a @ a)
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    tracing.reset()
    returned = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if pause_s:
                time.sleep(pause_s)
            with tracing.span("probe"):
                launch()
                returned.append(time.time_ns())
                torch.cuda.synchronize()
    spans = [s for s in tracing.snapshot().spans if s.name == "probe"]
    tracing.reset()
    dev = device_intervals(prof)
    rows = []
    for s, ret in zip(spans, returned):  # device events whose middle lies in the span
        inside = [iv for iv in dev if s.start_ns <= (iv[0] + iv[1]) // 2 <= s.end_ns]
        if not inside:
            continue
        k0, k1 = inside[0][0], max(t for _, t in inside)
        rows.append({"launch_us": (ret - s.start_ns) / 1e3, "lead_us": (k0 - s.start_ns) / 1e3,
                     "trail_us": (s.end_ns - k1) / 1e3, "device_us": (k1 - k0) / 1e3,
                     "events": len(inside)})
    out = {"kernel": kernel, "pause_s": pause_s, "matched": len(rows), "of": len(spans)}
    for key in ("launch_us", "lead_us", "trail_us", "device_us", "events"):
        xs = [r[key] for r in rows[1:]]  # the first after the session starts left out
        out[key] = [min(xs), statistics.median(xs), max(xs)] if xs else None
    return out


def cell_breakdown(name: str, seed: int, seconds: float) -> dict:
    """One traced run of a benchmark cell, its stretch read by the program's
    spans."""
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "portbench"))
    import run as bench_run

    bench_run.environment()
    from portbench.harness import cell, trace

    seen = {}
    reduce = trace.reduce_events

    def keep(events, w0, w1, spans):
        dev = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation()]
        seen.update(dev=dev, w0=w0, w1=w1, harness=list(spans))
        return reduce(events, w0, w1, spans)

    trace.reduce_events = keep
    tracing.reset()
    result, _ = cell.run(name, seed, seconds, True, time.perf_counter())
    w0, w1 = seen["w0"], seen["w1"]
    snap = tracing.snapshot()
    spans = [s for s in snap.spans if w0 <= s.start_ns and s.end_ns <= w1]
    counts = defaultdict(int)
    for c in snap.counts:
        if w0 <= c.time_ns <= w1:
            counts[c.name] += c.n
    total, n = defaultdict(int), defaultdict(int)
    for s in spans:
        total[s.name] += s.end_ns - s.start_ns
        n[s.name] += 1
    harness_total = defaultdict(int)
    for h, a, b in seen["harness"]:
        harness_total[h] += b - a
    units = max(n.get("train.step", 0), harness_count(seen["harness"]))
    out = {"cell": name, "seed": seed, "correct": result["correct"], "units": units,
           "window_s": (w1 - w0) / 1e9, "metrics": {k: v["value"]
                                                   for k, v in result["metrics"].items()},
           "ms_a_unit": {k: v / 1e6 / units for k, v in sorted(total.items())},
           "spans": dict(n), "counters": dict(counts),
           "harness_ms_a_unit": {k: v / 1e6 / units for k, v in harness_total.items()},
           "idle_ms_a_unit_by_span": {k: v / 1e6 / units
                                      for k, v in idle_by_span(seen, spans).items()}}
    if n.get("train.step"):
        phases = sum(total[p] for p in PHASES)
        out["phases_over_step"] = phases / total["train.step"]
        out["step_over_harness_step"] = total["train.step"] / harness_total["portbench.step"]
    return out


def harness_count(harness: list) -> int:
    """Units of the stretch: the harness's sampler or step spans."""
    names = [h for h, _, _ in harness]
    return max(names.count("portbench.sampler"), names.count("portbench.step"))


def idle_by_span(seen: dict, spans: list) -> dict:
    """Idle device ns in [w0, w1] by the innermost program span open at each
    gap's middle, else the innermost harness span, else the harness loop."""
    w0, w1 = seen["w0"], seen["w1"]
    iv = sorted((max(a, w0), min(b, w1)) for a, b in seen["dev"] if b > w0 and a < w1)
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    program = sorted(((s.start_ns, s.end_ns, s.name) for s in spans), key=lambda r: r[0])
    harness = [(a, b, h) for h, a, b in seen["harness"]]
    out = defaultdict(int)
    for a, b in gaps:
        mid = (a + b) // 2
        label = "harness loop"
        for pool in (program, harness):
            open_ = [(e - s, name) for s, e, name in pool if s <= mid <= e]
            if open_:
                label = min(open_)[1]
                break
        out[label] += b - a
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--cell", default=None)
    p.add_argument("--seed", type=int, default=2147483701)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_tracing.py: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    if args.cell:
        out = cell_breakdown(args.cell, args.seed, args.seconds)
    else:
        from torch.autograd import profiler as autograd_profiler

        with profile(activities=[ProfilerActivity.CUDA]):
            flags = {"python_flag": bool(autograd_profiler._is_profiler_enabled),
                     "c_flag": bool(torch._C._autograd._profiler_enabled())}
        flags["python_flag_after"] = bool(autograd_profiler._is_profiler_enabled)
        out = {"torch": torch.__version__, "flags": flags, "costs": costs(args.n),
               "clock": [clock(k, args.reps, p) for k in ("sleep", "gemm") for p in (0.002, 0.0)]}
    out["card"] = card.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
