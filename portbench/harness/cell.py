"""One run of one cell: set-up, the measured window, the per-layer reading
of a traced stretch, the check against the plain reference, and the result.

The window runs whole units of the cell's driver (a chain, a call, a
training step) back to back until `seconds` have passed: the unit running
at that moment finishes and belongs to the window. Nothing is built or
compiled inside it: each driver warms every shape it uses in set-up.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from portbench import counts
from portbench.harness import registry, traffic
from portbench.harness.trace import Spans, Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "motionstyle")


@dataclass
class Context:
    """What a driver is given."""

    cell: dict
    cfg: dict
    mix: dict
    seed: int
    device: torch.device
    spans: Optional[Spans] = None
    control: bool = False  # run the cell's control in the program's place
    fault: Optional[str] = None  # a planted fault (tests and readings only)
    notes: dict = field(default_factory=dict)  # a driver's diagnostics, for readings.py

    def sub_seed(self, *tags) -> int:
        return traffic.sub_seed(self.seed, *tags)

    def span(self, name: str):
        return self.spans.span(name) if self.spans is not None else contextlib.nullcontext()

    def say(self, text: str) -> None:
        _say(text)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class MetricView:
    """What a per-layer metric's reader is given."""

    def __init__(self, ctx: Context, trace, work: dict):
        self.cfg, self.trace, self.work, self.spans = ctx.cfg, trace, work, ctx.spans
        self.counts = counts

    def kernel_seconds(self, family: str) -> tuple:
        return self.trace.seconds_matching(registry.kernel_patterns(family))


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (motionstyle_torch is not motionstyle)."""
    tops = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


def resolve(name: str, overrides: Optional[dict] = None) -> tuple:
    """(cell, configuration, traffic mix) by the cell's name, with test
    overrides merged into the configuration and the mix."""
    cell = registry.cell(name)
    cfg = registry.load("configs", cell["config"])
    mix = registry.load("traffic", cell["traffic"])
    for part, d in (("config", cfg), ("traffic", mix)):
        for k, v in ((overrides or {}).get(part) or {}).items():
            d[k] = v
    return cell, cfg, mix


def run(name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", control: bool = False, fault: Optional[str] = None,
        overrides: Optional[dict] = None, notes: Optional[dict] = None) -> tuple:
    """(result dict, checks [(name, value, limit)]) of one run; a driver's
    diagnostics go into `notes`."""
    cell, cfg, mix = resolve(name, overrides)
    dev = torch.device(device)
    ctx = Context(cell, cfg, mix, int(seed), dev, Spans() if trace else None, control, fault,
                  {} if notes is None else notes)
    drv = registry.driver(cell["driver"]).Driver(ctx)
    drv.setup()
    ctx.sync()
    tracer = Tracer(ctx.spans, dev) if trace else None
    if tracer is not None:
        tracer.warm()
    trace_units = int(mix.get("trace_units", 1))
    data, traced = None, (0, 0)

    w0 = time.perf_counter()
    setup_s = w0 - t_start
    n = 0
    while True:
        if tracer is not None and n == 0:
            tracer.start()
        drv.unit(n)
        n += 1
        if tracer is not None and tracer.running and n >= trace_units:
            data, traced = tracer.stop(), (0, n)
        if time.perf_counter() - w0 >= seconds:
            break
    if tracer is not None and tracer.running:
        data, traced = tracer.stop(), (0, n)
    ctx.sync()
    window_s = time.perf_counter() - w0

    result = {"correct": False, "attempted": n, "failed": 0, "metrics": {}}
    if trace:
        view = MetricView(ctx, data, drv.work(*traced))
        for metric in cell["per_layer"]:
            reader = registry.metric(metric)
            value = reader.read(view, metric.split(".", 1)[1] if "." in metric else "")
            if value is not None:
                result["metrics"][metric] = {"value": value, "unit": reader.UNIT}
    else:
        e2e = dict(drv.end_to_end(n, window_s))
        e2e["setup_s"] = (setup_s, "s")
        for metric in cell["end_to_end"]:
            value, unit = e2e[metric]
            result["metrics"][metric] = {"value": value, "unit": unit}
    result["device"] = device_record(dev, cell["chips"])
    if trace:
        result["device"].update(busy_s=data.busy_s, window_s=data.window_s)
        result["breakdown"] = data.breakdown()

    drv.free()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    checks, failed = drv.check()
    _say(f"{name}: set-up {setup_s:.2f} s, {n} units in {window_s:.2f} s, "
         f"check {time.perf_counter() - c0:.2f} s")
    limits = cell["check"]
    rows = [(k, v, limits.get(k)) for k, v in checks]
    result["failed"] = failed
    result["correct"] = bool(rows) and failed == 0 and all(
        lim is not None and v == v and v <= lim for _, v, lim in rows)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows


def _say(text: str) -> None:
    print(f"portbench: {text}", file=sys.stderr, flush=True)


def device_record(dev: torch.device, chips: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
