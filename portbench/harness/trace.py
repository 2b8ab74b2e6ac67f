"""The traced stretch of a `--trace 1` run: torch.profiler's device
activity over whole timed units, reduced to the device's busy time, the
device operations by name and the longest idle gaps by what the host was
doing, and the harness's own spans around the calls into each layer.

Everything here reads the profiler's raw event list (kineto), not
key_averages(), which is slow on a trace of a few hundred thousand events.
"""
from __future__ import annotations

import contextlib
import re
import time
from collections import defaultdict

import numpy as np
import torch


class Spans:
    """Host seconds by span name, recorded only while a trace runs, with
    each span's interval on the host's wall clock (the profiler's clock),
    by which the trace names what the host did in an idle gap."""

    def __init__(self):
        self.active = False
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self.intervals = []  # (name, start_ns, end_ns)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        t0, w0 = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1
            self.intervals.append((name, w0, time.time_ns()))

    def wrap(self, name: str, fn):
        """fn with every call inside span `name`."""
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped


class TraceData:
    """What the metric readers see of the traced stretch."""

    def __init__(self, window_s: float, busy_s: float, ops: dict, gaps: list):
        self.window_s = window_s
        self.busy_s = busy_s
        self.ops = ops  # device operation name -> (seconds, count)
        self.gaps = gaps  # [[host span name, idle seconds]], longest first

    def seconds_matching(self, patterns) -> tuple:
        """(seconds, launches) of the device operations whose name holds any
        of the regular expressions."""
        regs = [re.compile(p) for p in patterns]
        hit = [(s, n) for name, (s, n) in self.ops.items() if any(r.search(name) for r in regs)]
        return sum(s for s, _ in hit), sum(n for _, n in hit)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((k, s) for k, (s, _) in self.ops.items()), key=lambda r: -r[1])[:top]
        return {"device_ops": [[k, s] for k, s in ops], "idle_gaps": self.gaps[:top]}


class Tracer:
    """torch.profiler's device activity (CUPTI) around whole units of the
    window, each end after the device has drained. Host operations are not
    recorded: recording them costs the host more than the sampler's own
    work a step; the harness's spans say what the host was doing."""

    def __init__(self, spans: Spans, device: torch.device):
        self.spans = spans
        self.cuda = device.type == "cuda"
        self._prof = None

    def _activities(self) -> list:
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CUDA] if self.cuda else [ProfilerActivity.CPU]

    def warm(self) -> None:
        """One short profile before the window: the first one in a process
        spends seconds setting the profiler up."""
        from torch.profiler import profile

        with profile(activities=self._activities()):
            torch.zeros(1, device="cuda" if self.cuda else "cpu").add_(1)
            self._drain()

    @property
    def running(self) -> bool:
        return self._prof is not None

    def _drain(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import profile

        self._drain()
        self._prof = profile(activities=self._activities())
        self._prof.__enter__()
        self.spans.intervals.clear()
        self._w0 = time.time_ns()
        self.spans.active = True

    def stop(self) -> TraceData:
        self._drain()
        w1 = time.time_ns()
        self.spans.active = False
        self._prof.__exit__(None, None, None)
        prof, self._prof = self._prof, None
        return reduce_events(prof.profiler.kineto_results.events(), self._w0, w1,
                             self.spans.intervals)


def short_name(name: str, cap: int = 160) -> str:
    """A device operation's name, a demangled kernel's without its
    parameter list, at most `cap` characters."""
    if name.startswith("void "):
        name, depth = name[5:].replace("(anonymous namespace)::", ""), 0
        for i, ch in enumerate(name):
            depth += (ch == "<") - (ch == ">")
            if ch == "(" and depth == 0 and i:
                name = name[:i]
                break
    return name if len(name) <= cap else name[:cap - 3] + "..."


def reduce_events(events, w0: int, w1: int, spans: list) -> TraceData:
    """Busy time (the union of the device's intervals within [w0, w1], ns on
    the host's wall clock), device operations by name, and the longest idle
    gaps named by the innermost harness span open at the gap's middle."""
    dev = [(e.start_ns(), e.start_ns() + e.duration_ns(), short_name(e.name())) for e in events
           if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()]
    ops: dict = {}
    for s, t, name in dev:
        sec, n = ops.get(name, (0.0, 0))
        ops[name] = (sec + (t - s) / 1e9, n + 1)
    iv = sorted((max(s, w0), min(t, w1)) for s, t, _ in dev if t > w0 and s < w1)
    merged = []
    for s, t in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    edges = [w0] + [x for st in merged for x in st] + [w1]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])
    by_name: dict = defaultdict(float)
    if gaps:
        starts = np.asarray([a for _, a, _ in spans] or [0], np.int64)
        ends = np.asarray([b for _, _, b in spans] or [-1], np.int64)
        for a, b in gaps[:1000]:
            mid = (a + b) // 2
            hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = (spans[hit[np.argmin(ends[hit] - starts[hit])]][0] if len(hit)
                     else "harness loop")
            by_name[label] += (b - a) / 1e9
    named = sorted(([k, v] for k, v in by_name.items()), key=lambda r: -r[1])
    return TraceData((w1 - w0) / 1e9, busy / 1e9, ops, named)
