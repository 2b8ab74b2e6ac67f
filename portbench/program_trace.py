"""The program's own spans and counters (motionstyle_torch/tracing.py) inside
a traced run's stretch, for the per-layer metrics that read them.

The program records while a torch.profiler session is active, so a
`--trace 1` run finds in its snapshot what the program did during the
traced stretch. The stretch runs from the first start to the last end of
the harness's own spans (`view.spans.intervals`), and records outside it
are left out: a cell traced twice in one process never reads the first
trace. Where the program records nothing there (a checkout without the
recorder, or no span of that name), the readers return None.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Optional


class Records:
    """A traced stretch's spans and counters, by name."""

    def __init__(self, spans, counts):
        self.spans = list(spans)
        self.counts = list(counts)
        self._total = defaultdict(int)
        self._n = defaultdict(int)
        for s in self.spans:
            self._total[s.name] += s.end_ns - s.start_ns
            self._n[s.name] += 1

    def n(self, name: str) -> int:
        """How many `name` spans."""
        return self._n.get(name, 0)

    def total_ms(self, name: str) -> float:
        """The `name` spans' summed duration, ms."""
        return self._total.get(name, 0) / 1e6

    def self_ms(self, name: str, less: str) -> float:
        """The `name` spans' summed duration less that of their direct
        children named `less`, ms."""
        ids = {s.id for s in self.spans if s.name == name}
        children = sum(s.end_ns - s.start_ns for s in self.spans
                       if s.name == less and s.parent in ids)
        return (self._total.get(name, 0) - children) / 1e6

    def counted(self, name: str) -> Optional[int]:
        """The sum of counter `name`, or None where it was never counted."""
        hits = [c.n for c in self.counts if c.name == name]
        return sum(hits) if hits else None


def records(view) -> Optional[Records]:
    """The program's records inside the traced stretch of `view` (a
    harness MetricView), or None where there are none."""
    spans = getattr(view, "spans", None)
    if spans is None or not spans.intervals:
        return None
    try:
        from motionstyle_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    lo = min(a for _, a, _ in spans.intervals)
    hi = max(b for _, _, b in spans.intervals)
    snap = tracing.snapshot()
    inside = [s for s in snap.spans if lo <= s.start_ns and s.end_ns <= hi]
    counts = [c for c in snap.counts if lo <= c.time_ns <= hi]
    if not inside and not counts:
        return None
    return Records(inside, counts)


def calls(view) -> int:
    """The traced stretch's sampler calls: the harness's portbench.sampler
    spans."""
    return 0 if view.spans is None else view.spans.count.get("portbench.sampler", 0)


def per_call_ms(view, name: str) -> Optional[float]:
    """ms of `name` spans a sampler call, or None."""
    r = records(view)
    if r is None or not r.n(name) or not calls(view):
        return None
    return r.total_ms(name) / calls(view)


def per_train_step_ms(view, name: str) -> Optional[float]:
    """ms of `name` spans a training step (the program's train.step spans),
    or None."""
    r = records(view)
    if r is None or not r.n(name) or not r.n("train.step"):
        return None
    return r.total_ms(name) / r.n("train.step")
