"""Spans and counters inside the port, recorded only while a torch.profiler
session is active.

    from motionstyle_torch import tracing

    with tracing.span("sampler.step"):
        ...
    tracing.count("text.memo_hits", n)

A span's record is its name, its start and end on time.time_ns() and its
parent, the span that was open on the same thread when it began. That clock
is the one the profiler's device events (kineto) carry, so each span lies
over the device trace. A counter's record is its name, its amount and its
time. snapshot() returns what was recorded; reset() clears it. Nothing here
writes a file: a profiler's owner reads the snapshot.

Recording follows torch.autograd.profiler._is_profiler_enabled, which every
torch.profiler session sets, whatever activities it records: the
benchmark's traced stretch and the tools' --profile DIR. With no session a
span costs that one check: span() returns a shared object whose enter and
exit do nothing, and reads no clock. Inside utils.profile_trace (ranges())
each span also opens a torch.profiler.record_function range, so the Chrome
trace shows the spans beside the kernels; a session that records the device
only gets no ranges, since recording host operations would cost the host
more than the work it times.

The spans and counters of the port, and what each covers:

  sampler.step          one step of diffusion/sampling.py::sample_loop
  denoiser              one MDM or StyleDiffusion forward (models/denoiser.py)
  sampler.inputs        Sampler.__call__ putting a call's inputs on the device
  sampler.item_noise    a call's per-item generators and draws
  copy.h2d_bytes        bytes copied from host arrays to a CUDA device
                        (the sampler's inputs, the trainer's batch)
  text.encode           ModelBundle.encode_text: the memo and the text tower
  text.memo_hits, text.memo_misses
                        distinct captions of a batch found in the memo or not
  train.step            PriorTrainer.run_step, covered end to end by its phases
                        train.copy_in, train.forward, train.backward and
                        train.optimizer (train/pretrain.py)
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import profiler as _profiler


class SpanRecord(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]  # the id of the span open on the same thread, if any


class CountRecord(NamedTuple):
    name: str
    n: int
    time_ns: int


class Snapshot(NamedTuple):
    spans: tuple
    counts: tuple


_spans: list = []  # plain tuples: under a profiler a NamedTuple costs more than the rest
_counts: list = []
_ids = itertools.count()
_local = threading.local()
_ranges = False  # set inside utils.profile_trace


class _Off:
    """The span of a process with no profiler session: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):  # named: *args costs ~30 ns more a call
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "start_ns", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        stack.append(self)
        self.range = None
        if _ranges:
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(exc_type, exc, tb)
        _local.stack.pop()
        _spans.append((self.id, self.name, self.start_ns, end, self.parent))
        return False


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str):
    """A context manager that records `name`'s interval while a profiler
    session is active."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, n: int) -> None:
    """Record `n` under counter `name` while a profiler session is active."""
    if _profiler._is_profiler_enabled:
        _counts.append((name, int(n), time.time_ns()))


def _cuda_target(device) -> bool:
    return torch.device(device).type == "cuda"


def h2d_bytes(a, device, dtype: Optional[torch.dtype] = None) -> int:
    """The bytes torch.as_tensor(a, dtype=dtype, device=device) copies from
    the host to a CUDA device: a numpy array's or a CPU tensor's elements at
    the target dtype (a conversion runs on the host, before the copy); 0
    for a CPU target, for data already on a device and for None."""
    if a is None or not _cuda_target(device):
        return 0
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            return 0
        return a.numel() * (dtype or a.dtype).itemsize
    a = np.asarray(a)
    return a.size * (dtype.itemsize if dtype is not None else a.itemsize)


def count_h2d(a, device, dtype: Optional[torch.dtype] = None) -> None:
    """Count h2d_bytes(a, device, dtype) under copy.h2d_bytes."""
    if _profiler._is_profiler_enabled:
        n = h2d_bytes(a, device, dtype)
        if n:
            count("copy.h2d_bytes", n)


@contextlib.contextmanager
def ranges():
    """Inside: each recorded span also opens a record_function range."""
    global _ranges
    old, _ranges = _ranges, True
    try:
        yield
    finally:
        _ranges = old


def snapshot() -> Snapshot:
    """Every span and counter recorded since the last reset()."""
    return Snapshot(tuple(SpanRecord(*r) for r in list(_spans)),
                    tuple(CountRecord(*r) for r in list(_counts)))


def reset() -> None:
    _spans.clear()
    _counts.clear()
