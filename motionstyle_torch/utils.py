"""Seed fixing and tracing for the port's CLIs (the port's own copies of
motionstyle/utils.py::fixseed and ::profile_trace; parity:
utils/fixseed.py:6).
"""
from __future__ import annotations

import contextlib
import os
import random

import numpy as np
import torch

from motionstyle_torch import tracing

TRACE_FILE = "trace.json"  # the Chrome trace profile_trace writes into its directory


def fixseed(seed: int) -> None:
    """Pin Python's, numpy's global and torch's default generators. The
    loaders' crops and caption picks and the evaluation's choices draw from
    the global numpy stream, the same stream in both packages; the CLIs'
    sampling noise comes from torch.Generators seeded from the same seed."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """A torch.profiler trace of the region (host activity, and the card's
    kernels and copies where a card is present), written on exit as a Chrome
    trace, log_dir/trace.json (open it in Perfetto or chrome://tracing).
    Yields the profiler (its key_averages() summarise the region), or None
    when not enabled. The counterpart of the JAX package's jax.profiler
    trace, which the CLIs' --profile DIR asks for. The port's spans
    (tracing.py) appear in it as record_function ranges."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, tracing.ranges():
        yield prof
        if cuda:
            torch.cuda.synchronize()  # the region's kernels end inside the trace
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")
