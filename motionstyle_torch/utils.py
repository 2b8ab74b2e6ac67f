"""Seed fixing for the port's CLIs (the port's own copy of
motionstyle/utils.py::fixseed; parity: utils/fixseed.py:6).
"""
from __future__ import annotations

import random

import numpy as np
import torch


def fixseed(seed: int) -> None:
    """Pin Python's, numpy's global and torch's default generators. The
    loaders' crops and caption picks and the evaluation's choices draw from
    the global numpy stream, the same stream in both packages; the CLIs'
    sampling noise comes from torch.Generators seeded from the same seed."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
