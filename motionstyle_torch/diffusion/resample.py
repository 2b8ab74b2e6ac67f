"""Timestep sampler for the finetune: uniform over [0, num_timesteps) or a
restricted range, drawn from an explicit torch.Generator.

Counterpart of motionstyle/diffusion/resample.py::UniformSampler (parity:
diffusion/resample.py; the reference keeps finetune timesteps below
T - skip, training_loop.py:240-246). Not on this slice: the loss-second-
moment sampler.
"""
from __future__ import annotations

from typing import Optional

import torch


class UniformSampler:
    """Uniform timesteps over [0, num_timesteps) or a restricted range."""

    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample(self, generator: Optional[torch.Generator], batch: int, data_range=None,
               device=None):
        """(t (batch,) int64, weights (batch,) ones) on `device` (default: the
        generator's). data_range: None, hi, or (lo, hi)."""
        if data_range is None:
            lo, hi = 0, self.num_timesteps
        elif isinstance(data_range, tuple):
            lo, hi = data_range
        else:
            lo, hi = 0, int(data_range)
        device = device or (generator.device if generator is not None else "cpu")
        t = torch.randint(lo, hi, (batch,), generator=generator, device=device)
        return t, torch.ones((batch,), dtype=torch.float32, device=device)
