"""Timestep samplers: uniform over [0, num_timesteps) or a restricted range,
and the loss-second-moment importance sampler, drawn from an explicit
torch.Generator.

Counterpart of motionstyle/diffusion/resample.py (parity:
diffusion/resample.py:8-159; the reference keeps finetune timesteps below
T - skip, training_loop.py:240-246). The loss-aware sampler keeps its history
on the host in numpy, as the JAX one does; where the JAX samplers take a
PRNG key, these take a torch.Generator, so the draws differ between the
packages while the weights and their support agree.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _bounds(num_timesteps: int, data_range) -> tuple:
    """(lo, hi) of data_range: None, hi, or (lo, hi)."""
    if data_range is None:
        return 0, num_timesteps
    if isinstance(data_range, tuple):
        return data_range
    return 0, int(data_range)


def _device(generator: Optional[torch.Generator], device):
    return device or (generator.device if generator is not None else "cpu")


class UniformSampler:
    """Uniform timesteps over [0, num_timesteps) or a restricted range."""

    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample(self, generator: Optional[torch.Generator], batch: int, data_range=None,
               device=None):
        """(t (batch,) int64, weights (batch,) ones) on `device` (default: the
        generator's). data_range: None, hi, or (lo, hi)."""
        lo, hi = _bounds(self.num_timesteps, data_range)
        device = _device(generator, device)
        t = torch.randint(lo, hi, (batch,), generator=generator, device=device)
        return t, torch.ones((batch,), dtype=torch.float32, device=device)


class LossSecondMomentResampler:
    """Importance-sample timesteps by sqrt(E[loss^2]) with a uniform warmup
    (parity: resample.py:129-159); the history lives on the host."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros([num_timesteps, history_per_term], dtype=np.float64)
        self._loss_counts = np.zeros([num_timesteps], dtype=int)

    def _warmed_up(self) -> bool:
        return bool((self._loss_counts == self.history_per_term).all())

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones([self.num_timesteps], dtype=np.float64)
        w = np.sqrt(np.mean(self._loss_history ** 2, axis=-1))
        w /= w.sum()
        w *= 1 - self.uniform_prob
        w += self.uniform_prob / len(w)
        return w

    def probabilities(self, data_range=None) -> tuple:
        """(p over all timesteps, |support|): the weights restricted to
        data_range and normalised."""
        w = self.weights()
        support = self.num_timesteps
        if data_range is not None:
            lo, hi = _bounds(self.num_timesteps, data_range)
            keep = np.zeros_like(w)
            keep[lo:hi] = 1.0
            w = w * keep
            support = hi - lo
        return w / w.sum(), support

    def sample(self, generator: Optional[torch.Generator], batch: int, data_range=None,
               device=None):
        """(t (batch,) int64, weights (batch,) fp32) on `device` (default: the
        generator's). The importance weights are 1/(|support| p[t]), unbiased
        over a restricted range too."""
        p, support = self.probabilities(data_range)
        device = _device(generator, device)
        probs = torch.as_tensor(p, dtype=torch.float64, device=device)
        t = torch.multinomial(probs, batch, replacement=True, generator=generator)
        weights = 1.0 / (support * probs[t])
        return t, weights.to(torch.float32)

    def update_with_local_losses(self, ts, losses):
        """Append (t, loss) pairs to the history, oldest out once a timestep
        holds history_per_term losses (resample.py:88-108 without the
        cross-rank gather: the port trains on one device)."""
        for t, loss in zip(np.asarray(ts).tolist(), np.asarray(losses).tolist()):
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1


# the samplers by the name the trainer and the pretrain CLI take
SCHEDULE_SAMPLERS = {"uniform": UniformSampler, "loss_second_moment": LossSecondMomentResampler}


def create_named_schedule_sampler(name: str, num_timesteps: int):
    """The sampler named `name`, in the trainer's spelling or the
    reference's ("loss-second-moment")."""
    key = name.replace("-", "_")
    if key not in SCHEDULE_SAMPLERS:
        raise ValueError(f"unknown schedule_sampler {name!r} ({' | '.join(SCHEDULE_SAMPLERS)})")
    return SCHEDULE_SAMPLERS[key](num_timesteps)
