"""Diffusion noise schedules + timestep respacing, as torch tables.

Counterpart of motionstyle/diffusion/schedule.py. Tables are computed in
float64 with numpy (the reference's fp64 tables, gaussian_diffusion.py:
182-219) and stored as float32 tensors on the schedule's device; per-step
lookups are gathers. Respacing rebuilds the betas over the kept steps exactly
as SpacedDiffusion does (respace.py:78-87); `timestep_map` maps a respaced
index back to the original timestep fed to the denoiser.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int,
                            scale_betas: float = 1.0) -> np.ndarray:
    if schedule_name == "linear":
        scale = scale_betas * 1000 / num_diffusion_timesteps
        return np.linspace(scale * 0.0001, scale * 0.02, num_diffusion_timesteps,
                           dtype=np.float64)
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps: int, alpha_bar,
                        max_beta: float = 0.999) -> np.ndarray:
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas)


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """Select a subset of timesteps ('ddimN' striding or sectioned counts).
    Parity: respace.py:8-61."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired_count} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        start_idx += size
    return set(all_steps)


@dataclass(frozen=True)
class DiffusionSchedule:
    """Per-timestep coefficient tables, each (T,) float32 on one device."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    timestep_map: torch.Tensor  # (T,) int64: respaced index -> original timestep
    original_num_steps: int = 1000

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @property
    def device(self) -> torch.device:
        return self.betas.device

    def extract(self, table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """Gather table[t] and right-pad dims to broadcast against x (ndim)."""
        out = table[t]
        return out.reshape(out.shape + (1,) * (ndim - out.ndim))


def _tables_from_betas(betas: np.ndarray) -> dict:
    betas = np.asarray(betas, dtype=np.float64)
    assert betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    return dict(
        betas=betas,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        alphas_cumprod_next=alphas_cumprod_next,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        log_one_minus_alphas_cumprod=np.log(1.0 - alphas_cumprod),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=np.log(
            np.append(posterior_variance[1], posterior_variance[1:])),
        posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        posterior_mean_coef2=(1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod),
    )


def make_schedule(noise_schedule: str = "cosine", diffusion_steps: int = 1000,
                  timestep_respacing=None, scale_betas: float = 1.0,
                  device="cuda") -> DiffusionSchedule:
    """Build a (possibly respaced) DiffusionSchedule on `device`."""
    base_betas = get_named_beta_schedule(noise_schedule, diffusion_steps, scale_betas)
    base_alphas_cumprod = np.cumprod(1.0 - np.asarray(base_betas, dtype=np.float64))
    if timestep_respacing:
        use_timesteps = space_timesteps(diffusion_steps, timestep_respacing)
        timestep_map, new_betas = [], []
        last_alpha_cumprod = 1.0
        for i, ac in enumerate(base_alphas_cumprod):
            if i in use_timesteps:
                new_betas.append(1 - ac / last_alpha_cumprod)
                last_alpha_cumprod = ac
                timestep_map.append(i)
        betas = np.array(new_betas)
    else:
        betas = base_betas
        timestep_map = list(range(diffusion_steps))
    tables = _tables_from_betas(betas)
    return DiffusionSchedule(
        **{k: torch.as_tensor(v, dtype=torch.float32, device=device)
           for k, v in tables.items()},
        timestep_map=torch.as_tensor(timestep_map, dtype=torch.int64, device=device),
        original_num_steps=diffusion_steps,
    )
