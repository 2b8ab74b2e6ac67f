"""Plain diffusion arithmetic: the cosine schedule with respacing, q_sample,
the DDPM and DDIM (eta 0) updates of an x0-predicting denoiser with the
inpainting blend, and classifier-free guidance (Ho et al.; MDM's
cfg_sampler; the improved-DDPM tables of Nichol and Dhariwal). Tables are
worked out in float64 and used in float32, as the guided-diffusion code
does.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def cosine_betas(steps: int, max_beta: float = 0.999) -> np.ndarray:
    def abar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    return np.array([min(1 - abar((i + 1) / steps) / abar(i / steps), max_beta)
                     for i in range(steps)], dtype=np.float64)


def ddim_kept(steps: int, count: int) -> list:
    """The kept timesteps of 'ddim<count>': the one integer stride giving
    exactly `count` steps."""
    for stride in range(1, steps):
        if len(range(0, steps, stride)) == count:
            return list(range(0, steps, stride))
    raise ValueError(f"no stride gives {count} of {steps} steps")


class Schedule:
    """Per-step float32 tables on `device`; `tmap[i]` is the original
    timestep of respaced step i, which the denoiser is given."""

    def __init__(self, steps: int, respacing: str | None, device):
        betas = cosine_betas(steps)
        kept = list(range(steps))
        if respacing:
            if not respacing.startswith("ddim"):
                raise ValueError(f"respacing {respacing!r}: only ddimN is used here")
            kept = ddim_kept(steps, int(respacing[4:]))
            ac, last, new = np.cumprod(1.0 - betas), 1.0, []
            for i in kept:
                new.append(1 - ac[i] / last)
                last = ac[i]
            betas = np.array(new, dtype=np.float64)
        ac = np.cumprod(1.0 - betas)
        ac_prev = np.append(1.0, ac[:-1])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)

        def t32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

        self.n = len(betas)
        self.tmap = torch.as_tensor(kept, dtype=torch.int64, device=device)
        self.ac, self.ac_prev = t32(ac), t32(ac_prev)
        self.sqrt_ac, self.sqrt_1m_ac = t32(np.sqrt(ac)), t32(np.sqrt(1.0 - ac))
        self.sqrt_recip_ac = t32(np.sqrt(1.0 / ac))
        self.sqrt_recipm1_ac = t32(np.sqrt(1.0 / ac - 1))
        self.coef1 = t32(betas * np.sqrt(ac_prev) / (1.0 - ac))
        self.coef2 = t32((1.0 - ac_prev) * np.sqrt(1.0 - betas) / (1.0 - ac))
        self.log_var = t32(np.log(np.append(post_var[1], post_var[1:])))


def q_sample(s: Schedule, x0, i: int, noise, mask=None):
    """x_t at respaced step i; kept features (mask 1) get no noise."""
    if mask is not None:
        noise = noise * (1.0 - mask)
    return s.sqrt_ac[i] * x0 + s.sqrt_1m_ac[i] * noise


def blend(x0, mask, motion):
    """The inpainting blend of the x0 prediction."""
    return x0 if mask is None else x0 * (1.0 - mask) + motion * mask


def ddpm_step(s: Schedule, x, i: int, x0, noise):
    """x_{i-1} from the posterior mean, fixed-small variance; no noise at 0."""
    mean = s.coef1[i] * x0 + s.coef2[i] * x
    return mean + (1.0 if i != 0 else 0.0) * torch.exp(0.5 * s.log_var[i]) * noise


def ddim_step(s: Schedule, x, i: int, x0):
    """DDIM at eta 0."""
    eps = (s.sqrt_recip_ac[i] * x - x0) / s.sqrt_recipm1_ac[i]
    return x0 * torch.sqrt(s.ac_prev[i]) + torch.sqrt(1 - s.ac_prev[i]) * eps


def guided(out_cond, out_uncond, scale: float):
    """Classifier-free guidance: uncond + scale (cond - uncond)."""
    return out_uncond + scale * (out_cond - out_uncond)
