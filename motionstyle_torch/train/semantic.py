"""Semantic-discriminator training: align the motion encoder's embedding mu
with the prior's text-conditioning space.

Counterpart of motionstyle/train/semantic.py (the reference consumes an
externally trained discriminator, mdm_forstyledataset.py:569-577; its
objective is MotionEncoder.finetune_forward, :136-180). A clean motion is
encoded into mu, mu conditions the frozen prior, and the prior denoises a
noised copy of the same motion:

  x_t = q_sample(x_start, t, noise)
  mu  = mask_cond(encode_motion(x_start, frame_mask))   (training forward)
  out = denoise_prior(x_t, t, mu)                      (training forward)
  loss = mean over clips of masked SSE / (mask frames * C * F)

AdamW updates only the discriminator: 'motion_enc_encoder', 'mu_query' and
'sigma_query'. Every other parameter (the prior, the style encoder) has
requires_grad False and stays out of the optimizer's groups, so weight decay
cannot touch it. With cfg.fused_train the prior's training forward runs the
CUDA training kernels, as the JAX prior's does; the discriminator's encoder
runs the plain layers (its key-padding mask), as in the JAX package.

Randomness: one torch.Generator on the model's device, seeded from the
config, draws the timesteps, the noise, the discriminator's dropout, the
condition mask and the prior's dropout in turn; the draws differ from the
JAX trainer's PRNG keys. save() writes semantic_discriminator.pt in the
reference layout (models/params.py export_semantic_discriminator), which
--semantic_discriminator_path loads in either package.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import torch

from motionstyle_torch.diffusion import ddpm
from motionstyle_torch.diffusion.resample import UniformSampler
from motionstyle_torch.diffusion.schedule import DiffusionSchedule
from motionstyle_torch.models.denoiser import StyleDiffusion, mask_cond
from motionstyle_torch.models.params import export_semantic_discriminator
from motionstyle_torch.train import logging as logger

TRAINABLE_KEYS = ("motion_enc_encoder", "mu_query", "sigma_query")


def is_trainable(name: str) -> bool:
    """True for the discriminator's parameters (a StyleDiffusion parameter name)."""
    return name.split(".", 1)[0] in TRAINABLE_KEYS


@dataclass
class SemanticConfig:
    save_dir: str
    lr: float = 1e-4
    weight_decay: float = 0.0
    num_steps: int = 600
    log_interval: int = 50
    save_interval: int = 0  # 0 = only the final save
    cond_mask_prob: float = 0.1
    seed: int = 10


class SemanticTrainer:
    """Trains the mu/sigma queries and the discriminator's encoder of a
    StyleDiffusion in place; everything else stays frozen."""

    def __init__(self, cfg: SemanticConfig, model: StyleDiffusion, sched: DiffusionSchedule):
        self.cfg = cfg
        self.model = model
        self.sched = sched
        self.device = sched.device
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.sampler = UniformSampler(sched.num_timesteps)
        trainable = []
        for name, p in model.named_parameters():
            p.requires_grad_(is_trainable(name))
            if p.requires_grad:
                trainable.append(p)
        self.opt = torch.optim.AdamW(trainable, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=cfg.weight_decay)

    def loss(self, batch: dict, t: torch.Tensor,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The objective on one batch at timesteps t. batch: x_start (B, C, F,
        T), frame_mask (B, T) bool, mask (B, 1, 1, T), tensors on the model's
        device; `noise` pins the q_sample noise (tests replay other draws)."""
        x_start, gen, model = batch["x_start"], self.generator, self.model
        if noise is None:
            noise = torch.randn(x_start.shape, generator=gen, device=x_start.device)
        x_t = ddpm.q_sample(self.sched, x_start, t, noise)
        mu = model.encode_motion(x_start, batch.get("frame_mask"), deterministic=False,
                                 generator=gen)
        mu = mask_cond(mu, self.cfg.cond_mask_prob, gen)
        out = model.denoise_prior(x_t, t, mu, deterministic=False, generator=gen)
        m = batch["mask"]
        sse = (((out - x_start) ** 2) * m).sum(dim=(1, 2, 3))
        n = torch.clamp(m.sum(dim=(1, 2, 3)), min=1.0) * (x_start.shape[1] * x_start.shape[2])
        return (sse / n).mean()

    def train_step(self, batch: dict, t: torch.Tensor,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One AdamW step on the discriminator; returns the loss (detached)."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(batch, t, noise)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def run_step(self, batch: dict) -> float:
        t0 = time.perf_counter()
        batch = {k: None if v is None else torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        t, _ = self.sampler.sample(self.generator, batch["x_start"].shape[0])
        loss = float(self.train_step(batch, t))  # waits for the card
        self.step += 1
        if self.cfg.log_interval and self.step % self.cfg.log_interval == 0:
            logger.logkv("semantic_step", self.step)
            logger.logkv("semantic_loss", loss)
            logger.logkv("step_seconds", time.perf_counter() - t0)
        if self.cfg.save_interval and self.step % self.cfg.save_interval == 0:
            self.save()
        return loss

    def save(self) -> str:
        os.makedirs(self.cfg.save_dir, exist_ok=True)
        path = os.path.join(self.cfg.save_dir, "semantic_discriminator.pt")
        torch.save(export_semantic_discriminator(self.model), path)
        logger.log(f"saved semantic discriminator {path}")
        return path
