"""Prior pretraining: the text-conditioned MDM prior trained with the
standard denoising objective.

Counterpart of motionstyle/train/pretrain.py (the reference ships no prior
trainer; its finetune consumes mdm.pt and model_pretrained.pt, README.md:53):

  x_t = q_sample(x0, t, noise)             (diffusion/ddpm.py)
  loss = mean(masked_l2(x0, mdm(x_t, t, c)) * t_weights)
                                           (predict-x0; masked_l2 parity
                                            gaussian_diffusion.py:223)
  c = mask_cond(enc_text)                  (CFG condition dropout,
                                            mdm_forstyledataset.py:288-296)

AdamW over the prior ('mdm') only; the style encoder, the semantic
discriminator and the text tower stay frozen (:147-158). The LR anneals
linearly to 0 over lr_anneal_steps. grad_accum splits each batch into
sequential microbatches, each with its own dropout draws, averaged into one
update (:319-346). With ema_rate the prior's exponential moving average
follows every update (:351-355). The loss-second-moment timestep sampler
takes each step's per-sample losses one step late (:360-401), as the JAX
trainer does to keep its dispatch pipeline from waiting on the device.

Randomness: one torch.Generator on the model's device, seeded from the
config, draws the timesteps, the noise, the condition mask and then each
microbatch's dropout in turn (positional-encoding dropout and the encoder's
masks or, with cfg.fused_train_prng, its per-layer seeds). The draws differ
from the JAX trainer's PRNG keys.

Checkpoints in the reference torch layout: save() writes mdm.pt (the prior,
for --mdm_path), model_pretrained.pt (its encoder, a style-encoder warm
start for --resume_checkpoint) and with ema_rate mdm_ema.pt; save_step()
writes mdm{step:09d}.pt, opt{step:09d}.pt (the JAX trainer's flat optax
layout over the 'mdm' subtree: Adam's count, mu and nu in flax order, the
LR schedule's count when the LR anneals) and ema{step:09d}.pt, from which a
run resumes. A missing or unreadable opt{step}.pt restarts Adam's moments
and keeps the LR anneal at the resumed step (:512-538).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from motionstyle_torch.diffusion import ddpm
from motionstyle_torch.diffusion.resample import (
    LossSecondMomentResampler, create_named_schedule_sampler)
from motionstyle_torch.diffusion.schedule import DiffusionSchedule
from motionstyle_torch.models.denoiser import StyleDiffusion, mask_cond
from motionstyle_torch.models.params import (
    export_encoder, export_mdm, from_torch_state_dict, mdm_leaves)
from motionstyle_torch.train import logging as logger
from motionstyle_torch.train.finetune import (
    find_resume_checkpoint, linear_anneal, load_optimizer_state_leaves, optimizer_state_leaves,
    set_schedule_position)
from motionstyle_torch.train.preemption import PreemptionMixin

@dataclass
class PretrainConfig:
    save_dir: str
    lr: float = 1e-4
    weight_decay: float = 0.0
    num_steps: int = 600
    log_interval: int = 50
    save_interval: int = 0  # 0 = only the final save
    cond_mask_prob: float = 0.1
    seed: int = 10
    lr_anneal_steps: int = 0  # linear decay to 0 over this many steps; 0 = constant
    grad_accum: int = 1  # sequential microbatches per update; must divide the batch
    resume_checkpoint: str = ""  # a mdm{step:09d}.pt, or the directory holding them
    schedule_sampler: str = "uniform"  # or "loss_second_moment"
    ema_rate: float = 0.0  # 0 = no EMA


def per_sample_loss(out: torch.Tensor, x_start: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """masked_l2 per clip as the JAX trainer takes it (:288-296): the squared
    error over the unmasked frames over their count (at least 1) x C x F."""
    sse = (((out - x_start) ** 2) * mask).sum(dim=(1, 2, 3))
    n = mask.sum(dim=(1, 2, 3)).clamp_min(1.0) * (x_start.shape[1] * x_start.shape[2])
    return sse / n


class PriorTrainer(PreemptionMixin):
    """Trains the MDM prior ('mdm') of a StyleDiffusion model in place."""

    def __init__(self, cfg: PretrainConfig, model: StyleDiffusion, sched: DiffusionSchedule):
        self.sampler = create_named_schedule_sampler(cfg.schedule_sampler, sched.num_timesteps)
        self.cfg = cfg
        self.model = model
        self.sched = sched
        self.device = sched.device
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.step = 0
        self.resume_step = 0
        self._pending = None  # (t, per-sample losses) for the sampler, one step late
        self._resolved_checkpoint = cfg.resume_checkpoint
        if cfg.resume_checkpoint:
            self._load_checkpoint(cfg.resume_checkpoint)

        for name, p in model.named_parameters():
            p.requires_grad_(name.startswith("mdm."))
        named = dict(model.mdm.named_parameters())
        # (parameter, transposed) in the JAX trainer's flax leaf order
        self.params = [(named[key], transposed)
                       for _, key, transposed in mdm_leaves(model.cfg.num_layers)]
        self.opt = torch.optim.AdamW([p for p, _ in self.params], lr=cfg.lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=cfg.weight_decay)
        self._lr_factor = linear_anneal(cfg.lr_anneal_steps)
        self.lr_schedule = torch.optim.lr_scheduler.LambdaLR(self.opt, self._lr_factor)
        if self.resume_step:
            self._load_optimizer_state()
        self.ema = ({k: p.detach().clone() for k, p in named.items()}
                    if cfg.ema_rate > 0 else {})
        if cfg.ema_rate > 0 and self.resume_step:
            self._load_ema_state()

    # ------------------------------------------------------------------
    def train_step(self, batch: dict, t: torch.Tensor, t_weights: torch.Tensor,
                   noise=None, enc=None) -> tuple:
        """One AdamW update of the prior from a batch of tensors on the
        model's device: x_start (B, C, F, T), enc_text (B, clip_dim), mask
        (B, 1, 1, T). noise and enc (the condition after mask_cond) may be
        pinned; else they are drawn. Returns (loss, per-sample losses)."""
        cfg = self.cfg
        x_start = batch["x_start"]
        B = x_start.shape[0]
        accum = max(1, cfg.grad_accum)
        if B % accum:
            raise ValueError(f"grad_accum={accum} must divide the batch size {B}")
        # q_sample and the condition mask once at full batch, so grad_accum
        # changes only the granularity of the model's forward and backward
        if noise is None:
            noise = torch.randn(x_start.shape, generator=self.generator, device=self.device)
        x_t = ddpm.q_sample(self.sched, x_start, t, noise)
        if enc is None:
            enc = mask_cond(batch["enc_text"], cfg.cond_mask_prob, self.generator)
        self.opt.zero_grad(set_to_none=True)
        n = B // accum
        loss = torch.zeros((), device=self.device)
        per_sample = []
        for i in range(accum):
            mb = slice(i * n, (i + 1) * n)
            out = self.model.denoise_prior(x_t[mb], t[mb], enc[mb], deterministic=False,
                                           generator=self.generator)
            ps = per_sample_loss(out, x_start[mb], batch["mask"][mb])
            micro = (ps * t_weights[mb]).mean()
            (micro / accum).backward()
            loss = loss + micro.detach()
            per_sample.append(ps.detach())
        self.opt.step()
        self.lr_schedule.step()
        if cfg.ema_rate > 0:
            self._update_ema()
        return loss / accum, torch.cat(per_sample)

    @torch.no_grad()
    def _update_ema(self):
        r = self.cfg.ema_rate
        for key, p in self.model.mdm.named_parameters():
            e = self.ema[key]
            e.copy_(r * e + (1.0 - r) * p)

    def run_step(self, batch: dict) -> torch.Tensor:
        """One training step on a batch of numpy arrays (x_start, enc_text,
        mask); returns the loss as a 0-d tensor on the device. At a log step
        the loss is read on the host, and step_seconds covers the step up to
        that read."""
        t0 = time.perf_counter()
        batch = {k: torch.as_tensor(np.asarray(v, np.float32), device=self.device)
                 for k, v in batch.items()}
        if self._pending is not None:
            t_prev, losses_prev = self._pending
            self.sampler.update_with_local_losses(t_prev.cpu().numpy(), losses_prev.cpu().numpy())
            self._pending = None
        t, t_weights = self.sampler.sample(self.generator, batch["x_start"].shape[0])
        loss, per_sample = self.train_step(batch, t, t_weights)
        if isinstance(self.sampler, LossSecondMomentResampler):
            self._pending = (t, per_sample)
        self.step += 1
        if self.cfg.log_interval and self.step % self.cfg.log_interval == 0:
            logger.logkv("prior_step", self.step + self.resume_step)
            logger.logkv("prior_loss", float(loss))
            logger.logkv("step_seconds", time.perf_counter() - t0)
        if self.cfg.save_interval and self.step % self.cfg.save_interval == 0:
            self.save_step()
        return loss

    # ------------------------------------------------------------------
    def optimizer_leaves(self) -> list:
        """The optimizer state in the JAX trainer's flat layout over 'mdm'."""
        return optimizer_state_leaves(
            self.opt, self.params,
            self.lr_schedule.last_epoch if self.cfg.lr_anneal_steps else None)

    def save_step(self) -> str:
        """mdm{step:09d}.pt, opt{step:09d}.pt and, with ema_rate,
        ema{step:09d}.pt, from which a run resumes."""
        os.makedirs(self.cfg.save_dir, exist_ok=True)
        step = self.step + self.resume_step
        path = os.path.join(self.cfg.save_dir, f"mdm{step:09d}.pt")
        torch.save(export_mdm(self.model.mdm), path)
        torch.save(self.optimizer_leaves(), os.path.join(self.cfg.save_dir, f"opt{step:09d}.pt"))
        if self.cfg.ema_rate > 0:
            torch.save(self._ema_state(), os.path.join(self.cfg.save_dir, f"ema{step:09d}.pt"))
        logger.log(f"saved prior step checkpoint {path}")
        return path

    def save(self) -> tuple:
        """mdm.pt (for --mdm_path), model_pretrained.pt (the prior's encoder,
        a style-encoder warm start) and, with ema_rate, mdm_ema.pt."""
        os.makedirs(self.cfg.save_dir, exist_ok=True)
        mdm_path = os.path.join(self.cfg.save_dir, "mdm.pt")
        torch.save(export_mdm(self.model.mdm), mdm_path)
        warm_path = os.path.join(self.cfg.save_dir, "model_pretrained.pt")
        torch.save(export_encoder(self.model.mdm.seqTransEncoder), warm_path)
        if self.cfg.ema_rate > 0:
            torch.save(self._ema_state(), os.path.join(self.cfg.save_dir, "mdm_ema.pt"))
        logger.log(f"saved prior checkpoints {mdm_path} / {warm_path}")
        return mdm_path, warm_path

    def _ema_state(self) -> dict:
        return {k: v.detach().float().cpu().clone() for k, v in self.ema.items()}

    def _load_prior(self, path: str) -> dict:
        """A reference-layout prior checkpoint as the MDM's state dict."""
        sd = torch.load(path, map_location="cpu", weights_only=False)
        state = from_torch_state_dict(sd, self.model.cfg, part="mdm")
        return {k[len("mdm."):]: v for k, v in state.items()}

    def _load_checkpoint(self, path: str):
        if os.path.isdir(path):
            found = find_resume_checkpoint(path, "mdm")
            if found is None:
                logger.log(f"no mdm step checkpoint in {path}; fresh start")
                return
            path = found
        self._resolved_checkpoint = path
        digits = os.path.basename(path)[len("mdm"): len("mdm") + 9]
        self.resume_step = int(digits) if digits.isdigit() else 0
        logger.log(f"resuming prior from {path} (step {self.resume_step})")
        self.model.mdm.load_state_dict(self._load_prior(path))

    def _sibling(self, prefix: str) -> str:
        return os.path.join(os.path.dirname(self._resolved_checkpoint),
                            f"{prefix}{self.resume_step:09d}.pt")

    def _load_optimizer_state(self):
        """opt{step}.pt in the JAX trainer's layout; without a readable one,
        fresh moments with the LR schedule at the resumed step (Adam's bias
        correction restarts, as in the JAX trainer's _seed_opt_counts)."""
        path = self._sibling("opt")
        try:
            leaves = torch.load(path, map_location="cpu", weights_only=False)
            position = load_optimizer_state_leaves(self.opt, self.params, leaves)
            logger.log(f"loaded optimizer state from {path}")
        except (OSError, ValueError, RuntimeError) as e:
            logger.log(f"optimizer state unavailable ({e}): fresh moments, LR schedule at "
                       f"step {self.resume_step}")
            position = self.resume_step
        set_schedule_position(self.lr_schedule, position, self._lr_factor)

    def _load_ema_state(self):
        """ema{step}.pt; without one the EMA starts from the loaded prior."""
        path = self._sibling("ema")
        if not os.path.exists(path):
            logger.log("no EMA checkpoint; EMA starts from the prior's weights")
            return
        for k, v in self._load_prior(path).items():
            self.ema[k].copy_(v)
        logger.log(f"loaded EMA state from {path}")
