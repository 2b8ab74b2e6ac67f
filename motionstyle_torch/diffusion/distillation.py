"""Progressive distillation of the diffusion prior (Salimans & Ho, ICLR 2022,
"Progressive Distillation for Fast Sampling of Diffusion Models").

The port's copy of motionstyle/diffusion/distillation.py. Each stage trains
a student, started from the teacher, whose ONE deterministic DDIM step
matches TWO teacher DDIM steps, halving the sampling grid per stage
(N -> N/2 -> ...). Grids of >= 4 steps are the supported ladder: the
respaced grid tops out at original step T - T/N, so very short grids train
on near-clean marginals while sampling feeds pure noise there; run_stage
warns when a stage crosses that line.

Grid alignment: make_schedule(name, T, f"ddim{N}") keeps the original steps
range(0, T, T//N) and the respaced betas keep alphas_cumprod at those steps,
so the student grid (N/2 steps) is every second index of the teacher grid,
and every coefficient of both comes from the TEACHER schedule.

Math (x0 parameterisation, eta=0 DDIM, sampling.py's _ddim_update): one step
from grid index t is
    x_prev = a_prev * x0 + (s_prev / s_t) * (x_t - a_t * x0),
with a = sqrt(alphas_cumprod), s = sqrt(1 - alphas_cumprod). Running the
teacher twice from index t_hi = 2j gives x_lo at teacher index 2j-2, the
student's next grid point. The student's x0 target is the exact inversion

    x0_tgt = (x_lo - r * x_t) / (a_lo - r * a_hi),   r = s_lo / s_hi,

so a perfect student reproduces the two-step teacher output. At j = 0 the
tables give a_lo = 1, s_lo = 0 and the target is x_lo itself. Loss: the
truncated-SNR weight max(acp/(1-acp), 1) (paper eq. 10) on the masked L2.

Only the prior ('mdm') trains: AdamW(lr, weight_decay, betas (0.9, 0.999),
eps 1e-8), fresh at every stage, as the JAX distiller's optax.adamw. The
teacher is a copy of the student's prior made at the start and after every
stage. The student forward is the prior's deterministic forward under a
gradient: the plain layers, whose self-attention takes kernel 4 on the card
under MOTIONSTYLE_PALLAS_ATTN=1 (ops/attention.py; its autograd Function
gives the backward). The fused inference layers (kernels 1 and 2) have no
backward, as the JAX package's Pallas layers have none, so a model built
with fused or quant_int8 is refused before any step. Randomness: one
torch.Generator on the model's device, seeded from the config, draws each
step's student indices j and then its noise; the draws differ from the JAX
distiller's PRNG keys, and stage_loss takes both pinned.
"""
from __future__ import annotations

import copy
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from motionstyle_torch.diffusion import ddpm
from motionstyle_torch.diffusion.schedule import DiffusionSchedule, make_schedule
from motionstyle_torch.models.denoiser import StyleDiffusion
from motionstyle_torch.models.params import export_mdm
from motionstyle_torch.train import logging as logger

ModelFn = Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]


def ddim_step(sched: DiffusionSchedule, model_fn: ModelFn, x: torch.Tensor,
              t: torch.Tensor, cond: dict) -> tuple:
    """One eta=0 DDIM update on grid index t; returns (x_prev, x0_pred).
    The math of sampling.py's _ddim_update at eta=0, the t == 0 boundary
    included (alphas_cumprod_prev[0] = 1 returns x0 exactly)."""
    x0 = model_fn(x, sched.timestep_map[t], cond)
    a = sched.extract(sched.sqrt_alphas_cumprod, t, x.ndim)
    s = sched.extract(sched.sqrt_one_minus_alphas_cumprod, t, x.ndim)
    acp_prev = sched.extract(sched.alphas_cumprod_prev, t, x.ndim)
    eps = (x - a * x0) / s
    return torch.sqrt(acp_prev) * x0 + torch.sqrt(1.0 - acp_prev) * eps, x0


@torch.no_grad()
def distill_target(sched: DiffusionSchedule, teacher_fn: ModelFn, x_t: torch.Tensor,
                   j: torch.Tensor, cond: dict) -> torch.Tensor:
    """The student's x0 target at STUDENT grid index j (teacher index 2j),
    (B,) per clip: the teacher runs two DDIM steps (2j -> 2j-1 -> 2j-2) and
    the student's single step is inverted; every coefficient comes from the
    teacher schedule. No gradient reaches it."""
    t_hi = 2 * j
    t_mid = (t_hi - 1).clamp_min(0)
    x_mid, _ = ddim_step(sched, teacher_fn, x_t, t_hi, cond)
    x_lo, _ = ddim_step(sched, teacher_fn, x_mid, t_mid, cond)
    a_hi = sched.extract(sched.sqrt_alphas_cumprod, t_hi, x_t.ndim)
    s_hi = sched.extract(sched.sqrt_one_minus_alphas_cumprod, t_hi, x_t.ndim)
    acp_lo = sched.extract(sched.alphas_cumprod_prev, t_mid, x_t.ndim)
    a_lo, s_lo = torch.sqrt(acp_lo), torch.sqrt(1.0 - acp_lo)
    r = s_lo / s_hi
    denom = a_lo - r * a_hi  # > 0: the noise strictly decreases along the grid
    return (x_lo - r * x_t) / denom


def snr_weight(sched: DiffusionSchedule, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Truncated-SNR loss weight max(acp/(1-acp), 1) (paper eq. 10)."""
    acp = sched.extract(sched.alphas_cumprod, t, ndim)
    return torch.clamp(acp / (1.0 - acp), min=1.0)


@dataclass
class DistillConfig:
    save_dir: str
    lr: float = 1e-4
    weight_decay: float = 0.0
    steps_per_stage: int = 400
    log_interval: int = 50
    seed: int = 10
    # > 0: guided distillation: the ORIGINAL teacher runs classifier-free
    # guided (ddpm.cfg_model_fn at this scale) inside the first stage's
    # targets; later stages distill plain (stage_guidance). Sampling any
    # student needs no guidance (one denoiser call a step).
    guidance: float = 0.0


class ProgressiveDistiller:
    """Distills the prior ('mdm') of a StyleDiffusion stage by stage: teacher
    grid N -> student grid N/2, the student becoming the next teacher. The
    model trains in place; everything but its prior stays frozen."""

    def __init__(self, cfg: DistillConfig, model: StyleDiffusion, noise_schedule: str,
                 diffusion_steps: int):
        if model.cfg.fused or model.cfg.quant_int8:
            raise ValueError(
                "distillation differentiates the prior's forward, and the fused inference "
                "layers (--fused, --quant_int8) have no backward (nor do the JAX package's "
                "Pallas layers, whose distill_prior fails at its first step); run it without "
                "them")
        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device
        self.noise_schedule = noise_schedule
        self.diffusion_steps = diffusion_steps
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._stage_no = 0
        for name, p in model.named_parameters():
            p.requires_grad_(name.startswith("mdm."))
        self.teacher = self._copy_prior()
        self.opt = self._optimizer()

    def _copy_prior(self):
        teacher = copy.deepcopy(self.model.mdm)
        for p in teacher.parameters():
            p.requires_grad_(False)
        return teacher

    def _optimizer(self) -> torch.optim.Optimizer:
        return torch.optim.AdamW(self.model.mdm.parameters(), lr=self.cfg.lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=self.cfg.weight_decay)

    def stage_sched(self, n: int) -> DiffusionSchedule:
        """The n-step DDIM grid of the base schedule (the base itself at n = T)."""
        respacing = None if n == self.diffusion_steps else f"ddim{n}"
        return make_schedule(self.noise_schedule, self.diffusion_steps, respacing,
                             device=self.device)

    def stage_guidance(self, stage_idx: int) -> float:
        """The CFG scale on the TEACHER at a halving stage: the original
        teacher's only. From stage 1 on the teacher is the previous student,
        whose plain conditional forward already bakes in the guided map;
        guiding it again would compound the scale against an unconditional
        branch the loss never trained (Meng et al. 2023 guide the first
        distillation only)."""
        return self.cfg.guidance if stage_idx == 0 else 0.0

    def stage_loss(self, sched: DiffusionSchedule, guidance: float, batch: dict,
                   noise: Optional[torch.Tensor] = None,
                   j: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The distillation loss of one batch (x_start (B, C, F, T), enc_text
        (B, clip_dim), mask (B, 1, 1, T), tensors on the model's device) on
        the teacher grid `sched`, attached to the student's parameters. j
        (B,) student indices and noise are drawn from the generator (j first)
        unless pinned."""
        x0 = batch["x_start"]
        B = x0.shape[0]
        if j is None:
            j = torch.randint(0, sched.num_timesteps // 2, (B,), generator=self.generator,
                              device=self.device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=self.generator, device=self.device)
        t_hi = 2 * j
        x_t = ddpm.q_sample(sched, x0, t_hi, noise)
        cond = {"enc_text": batch["enc_text"]}

        def teacher_fn(x, t, c):
            return self.teacher(x, t, c["enc_text"])

        if guidance > 0:
            teacher_fn = ddpm.cfg_model_fn(
                teacher_fn, torch.full((B,), guidance, dtype=torch.float32, device=self.device))
        x0_tgt = distill_target(sched, teacher_fn, x_t, j, cond)
        out = self.model.denoise_prior(x_t, sched.timestep_map[t_hi], cond["enc_text"])
        w = snr_weight(sched, t_hi, x0.ndim)
        mask = batch["mask"]
        sse = (w * (out - x0_tgt) ** 2 * mask).sum(dim=(1, 2, 3))
        n = mask.sum(dim=(1, 2, 3)).clamp_min(1.0) * (x0.shape[1] * x0.shape[2])
        return (sse / n).mean()

    def stage_step(self, sched: DiffusionSchedule, guidance: float, batch: dict,
                   **pinned) -> torch.Tensor:
        """One AdamW update of the student; returns the loss (0-d, detached)."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.stage_loss(sched, guidance, batch, **pinned)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def run_stage(self, n_teacher: int, data) -> float:
        """One halving stage: distill the n_teacher-step teacher into an
        (n_teacher // 2)-step student over `data`, a re-iterable of
        (motion, cond) with cond['enc_text'] (B, clip_dim) and cond['mask']
        (B, 1, 1, T) (cli/distill_prior.py), cycled until the stage's budget.
        Returns the last loss; afterwards the student is the new teacher."""
        if n_teacher % 2 or n_teacher < 2:
            raise ValueError(f"a teacher grid of {n_teacher} steps cannot be halved")
        n_student = n_teacher // 2
        # the respaced grid tops out at original step T - T/N: sampling the
        # student feeds pure N(0, 1) at that index, which is in distribution
        # only while alphas_cumprod there is ~0
        top_acp = float(self.stage_sched(n_student).alphas_cumprod[-1])
        if top_acp > 0.05:
            print(f"WARNING: {n_student}-step grid tops out at alphas_cumprod {top_acp:.3f} "
                  "— sampling this student from pure noise is out of its training "
                  "distribution; grids of >= 4 steps are the supported ladder")
        sched = self.stage_sched(n_teacher)
        guidance = self.stage_guidance(self._stage_no)
        self._stage_no += 1
        self.opt = self._optimizer()
        loss = None
        step = 0
        while step < self.cfg.steps_per_stage:
            yielded = False
            for motion, cond in data:
                yielded = True
                if step >= self.cfg.steps_per_stage:
                    break
                t0 = time.perf_counter()
                batch = {"x_start": motion, "enc_text": cond["enc_text"], "mask": cond["mask"]}
                batch = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                         for k, v in batch.items()}
                loss = self.stage_step(sched, guidance, batch)
                if self.cfg.log_interval and step % self.cfg.log_interval == 0:
                    loss_f = float(loss)  # the host waits for the card at log steps only
                    print(f"distill[{n_teacher}->{n_student}] step[{step}]: loss[{loss_f:0.5f}]")
                    logger.logkv(f"distill_{n_teacher}_loss", loss_f)
                    logger.logkv("step_seconds", time.perf_counter() - t0)
                    logger.dumpkvs()
                step += 1
            if not yielded:
                raise ValueError("data yielded no batches: run_stage cycles its iterator "
                                 "until the stage budget, so it must be re-iterable")
        self.teacher = self._copy_prior()
        return float("nan") if loss is None else float(loss)

    def save(self, n_steps: int) -> str:
        """The current student as save_dir/mdm_{n_steps}step.pt in the
        reference layout (models.params.export_mdm), loadable by either
        package's --mdm_path; sample it with the ddim{n_steps} grid."""
        os.makedirs(self.cfg.save_dir, exist_ok=True)
        path = os.path.join(self.cfg.save_dir, f"mdm_{n_steps}step.pt")
        torch.save(export_mdm(self.model.mdm), path)
        logger.log(f"saved distilled prior {path}")
        return path
