"""The few-shot style finetune loss: a differentiable DDIM/DDPM unroll whose
every x0 prediction is pulled toward the style example, plus a cosine
between the caption's text features and the motion encoder's embedding of a
denoised dataset clip ("semantic guidance").

Counterpart of motionstyle/diffusion/losses.py (parity:
gaussian_diffusion.py:1317-1399, few_shot_style_finetune_losses):
  - the denoise forward at a sampled t on the dataset batch feeds only the
    semantic-guidance branch, through the motion encoder;
  - the unroll starts from the neutral content motion with skip_steps under
    the inpainting diffusion, each x0 prediction in the graph and the carried
    sample detached between steps (sampling.sample_loop differentiable);
  - rot_mse = masked L2 of all dumped x0 predictions against the style target;
  - loss = rot_mse.mean() + ls_weight * (1 - cos(text_features, mu)).

parallel_unroll replaces the sequential unroll by the Picard-parallel one
(losses.py:140-195): the chain's states solved gradient-free in a few
batched sweeps (diffusion/parallel_sampling.py), then one differentiable
forward over all S*B (state, t) rows. The sequential unroll detaches the
carried sample between steps, so its gradients too flow only through each
step's own forward at a detached input: the two agree up to the Picard
tolerance (for DDIM with eta=0, the finetune's default, up to tol_floor).
Its terms also hold "picard_sweeps", the sweeps the states took.

As the reference and the JAX package, the t2m noise is uniform (th.rand_like,
gaussian_diffusion.py:1332), not Gaussian. `noise_t2m` and `noise` pin the
two draws (the unroll's initial noise), as sample_loop's `noise=` does, so a
test replays the JAX package's draws.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from motionstyle_torch.diffusion import ddpm, sampling
from motionstyle_torch.diffusion.ddpm import Inpainting, ModelFn
from motionstyle_torch.diffusion.parallel_sampling import (
    parallel_sample_loop, tile_cond, tile_inpainting)
from motionstyle_torch.diffusion.schedule import DiffusionSchedule
from motionstyle_torch.parallel.mesh import draw_rows

_COS_EPS = 1e-6


def cosine_guidance_loss(text_features: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """mean(1 - cos) after explicit L2 normalisation of both sides
    (gaussian_diffusion.py:1382-1389: normalize, then CosineSimilarity with
    eps=1e-6)."""
    f = text_features / text_features.norm(dim=-1, keepdim=True)
    m = mu / mu.norm(dim=-1, keepdim=True)
    denom = torch.clamp(f.norm(dim=-1) * m.norm(dim=-1), min=_COS_EPS)
    return (1.0 - (f * m).sum(-1) / denom).mean()


def few_shot_style_finetune_loss(
    sched: DiffusionSchedule,
    model_fn: ModelFn,
    x_start: torch.Tensor,
    t: torch.Tensor,
    x_content_start: torch.Tensor,
    x_style_start: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    mask: torch.Tensor,
    cond_style: dict,
    cond_t2m: dict,
    inpainting_style: Optional[Inpainting],
    inpainting_t2m_mask: Optional[torch.Tensor],
    skip_steps: int = 700,
    use_ddim: bool = True,
    semantic_guidance: bool = True,
    motion_enc_fn: Optional[Callable[[torch.Tensor, dict], torch.Tensor]] = None,
    text_features: Optional[torch.Tensor] = None,
    ls_weight: float = 10.0,
    noise_t2m: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    parallel_unroll: bool = False,
    model_fn_t2m: Optional[ModelFn] = None,
) -> dict:
    """The loss terms. x_start: dataset batch (B, C, 1, T), the semantic
    branch's input; x_content_start: the neutral content (the unroll's warm
    start); x_style_start: the style example (the target). t: (B,) respaced
    timesteps for the semantic branch. skip_steps is in original timesteps
    and, with use_ddim, rescaled onto the respaced grid as the reference
    does (:1345). Unpinned draws come from `generator`. model_fn_t2m runs
    the semantic branch's forward in model_fn's place when given (a data
    rank seeds that forward from the global batch's first timestep)."""
    terms: dict = {}
    if semantic_guidance:
        if motion_enc_fn is None or text_features is None:
            raise ValueError("semantic guidance needs motion_enc_fn and text_features")
        if noise_t2m is None:
            noise_t2m = draw_rows(lambda shape: torch.rand(shape, generator=generator,
                                                           device=x_start.device), x_start.shape)
        inp_t2m = None if inpainting_t2m_mask is None else Inpainting(inpainting_t2m_mask, x_start)
        x_t = ddpm.q_sample(sched, x_start, t, noise_t2m, inpainting=inp_t2m)
        mu = motion_enc_fn((model_fn_t2m or model_fn)(x_t, sched.timestep_map[t], cond_t2m),
                           cond_t2m)
        terms["text_cosine"] = cosine_guidance_loss(text_features, mu)

    if use_ddim:
        method, skip = "ddim", int(skip_steps / sched.original_num_steps * sched.num_timesteps)
    else:
        method, skip = "ddpm", skip_steps
    if parallel_unroll:
        xstarts, sweeps = _parallel_unroll_xstarts(
            sched, model_fn, cond_style, generator, init_image=x_content_start,
            method=method, skip=skip, inpainting=inpainting_style, noise=noise)
        terms["picard_sweeps"] = torch.tensor(float(sweeps))
    else:
        xstarts = sampling.sample_loop(
            sched, model_fn, cond_style, generator, shape=tuple(x_content_start.shape),
            noise=noise, init_image=x_content_start, method=method, skip_timesteps=skip,
            clip_denoised=False, inpainting=inpainting_style, dump_all_xstart=True,
            differentiable=True, remat=True)  # (steps, B, C, 1, T)

    flat = lambda a: a.reshape((-1,) + tuple(a.shape[2:]))  # noqa: E731
    target = x_style_start[None].expand(xstarts.shape)
    step_mask = mask[None].expand((xstarts.shape[0],) + tuple(mask.shape))
    terms["rot_mse"] = ddpm.masked_l2(flat(target), flat(xstarts), flat(step_mask))
    loss = terms["rot_mse"].mean()
    if semantic_guidance:
        loss = loss + terms["text_cosine"] * ls_weight
    terms["loss"] = loss
    return terms


def _parallel_unroll_xstarts(sched: DiffusionSchedule, model_fn: ModelFn, cond: dict,
                             generator: Optional[torch.Generator], *,
                             init_image: torch.Tensor, method: str, skip: int,
                             inpainting: Optional[Inpainting],
                             noise: Optional[torch.Tensor] = None) -> tuple:
    """The Picard-parallel replacement of the differentiable sequential
    unroll: (1) the chain's per-step states from parallel_sample_loop
    (window min(64, S), gradient-free), detached; (2) one differentiable
    p_mean_variance over the S*B rows with cond and the inpainting tiled.
    Returns the x0 predictions (S, B, C, 1, T) in execution order and the
    number of Picard sweeps."""
    shape = tuple(init_image.shape)
    S = sched.num_timesteps - skip
    _, sweeps, states = parallel_sample_loop(
        sched, model_fn, cond, generator, shape=shape, noise=noise, init_image=init_image,
        method=method, skip_timesteps=skip, inpainting=inpainting, window=min(64, S),
        dump_states=True)
    states = states.detach()
    B = shape[0]
    t_flat = torch.arange(S - 1, -1, -1, device=states.device).repeat_interleave(B)
    pmv = ddpm.p_mean_variance(sched, model_fn, states.reshape((S * B,) + shape[1:]), t_flat,
                               tile_cond(cond, S), clip_denoised=False,
                               inpainting=tile_inpainting(inpainting, S))
    return pmv.pred_xstart.reshape((S, B) + shape[1:]), sweeps
