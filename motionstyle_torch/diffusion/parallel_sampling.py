"""Parallel-in-time diffusion sampling (Picard iteration, ParaDiGMS).

Counterpart of motionstyle/diffusion/parallel_sampling.py (technique: Shih
et al., "Parallel Sampling of Diffusion Models", arXiv:2305.16317). A
sliding window of W timesteps is evaluated as one (W*B)-batch denoiser call
and fixed-point iterated until the window's prefix converges:

    x_j = x_s + sum_{i<j} [ f(x_i, t_i, z_i) - x_i ]

with the per-step noises z_i fixed up front, so the fixed point is the
sequential chain's sample (sampling.sample_loop with the same step noise).
The JAX while_loop becomes a Python loop here: each sweep reads its
converged prefix length on the host.

Noise: the initial noise is drawn from `generator` unless `noise` pins it;
the per-step noise is `step_noise` (S, B, ...) when given (the test hook
shared with sample_loop), none for DDIM with eta=0 (multiplied by sigma =
0), else one (S, B, ...) table drawn from `generator` before the first
sweep, so every sweep sees the same z_p at position p. Composes with
respacing, inpainting, CFG-wrapped model_fns, skip/stop timesteps and
init_image warm starts; not with dump_all_xstart, cond_fn or gradients
(the loop runs under torch.no_grad(); the parallel finetune unroll,
losses._parallel_unroll_xstarts, re-evaluates the dumped states instead).
"""
from __future__ import annotations

from typing import Optional

import torch

from motionstyle_torch.diffusion import ddpm
from motionstyle_torch.diffusion.ddpm import Inpainting, ModelFn
from motionstyle_torch.diffusion.sampling import _ddim_update, _ddpm_update, timestep_indices
from motionstyle_torch.diffusion.schedule import DiffusionSchedule
from motionstyle_torch.parallel.mesh import draw_rows


def tile_batch(a: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    """a repeated n times along dim 0 (jnp.tile's leading-axis form)."""
    if a is None:
        return None
    return a.repeat((n,) + (1,) * (a.ndim - 1))


def tile_cond(cond: dict, n: int) -> dict:
    return {k: tile_batch(v, n) if torch.is_tensor(v) else v for k, v in cond.items()}


def tile_inpainting(inpainting: Optional[Inpainting], n: int) -> Optional[Inpainting]:
    if inpainting is None:
        return None
    return Inpainting(tile_batch(inpainting.mask, n), tile_batch(inpainting.motion, n))


@torch.no_grad()
def parallel_sample_loop(
    sched: DiffusionSchedule,
    model_fn: ModelFn,
    cond: dict,
    generator: Optional[torch.Generator] = None,
    *,
    shape: Optional[tuple] = None,
    noise: Optional[torch.Tensor] = None,
    init_image: Optional[torch.Tensor] = None,
    method: str = "ddpm",
    skip_timesteps: int = 0,
    stop_timesteps: Optional[int] = None,
    clip_denoised: bool = False,
    inpainting: Optional[Inpainting] = None,
    eta: float = 0.0,
    sigma_small: bool = True,
    window: int = 16,
    tol: float = 0.1,
    tol_floor: float = 1e-2,
    max_sweeps: Optional[int] = None,
    step_noise: Optional[torch.Tensor] = None,
    dump_states: bool = False,
):
    """Sample by windowed Picard iteration. Returns (final, sweeps), or with
    dump_states (final, sweeps, states): states (S, B, ...) holds the
    converged pre-transition state of every step in execution order
    (highest t first), the input each denoiser call of the sequential chain
    saw.

    window: timesteps per batched forward. A window position counts as
    converged when its mean-square Picard residual is at most tol^2 *
    (sigma_j^2 + tol_floor^2), sigma_j the DDPM posterior std of the step
    feeding it (0 for DDIM with eta=0: tol_floor alone sets the threshold).
    max_sweeps (default 4 S + 16) forces one position of progress per sweep
    from then on."""
    device = sched.device
    if noise is None:
        assert shape is not None, "need shape when noise is not given"
        img = draw_rows(lambda s: torch.randn(s, generator=generator, device=device), shape)
    else:
        img = noise.to(device=device, dtype=torch.float32)
        shape = tuple(img.shape)

    idx = timestep_indices(sched.num_timesteps, skip_timesteps, stop_timesteps)
    S = len(idx)
    W = min(window, S)
    B = shape[0]
    if step_noise is not None and step_noise.shape[0] != S:
        raise ValueError(f"step_noise covers {step_noise.shape[0]} steps, the chain has {S}")

    if skip_timesteps and init_image is None:
        init_image = torch.zeros_like(img)
    if init_image is not None:
        t0 = torch.full((B,), int(idx[0]), dtype=torch.int64, device=device)
        img = ddpm.q_sample(sched, init_image, t0, img, inpainting=inpainting)

    idx_t = torch.as_tensor(idx.copy(), dtype=torch.int64, device=device)
    is_ddim = method == "ddim"
    deterministic = is_ddim and eta == 0.0
    if step_noise is not None:
        table = step_noise.to(device=device, dtype=torch.float32)
    elif deterministic:
        table = None
    else:
        table = draw_rows(lambda s: torch.randn(s, generator=generator, device=device),
                          (S,) + shape, dim=1)

    # per-position posterior variance for the convergence threshold
    sigma2_all = torch.where(idx_t != 0, torch.exp(sched.posterior_log_variance_clipped[idx_t]),
                             torch.zeros((), device=device))
    if deterministic:
        sigma2_all = torch.zeros_like(sigma2_all)
    thresh_all = tol ** 2 * (sigma2_all + tol_floor ** 2)

    cond_w = tile_cond(cond, W)
    inp_w = tile_inpainting(inpainting, W)
    arange_w = torch.arange(W, device=device)

    def transitions(xs: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """One sequential step applied to all W window states at once (one
        (W*B)-batch denoiser call). xs (W, B, ...); p (W,) clamped positions."""
        x_flat = xs.reshape((W * B,) + shape[1:])
        t_flat = idx_t[p].repeat_interleave(B)
        pmv = ddpm.p_mean_variance(sched, model_fn, x_flat, t_flat, cond_w,
                                   clip_denoised=clip_denoised, inpainting=inp_w,
                                   sigma_small=sigma_small)
        z = torch.zeros_like(x_flat) if table is None else table[p].reshape(x_flat.shape)
        if is_ddim:
            nxt = _ddim_update(sched, pmv, x_flat, t_flat, z, inp_w, eta)
        else:
            nxt = _ddpm_update(pmv, x_flat, t_flat, z, inp_w)
        return nxt.reshape((W, B) + shape[1:])

    max_it = max_sweeps if max_sweeps is not None else 4 * S + 16
    X = img.expand((W + 1,) + shape).clone()  # X[j] ~ x_{s+j}
    states = torch.zeros((S,) + shape, device=device) if dump_states else None
    s, sweeps = 0, 0
    while s < S:
        positions = s + arange_w
        p = positions.clamp(max=S - 1)
        delta = transitions(X[:W], p) - X[:W]
        live = (positions < S).to(delta.dtype).reshape((W,) + (1,) * len(shape))
        delta = delta * live  # positions past the chain's end contribute nothing
        X_new = torch.cat([X[:1], X[:1] + torch.cumsum(delta, dim=0)], dim=0)
        err = ((X_new[1:] - X[1:]) ** 2).mean(dim=tuple(range(1, X.ndim)))
        ok = (err <= thresh_all[p]).to(torch.int64)
        k = W if bool(ok.all()) else int(torch.argmin(torch.cumprod(ok, 0)))  # the prefix
        if sweeps >= max_it:
            k = max(k, 1)  # forced progress
        if states is not None and k:
            n = min(k, S - s)  # positions s..s+k-1 retire with states X_new[0..k-1]
            states[s:s + n] = X_new[:n]
        # slide: X'[i] = X_new[i + k]; past the window reuse the last estimate
        X = X_new[(torch.arange(W + 1, device=device) + k).clamp(max=W)]
        s = min(s + k, S)
        sweeps += 1
    if dump_states:
        return X[0], sweeps, states
    return X[0], sweeps
