"""One-device batched sampler with the interface the serving engine uses.

Counterpart of motionstyle/parallel/inference.py::ShardedSampler without the
mesh: one card. The engine calls make_run, n_live_steps, needs_step_noise,
prepare_params and __call__; multi-device sampling comes with ROADMAP §1
item 11 (torch.distributed).
"""
from __future__ import annotations

import copy
from typing import Callable, Optional

import torch

from motionstyle_torch.diffusion import sampling
from motionstyle_torch.diffusion.ddpm import Inpainting
from motionstyle_torch.diffusion.schedule import DiffusionSchedule


def _as_tensor(a, device, dtype=torch.float32):
    return None if a is None else torch.as_tensor(a, dtype=dtype, device=device)


def item_noise(seeds, item_shape: tuple, device, n_steps: int = 0):
    """(noise (B, ...), step_noise (S, B, ...) or None) from per-item seeds:
    item i's initial noise and then its n_steps-step noise stack come from
    its own torch.Generator on `device` seeded with seeds[i]."""
    inits, steps = [], []
    for seed in seeds:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        inits.append(torch.randn(item_shape, generator=gen, device=device))
        if n_steps:
            steps.append(torch.randn((n_steps,) + tuple(item_shape), generator=gen,
                                     device=device))
    return torch.stack(inits), (torch.stack(steps, dim=1) if steps else None)


def style_view(model, encoder_state: dict):
    """A StyleDiffusion that shares every module of `model` but its style
    encoder, a new one loaded with encoder_state on model's device. With
    the fused layers its kernel-format weights are packed here, so a
    style's first request does not pay for it."""
    src = model.style_encoder
    encoder = type(src)(len(src.layers), src.layers[0].linear1.in_features, src.nhead,
                        src.dim_feedforward, src.dropout)
    encoder.load_state_dict(encoder_state)
    encoder.to(next(src.parameters()).device).train(src.training)
    cfg = model.cfg
    if cfg.fused or cfg.quant_int8:
        encoder.packed_layers(cfg.quant_int8)
    view = copy.copy(model)
    view._modules = dict(model._modules)
    view._modules["style_encoder"] = encoder
    return view


class Sampler:
    """Batched sampler on the schedule's device.

    model_fn_builder(params) -> model_fn(x, t_orig, cond); `params` is
    whatever the builder takes (here the model module)."""

    def __init__(self, sched: DiffusionSchedule, model_fn_builder: Callable,
                 params, **sample_kwargs):
        self.sched = sched
        self.device = sched.device
        self.params = params
        self.model_fn_builder = model_fn_builder
        self.sample_kwargs = sample_kwargs

    def needs_step_noise(self) -> bool:
        """False when the chain never consumes per-step noise: DDIM at eta=0
        multiplies it by sigma = 0."""
        kw = self.sample_kwargs
        return not (kw.get("method") == "ddim" and float(kw.get("eta", 0.0)) == 0.0)

    def n_live_steps(self) -> int:
        """Loop length implied by the skip/stop kwargs."""
        return len(sampling.timestep_indices(
            self.sched.num_timesteps, self.sample_kwargs.get("skip_timesteps", 0),
            self.sample_kwargs.get("stop_timesteps", None)))

    def item_noise(self, seeds, item_shape: tuple):
        """Per-item pinned noise from seeds, drawn on the device: item i's
        initial noise and then its (S, ...) step noise come from its own
        torch.Generator seeded with seeds[i], so they depend on nothing
        else in the batch. Returns (noise (B, ...), step_noise (S, B, ...)
        or None)."""
        return item_noise(seeds, item_shape, self.device,
                          self.n_live_steps() if self.needs_step_noise() else 0)

    def prepare_params(self, encoder_state: dict):
        """A named style's model for a per-call `params` override: a view of
        the served model that shares its frozen prior and semantic modules
        and holds its own copy of the style encoder, loaded with
        `encoder_state` (a TransformerEncoder state dict) on this sampler's
        device. Only the encoder is copied, so each style costs one encoder
        of memory; the copy keeps its own packed-kernel cache, so kernels 1
        and 2 read that style's weights."""
        return style_view(self.params, encoder_state)

    def make_run(self, shape: tuple) -> Callable:
        """The sampler computation for one batch shape: `run(params,
        init_image, cond, inpainting, noise, step_noise, item_seeds,
        generator)`, optional arguments None."""
        shape = tuple(shape)

        def run(params, init_image, cond, inpainting, noise, step_noise,
                item_seeds, generator):
            if item_seeds is not None:
                noise, step_noise = self.item_noise(item_seeds, shape[1:])
            return sampling.sample_loop(
                self.sched, self.model_fn_builder(params), cond, generator,
                shape=shape, init_image=init_image, inpainting=inpainting,
                noise=noise, step_noise=step_noise, **self.sample_kwargs)

        return run

    def __call__(self, batch: dict, generator: Optional[torch.Generator] = None,
                 params=None) -> torch.Tensor:
        """batch: {'shape' | 'init_image' (B, C, 1, T), 'cond': dict,
        optional 'inpainting': Inpainting, 'noise', 'step_noise', or
        'item_seeds' (B,) for per-item pinned noise}; arrays may be numpy.
        Returns the samples on the device."""
        dev = self.device
        init_image = _as_tensor(batch.get("init_image"), dev)
        shape = tuple(batch["shape"]) if "shape" in batch else tuple(init_image.shape)
        cond = {k: _as_tensor(v, dev) for k, v in batch.get("cond", {}).items()}
        inpainting = batch.get("inpainting")
        if inpainting is not None:
            inpainting = Inpainting(*(_as_tensor(a, dev) for a in inpainting))
        return self.make_run(shape)(
            self.params if params is None else params, init_image, cond, inpainting,
            _as_tensor(batch.get("noise"), dev), _as_tensor(batch.get("step_noise"), dev),
            batch.get("item_seeds"), generator)
