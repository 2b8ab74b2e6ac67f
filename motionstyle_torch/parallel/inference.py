"""Batched samplers with the interface the serving engine uses.

Counterpart of motionstyle/parallel/inference.py. The engine calls make_run,
n_live_steps, needs_step_noise, prepare_params and __call__:

  - Sampler: one card;
  - ShardedSampler: the same over a mesh (parallel/mesh.py). Each data rank
    samples its rows of the batch and the results are all-gathered, so
    every rank returns the whole batch; its draws are its rows of the
    global batch's (mesh.batch_rows), so the samples equal one device's.
    With 'model' > 1 the encoder layers are split Megatron-style
    (mesh.TensorParallelEncoderLayer). Under cfg.fused or cfg.quant_int8
    the kernels run instead on every rank with the whole weights (kernel 1
    or 2 on each data rank's rows), as GSPMD gathers the weights of the
    JAX package's Pallas call under --model_parallel. parallel_window
    serves through the Picard sampler, forecast_stride through the
    forecast sampler. A DDPM chain with fused_update (kernel 3) draws its
    noise in the kernel from each element's place in the rank's own rows,
    so there a data rank's noise is not its rows of one device's;
  - data_parallel_sample: one sample_loop call with the batch over 'data'.

Every rank of the mesh must make the same calls in the same order: the
server's rank 0 broadcasts each device batch to the others
(cli/serve.py).
"""
from __future__ import annotations

import contextlib
import copy
from typing import Callable, Optional

import torch
import torch.distributed as dist

from motionstyle_torch import tracing
from motionstyle_torch.diffusion import sampling
from motionstyle_torch.diffusion.ddpm import Inpainting
from motionstyle_torch.diffusion.schedule import DiffusionSchedule
from motionstyle_torch.parallel import mesh as mesh_lib


def _as_tensor(a, device, dtype=torch.float32):
    tracing.count_h2d(a, device, dtype)
    return None if a is None else torch.as_tensor(a, dtype=dtype, device=device)


def item_noise(seeds, item_shape: tuple, device, n_steps: int = 0):
    """(noise (B, ...), step_noise (S, B, ...) or None) from per-item seeds:
    item i's initial noise and then its n_steps-step noise stack come from
    its own torch.Generator on `device` seeded with seeds[i]. The span
    sampler.item_noise."""
    with tracing.span("sampler.item_noise"):
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
        Returns the samples on the device. Putting the inputs on the device
        is the span sampler.inputs, its bytes the counter copy.h2d_bytes."""
        dev = self.device
        with tracing.span("sampler.inputs"):
            init_image = _as_tensor(batch.get("init_image"), dev)
            shape = tuple(batch["shape"]) if "shape" in batch else tuple(init_image.shape)
            cond = {k: _as_tensor(v, dev) for k, v in batch.get("cond", {}).items()}
            inpainting = batch.get("inpainting")
            if inpainting is not None:
                inpainting = Inpainting(*(_as_tensor(a, dev) for a in inpainting))
            noise = _as_tensor(batch.get("noise"), dev)
            step_noise = _as_tensor(batch.get("step_noise"), dev)
        return self.make_run(shape)(
            self.params if params is None else params, init_image, cond, inpainting,
            noise, step_noise, batch.get("item_seeds"), generator)


# the forecast sampler takes these of sample_loop's kwargs (JAX :48-52)
FORECAST_KWARGS = {"method", "skip_timesteps", "stop_timesteps", "clip_denoised", "eta",
                   "sigma_small", "order", "step_noise", "remat"}


def place_for_serving(model, mesh):
    """The model laid out for sampling on `mesh`: with 'model' > 1 a copy
    whose encoder layers are split over that dim, unless the model runs
    the fused kernels (cfg.fused or cfg.quant_int8), which take the whole
    weights on every rank. Without a model dim, the model itself."""
    if model is None or mesh is None or mesh_lib.axis_size(mesh, "model") == 1:
        return model
    cfg = getattr(model, "cfg", None)
    if cfg is not None and (cfg.fused or cfg.quant_int8):
        return model
    return mesh_lib.shard_tensor_parallel(copy.deepcopy(model),
                                          mesh_lib.axis_group(mesh, "model"))


def _gather_rows(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every data rank's rows (along dim) in rank order, on every rank."""
    n = mesh_lib.axis_size(mesh, "data")
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=mesh_lib.axis_group(mesh, "data"))
    return torch.cat(parts, dim=dim)


class ShardedSampler(Sampler):
    """Data-parallel (and tensor-parallel) batched sampler over a mesh; with
    mesh=None it runs on one card. model_fn_builder(params) ->
    model_fn(x, t_orig, cond); `params` is the model module."""

    def __init__(self, mesh, sched: DiffusionSchedule, model_fn_builder: Callable, params,
                 parallel_window: int = 0, forecast_stride: int = 1, **sample_kwargs):
        """parallel_window > 0: each call runs the Picard-parallel sampler
        (diffusion/parallel_sampling.py) with that window; forecast_stride >
        1: the forecast sampler (diffusion/forecast_sampling.py), which
        takes a subset of sample_loop's kwargs (checked here)."""
        if parallel_window > 0 and forecast_stride > 1:
            raise ValueError("parallel_window and forecast_stride are mutually exclusive")
        if forecast_stride > 1:
            unsupported = set(sample_kwargs) - FORECAST_KWARGS
            if unsupported:
                raise ValueError(
                    f"forecast_stride does not support kwargs {sorted(unsupported)}")
        super().__init__(sched, model_fn_builder, place_for_serving(params, mesh),
                         **sample_kwargs)
        self.mesh = mesh
        self.parallel_window = parallel_window
        self.forecast_stride = forecast_stride

    @classmethod
    def min_latency(cls, mesh, sched: DiffusionSchedule, model_fn_builder: Callable, params):
        """The demo's DDIM skip-14 inpainting chain stopped at t=4 (the
        dump[-5] pick in 2 denoiser calls, sampling.min_latency_plan); take
        [-1] of the returned x0 stack."""
        return cls(mesh, sched, model_fn_builder, params, method="ddim",
                   skip_timesteps=14, stop_timesteps=4, dump_all_xstart=True)

    def prepare_params(self, encoder_state: dict):
        """A named style's model (Sampler.prepare_params) laid out on the
        mesh as the served model is."""
        view = style_view(self.params, encoder_state)
        if mesh_lib.tensor_parallel_layers(self.params):
            mesh_lib.shard_tensor_parallel(view.style_encoder,
                                           mesh_lib.axis_group(self.mesh, "model"))
        return view

    def _loop(self, model_fn, cond, generator, shape, init_image, inpainting, noise,
              step_noise):
        kw = self.sample_kwargs
        if self.parallel_window > 0:
            from motionstyle_torch.diffusion.parallel_sampling import parallel_sample_loop

            if noise is not None or step_noise is not None:
                raise ValueError("per-item pinned noise is not supported with parallel_window")
            sample, _ = parallel_sample_loop(
                self.sched, model_fn, cond, generator, shape=shape, init_image=init_image,
                inpainting=inpainting, window=self.parallel_window,
                **{k: v for k, v in kw.items() if k != "remat"})
            return sample
        if self.forecast_stride > 1:
            from motionstyle_torch.diffusion.forecast_sampling import forecast_sample_loop

            return forecast_sample_loop(
                self.sched, model_fn, cond, generator, shape=shape, init_image=init_image,
                inpainting=inpainting, stride=self.forecast_stride, noise=noise,
                **{k: v for k, v in kw.items() if k != "remat"},
                **({} if step_noise is None else {"step_noise": step_noise}))
        return sampling.sample_loop(
            self.sched, model_fn, cond, generator, shape=shape, init_image=init_image,
            inpainting=inpainting, noise=noise, step_noise=step_noise, **kw)

    def make_run(self, shape: tuple) -> Callable:
        """run(params, init_image, cond, inpainting, noise, step_noise,
        item_seeds, generator) over the whole batch of `shape`: each data
        rank takes its rows, draws them as the global batch's rows (or from
        their items' seeds) and the results are gathered."""
        shape = tuple(shape)
        rows = mesh_lib.data_rows(self.mesh, shape[0]) if self.mesh is not None \
            else (0, shape[0])
        a, b = rows
        dump = bool(self.sample_kwargs.get("dump_all_xstart"))

        def mine(x, dim=0):
            return None if x is None else x.narrow(dim, a, b - a)

        def run(params, init_image, cond, inpainting, noise, step_noise, item_seeds,
                generator):
            local = (b - a,) + shape[1:]
            if item_seeds is not None:
                noise, step_noise = self.item_noise(list(item_seeds)[a:b], shape[1:])
            else:
                noise, step_noise = mine(noise), mine(step_noise, 1)
            if inpainting is not None:
                inpainting = Inpainting(*(mine(t) if t.shape[0] == shape[0] else t
                                          for t in inpainting))
            drawing = contextlib.nullcontext() if b - a == shape[0] else \
                mesh_lib.batch_rows(a, b, shape[0])
            with drawing:
                out = self._loop(self.model_fn_builder(params),
                                 {k: mine(v) for k, v in cond.items()}, generator, local,
                                 mine(init_image), inpainting, noise, step_noise)
            return out if self.mesh is None else _gather_rows(out, self.mesh, 1 if dump else 0)

        return run


def data_parallel_sample(mesh, sched: DiffusionSchedule, model_fn, cond: dict,
                         generator: Optional[torch.Generator], shape: tuple, **kwargs):
    """One sample_loop with the batch over the mesh's 'data' dim; every rank
    returns the whole batch, equal to one device's."""
    batch = {"shape": shape, "cond": cond}
    for name in ("init_image", "inpainting"):
        if kwargs.get(name) is not None:
            batch[name] = kwargs[name]
        kwargs.pop(name, None)
    return ShardedSampler(mesh, sched, lambda params: model_fn, None, **kwargs)(batch, generator)
