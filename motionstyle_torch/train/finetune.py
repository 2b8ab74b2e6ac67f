"""Few-shot style finetuning loop.

Counterpart of motionstyle/train/finetune.py (parity: train/training_loop.py,
TrainInpaintingLoop :43): AdamW on the style encoder only (:97,
parameters_wo_enc), the uniform timestep sampler restricted to the unrolled
range (:240-246), the few-shot style loss (:248-263), the linear LR anneal
(:297-303), checkpoints in the reference layout with the frozen modules
stripped as model{step:09d}.pt (:312-348), resume from the newest checkpoint
(:110-141, :374-382) and a step-boundary save on SIGTERM.

Randomness: one torch.Generator on the model's device, seeded from the
config, draws each step's timesteps, the t2m noise and the unroll's initial
noise. Each denoiser call re-seeds its own generators for dropout and the
condition mask from (a per-step seed, the call's timestep), as the JAX
trainer folds t into its dropout key; a step recomputed under
torch.utils.checkpoint therefore draws the same masks again. A batched
forward over several timesteps (the parallel unroll's) seeds its draws from
its first row's timestep, as the JAX trainer's does.

optax.adamw and torch.optim.AdamW compute the same update: decoupled decay
lr * wd * param, bias-corrected moments, eps added to sqrt(v_hat). So the
optimizer state crosses packages: opt{step:09d}.pt is written in the JAX
trainer's layout (motionstyle/train/finetune.py:343-345), the flat leaf list
of its optax.multi_transform state: Adam's count, mu and nu over the style
encoder's leaves in flax's order and (in, out) kernel layout, then the LR
schedule's count when the LR anneals. The frozen partition holds no leaves.

LoRA (lora_rank > 0, models/lora.py): only the adapter factors train; the
style encoder is frozen with the rest of the model, and AdamW runs over the
factors alone. Each step merges base + (alpha/rank) A@B once and runs every
forward of the step on the merged weights (torch.func.functional_call), so
autograd carries the weight gradients of whichever layer runs (the plain
layers or the training kernels 5-9) into A and B. save() writes the merged
encoder as model{step:09d}.pt, the factors as adapter{step:09d}.pt (the JAX
package's format) and their moments in opt{step:09d}.pt (the JAX trainer's
layout over its 'lora_style' subtree: per site a then b, sites in flax
order). A run resumes from an adapter file, or from a save dir's newest
adapter{step}.pt, onto the base the caller built.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from motionstyle_torch.diffusion import losses
from motionstyle_torch.diffusion.ddpm import Inpainting
from motionstyle_torch.diffusion.resample import UniformSampler
from motionstyle_torch.diffusion.schedule import DiffusionSchedule
from motionstyle_torch.models import lora
from motionstyle_torch.models.denoiser import StyleDiffusion, mask_cond
from motionstyle_torch.models.params import (
    convert_encoder, encoder_leaves, export_style_encoder, flax_to_torch, torch_to_flax)
from motionstyle_torch.parallel import mesh as mesh_lib
from motionstyle_torch.train import checkpoints
from motionstyle_torch.train import logging as logger
from motionstyle_torch.train.preemption import PreemptionMixin

_SEED_MOD = 2 ** 62


@dataclass
class FinetuneConfig:
    save_dir: str
    lr: float = 1e-4
    weight_decay: float = 0.0
    lr_anneal_steps: int = 0
    num_steps: int = 24
    log_interval: int = 1
    save_interval: int = 100
    batch_size: int = 64
    skip_steps: int = 700
    diffusion_steps: int = 1000
    use_ddim: bool = True
    semantic_guidance: bool = True
    ls_weight: float = 10.0
    cond_mask_prob: float = 0.1
    resume_checkpoint: str = ""
    seed: int = 10
    # the Picard-parallel unroll (diffusion/losses.py _parallel_unroll_xstarts):
    # the DDIM chain's states in batched sweeps, gradients through one
    # batched forward
    parallel_unroll: bool = False
    # LoRA adapter finetuning (models/lora.py): rank > 0 trains low-rank
    # factors on the style encoder's dense weights instead of the encoder;
    # alpha 0 means alpha = rank (scale 1)
    lora_rank: int = 0
    lora_alpha: float = 0.0
    # also write the whole trainer state (parameters, Adam's moments, step)
    # as a sharded DCP checkpoint dcp_{step:09d}/ (train/checkpoints.py)
    orbax_checkpoints: bool = False


def parse_resume_step_from_filename(filename: str) -> int:
    """path/to/modelNNNNNNNNN.pt -> NNNNNNNNN; parity: training_loop.py:352."""
    split = filename.split("model")
    if len(split) < 2:
        return 0
    try:
        return int(split[-1].split(".")[0])
    except ValueError:
        return 0


def find_resume_checkpoint(save_dir: str, mode: str = "model") -> Optional[str]:
    """The newest '{mode}NNNNNNNNN.pt' in save_dir; parity: training_loop.py:374."""
    files = [f for f in os.listdir(save_dir) if f.endswith(".pt") and f.startswith(mode)]
    steps = sorted(int(f[len(mode): len(mode) + 9]) for f in files
                   if f[len(mode): len(mode) + 9].isdigit())
    if not steps:
        return None
    return os.path.join(save_dir, f"{mode}{steps[-1]:09d}.pt")


def optimizer_state_leaves(opt: torch.optim.Optimizer, params: list,
                           schedule_count: Optional[int] = None, full=None) -> list:
    """An AdamW's state as the JAX trainers flatten their optax.adamw state:
    [Adam count, mu leaves..., nu leaves..., (the LR schedule's count)] as
    numpy arrays, int32 counts and fp32 moments in flax's layout. params:
    (parameter, transposed) in flax leaf order. full(i, t): the whole
    tensor of parameter i's moment t on a mesh (a collective)."""
    full = full or (lambda i, t: t)
    states = [opt.state.get(p, {}) for p, _ in params]
    count = int(states[0]["step"]) if "step" in states[0] else 0
    moments = [torch_to_flax(full(i, st.get(name, torch.zeros_like(p))), transposed)
               for name in ("exp_avg", "exp_avg_sq")
               for i, ((p, transposed), st) in enumerate(zip(params, states))]
    leaves = [np.asarray(count, np.int32)] + moments
    if schedule_count is not None:
        leaves.append(np.asarray(schedule_count, np.int32))
    return leaves


def load_optimizer_state_leaves(opt: torch.optim.Optimizer, params: list, leaves: list,
                                local=None, shapes=None) -> int:
    """Restore an AdamW's moments and step from optimizer_state_leaves'
    format; returns the LR schedule's count (the Adam count when the leaves
    hold none). On a mesh, shapes[i] is parameter i's whole shape and
    local(i, t) its part of the whole moment t."""
    local = local or (lambda i, t: t.to(params[i][0].device))
    n = len(params)
    if not isinstance(leaves, list) or len(leaves) not in (1 + 2 * n, 2 + 2 * n):
        raise ValueError(f"an optimizer state of {1 + 2 * n} or {2 + 2 * n} leaves "
                         f"(count, mu, nu[, schedule count]) was expected, got "
                         f"{len(leaves) if isinstance(leaves, list) else type(leaves)}")
    count = int(np.asarray(leaves[0]))
    moments = [(flax_to_torch(leaves[1 + i], transposed),
                flax_to_torch(leaves[1 + n + i], transposed))
               for i, (_, transposed) in enumerate(params)]
    for i, ((p, _), (mu, nu)) in enumerate(zip(params, moments)):
        shape = tuple(shapes[i]) if shapes else tuple(p.shape)
        if tuple(mu.shape) != shape or tuple(nu.shape) != shape:
            raise ValueError(f"optimizer leaf {i}: moments of shape {tuple(mu.shape)} for "
                             f"a parameter of shape {shape}")
    for i, ((p, _), (mu, nu)) in enumerate(zip(params, moments)):  # all checked
        opt.state[p] = {"step": torch.tensor(float(count)),
                        "exp_avg": local(i, mu), "exp_avg_sq": local(i, nu)}
    return int(np.asarray(leaves[-1])) if len(leaves) == 2 + 2 * n else count


def set_schedule_position(lr_schedule, position: int, factor) -> None:
    """Move a LambdaLR to `position` updates, its optimizer's LR with it."""
    lr_schedule.last_epoch = position
    for group, base in zip(lr_schedule.optimizer.param_groups, lr_schedule.base_lrs):
        group["lr"] = base * factor(position)
    lr_schedule._last_lr = [group["lr"] for group in lr_schedule.optimizer.param_groups]


def linear_anneal(anneal_steps: int):
    """optax.linear_schedule(lr, 0, anneal_steps) as a factor of the base LR
    (constant without an anneal)."""
    return lambda k: max(0.0, 1.0 - k / anneal_steps) if anneal_steps else 1.0


def _mix(*parts: int) -> int:
    """A generator seed from integers (a fixed polynomial hash)."""
    h = 0
    for p in parts:
        h = (h * 1000003 + int(p)) % _SEED_MOD
    return h


class MeshMixin:
    """What the finetune and pretrain trainers share on a mesh
    (parallel/mesh.py): the placement of the model, the rank's rows of a
    batch and its draws, the gradient mean over 'data', the whole tensors
    of sharded parameters and moments for model*.pt and opt*.pt, and the
    sharded DCP checkpoint (train/checkpoints.py). Without a mesh each is a
    no-op. Every rank calls save() and the gathers in it; global rank 0
    alone writes files.

    The subclass sets self.mesh, self.fsdp, self.model, self.opt,
    self.params ((parameter, transposed) in flax order), self._unit (the
    module its parameters live in, the FSDP unit; None for LoRA factors)
    and self._keys (their names in _unit)."""

    mesh = None
    fsdp = False
    _unit = None
    _keys: list = []
    _shapes: list = []

    def _place(self, unit: torch.nn.Module, keys: list) -> None:
        """Make every rank's model rank 0's, then lay it out on the mesh:
        tensor-parallel layers over 'model', with fsdp `unit` one FSDP2
        unit over 'data'. Records each trained parameter's whole shape."""
        self._unit, self._keys = unit, keys
        named = dict(unit.named_parameters())
        self._shapes = [tuple(named[k].shape) for k in keys]
        if self.mesh is None:
            return
        mesh_lib.replicate(self.model)
        mesh_lib.shard_params(self.model, self.mesh, fsdp=self.fsdp, unit=unit)

    @property
    def dp(self) -> int:
        return mesh_lib.axis_size(self.mesh, "data")

    def _rows(self, batch_size: int) -> Optional[tuple]:
        """(start, stop, batch_size): this rank's rows over 'data', or None
        with one data rank."""
        if self.dp == 1:
            return None
        return mesh_lib.data_rows(self.mesh, batch_size) + (batch_size,)

    @staticmethod
    def _drawing(rows):
        return contextlib.nullcontext() if rows is None else mesh_lib.batch_rows(*rows)

    def _sync_grads(self) -> None:
        """The gradient mean over 'data' (FSDP reduce-scatters its own)."""
        if self.mesh is not None and not self.fsdp:
            mesh_lib.sync_grads([p for g in self.opt.param_groups for p in g["params"]],
                                self.mesh)

    def _data_mean(self, terms: dict) -> dict:
        """Each term's mean over the data ranks: the global batch's value."""
        if self.dp == 1:
            return terms
        keys = sorted(terms)
        flat = torch.stack([terms[k].detach().float().mean() for k in keys])
        torch.distributed.all_reduce(flat, group=mesh_lib.axis_group(self.mesh, "data"))
        return dict(zip(keys, flat / self.dp))

    def _any_rank(self, flag: bool) -> bool:
        """flag on any rank (the preemption signal reaches ranks at different
        steps; all must save at the same step boundary)."""
        if self.mesh is None:
            return flag
        t = torch.tensor([float(flag)], device=self.device)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
        return bool(t.item())

    def _full(self, i: int, t: torch.Tensor) -> torch.Tensor:
        if self._unit is None or self.mesh is None:
            return t
        return mesh_lib.gather_full(self._unit, self._keys[i], t)

    def _local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        p = self.params[i][0]
        if self._unit is None or self.mesh is None:
            return t.to(p.device)
        return mesh_lib.local_like(self._unit, self._keys[i], p, t)

    def _init_moments(self) -> None:
        """Zero moments at Adam count 0 where a parameter has none yet (the
        state AdamW's first step would make)."""
        for p, _ in self.params:
            if not self.opt.state.get(p):
                self.opt.state[p] = {"step": torch.tensor(0.0),
                                     "exp_avg": torch.zeros_like(p),
                                     "exp_avg_sq": torch.zeros_like(p)}

    def _dcp_view(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """What the DCP checkpoint holds of parameter i's tensor t: t itself
        (a replicated tensor, or an FSDP DTensor whose shards each rank
        writes), or for a tensor-parallel shard the whole gathered tensor."""
        if self._unit is not None and self.mesh is not None and \
                mesh_lib.owner_of(self._unit, self._keys[i])[0] is not None:
            return mesh_lib.gather_full(self._unit, self._keys[i], t)
        return t.detach()

    def sharded_state(self) -> tuple:
        """(params, opt_state) for save_sharded: the trained parameters by
        name, and per name Adam's moments, with the Adam and LR-schedule
        counts under '_counts'."""
        self._init_moments()
        params, opt = {}, {}
        for i, (p, _) in enumerate(self.params):
            st = self.opt.state[p]
            params[self._keys[i]] = self._dcp_view(i, p)
            opt[self._keys[i]] = {k: self._dcp_view(i, st[k]) for k in ("exp_avg", "exp_avg_sq")}
        count = self.opt.state[self.params[0][0]]["step"]
        opt["_counts"] = {"adam": torch.as_tensor(count).detach().clone().float(),
                          "schedule": torch.tensor(float(self.lr_schedule.last_epoch))}
        return params, opt

    def save_dcp(self, step: int) -> str:
        params, opt = self.sharded_state()
        return checkpoints.save_sharded(self.cfg.save_dir, step, params, opt)

    def load_sharded(self, path: Optional[str] = None) -> int:
        """Restore parameters, Adam's moments and counts from a DCP
        checkpoint (default: the newest in save_dir) saved at any world size
        or layout; the run continues from its step. Returns the step."""
        path = path or checkpoints.latest_sharded(self.cfg.save_dir)
        if path is None:
            raise FileNotFoundError(f"no {checkpoints.PREFIX}* checkpoint in {self.cfg.save_dir}")
        params, opt = self.sharded_state()
        like = {"params": params, "opt_state": opt, "step": torch.tensor(0, dtype=torch.int64)}
        checkpoints.restore_sharded(path, like)
        with torch.no_grad():
            for i, (p, _) in enumerate(self.params):
                st, key = self.opt.state[p], self._keys[i]
                for dst, src in ((p, params[key]), (st["exp_avg"], opt[key]["exp_avg"]),
                                 (st["exp_avg_sq"], opt[key]["exp_avg_sq"])):
                    if src.data_ptr() != dst.data_ptr():  # a gathered tensor-parallel copy
                        dst.copy_(self._local(i, src))
                st["step"] = opt["_counts"]["adam"].clone()
        set_schedule_position(self.lr_schedule, int(opt["_counts"]["schedule"]), self._lr_factor)
        self.step, self.resume_step = 0, int(like["step"])
        return self.resume_step


class StyleFinetuneTrainer(MeshMixin, PreemptionMixin):
    """Drives few-shot style finetuning of a StyleDiffusion model in place."""

    def __init__(self, cfg: FinetuneConfig, model: StyleDiffusion, sched: DiffusionSchedule,
                 train_platform=None, mesh=None, fsdp: bool = False):
        """mesh: a parallel.mesh DeviceMesh to train on (data parallel, with
        'model' > 1 tensor parallel too); fsdp: shard the style encoder and
        its moments over 'data' (one FSDP2 unit, the encoder stack, whose
        forward gathers the weights the training kernels read)."""
        self.cfg = cfg
        self.mesh = mesh
        self.fsdp = bool(fsdp and mesh is not None)
        if mesh is not None and cfg.lora_rank > 0 and (
                self.fsdp or mesh_lib.axis_size(mesh, "model") > 1):
            raise ValueError("--lora_rank trains on --data_parallel only: the factors are "
                             "merged into whole weights, which --fsdp and --model_parallel "
                             "shard")
        self.model = model
        self.sched = sched
        self.platform = train_platform
        self.device = sched.device
        self.step = 0
        self.resume_step = 0
        self.preempted = False
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._seeds = torch.Generator().manual_seed(cfg.seed)  # per-step seeds, on the host
        self._last_saved_step = None
        self._resolved_checkpoint = cfg.resume_checkpoint
        self._pending_adapter = None
        if cfg.resume_checkpoint:
            self._load_checkpoint(cfg.resume_checkpoint)

        self.lora = None
        if cfg.lora_rank > 0:
            self.lora = self._init_factors()
        for name, p in model.named_parameters():
            p.requires_grad_(self.lora is None and model.is_trainable(name))
        if self.lora is None:
            self._place(model.style_encoder,
                        [key for _, key, _ in encoder_leaves(model.cfg.num_layers)])
        elif mesh is not None:
            mesh_lib.replicate(model)
        trainable = [p for p in model.parameters() if p.requires_grad]
        # (parameter, transposed) of what trains, in the JAX trainer's flax leaf
        # order: the order of opt*.pt. AdamW keeps named_parameters' order, the
        # order of a torch state_dict of the port's earlier layout.
        self.params = self._encoder_params() if self.lora is None else [
            (self.lora[site][name], False)
            for site, _ in lora.adapter_sites(model.cfg.num_layers) for name in ("a", "b")]
        self.opt = torch.optim.AdamW(trainable or [p for p, _ in self.params], lr=cfg.lr,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=cfg.weight_decay)
        self._lr_factor = linear_anneal(cfg.lr_anneal_steps)
        self.lr_schedule = torch.optim.lr_scheduler.LambdaLR(self.opt, self._lr_factor)
        if self.resume_step:
            self._load_optimizer_state()
        if cfg.use_ddim:
            self.t_range = int((cfg.diffusion_steps - cfg.skip_steps) / cfg.diffusion_steps
                               * sched.num_timesteps)
        else:
            self.t_range = cfg.diffusion_steps - cfg.skip_steps
        self.sampler = UniformSampler(sched.num_timesteps)

    # ------------------------------------------------------------------
    def _init_factors(self) -> dict:
        """The LoRA factors as parameters on the model's device: fresh
        (lora.init_lora from a generator of their own, seeded from the config,
        so the steps' draws are those of a run without LoRA) or the resumed
        adapter's, whose rank must be the config's."""
        cfg = self.cfg
        factors = lora.init_lora(self.model.style_encoder.state_dict(), cfg.lora_rank,
                                 torch.Generator().manual_seed(_mix(cfg.seed, 3)))
        if self._pending_adapter is not None:
            factors, saved_alpha = lora.import_lora(self._pending_adapter)
            got = lora.lora_rank(factors)
            if got != cfg.lora_rank:
                raise ValueError(f"resume adapter has rank {got} but --lora_rank is "
                                 f"{cfg.lora_rank}; pass the matching rank")
            if saved_alpha and not cfg.lora_alpha:
                self.cfg = dataclasses.replace(cfg, lora_alpha=saved_alpha)
            self._pending_adapter = None
        return {site: {k: torch.nn.Parameter(v.to(self.device)) for k, v in pair.items()}
                for site, pair in factors.items()}

    @property
    def lora_alpha(self) -> float:
        return self.cfg.lora_alpha or self.cfg.lora_rank

    def effective_weights(self) -> dict:
        """{'style_encoder.<key>': tensor} to run the model with (run_model):
        with LoRA each adapted weight merged with its factors (attached to
        the factors' autograd when grad is enabled); empty without LoRA."""
        if self.lora is None:
            return {}
        encoder = self.model.style_encoder
        base = {key: encoder.get_parameter(key).detach()
                for _, key in lora.adapter_sites(self.model.cfg.num_layers)}
        merged = lora.merge_lora(base, self.lora, self.lora_alpha)
        return {f"style_encoder.{k}": v for k, v in merged.items()}

    def run_model(self, weights: dict, *args, **kwargs):
        """The model's forward with `weights` (effective_weights) in place of
        its own parameters. The model ties no weights, so the swap skips the
        search for tied ones (about 2 ms of host time a call at d=512)."""
        if not weights:
            return self.model(*args, **kwargs)
        return functional_call(self.model, weights, args, kwargs, tie_weights=False)

    def merge_into_model(self) -> None:
        """Write the merged weights into the model's style encoder, so that
        what runs after training (the final resample) runs the merged style.
        A no-op without LoRA."""
        with torch.no_grad():
            for name, v in self.effective_weights().items():
                self.model.get_parameter(name).copy_(v)

    def _model_fn(self, step_seed: int, weights: Optional[dict] = None,
                  t0: Optional[int] = None):
        """model_fn(x, t_orig, cond) of a training forward on `weights`
        (effective_weights; the model's own without): condition dropout and
        layer dropout from generators seeded by (step_seed, t_orig[0]), or
        by (step_seed, t0) when given: the global batch's first timestep,
        which a data rank's own rows may not hold."""
        cfg, dev = self.cfg, self.device
        fixed = t0

        def fn(x, t_orig, cond):
            t0 = int(t_orig[0]) if fixed is None else fixed
            gen_cond = torch.Generator(device=dev).manual_seed(_mix(step_seed, 1, t0))
            gen_drop = torch.Generator(device=dev).manual_seed(_mix(step_seed, 2, t0))
            enc = mask_cond(cond["enc_text"], cfg.cond_mask_prob, gen_cond)
            return self.run_model(weights, x, t_orig, enc, deterministic=False,
                                  generator=gen_drop)

        return fn

    def loss_terms(self, batch: dict, t: torch.Tensor, step_seed: int,
                   t0_t2m: Optional[int] = None, **pinned) -> dict:
        """The few-shot loss of one batch at semantic-branch timesteps t.
        batch: x_start, content, style_target, mask, inp_mask,
        enc_text_style, enc_text_t2m, text_features, and optionally
        inp_mask_t2m and frame_mask_t2m, as tensors on the model's device.
        pinned: noise_t2m / noise for the loss (tests replay other draws).
        With LoRA the encoder is merged here, once for the whole loss.
        t0_t2m: the seeding timestep of the semantic branch's forward (on a
        mesh, the global batch's first; default t[0]'s)."""
        cfg = self.cfg
        weights = self.effective_weights()
        return losses.few_shot_style_finetune_loss(
            self.sched, self._model_fn(step_seed, weights), batch["x_start"], t,
            batch["content"], batch["style_target"], self.generator,
            mask=batch["mask"],
            cond_style={"enc_text": batch["enc_text_style"]},
            cond_t2m={"enc_text": batch["enc_text_t2m"],
                      "frame_mask": batch.get("frame_mask_t2m")},
            # the unroll keeps the style example's masked channels (reference:
            # y['inpainted_motion'] = input_motions, finetune_style_diffusion.py:141)
            inpainting_style=Inpainting(batch["inp_mask"], batch["style_target"]),
            inpainting_t2m_mask=batch.get("inp_mask_t2m"),
            skip_steps=cfg.skip_steps, use_ddim=cfg.use_ddim,
            semantic_guidance=cfg.semantic_guidance,
            motion_enc_fn=(lambda motion, cond: self.model.encode_motion(
                motion, cond.get("frame_mask"))) if cfg.semantic_guidance else None,
            text_features=batch.get("text_features"), ls_weight=cfg.ls_weight,
            parallel_unroll=cfg.parallel_unroll,
            model_fn_t2m=None if t0_t2m is None else self._model_fn(step_seed, weights, t0_t2m),
            **pinned)

    def train_step(self, batch: dict, t: torch.Tensor, step_seed: int,
                   rows: Optional[tuple] = None, t0_t2m: Optional[int] = None,
                   **pinned) -> dict:
        """One AdamW step on the style encoder (with LoRA, on the factors);
        returns the loss terms. On a mesh, batch and t are the rank's rows
        (start, stop, global size) of the global batch; its draws are its
        rows of the global batch's, the backward's recompute included."""
        self.opt.zero_grad(set_to_none=True)
        with self._drawing(rows):
            terms = self.loss_terms(batch, t, step_seed, t0_t2m, **pinned)
            terms["loss"].backward()
        self._sync_grads()
        self.opt.step()
        self.lr_schedule.step()
        return {k: v.detach() for k, v in terms.items()}

    def run_step(self, batch: dict) -> dict:
        t0 = time.perf_counter()
        batch = {k: None if v is None else torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        B = batch["x_start"].shape[0]
        t, _ = self.sampler.sample(self.generator, B, data_range=self.t_range)
        step_seed = int(torch.randint(0, _SEED_MOD, (1,), generator=self._seeds))
        rows, t0_t2m = self._rows(B), None
        if rows is not None:
            # the rank's rows of the global batch; the B=1 style pair whole
            t0_t2m = int(self.sched.timestep_map[t[0]])
            t = t[rows[0]:rows[1]]
            batch = mesh_lib.shard_batch(batch, self.mesh, replicate_indivisible=True)
        terms = self._data_mean(self.train_step(batch, t, step_seed, rows, t0_t2m))
        self.preempted = self._any_rank(self.preempted)
        out = {k: float(v.float().mean()) for k, v in terms.items()}  # waits for the card
        self._log_terms(out)
        logger.logkv("step_seconds", time.perf_counter() - t0)
        self.step += 1
        if self.cfg.save_interval and \
                (self.step - 1 + self.resume_step) % self.cfg.save_interval == 0:
            self.save()
        elif self.preempted:
            self.save()  # step-boundary save on SIGTERM/SIGINT
        return out

    def finish(self):
        if self._last_saved_step != self.step + self.resume_step:
            self.save()

    def _log_terms(self, terms: dict):
        for k, v in terms.items():
            logger.logkv_mean(k, v)
        logger.logkv("step", self.step + self.resume_step)
        if self.platform is not None:
            for k, v in terms.items():
                self.platform.report_scalar(name=k, value=v,
                                            iteration=self.step + self.resume_step,
                                            group_name="Loss")

    # ------------------------------------------------------------------
    def ckpt_file_name(self) -> str:
        return f"model{self.step + self.resume_step:09d}.pt"

    def save(self):
        """The style encoder in the reference layout (frozen modules stripped,
        training_loop.py:316-335; with LoRA the merged encoder, and the
        factors as adapter{step:09d}.pt) and the optimizer state in the JAX
        trainer's layout (optimizer_leaves)."""
        step = self.step + self.resume_step
        path = os.path.join(self.cfg.save_dir, self.ckpt_file_name())
        sd = export_style_encoder(self.model)  # on a mesh, gathered on every rank
        leaves = self.optimizer_leaves()
        if self.cfg.orbax_checkpoints:
            self.save_dcp(step)
        self._last_saved_step = step
        if not mesh_lib.is_main():
            return
        os.makedirs(self.cfg.save_dir, exist_ok=True)
        if self.lora is not None:
            with torch.no_grad():
                sd.update({f"seqTransEncoder.{k[len('style_encoder.'):]}": v.float().cpu()
                           for k, v in self.effective_weights().items()})
            torch.save(lora.export_lora(self.lora, self.lora_alpha),
                       os.path.join(self.cfg.save_dir, f"adapter{step:09d}.pt"))
        torch.save(sd, path)
        torch.save(leaves, os.path.join(self.cfg.save_dir, f"opt{step:09d}.pt"))
        logger.log(f"saved checkpoint {path}")

    def _load_checkpoint(self, path: str):
        if os.path.isdir(path):
            # a LoRA run resumed from its own save dir restores the factors
            # (adapter{step}.pt) onto the base the caller built
            found = self.cfg.lora_rank > 0 and find_resume_checkpoint(path, "adapter")
            found = found or find_resume_checkpoint(path, "model")
            if found is None:
                return
            path = found
        self._resolved_checkpoint = path
        logger.log(f"loading model from checkpoint: {path}...")
        sd = torch.load(path, map_location="cpu")
        if lora.is_adapter_state_dict(sd):
            if self.cfg.lora_rank <= 0:
                raise ValueError(
                    f"{path} is a LoRA adapter checkpoint; pass --lora_rank matching it "
                    "(a full-encoder resume cannot consume factors)")
            self._pending_adapter = sd  # imported once the factors are built
            base = os.path.basename(path)
            self.resume_step = parse_resume_step_from_filename(
                "model" + base[len("adapter"):]) if base.startswith("adapter") else 0
            return
        self.resume_step = parse_resume_step_from_filename(path)
        self.model.style_encoder.load_state_dict(
            convert_encoder(sd, "seqTransEncoder", self.model.cfg.num_layers))

    def _encoder_params(self) -> list:
        """(parameter, transposed) of the style encoder in flax leaf order."""
        named = dict(self.model.style_encoder.named_parameters())
        return [(named[key], transposed)
                for _, key, transposed in encoder_leaves(self.model.cfg.num_layers)]

    def optimizer_leaves(self) -> list:
        """The optimizer state in the JAX trainer's flat layout
        (optimizer_state_leaves over the style encoder, or the factors)."""
        return optimizer_state_leaves(
            self.opt, self.params,
            self.lr_schedule.last_epoch if self.cfg.lr_anneal_steps else None, self._full)

    def load_optimizer_leaves(self, leaves: list):
        """Restore AdamW's moments and step and the LR schedule's position
        from the JAX trainer's flat leaf list (optimizer_leaves' format)."""
        position = load_optimizer_state_leaves(self.opt, self.params, leaves, self._local,
                                               self._shapes or None)
        set_schedule_position(self.lr_schedule, position, self._lr_factor)

    def _load_optimizer_state(self):
        opt_path = os.path.join(os.path.dirname(self._resolved_checkpoint),
                                f"opt{self.resume_step:09d}.pt")
        if not os.path.exists(opt_path):
            return
        state = torch.load(opt_path, map_location="cpu", weights_only=False)
        if isinstance(state, dict) and "optimizer" in state:
            # a file of this port's earlier layout (a torch state_dict)
            self.opt.load_state_dict(state["optimizer"])
            self.lr_schedule.load_state_dict(state["lr_schedule"])
        else:
            try:
                self.load_optimizer_leaves(state)
            except ValueError as e:
                # another run's layout (a LoRA run resumed from a full run's
                # model*.pt): fresh moments, as the JAX trainer's tolerant
                # load leaves them (training_loop.py:138-141)
                logger.log(f"could not load optimizer state: {e}")
                return
        logger.log(f"loaded optimizer state from {opt_path}")
