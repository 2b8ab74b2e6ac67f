"""Process groups, the device mesh and the sharding rules of the port.

Counterpart of motionstyle/parallel/mesh.py. The JAX package is one
controller that sees every device and lets XLA place the collectives; the
port is one process per rank, started by torchrun, and issues them itself:

  - init_distributed() reads torchrun's RANK, WORLD_SIZE and LOCAL_RANK,
    sets the rank's card from LOCAL_RANK and joins the process group:
    NCCL when each rank has a card of its own, gloo when ranks share a card
    (more local ranks than cards) or run on the CPU. Without torchrun's
    environment the world is one rank and no group is made;
  - make_mesh() is a torch DeviceMesh with dims ('data', 'model'|'pipe'|
    'seq'), the JAX mesh's axes;
  - shard_batch() gives the rank its rows of the leading axis over 'data';
  - param_spec()/fsdp_spec() are the JAX rules under the port's parameter
    names (torch layout: a Linear weight is (out, in), the transpose of a
    flax kernel); shard_params() applies them: Megatron tensor-parallel
    layers over 'model' (TensorParallelEncoderLayer) and, with fsdp, one
    FSDP2 fully_shard unit over 'data';
  - sync_grads() is the data-parallel gradient mean (DDP's all-reduce, one
    flat bucket), all_gather_batch() the gather with a gradient.

Equal to one device, as GSPMD is: a data-parallel step draws every
batch-shaped random tensor (noise, timesteps, the condition mask, dropout
masks and the in-kernel dropout seeds) at the global batch from the one
seeded generator and keeps the rank's rows (batch_rows / draw_rows), so a
world-2 step equals a world-1 step.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# process group
# ---------------------------------------------------------------------------

def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", 1))


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", 0))


def is_main() -> bool:
    """True on the rank that writes logs and checkpoints (global rank 0)."""
    return rank() == 0


def pick_backend(device: str, local_world: int) -> str:
    """NCCL when every local rank has a card of its own; gloo when ranks
    share a card (NCCL refuses two ranks on one device) or run on the CPU."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def init_distributed(device: str = "cuda", init_method: Optional[str] = None) -> int:
    """Join the process group torchrun describes; returns the world size (1,
    with no group, without torchrun's environment). The rank's card is
    LOCAL_RANK modulo the visible cards. init_method defaults to torchrun's
    env:// rendezvous (a file:// URL in tests)."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    if dist.is_initialized():
        return dist.get_world_size()
    if world == 1:
        return 1
    rank_, local = int(os.environ["RANK"]), int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run the ranks on the CPU")
        torch.cuda.set_device(local % torch.cuda.device_count())
    backend = pick_backend(device, local_world)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank_,
                            world_size=world)
    if rank_ == 0:
        where = (f"{local_world} local ranks on {torch.cuda.device_count()} card(s)"
                 if torch.device(device).type == "cuda" else "the CPU")
        print(f"torch.distributed: world {world}, backend {backend} ({where})", flush=True)
    return world


@contextlib.contextmanager
def distributed(device: str = "cuda"):
    """A CLI run's process group (init_distributed), destroyed at the end
    when this call made it. Yields the world size."""
    owns = not dist.is_initialized()
    world = init_distributed(device)
    try:
        yield world
    finally:
        if owns and dist.is_initialized():
            dist.destroy_process_group()


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def say(msg: str) -> None:
    """Print on global rank 0 only (the JAX package's one controller)."""
    if is_main():
        print(msg, flush=True)


def cli_training_mesh(data_parallel: bool, model_parallel: int, batch_size: int,
                      label: str = "training", fused_train: bool = False,
                      pipeline_parallel: int = 1, device: str = "cuda"):
    """The (data x model) or (data x pipe) mesh policy shared by the training
    CLIs, with the JAX CLIs' messages and exits: the model or pipe dim must
    divide the world; the data dim takes the largest divisor the batch
    supports. Returns None for one rank."""
    mp = max(1, model_parallel)
    pp = max(1, pipeline_parallel)
    if pp > 1:
        if mp > 1:
            raise SystemExit("--model_parallel and --pipeline_parallel are "
                             "mutually exclusive mesh layouts; pass one")
        if fused_train:
            raise SystemExit(
                "--fused_train is data-parallel only: the CUDA layer "
                "kernels carry no 'pipe' collectives; drop one flag")
        ndev = world_size()
        if ndev % pp != 0:
            raise ValueError(f"--pipeline_parallel {pp} does not divide the "
                             f"world size {ndev}")
        dp = math.gcd(ndev // pp, max(1, batch_size)) if data_parallel else 1
        say(f"{label} pipelined over a ({dp} data x {pp} pipe) mesh")
        return make_mesh(dp * pp, pipeline_parallel=pp, device=device)
    if not data_parallel and mp <= 1:
        return None
    if fused_train and mp > 1:
        raise SystemExit(
            f"--fused_train is data-parallel only: the CUDA layer kernels "
            f"have no tensor-parallel collectives, so --model_parallel {mp} "
            f"would silently replicate the encoder weights. Drop one flag.")
    ndev = world_size()
    if ndev % mp != 0:
        raise ValueError(
            f"--model_parallel {mp} does not divide the world size {ndev}")
    dp = math.gcd(ndev // mp, max(1, batch_size)) if data_parallel else 1
    if dp * mp > 1:
        say(f"{label} sharded over a ({dp} data x {mp} model) mesh")
        return make_mesh(dp * mp, model_parallel=mp, device=device)
    say("--data_parallel: batch size shares no divisor with the world "
         "size; running single-device")
    return None


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              pipeline_parallel: int = 1, sequence_parallel: int = 1,
              device: str = "cuda"):
    """A DeviceMesh of dims ('data', 'model') over the first n ranks, or
    ('data', 'pipe') / ('data', 'seq') when pipeline_parallel /
    sequence_parallel > 1. One of the three model dims per mesh, as in the
    JAX package; data parallelism composes with each. n must be the world
    size: where the JAX package leaves devices out of a mesh, a rank cannot
    sit out of a process group's collectives, so the launcher must start n."""
    from torch.distributed.device_mesh import init_device_mesh

    par_axes = {"model": model_parallel, "pipe": pipeline_parallel, "seq": sequence_parallel}
    active = [(name, deg) for name, deg in par_axes.items() if deg > 1]
    if len(active) > 1:
        raise ValueError(f"pick ONE of tensor/pipeline/sequence parallelism per mesh: {active}")
    axis, par = active[0] if active else ("model", 1)
    n = n_devices or world_size()
    if n % par:
        raise ValueError(f"a {axis} degree of {par} does not divide {n} ranks")
    if n != world_size():
        raise ValueError(f"a mesh of {n} ranks in a world of {world_size()}: launch "
                         f"{n} ranks (torchrun --nproc_per_node {n})")
    device_type = torch.device(device).type
    return init_device_mesh(device_type, (n // par, par), mesh_dim_names=("data", axis))


def mesh_axes(mesh) -> dict:
    """{dim name: size} of a DeviceMesh (the JAX mesh's shape dict)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh, name: str) -> int:
    return mesh_axes(mesh).get(name, 1) if mesh is not None else 1


def axis_rank(mesh, name: str) -> int:
    return mesh.get_local_rank(name) if mesh is not None and name in mesh.mesh_dim_names else 0


def axis_group(mesh, name: str):
    return mesh.get_group(name)


def data_rows(mesh, batch: int) -> tuple:
    """(start, stop) of this rank's rows of a batch sharded over 'data'."""
    dp = axis_size(mesh, "data")
    if batch % dp:
        raise ValueError(f"batch size {batch} is not divisible by the mesh data axis {dp}")
    n = batch // dp
    r = axis_rank(mesh, "data")
    return r * n, (r + 1) * n


def shard_batch(batch, mesh, replicate_indivisible: bool = False):
    """This rank's rows (leading axis over 'data') of every leaf of a dict,
    tuple or array/tensor tree. replicate_indivisible: leaves whose leading
    axis does not divide the data dim (the finetune's B=1 style and neutral
    pair beside a dataset batch) are kept whole instead of raising."""
    dp = axis_size(mesh, "data")
    r = axis_rank(mesh, "data")

    def place(leaf):
        if leaf is None:
            return None
        n0 = leaf.shape[0] if getattr(leaf, "ndim", 0) else None
        if replicate_indivisible and (n0 is None or n0 % dp):
            return leaf
        if n0 is None or n0 % dp:
            raise ValueError(f"a leaf of leading size {n0} does not divide the data axis {dp}")
        n = n0 // dp
        return leaf[r * n:(r + 1) * n]

    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, replicate_indivisible) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return type(batch)(*(shard_batch(v, mesh, replicate_indivisible) for v in batch)) \
            if hasattr(batch, "_fields") else tuple(shard_batch(v, mesh, replicate_indivisible)
                                                   for v in batch)
    return place(batch)


def replicate(module: nn.Module) -> nn.Module:
    """Every parameter and buffer of `module` made equal to global rank 0's
    (a broadcast over the whole world), the placement of a replicated tree."""
    if world_size() > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


class _Gather(torch.autograd.Function):
    """Every rank's t concatenated along dim in rank order; the backward
    sums every rank's gradient of the whole and keeps this rank's part (a
    reduce-scatter, done as an all-reduce, which gloo has)."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.n = dist.get_rank(group), dist.get_world_size(group)
        parts = [torch.empty_like(t) for _ in range(ctx.n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.rank].contiguous(), None, None


def gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """All ranks' t along dim, with a gradient (_Gather)."""
    return _Gather.apply(t, group, dim)


def all_gather_batch(x: torch.Tensor, mesh=None, axis: str = "data") -> torch.Tensor:
    """The leading-axis concatenation of every data rank's x, in rank order,
    with a gradient (the loss-aware resampler's gather, resample.py)."""
    if mesh is None or axis_size(mesh, axis) == 1:
        return x
    return gather(x, axis_group(mesh, axis), 0)


def sync_grads(params, mesh, axis: str = "data") -> None:
    """The data-parallel gradient mean: one all-reduce of the flattened
    gradients of `params` over `axis`, divided by its size. Each rank's loss
    is the mean over its equal share of the batch, so the mean of the ranks'
    gradients is the gradient of the global batch's loss. This is
    DistributedDataParallel's all-reduce done by hand: a step of these
    trainers runs several forwards of the same parameters (the DDIM unroll,
    grad_accum's microbatches, the semantic branch) before its one
    backward, which DDP's reducer refuses, and calls the model's methods
    besides forward."""
    n = axis_size(mesh, axis)
    if n == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=axis_group(mesh, axis))
    flat /= n
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


# ---------------------------------------------------------------------------
# global draws in a data-parallel step
# ---------------------------------------------------------------------------

# (start, stop, total) while a sharded step draws. Process-wide, not a
# context variable: on the card the autograd engine recomputes a
# checkpointed forward (the finetune's unroll) on its own device thread, and
# that recompute must draw the rows the forward drew
_ROWS = [None]


@contextlib.contextmanager
def batch_rows(start: int, stop: int, total: int):
    """Inside: draw_rows draws a tensor whose batch dim has stop - start rows
    at `total` rows and keeps [start, stop), so the rank's draws are its rows
    of the global batch's. A draw of another batch size (the finetune's
    replicated B=1 style pair) is made whole on every rank, as on one."""
    prev, _ROWS[0] = _ROWS[0], (start, stop, total)
    try:
        yield
    finally:
        _ROWS[0] = prev


def draw_rows(draw, shape, dim: int = 0) -> torch.Tensor:
    """draw(shape), or inside batch_rows this rank's rows (along `dim`) of
    draw at the global batch."""
    shape = tuple(shape)
    rows = _ROWS[0]
    if rows is None:
        return draw(shape)
    start, stop, total = rows
    if shape[dim] != stop - start or total == stop - start:
        return draw(shape)
    full = shape[:dim] + (total,) + shape[dim + 1:]
    return draw(full).narrow(dim, start, stop - start).contiguous()


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

def transposed_name(name: str, ndim: int) -> bool:
    """True for the port's 2-D weights, whose layout is the transpose of the
    flax kernel's: every Linear weight and the packed in_proj_weight."""
    return ndim == 2 and name.endswith("weight")


def param_spec(name: str, shape) -> tuple:
    """Megatron sharding of a port parameter: a tuple with 'model' on the
    sharded dim (None elsewhere), () for replicated. The JAX rules on flax
    kernels (in, out), moved to torch's (out, in): linear1 and in_proj are
    column-parallel (the output dim, torch dim 0), linear2 and out_proj
    row-parallel (the input dim, torch dim 1); linear1's and in_proj's
    biases follow their columns."""
    ndim = len(shape)
    if ndim == 2:
        if name.endswith("linear1.weight") or name.endswith("in_proj_weight"):
            return ("model", None)
        if name.endswith("linear2.weight") or name.endswith("out_proj.weight"):
            return (None, "model")
    if ndim == 1 and (name.endswith("linear1.bias") or name.endswith("in_proj_bias")):
        return ("model",)
    return ()


def fsdp_spec(name: str, shape, dp: int, min_leaf_size: int = 1024,
              use_model_base: bool = True) -> tuple:
    """ZeRO sharding of a port parameter: the base spec (param_spec, or
    replicated) plus 'data' on ONE free dim, the largest whose size the data
    degree divides; leaves under min_leaf_size elements keep the base. The
    JAX rule leaf for leaf: a tie between equal dims goes to the flax
    kernel's first dim, which is torch's last for a transposed weight."""
    shape = tuple(shape)
    base = param_spec(name, shape) if use_model_base else ()
    spec = list(base) + [None] * (len(shape) - len(base))
    flip = transposed_name(name, len(shape))
    order = list(range(len(shape)))[::-1] if flip else list(range(len(shape)))
    if dp > 1 and math.prod(shape) >= min_leaf_size:
        free = [i for i in order if spec[i] is None and shape[i] % dp == 0]
        if free:
            spec[max(free, key=lambda i: shape[i])] = "data"
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient backward
    (the input of a column-parallel layer is replicated over 'model')."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward (the row-parallel partial sums),
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


COLLECTIVE_COUNTS = {"all_reduce": 0}  # the tensor-parallel layers' all-reduces


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    COLLECTIVE_COUNTS["all_reduce"] += 1
    return _ReduceFromModel.apply(x, group)


# the kind of each sharded parameter of a layer: rows of a packed (3D, D)
# qkv weight or bias split by heads, or dim 0 / dim 1 cut in n
_TP_KINDS = {"self_attn.in_proj_weight": "qkv", "self_attn.in_proj_bias": "qkv",
             "linear1.weight": 0, "linear1.bias": 0,
             "self_attn.out_proj.weight": 1, "linear2.weight": 1}


def tp_shard(full: torch.Tensor, kind, rank_: int, n: int) -> torch.Tensor:
    """Rank rank_'s shard of a full tensor (see _TP_KINDS)."""
    if kind == "qkv":
        return torch.cat([part.chunk(n, 0)[rank_] for part in full.chunk(3, 0)], 0).contiguous()
    return full.chunk(n, kind)[rank_].contiguous()


def tp_unshard(shards: list, kind) -> torch.Tensor:
    """The full tensor from every rank's shard, in rank order."""
    if kind == "qkv":
        parts = [s.chunk(3, 0) for s in shards]
        return torch.cat([torch.cat([p[i] for p in parts], 0) for i in range(3)], 0)
    return torch.cat(shards, kind)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of an FSDP shard (a DTensor; every rank of its mesh
    takes part), else t."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


class TensorParallelEncoderLayer(nn.Module):
    """A post-LN encoder layer split over a 'model' group of n ranks
    (Megatron): in_proj by heads (rank r holds heads [r h/n, (r+1) h/n) of
    q, k and v) and linear1 by columns; out_proj and linear2 by rows, each
    followed by one all-reduce and then its bias, added once. So the heads
    must divide by n (a narrower contract than the JAX package's, where XLA
    cuts the packed qkv kernel any way). The parameter names are
    TransformerEncoderLayer's; state_dict() gathers the full tensors and
    load_state_dict() takes full tensors, so checkpoints stay
    layout-independent. Dropout takes the plain layer's full masks and keeps
    the rank's FFN columns, so a training forward equals the plain one.
    TransformerEncoder runs these layers plain, never through the fused
    kernels, which carry no collectives."""

    tensor_parallel = True

    def __init__(self, layer: nn.Module, nhead: int, group):
        super().__init__()
        self.group = group
        self.n = dist.get_world_size(group)
        self.r = dist.get_rank(group)
        if nhead % self.n:
            raise ValueError(f"--model_parallel {self.n} does not divide the {nhead} "
                             "attention heads: the port splits q, k and v by heads")
        self.local_heads = nhead // self.n
        self.self_attn = layer.self_attn
        self.linear1, self.linear2 = layer.linear1, layer.linear2
        self.norm1, self.norm2 = layer.norm1, layer.norm2
        with torch.no_grad():
            for name, kind in _TP_KINDS.items():
                mod, attr = self._owner(name)
                p = getattr(mod, attr)
                setattr(mod, attr, nn.Parameter(tp_shard(p.data, kind, self.r, self.n),
                                                requires_grad=p.requires_grad))
        # load_state_dict takes full tensors: each is cut to the rank's shard
        self.register_load_state_dict_pre_hook(self._shard_on_load)

    def _owner(self, name: str) -> tuple:
        *path, attr = name.split(".")
        mod = self
        for p in path:
            mod = getattr(mod, p)
        return mod, attr

    def state_dict(self, *args, **kwargs):
        """The full tensors, gathered over the group (every rank takes part)."""
        destination = super().state_dict(*args, **kwargs)
        prefix = kwargs.get("prefix", "")
        for name in _TP_KINDS:
            destination[prefix + name] = self.gather(name, destination[prefix + name])
        return destination

    def _shard_on_load(self, module, state_dict, prefix, *args):
        for name, kind in _TP_KINDS.items():
            if prefix + name in state_dict:
                state_dict[prefix + name] = tp_shard(state_dict[prefix + name], kind,
                                                     self.r, self.n)

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The full tensor of a tensor laid out as parameter `name` (an Adam
        moment)."""
        kind = _TP_KINDS.get(name)
        t = full_tensor(t).detach().contiguous()
        if kind is None:
            return t
        shards = [torch.empty_like(t) for _ in range(self.n)]
        dist.all_gather(shards, t, group=self.group)
        return tp_unshard(shards, kind)

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        kind = _TP_KINDS.get(name)
        return full if kind is None else tp_shard(full, kind, self.r, self.n)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32, masks: Optional[tuple] = None
                ) -> torch.Tensor:
        from motionstyle_torch.ops.attention import multihead_attention

        g = self.group
        drop = (lambda t, i: t) if masks is None else \
            (lambda t, i: t * masks[i].to(t.dtype))  # noqa: E731
        attn = self.self_attn
        xin = _CopyToModel.apply(x, g)
        qkv = F.linear(xin.to(dtype), attn.in_proj_weight.to(dtype), attn.in_proj_bias.to(dtype))
        q, k, v = qkv.chunk(3, -1)
        out = multihead_attention(q, k, v, self.local_heads, key_padding_mask)
        a = reduce_from_model(F.linear(out.to(dtype), attn.out_proj.weight.to(dtype)), g)
        a = drop(a + attn.out_proj.bias.to(dtype), 0)
        x = self.norm1((x.to(dtype) + a).float()).to(dtype)
        xin = _CopyToModel.apply(x, g)
        h = F.gelu(F.linear(xin, self.linear1.weight.to(dtype), self.linear1.bias.to(dtype)),
                   approximate="none")
        if masks is not None:
            fl = h.shape[-1]
            h = h * masks[1][..., self.r * fl:(self.r + 1) * fl].to(h.dtype)
        h = reduce_from_model(F.linear(h, self.linear2.weight.to(dtype)), g)
        h = drop(h + self.linear2.bias.to(dtype), 2)
        return self.norm2((x + h).float()).to(dtype)


def tensor_parallel_layers(module: nn.Module) -> list:
    """Every TensorParallelEncoderLayer inside `module`."""
    return [m for m in module.modules() if isinstance(m, TensorParallelEncoderLayer)]


def shard_tensor_parallel(module: nn.Module, group) -> nn.Module:
    """Replace every encoder layer of every TransformerEncoder inside
    `module` by its tensor-parallel split over `group`, in place."""
    from motionstyle_torch.models.transformer import TransformerEncoder

    for enc in [m for m in module.modules() if isinstance(m, TransformerEncoder)]:
        enc.layers = nn.ModuleList(TensorParallelEncoderLayer(layer, enc.nhead, group)
                                   for layer in enc.layers)
    return module


def owner_of(module: nn.Module, name: str) -> tuple:
    """(the TensorParallelEncoderLayer holding parameter `name` of module, the
    name inside it), or (None, name)."""
    parts = name.split(".")
    mod = module
    for i, p in enumerate(parts[:-1]):
        mod = getattr(mod, p)
        if isinstance(mod, TensorParallelEncoderLayer):
            return mod, ".".join(parts[i + 1:])
    return None, name


def gather_full(module: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of `t`, laid out as parameter `name` of `module`:
    gathered over 'data' when it is an FSDP shard (a DTensor), then over
    'model' when the parameter is a tensor-parallel shard. Every rank takes
    part."""
    layer, inner = owner_of(module, name)
    if layer is not None:
        return layer.gather(inner, t)
    return full_tensor(t).detach()


def local_like(module: nn.Module, name: str, param: torch.Tensor, full: torch.Tensor
               ) -> torch.Tensor:
    """The rank's part of a whole tensor laid out as parameter `name` (a
    DTensor like the FSDP shard `param`, or the tensor-parallel shard)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    layer, inner = owner_of(module, name)
    if layer is not None:
        full = layer.shard(inner, full)
    if isinstance(param, DTensor):
        return distribute_tensor(full.to(param.device), param.device_mesh, param.placements,
                                 src_data_rank=None)
    return full.to(param.device)


def shard_params(module: nn.Module, mesh, fsdp: bool = False,
                 unit: Optional[nn.Module] = None) -> nn.Module:
    """Lay a module out on the mesh, in place: its encoder layers split over
    'model' (tensor parallelism) when the mesh has that dim, and with fsdp
    the FSDP2 unit `unit` (default: the module) sharded over 'data', each
    parameter on the dim fsdp_spec picks, through shard_placement_fn. FSDP2
    shards every parameter of a unit, so the leaves that fsdp_spec keeps
    whole (under 1024 elements: biases and LayerNorm scales; or with no dim
    the data degree divides) are sharded on dim 0 (padded) instead."""
    if "model" in mesh.mesh_dim_names and axis_size(mesh, "model") > 1:
        shard_tensor_parallel(module, axis_group(mesh, "model"))
    if fsdp:
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        unit = module if unit is None else unit
        dp = axis_size(mesh, "data")
        by_param = {p: n for n, p in unit.named_parameters()}
        use_base = "model" in mesh.mesh_dim_names

        def placement(p):
            spec = fsdp_spec(by_param[p], tuple(p.shape), dp, use_model_base=use_base)
            return Shard(spec.index("data")) if "data" in spec else None

        fully_shard(unit, mesh=mesh["data"], shard_placement_fn=placement)
    return module


def refuse_dtensor(*tensors) -> None:
    """The CUDA kernels take plain tensors: a DTensor (an FSDP shard that was
    never gathered, because the FSDP unit sits below the module whose
    forward reads the weights) is refused before any launch."""
    from torch.distributed.tensor import DTensor

    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError("a DTensor reached a fused kernel: the FSDP unit must be the "
                            "encoder stack or a module above it, so that its forward "
                            "gathers the weights before the kernels read them")
