"""Weights into the port: the reference's torch checkpoints, the JAX package's
flax parameter trees, and a seeded initialisation.

Checkpoint format (motionstyle/models/torch_import.py): reference-layout
state dicts. A prior checkpoint (model*.pt / --mdm_path) holds the whole MDM
under its own keys plus the sequence_pos_encoder buffers, which are
recomputed, not loaded. A style checkpoint (--model_path) holds only
'seqTransEncoder.layers.{i}.*', the finetuned style encoder (the reference
strips everything else at save time, training_loop.py:316-335);
export_style_encoder writes one and convert_encoder reads one; export_mdm
writes a prior and from_torch_state_dict reads one. A semantic
discriminator checkpoint (--semantic_discriminator_path) holds muQuery,
sigmaQuery and its own 'seqTransEncoder.layers.{i}.*';
export_semantic_discriminator writes one.

flax trees: Dense kernels are (in, out) where torch weights are (out, in);
LayerNorm 'scale' is torch's 'weight'; the packed in-projection is one
(D, 3D) kernel, torch's (3D, D) in_proj_weight. encoder_leaves and
mdm_leaves list an encoder's and a prior's leaves in jax's flattening order
with that mapping; the weights and the optimizer's moments
(train/finetune.py, train/pretrain.py) cross over through them.
from_jax_params also carries the other architectures' trees (a decoder's
'seqTransDecoder', whose cross-attention keeps the JAX module's q_proj and
packed kv_proj; a GRU's 'gru', already in torch's layout) and DiffuseTransfer's
('transfer_encoder'). assemble_diffuse_transfer_params reads a reference
DiffuseTrasnfer state dict; checkpoint import stays trans_enc only, as in the
JAX package (torch_import.py:66-76).
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

from motionstyle_torch.models.denoiser import MDMConfig
from motionstyle_torch.parallel.mesh import full_tensor

# recomputed buffers of the reference prior, never loaded
_BUFFERS = ("sequence_pos_encoder.pe", "embed_timestep.sequence_pos_encoder.pe")


def _num_layers(keys) -> int:
    """Encoder depth named by state-dict keys ('...layers.{i}.*')."""
    found = [int(m.group(1)) for k in keys
             if (m := re.search(r"(?:^|\.)layers\.(\d+)\.", k))]
    return 1 + max(found, default=-1)


def _tensor(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def convert_encoder(sd: Dict[str, np.ndarray], prefix: str, num_layers: int
                    ) -> Dict[str, torch.Tensor]:
    """'{prefix}.layers.{i}.*' of a reference-layout state dict -> a port
    TransformerEncoder's state dict (counterpart of torch_import.py's
    convert_encoder)."""
    head = prefix + "."
    out = {k[len(head):]: _tensor(v) for k, v in sd.items() if k.startswith(head)}
    if _num_layers(out) != num_layers:
        raise ValueError(f"checkpoint has {_num_layers(out)} encoder layers under "
                         f"{prefix!r}, the config {num_layers}")
    return out


def _cpu_state(module: nn.Module, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Whole fp32 CPU copies; an FSDP shard is gathered first (so on a mesh
    every rank calls this) and a tensor-parallel layer's state_dict gathers
    its own (parallel/mesh.py)."""
    return {prefix + k: full_tensor(v).detach().float().cpu().clone()
            for k, v in module.state_dict().items()}


def export_encoder(encoder: nn.Module) -> Dict[str, torch.Tensor]:
    """A port TransformerEncoder in the reference layout
    ('seqTransEncoder.layers.{i}.*', fp32 on the CPU)."""
    return _cpu_state(encoder, "seqTransEncoder.")


def export_style_encoder(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The style encoder of a StyleDiffusion in the reference layout: what a
    model*.pt holds once the frozen modules are stripped
    (training_loop.py:316-335)."""
    return export_encoder(model.style_encoder)


def export_semantic_discriminator(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The semantic discriminator of a StyleDiffusion in the reference layout
    (muQuery, sigmaQuery and its encoder as 'seqTransEncoder.layers.{i}.*'),
    a --semantic_discriminator_path checkpoint for either package: the
    counterpart of motionstyle/models/torch_import.py:225
    export_semantic_discriminator. from_torch_state_dict(part='semantic')
    reads it back."""
    sd = export_encoder(model.motion_enc_encoder)
    sd["muQuery"] = model.mu_query.detach().float().cpu().clone()
    sd["sigmaQuery"] = model.sigma_query.detach().float().cpu().clone()
    return sd


def export_mdm(mdm: nn.Module) -> Dict[str, torch.Tensor]:
    """A port MDM prior in the reference layout (fp32 on the CPU), loadable as
    an --mdm_path checkpoint by either package: the counterpart of
    motionstyle/models/torch_import.py:203 export_mdm. The positional
    encoding is a recomputed buffer and is not written."""
    return _cpu_state(mdm)


def from_torch_state_dict(sd: Dict[str, np.ndarray], cfg: MDMConfig,
                          part: str = "mdm") -> Dict[str, torch.Tensor]:
    """A reference-layout state dict -> entries of StyleDiffusion's state
    dict. part='mdm' loads a prior checkpoint into 'mdm.*'; part=
    'style_encoder' loads a style checkpoint's seqTransEncoder into
    'style_encoder.*'; part='semantic' loads a semantic discriminator into
    'mu_query', 'sigma_query' and 'motion_enc_encoder.*'. Load with
    load_state_dict(..., strict=False)."""
    if part == "mdm":
        if cfg.arch != "trans_enc" or any(k.startswith(("seqTransDecoder", "gru")) for k in sd):
            raise NotImplementedError(
                f"checkpoint import supports arch='trans_enc' only (cfg.arch={cfg.arch!r})")
        out = {f"mdm.{k}": _tensor(v) for k, v in sd.items() if k not in _BUFFERS}
    elif part in ("style_encoder", "semantic"):
        dest = "style_encoder" if part == "style_encoder" else "motion_enc_encoder"
        out = {f"{dest}.{k}": v for k, v in
               convert_encoder(sd, "seqTransEncoder", cfg.num_layers).items()}
        if part == "semantic":
            out["mu_query"] = _tensor(sd["muQuery"]).reshape(1, -1)
            out["sigma_query"] = _tensor(sd["sigmaQuery"]).reshape(1, -1)
    else:
        raise ValueError(f"part must be 'mdm', 'style_encoder' or 'semantic', got {part!r}")
    n_layers = _num_layers(out)
    if n_layers != cfg.num_layers:
        raise ValueError(f"checkpoint has {n_layers} encoder layers, "
                         f"the config {cfg.num_layers}")
    return out


# One encoder layer's flax leaves and the port's parameter names: (flax path
# under 'layers_{i}', state-dict key under 'layers.{i}.', whether the flax
# kernel is the transpose of the torch weight).
_LAYER_LEAVES = (
    (("self_attn", "in_proj", "kernel"), "self_attn.in_proj_weight", True),
    (("self_attn", "in_proj", "bias"), "self_attn.in_proj_bias", False),
    (("self_attn", "out_proj", "kernel"), "self_attn.out_proj.weight", True),
    (("self_attn", "out_proj", "bias"), "self_attn.out_proj.bias", False),
    (("linear1", "kernel"), "linear1.weight", True),
    (("linear1", "bias"), "linear1.bias", False),
    (("linear2", "kernel"), "linear2.weight", True),
    (("linear2", "bias"), "linear2.bias", False),
    (("norm1", "scale"), "norm1.weight", False),
    (("norm1", "bias"), "norm1.bias", False),
    (("norm2", "scale"), "norm2.weight", False),
    (("norm2", "bias"), "norm2.bias", False),
)


def encoder_leaves(num_layers: int) -> list:
    """(flax path, port state-dict key, transposed) for every leaf of a flax
    TransformerEncoder tree, in the order jax.tree_util flattens it (dict
    keys sorted at every level, so 'layers_10' comes before 'layers_2')."""
    leaves = [((f"layers_{i}",) + path, f"layers.{i}.{key}", transposed)
              for i in range(num_layers) for path, key, transposed in _LAYER_LEAVES]
    return sorted(leaves, key=lambda leaf: leaf[0])


# The prior's Dense layers outside its encoder: (flax path under 'mdm', the
# port's module path under MDM).
_MDM_DENSE = (
    (("embed_text",), "embed_text"),
    (("embed_timestep", "time_embed_0"), "embed_timestep.time_embed.0"),
    (("embed_timestep", "time_embed_2"), "embed_timestep.time_embed.2"),
    (("input_process",), "input_process.poseEmbedding"),
    (("output_process",), "output_process.poseFinal"),
)


def mdm_leaves(num_layers: int) -> list:
    """(flax path, port MDM state-dict key, transposed) for every leaf of the
    JAX MDM subtree ('mdm': the embeddings, the input and output heads and
    the encoder), in the order jax.tree_util flattens it."""
    leaves = [(path + (leaf,), f"{key}.{name}", leaf == "kernel")
              for path, key in _MDM_DENSE for leaf, name in (("bias", "bias"), ("kernel", "weight"))]
    leaves += [(("seqTransEncoder",) + path, f"seqTransEncoder.{key}", transposed)
               for path, key, transposed in encoder_leaves(num_layers)]
    return sorted(leaves, key=lambda leaf: leaf[0])


def flax_to_torch(a, transposed: bool) -> torch.Tensor:
    """A flax leaf -> the port's layout ((in, out) kernels become (out, in))."""
    t = _tensor(a)
    return t.t().contiguous() if transposed else t


def torch_to_flax(t: torch.Tensor, transposed: bool) -> np.ndarray:
    """A port tensor -> the flax leaf's layout, fp32 numpy."""
    t = t.detach().float().cpu()
    return np.ascontiguousarray((t.t() if transposed else t).numpy())


def _dense(tree: dict, key: str) -> dict:
    return {f"{key}.weight": flax_to_torch(tree["kernel"], True),
            f"{key}.bias": flax_to_torch(tree["bias"], False)}


def encoder_from_jax(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """flax TransformerEncoder tree ('layers_{i}') -> port encoder state dict."""
    n = 0
    while f"layers_{n}" in tree:
        n += 1
    out = {}
    for path, key, transposed in encoder_leaves(n):
        leaf = tree
        for k in path:
            leaf = leaf[k]
        out[prefix + key] = flax_to_torch(leaf, transposed)
    return out


# A decoder layer's leaves beyond an encoder layer's: the cross-attention
# (q_proj, the packed kv_proj, out_proj) and norm3.
_DECODER_LAYER_LEAVES = _LAYER_LEAVES + tuple(
    (("multihead_attn", proj, leaf), f"multihead_attn.{proj}.{name}", leaf == "kernel")
    for proj in ("q_proj", "kv_proj", "out_proj")
    for leaf, name in (("kernel", "weight"), ("bias", "bias"))) + (
    (("norm3", "scale"), "norm3.weight", False), (("norm3", "bias"), "norm3.bias", False))


def _layers_from_jax(tree: dict, prefix: str, leaves) -> Dict[str, torch.Tensor]:
    out = {}
    n = 0
    while f"layers_{n}" in tree:
        for path, key, transposed in leaves:
            leaf = tree[f"layers_{n}"]
            for k in path:
                leaf = leaf[k]
            out[f"{prefix}layers.{n}.{key}"] = flax_to_torch(leaf, transposed)
        n += 1
    return out


def _mdm_from_jax(tree: dict, prefix: str) -> Dict[str, torch.Tensor]:
    """An MDM tree of any architecture (or without its stack, as
    DiffuseTransfer's) -> port state-dict entries under `prefix`."""
    out = {}
    for path, key in _MDM_DENSE:
        sub = tree
        for k in path:
            sub = sub[k]
        out.update(_dense(sub, prefix + key))
    if "seqTransEncoder" in tree:
        out.update(encoder_from_jax(tree["seqTransEncoder"], f"{prefix}seqTransEncoder."))
    if "seqTransDecoder" in tree:
        out.update(_layers_from_jax(tree["seqTransDecoder"], f"{prefix}seqTransDecoder.",
                                    _DECODER_LAYER_LEAVES))
    if "gru" in tree:  # weight_ih_l{k} etc., torch's layout and names already
        out.update({f"{prefix}gru.{k}": _tensor(v) for k, v in tree["gru"].items()})
    return out


def _depth(out: Dict[str, torch.Tensor]) -> int:
    """Layers named by a port state dict: the stacks' 'layers.{i}', or a
    GRU's 'weight_ih_l{i}'."""
    grus = [int(m.group(1)) for k in out if (m := re.search(r"gru\.weight_ih_l(\d+)$", k))]
    return max(_num_layers(out), 1 + max(grus, default=-1))


def from_jax_params(tree: dict, cfg: MDMConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's flax params (numpy leaves, optionally under
    'params') -> the port's state dict: a StyleDiffusion tree ('mdm',
    'style_encoder', the semantic discriminator's 'motion_enc_encoder',
    'mu_query' and 'sigma_query'), a DiffuseTransfer tree ('mdm' without its
    stack, the discriminator and 'transfer_encoder') or an MDM tree of any
    architecture ('input_process', ...)."""
    tree = tree.get("params", tree)
    if "mdm" in tree:
        out = _mdm_from_jax(tree["mdm"], "mdm.")
        second = "transfer_encoder" if "transfer_encoder" in tree else "style_encoder"
        out.update(encoder_from_jax(tree[second], f"{second}."))
        out.update(encoder_from_jax(tree["motion_enc_encoder"], "motion_enc_encoder."))
        out["mu_query"] = _tensor(tree["mu_query"])
        out["sigma_query"] = _tensor(tree["sigma_query"])
    else:
        out = _mdm_from_jax(tree, "")
    n_layers = _depth(out)
    if n_layers != cfg.num_layers:
        raise ValueError(f"tree has {n_layers} layers, the config {cfg.num_layers}")
    return out


def assemble_diffuse_transfer_params(cfg: MDMConfig, sd: Dict[str, np.ndarray],
                                     seed: int = 0) -> Dict[str, torch.Tensor]:
    """A reference DiffuseTrasnfer (sic, :628-760) state dict -> a port
    DiffuseTransfer's whole state dict (counterpart of
    motionstyle/models/torch_import.py:152-195). `seqTransEncoder.*` is the
    trainable transfer encoder; `motion_enc.*` the frozen MotionEncoder
    (muQuery, sigmaQuery, its own seqTransEncoder, and the inner mdm_model
    whose embeddings and heads the transfer forward borrows; its encoder
    stack is not used and not loaded). A subtree the state dict lacks keeps
    the seeded initialisation (seeded_init_ with `seed`)."""
    from motionstyle_torch.models.denoiser import DiffuseTransfer

    out = seeded_init_(DiffuseTransfer(cfg), seed).state_dict()
    head = "motion_enc.mdm_model."
    for _, key in _MDM_DENSE:
        if f"{head}{key}.weight" in sd:
            for leaf in ("weight", "bias"):
                out[f"mdm.{key}.{leaf}"] = _tensor(sd[f"{head}{key}.{leaf}"])
    if "motion_enc.muQuery" in sd:
        out["mu_query"] = _tensor(sd["motion_enc.muQuery"]).reshape(1, -1)
        out["sigma_query"] = _tensor(sd["motion_enc.sigmaQuery"]).reshape(1, -1)
    for prefix, dest in (("motion_enc.seqTransEncoder", "motion_enc_encoder"),
                         ("seqTransEncoder", "transfer_encoder")):
        if f"{prefix}.layers.0.norm1.weight" in sd:
            out.update({f"{dest}.{k}": v
                        for k, v in convert_encoder(sd, prefix, cfg.num_layers).items()})
    return out


@torch.no_grad()
def seeded_init_(module: nn.Module, seed: int, stds: dict | None = None) -> nn.Module:
    """Deterministic initialisation from a seed, independent of the device
    and of torch's global RNG: Linear, packed in-projection and GRU weights
    lecun-normal (std 1/sqrt(fan_in)), biases 0, LayerNorm 1 and 0, other
    parameters normal with the std `stds` gives their name, else 1 (flax's
    defaults for these modules).

    The draws differ from the JAX package's PRNGKey(seed) initialisation:
    the two frameworks' generators give different numbers from one seed."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("bias") or leaf.endswith("_bias"):
            p.zero_()
        elif p.ndim == 1:  # LayerNorm scale
            p.fill_(1.0)
        elif leaf in ("weight", "in_proj_weight") or leaf.startswith("weight_"):
            std = p.shape[1] ** -0.5
            p.copy_(torch.randn(p.shape, generator=gen) * std)
        else:
            p.copy_(torch.randn(p.shape, generator=gen) * (stds or {}).get(leaf, 1.0))
    return module
