"""Low-rank (LoRA) style adapters for the few-shot finetune.

The port's copy of motionstyle/models/lora.py. Instead of the whole style
encoder, the finetune can train low-rank deltas on its dense weights:

    W_eff = W_base + (alpha / rank) * (A @ B)^T     (A: din x r, B: r x dout)

Every 2-D dense weight of the encoder is an adapter site: each layer's
packed in-projection, out-projection, linear1 and linear2. Biases and
LayerNorms stay as they are. A ~ N(0, 1/din) and B = 0, so a fresh adapter
merges to the base bit for bit. The scale is (alpha or rank) / rank.

Factors are kept in flax orientation (A is (din, r), B is (r, dout)), as the
JAX package keeps them, so a torch weight (dout, din) gains the transpose of
s * A @ B. Sites are named by their flax path ('layers_0.self_attn.in_proj')
and listed in jax.tree_util's flattening order (keys sorted at every level:
'layers_10' before 'layers_2'; per layer linear1, linear2,
self_attn.in_proj, self_attn.out_proj). The adapter file is the JAX
package's format exactly (export_lora): keys 'lora.<site>.a' and
'lora.<site>.b' as fp32 arrays, plus a 0-d 'lora.alpha'. A file written by
either package loads into the other.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch

# (flax path of a site under 'layers_{i}', the port's weight key under 'layers.{i}.')
_SITES = ((("linear1",), "linear1.weight"),
          (("linear2",), "linear2.weight"),
          (("self_attn", "in_proj"), "self_attn.in_proj_weight"),
          (("self_attn", "out_proj"), "self_attn.out_proj.weight"))

Factors = Dict[str, Dict[str, torch.Tensor]]


def adapter_sites(num_layers: int) -> list:
    """(site name, port encoder state-dict key) of every adapter site, in the
    order jax.tree_util flattens a flax adapter tree."""
    sites = [((f"layers_{i}",) + path, f"layers.{i}.{key}")
             for i in range(num_layers) for path, key in _SITES]
    return [(".".join(path), key) for path, key in sorted(sites)]


def _num_layers(names) -> int:
    """Encoder depth named by sites ('layers_{i}.*') or state-dict keys ('layers.{i}.*')."""
    return 1 + max((int(m.group(1)) for n in names if (m := re.match(r"layers[._](\d+)\.", n))),
                   default=-1)


def init_lora(encoder_state: Dict[str, torch.Tensor], rank: int,
              generator: torch.Generator) -> Factors:
    """Fresh factors for every site of an encoder state dict: A ~ N(0, 1/din)
    drawn from `generator` (a CPU generator, so the draws do not depend on
    the device) in site order, B = 0. Tensors on the weights' device."""
    if rank <= 0:
        raise ValueError(f"lora rank must be positive, got {rank}")
    factors = {}
    for site, key in adapter_sites(_num_layers(encoder_state)):
        w = encoder_state[key]
        dout, din = w.shape
        a = torch.randn((din, rank), generator=generator) / din ** 0.5
        factors[site] = {"a": a.to(w.device),
                         "b": torch.zeros((rank, dout), device=w.device)}
    return factors


def lora_rank(factors: Factors) -> int:
    """The inner dimension the (a, b) pairs share."""
    for pair in factors.values():
        return int(pair["a"].shape[-1])
    raise ValueError("the adapter has no factors")


def lora_scale(factors: Factors, alpha: Optional[float] = None) -> float:
    """(alpha or rank) / rank: alpha None or 0 means scale 1."""
    r = lora_rank(factors)
    return (float(alpha) if alpha else float(r)) / float(r)


def merge_lora(encoder_state: Dict[str, torch.Tensor], factors: Factors,
               alpha: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """The encoder state dict with base + s * (A @ B)^T at every site; other
    entries as given. A pure function of its tensors: the finetune
    differentiates through it once a step."""
    s = lora_scale(factors, alpha)
    out = dict(encoder_state)
    for site, key in adapter_sites(_num_layers(factors)):
        w = out[key]
        delta = (factors[site]["a"] @ factors[site]["b"]) * s
        out[key] = w + delta.t().to(w.dtype)
    return out


def export_lora(factors: Factors, alpha: float) -> Dict[str, torch.Tensor]:
    """Factors -> the self-describing state dict of an adapter file (fp32
    on the CPU; motionstyle/models/lora.py:131-137)."""
    sd = {"lora.alpha": torch.tensor(float(alpha), dtype=torch.float32)}
    for site, _ in adapter_sites(_num_layers(factors)):
        for name in ("a", "b"):
            sd[f"lora.{site}.{name}"] = factors[site][name].detach().float().cpu().clone()
    return sd


def is_adapter_state_dict(sd: dict) -> bool:
    return any(str(k).startswith("lora.") for k in sd)


def import_lora(sd: dict) -> Tuple[Factors, float]:
    """An adapter file's state dict -> (factors as fp32 CPU tensors, alpha);
    the inverse of export_lora. Raises ValueError unless every site of the
    encoder depth it names has both factors."""
    factors: Factors = {}
    alpha = 0.0
    for k, v in sd.items():
        if not str(k).startswith("lora."):
            continue
        t = torch.as_tensor(v).detach().float().cpu()
        site, _, name = str(k)[len("lora."):].rpartition(".")
        if not site and name == "alpha":
            alpha = float(t.reshape(()))
            continue
        factors.setdefault(site, {})[name] = t
    if not factors:
        raise ValueError("state dict has no lora.* factor keys")
    want = {site for site, _ in adapter_sites(_num_layers(factors))}
    if set(factors) != want or any(set(p) != {"a", "b"} for p in factors.values()):
        raise ValueError(f"adapter sites {sorted(factors)} are not the sites of an encoder "
                         f"({sorted(want)}), each with 'a' and 'b'")
    return factors, alpha
