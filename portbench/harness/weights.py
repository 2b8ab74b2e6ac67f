"""Weights drawn from the seed on the device, in one large call per model.

The layout (names, shapes, how each leaf is scaled) is written here from the
configuration, in the published MDM and CLIP state-dict layouts, so the same
weights are handed to the program's modules and to the plain reference
without either side deriving them from the other. All leaves are fp32, the
type the program keeps its parameters in.
"""
from __future__ import annotations

import torch

# leaf kinds: how a standard normal draw becomes the leaf
#   w: std 1/sqrt(fan_in); b: std 0.02; g: 1 + 0.05 n (LayerNorm scale);
#   e: std 0.02 (token embedding, LayerNorm shift); p: std 0.01; q: std 1
_SCALE = {"b": 0.02, "g": 0.05, "e": 0.02, "p": 0.01, "q": 1.0}


def encoder_layout(prefix: str, layers: int, d: int, f: int) -> list:
    """torch.nn.TransformerEncoderLayer's keys under `prefix`."""
    out = []
    for i in range(layers):
        p = f"{prefix}.layers.{i}."
        out += [(p + "self_attn.in_proj_weight", (3 * d, d), "w"),
                (p + "self_attn.in_proj_bias", (3 * d,), "b"),
                (p + "self_attn.out_proj.weight", (d, d), "w"),
                (p + "self_attn.out_proj.bias", (d,), "b"),
                (p + "linear1.weight", (f, d), "w"), (p + "linear1.bias", (f,), "b"),
                (p + "linear2.weight", (d, f), "w"), (p + "linear2.bias", (d,), "b"),
                (p + "norm1.weight", (d,), "g"), (p + "norm1.bias", (d,), "e"),
                (p + "norm2.weight", (d,), "g"), (p + "norm2.bias", (d,), "e")]
    return out


def style_diffusion_layout(cfg: dict) -> list:
    """(name, shape, kind) of every parameter of StyleDiffusion: the MDM
    prior ('mdm.'), the style encoder and the semantic discriminator."""
    d, f, L = cfg["latent_dim"], cfg["ff_size"], cfg["num_layers"]
    c = cfg["njoints"] * cfg["nfeats"]
    mdm = [("mdm.input_process.poseEmbedding.weight", (d, c), "w"),
           ("mdm.input_process.poseEmbedding.bias", (d,), "b"),
           ("mdm.embed_timestep.time_embed.0.weight", (d, d), "w"),
           ("mdm.embed_timestep.time_embed.0.bias", (d,), "b"),
           ("mdm.embed_timestep.time_embed.2.weight", (d, d), "w"),
           ("mdm.embed_timestep.time_embed.2.bias", (d,), "b"),
           ("mdm.embed_text.weight", (d, cfg["clip_dim"]), "w"),
           ("mdm.embed_text.bias", (d,), "b")]
    mdm += encoder_layout("mdm.seqTransEncoder", L, d, f)
    mdm += [("mdm.output_process.poseFinal.weight", (c, d), "w"),
            ("mdm.output_process.poseFinal.bias", (c,), "b")]
    return (mdm + encoder_layout("style_encoder", L, d, f)
            + [("mu_query", (1, d), "q"), ("sigma_query", (1, d), "q")]
            + encoder_layout("motion_enc_encoder", L, d, f))


def clip_layout(clip: dict) -> list:
    """OpenAI CLIP's text-tower keys at the configuration's widths."""
    w, e = clip["width"], clip["embed_dim"]
    out = [("token_embedding.weight", (clip["vocab_size"], w), "e"),
           ("positional_embedding", (clip["context_length"], w), "p")]
    for i in range(clip["layers"]):
        p = f"transformer.resblocks.{i}."
        out += [(p + "ln_1.weight", (w,), "g"), (p + "ln_1.bias", (w,), "e"),
                (p + "attn.in_proj_weight", (3 * w, w), "w"),
                (p + "attn.in_proj_bias", (3 * w,), "b"),
                (p + "attn.out_proj.weight", (w, w), "w"), (p + "attn.out_proj.bias", (w,), "b"),
                (p + "ln_2.weight", (w,), "g"), (p + "ln_2.bias", (w,), "e"),
                (p + "mlp.c_fc.weight", (4 * w, w), "w"), (p + "mlp.c_fc.bias", (4 * w,), "b"),
                (p + "mlp.c_proj.weight", (w, 4 * w), "w"), (p + "mlp.c_proj.bias", (w,), "b")]
    return out + [("ln_final.weight", (w,), "g"), ("ln_final.bias", (w,), "e"),
                  ("text_projection", (w, e), "w")]


def draw(layout: list, seed: int, device) -> dict:
    """{name: fp32 tensor} for `layout`: one standard-normal draw of every
    element from a generator on `device` seeded with `seed`, cut into the
    leaves in layout order and scaled in place."""
    total = sum(_numel(shape) for _, shape, _ in layout)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, kind in layout:
        n = _numel(shape)
        leaf = flat[off:off + n].view(shape)
        off += n
        if kind == "w":
            leaf.mul_(shape[1] ** -0.5 if name != "text_projection" else shape[0] ** -0.5)
        elif kind == "g":
            leaf.mul_(_SCALE["g"]).add_(1.0)
        else:
            leaf.mul_(_SCALE[kind])
        out[name] = leaf
    return out


def load_into(module: torch.nn.Module, weights: dict) -> None:
    """Copy `weights` into the module's parameters; every parameter must
    have a leaf of its shape."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        missing, extra = sorted(set(params) - set(weights)), sorted(set(weights) - set(params))
        raise KeyError(f"weight layout does not match the module: missing {missing[:4]}, "
                       f"unexpected {extra[:4]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
