"""The system under test, assembled as its command-line tools assemble it:
StyleDiffusion and the CLIP text tower of motionstyle_torch on the device,
their weights drawn from the seed (harness/weights.py), wrapped in the
port's ModelBundle with its per-caption memo.
"""
from __future__ import annotations

import torch

from portbench.harness import traffic, weights


def mdm_config(cfg: dict, int8: bool = False):
    """The port's MDMConfig from a configuration file; int8 switches the
    program's own int8 serving path on (the inference cells' control)."""
    from motionstyle_torch.models.denoiser import MDMConfig

    return MDMConfig(
        njoints=cfg["njoints"], nfeats=cfg["nfeats"], latent_dim=cfg["latent_dim"],
        ff_size=cfg["ff_size"], num_layers=cfg["num_layers"], num_heads=cfg["num_heads"],
        clip_dim=cfg["clip_dim"], dtype=cfg["dtype"], dropout=cfg["dropout"],
        cond_mask_prob=cfg["cond_mask_prob"], fused=cfg["fused"],
        quant_int8=bool(cfg["quant_int8"] or int8), fused_train=cfg["fused_train"],
        fused_train_store=cfg["fused_train_store"], fused_train_prng=cfg["fused_train_prng"],
        arch=cfg["arch"])


def build(cfg: dict, seed: int, device, int8: bool = False):
    """The ModelBundle: the model and the text tower built on the device,
    every parameter overwritten from the seed."""
    from motionstyle_torch.cli.model_util import ModelBundle
    from motionstyle_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from motionstyle_torch.models.denoiser import StyleDiffusion

    mcfg = mdm_config(cfg, int8)
    c = cfg["clip"]
    with torch.device(device):
        model = StyleDiffusion(mcfg)
        clip = ClipTextEncoder(ClipTextConfig(
            vocab_size=c["vocab_size"], context_length=c["context_length"], width=c["width"],
            heads=c["heads"], layers=c["layers"], embed_dim=c["embed_dim"]))
    model.to(device)  # the position table is made on the host
    weights.load_into(model, model_weights(cfg, seed, device))
    weights.load_into(clip, clip_weights(cfg, seed, device))
    return ModelBundle(model.eval(), clip.eval(), mcfg, torch.device(device))


def model_weights(cfg: dict, seed: int, device) -> dict:
    return weights.draw(weights.style_diffusion_layout(cfg), traffic.sub_seed(seed, "weights"),
                        device)


def clip_weights(cfg: dict, seed: int, device) -> dict:
    return weights.draw(weights.clip_layout(cfg["clip"]), traffic.sub_seed(seed, "clip"), device)
