"""Plain prior pretraining steps (MDM's objective): x_t = q_sample(x0, t,
noise), the x0 prediction's squared error over each clip's valid frames,
the mean over the batch, the gradient of the prior's parameters by
autograd, and AdamW (Loshchilov and Hutter) with bias correction.

Every draw comes from one generator on the device seeded as the trainer's,
in the trainer's order: the timesteps, the noise, the condition dropout
(CFG), the dropout after the positional encoding, then each encoder layer's
three dropout sites. A kept element is scaled by 1/keep rounded to the
configuration's compute type (bfloat16: the JAX package's masks).
"""
from __future__ import annotations

import torch

from portbench.reference import clip as ref_clip
from portbench.reference import diffusion as ref_diff
from portbench.reference import mdm as ref_mdm


def run(w: dict, clip_w: dict, cfg: dict, batches: list, seed: int, device, lr: float,
        betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
        prec: str = "fp32") -> dict:
    """{'loss': [per step], 'grad': {leaf: the first step's gradient},
    'change': {leaf: the parameters' change over all steps}} for the
    prior's leaves ('mdm.*')."""
    names = [k for k in w if k.startswith("mdm.")]
    params = {k: w[k].detach().clone().requires_grad_(True) for k in names}
    start = {k: w[k].detach().clone() for k in names}
    m = {k: torch.zeros_like(start[k]) for k in names}
    v = {k: torch.zeros_like(start[k]) for k in names}
    gen = torch.Generator(device=device).manual_seed(int(seed))
    s = ref_diff.Schedule(cfg["diffusion_steps"], None, device)
    keep = 1.0 - cfg["dropout"]
    scale = float(torch.tensor(1.0 / keep, dtype=getattr(torch, cfg["dtype"])))
    d, f, L = cfg["latent_dim"], cfg["ff_size"], cfg["num_layers"]
    out = {"loss": [], "grad": {}, "change": {}}

    def mask(shape):
        return (torch.rand(shape, generator=gen, device=device) < keep).float() * scale

    for step, (x0, texts, frame_mask) in enumerate(batches, 1):
        x0 = torch.as_tensor(x0, device=device)
        frame_mask = torch.as_tensor(frame_mask, device=device)
        B, C, Fe, T = x0.shape
        with torch.no_grad():
            enc = ref_clip.encode_texts(clip_w, texts, cfg["clip"], device)
        t = torch.randint(0, s.n, (B,), generator=gen, device=device)
        noise = torch.randn(x0.shape, generator=gen, device=device)
        xt = s.sqrt_ac[t].view(B, 1, 1, 1) * x0 + s.sqrt_1m_ac[t].view(B, 1, 1, 1) * noise
        cond = torch.rand((B, 1), generator=gen, device=device) < 1.0 - cfg["cond_mask_prob"]
        enc = enc * cond.float()
        pe_mask = mask((B, T + 1, d))
        layer_masks = [(mask((B, T + 1, d)), mask((B, T + 1, f)), mask((B, T + 1, d)))
                       for _ in range(L)]
        with torch.enable_grad():
            pred = ref_mdm.denoise({**w, **params}, xt, t, enc, cfg, prec=prec,
                                   pe_mask=pe_mask, layer_masks=layer_masks)
            sse = (((pred - x0) ** 2) * frame_mask).sum(dim=(1, 2, 3))
            per = sse / (frame_mask.sum(dim=(1, 2, 3)).clamp_min(1.0) * (C * Fe))
            loss = per.mean()
            grads = torch.autograd.grad(loss, [params[k] for k in names])
        out["loss"].append(float(loss))
        if step == 1:
            out["grad"] = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            b1, b2 = betas
            for k, g in zip(names, grads):
                p = params[k]
                p.mul_(1.0 - lr * weight_decay)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k].sqrt() / (1 - b2 ** step) ** 0.5).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** step))
        del pred, layer_masks, grads
    out["change"] = {k: params[k].detach() - start[k] for k in names}
    return out
