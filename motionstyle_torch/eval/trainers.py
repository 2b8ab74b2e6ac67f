"""Training of the T2M evaluator stack: the movement autoencoder and the
contrastive text-motion matching encoders (the networks whose checkpoints
drive FID and R-precision).

Counterpart of motionstyle/eval/trainers.py (parity:
data_loaders/humanml/networks/trainers.py DecompTrainerV3 :25, L1
reconstruction + latent sparsity + latent smoothness; TextMotionMatchTrainer
:879, the Hadsell-Chopra-LeCun contrastive loss over positive pairs and
index-shifted negatives with the movement encoder frozen). Each update is
one step of optax.chain(clip_by_global_norm(0.5), adam(lr)), written out in
ClippedAdam; the modules run on the trainer's device (the card unless
`device` names another; raises without a card) in true fp32. The
reference's Dropout(0.2) is not copied: the JAX modules have none.
Weights start seeded (models/params.py::seeded_init_), or come from the
JAX trainers' trees through load_jax_params.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from motionstyle_torch.cli.model_util import resolve_device
from motionstyle_torch.eval.evaluators import (
    MOTION_SPEC, MOVEMENT_SPEC, TEXT_SPEC, MotionEncoderBiGRUCo, MovementConvEncoder,
    TextEncoderBiGRUCo, state_from_jax, true_fp32)
from motionstyle_torch.models.params import seeded_init_


def contrastive_loss(out1: torch.Tensor, out2: torch.Tensor, label: torch.Tensor,
                     margin: float = 3.0) -> torch.Tensor:
    """Hadsell-Chopra-LeCun; parity: modules.py:11-24 (label 1 = negative)."""
    d = torch.sqrt(torch.clamp(((out1 - out2) ** 2).sum(-1), min=1e-12))
    return torch.mean((1 - label) * d ** 2 + label * torch.clamp(margin - d, min=0.0) ** 2)


class MovementConvDecoder(nn.Module):
    """Two stride-2 transposed convs + linear; parity modules.py:102-121. The
    JAX module's ConvTranspose with SAME padding at k=4, s=2 is
    ConvTranspose1d(k=4, s=2, p=1) with its taps reversed (DECODER_SPEC)."""

    def __init__(self, input_size: int = 512, hidden_size: int = 512, output_size: int = 259):
        super().__init__()
        self.main = nn.Sequential(
            nn.ConvTranspose1d(input_size, hidden_size, 4, 2, 1), nn.LeakyReLU(0.2),
            nn.ConvTranspose1d(hidden_size, output_size, 4, 2, 1), nn.LeakyReLU(0.2))
        self.out_net = nn.Linear(output_size, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, input_size) -> (B, 4 T, output_size)."""
        return self.out_net(self.main(x.transpose(1, 2)).transpose(1, 2))


DECODER_SPEC = [("main.0", ("deconv1",), "deconv"), ("main.2", ("deconv2",), "deconv"),
                ("out_net", ("out_net",), "dense")]


class ClippedAdam:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr)) over parameters:
    the global norm of every gradient (a missing one counts as zeros), the
    gradients scaled by max_norm / norm where norm >= max_norm (optax's
    (g / norm) * max_norm), then torch.optim.Adam (betas 0.9, 0.999, eps
    1e-8: optax.adam's update). max_norm None skips the clip."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 max_norm: Optional[float] = 0.5):
        self.params = list(params)
        self.max_norm = max_norm
        self.opt = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.max_norm is not None:
            grads = [p.grad for p in self.params]
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < self.max_norm
            for g in grads:
                g.copy_(torch.where(keep, g, (g / norm) * self.max_norm))
        self.opt.step()


def _logs(values: Dict[str, torch.Tensor]) -> dict:
    return {k: float(v.detach()) for k, v in values.items()}


def _state_to(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


class MovementAETrainer:
    """Movement autoencoder (DecompTrainerV3).

    strip_fc: drop the trailing 4 foot-contact channels before encoding (the
    humanml/kit 263/251 convention); posrot layouts train on the full
    features. Defaults from dim_pose."""

    def __init__(self, dim_pose: int = 263, lr: float = 1e-4, lambda_sparsity: float = 1e-3,
                 lambda_smooth: float = 1e-3, seed: int = 0, strip_fc: Optional[bool] = None,
                 device="cuda"):
        self.strip_fc = dim_pose in (263, 251) if strip_fc is None else strip_fc
        in_dim = dim_pose - 4 if self.strip_fc else dim_pose
        self.device = resolve_device(device)
        self.enc = seeded_init_(MovementConvEncoder(in_dim), seed).to(self.device)
        self.dec = seeded_init_(MovementConvDecoder(output_size=in_dim), seed + 1).to(self.device)
        self.opt = ClippedAdam([*self.enc.parameters(), *self.dec.parameters()], lr)
        self.lambda_sparsity = lambda_sparsity
        self.lambda_smooth = lambda_smooth

    def load_jax_params(self, tree: dict) -> "MovementAETrainer":
        """The JAX trainer's params {"enc": ..., "dec": ...}."""
        self.enc.load_state_dict(state_from_jax(MOVEMENT_SPEC, tree["enc"]))
        self.dec.load_state_dict(state_from_jax(DECODER_SPEC, tree["dec"]))
        return self

    def update(self, motions) -> dict:
        motions = torch.as_tensor(np.asarray(motions, dtype=np.float32), device=self.device)
        x = motions[..., :-4] if self.strip_fc else motions
        self.opt.zero_grad()
        with true_fp32():
            lat = self.enc(x)
            rec = self.dec(lat)
            loss_rec = (rec - x).abs().mean()
            loss_sparsity = lat.abs().mean()
            loss_smooth = (lat[:, 1:] - lat[:, :-1]).abs().mean()
            loss = (loss_rec + self.lambda_sparsity * loss_sparsity
                    + self.lambda_smooth * loss_smooth)
            loss.backward()
            self.opt.step()
        return _logs({"loss": loss, "loss_rec": loss_rec, "loss_sparsity": loss_sparsity,
                      "loss_smooth": loss_smooth})


class TextMotionMatchTrainer:
    """Contrastive co-embedding training: the text and motion encoders
    train, the movement encoder (a state dict in the reference layout, e.g.
    MovementAETrainer.enc's) is frozen. Each update's negative shift comes
    from the global numpy stream (np.random.randint), as in the JAX trainer."""

    def __init__(self, movement_state: Dict[str, torch.Tensor], dim_pose: int = 263,
                 lr: float = 1e-4, negative_margin: float = 3.0, unit_length: int = 4,
                 seed: int = 0, strip_fc: Optional[bool] = None, device="cuda"):
        self.strip_fc = dim_pose in (263, 251) if strip_fc is None else strip_fc
        in_dim = dim_pose - 4 if self.strip_fc else dim_pose
        self.device = resolve_device(device)
        self.movement_enc = MovementConvEncoder(in_dim)
        self.movement_enc.load_state_dict(movement_state)
        self.movement_enc.to(self.device).eval().requires_grad_(False)
        self.text_enc = seeded_init_(TextEncoderBiGRUCo(), seed).to(self.device)
        self.motion_enc = seeded_init_(MotionEncoderBiGRUCo(), seed + 1).to(self.device)
        self.opt = ClippedAdam([*self.text_enc.parameters(), *self.motion_enc.parameters()], lr)
        self.margin = negative_margin
        self.unit_length = unit_length

    def load_jax_params(self, tree: dict) -> "TextMotionMatchTrainer":
        """The JAX trainer's params {"text": ..., "motion": ...}."""
        self.text_enc.load_state_dict(state_from_jax(TEXT_SPEC, tree["text"]))
        self.motion_enc.load_state_dict(state_from_jax(MOTION_SPEC, tree["motion"]))
        return self

    def update(self, word_embs, pos_ohot, cap_lens, motions, m_lens) -> dict:
        """One contrastive step; motions pre-sorted by descending m_lens as in
        the reference (the caller aligns them)."""
        shift = int(np.random.randint(1, max(2, len(motions))))
        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32), device=self.device)

        motions = t(motions)
        feats = motions[..., :-4] if self.strip_fc else motions
        self.opt.zero_grad()
        with true_fp32():
            with torch.no_grad():
                movements = self.movement_enc(feats)
            motion_emb = self.motion_enc(movements, np.asarray(m_lens) // self.unit_length)
            text_emb = self.text_enc(t(word_embs), t(pos_ohot), np.asarray(cap_lens))
            B = text_emb.shape[0]
            zeros = torch.zeros(B, device=self.device)
            loss_pos = contrastive_loss(text_emb, motion_emb, zeros, self.margin)
            mis = torch.roll(motion_emb, shift, dims=0)
            loss_neg = contrastive_loss(text_emb, mis, zeros + 1, self.margin)
            loss = loss_pos + loss_neg
            loss.backward()
            self.opt.step()
        return _logs({"loss": loss, "loss_pos": loss_pos, "loss_neg": loss_neg})


def save_evaluator(path: str, movement_enc: nn.Module, text_enc: nn.Module,
                   motion_enc: nn.Module, epoch: int = 0) -> str:
    """Write the trained evaluator in the reference finest.tar layout
    (movement_encoder / text_encoder / motion_encoder torch state dicts,
    evaluator_wrapper.py:95-121): the port's EvaluatorWrapper, the JAX
    package's and the reference all load it."""
    torch.save({"movement_encoder": _state_to(movement_enc.state_dict()),
                "text_encoder": _state_to(text_enc.state_dict()),
                "motion_encoder": _state_to(motion_enc.state_dict()),
                "epoch": epoch}, path)
    return path
