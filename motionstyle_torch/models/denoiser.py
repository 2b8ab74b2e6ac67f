"""MDM denoiser and the style-transfer model in PyTorch (trans_enc arch).

Counterpart of motionstyle/models/denoiser.py. Module and parameter names
follow the reference's state dict (mdm_forstyledataset.py), so a prior
checkpoint loads with its own keys: input_process.poseEmbedding,
embed_timestep.time_embed.{0,2}, embed_text, seqTransEncoder.layers.{i},
output_process.poseFinal.

As in the JAX package: batch-first (B, S, D); the CLIP embedding is hoisted
out of the forward (callers pass enc_text, already masked); compute runs in
cfg.dtype with fp32 parameters and an fp32 output; there is no key-padding
mask on the denoiser.

StyleDiffusion here holds the frozen prior ('mdm') and the style encoder
('style_encoder'), which is what sampling runs. The semantic discriminator
(motion_enc_encoder, mu/sigma queries) is not on this slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from motionstyle_torch.models.transformer import TransformerEncoder, dense


def sinusoidal_position_encoding(max_len: int, d_model: int) -> np.ndarray:
    """The classic sin/cos table; parity: mdm_forstyledataset.py:387-399."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


@dataclass(frozen=True)
class MDMConfig:
    """The fields of the JAX MDMConfig that this slice reads."""

    njoints: int = 181
    nfeats: int = 1
    latent_dim: int = 512
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 4
    clip_dim: int = 512
    max_len: int = 5000
    # compute dtype of the transformer stacks ('float32' | 'bfloat16');
    # parameters stay fp32 and the denoiser output is fp32
    dtype: str = "float32"
    # route the encoder stacks through the fused CUDA layer at inference
    fused: bool = False

    @property
    def input_feats(self) -> int:
        return self.njoints * self.nfeats

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]


class _InputProcess(nn.Module):
    def __init__(self, input_feats: int, latent_dim: int):
        super().__init__()
        self.poseEmbedding = nn.Linear(input_feats, latent_dim)


class _OutputProcess(nn.Module):
    def __init__(self, latent_dim: int, input_feats: int):
        super().__init__()
        self.poseFinal = nn.Linear(latent_dim, input_feats)


class TimestepEmbedder(nn.Module):
    """pe[t] -> Linear -> SiLU -> Linear; parity: TimestepEmbedder :408-422."""

    def __init__(self, latent_dim: int):
        super().__init__()
        self.time_embed = nn.Sequential(nn.Linear(latent_dim, latent_dim), nn.SiLU(),
                                        nn.Linear(latent_dim, latent_dim))

    def forward(self, timesteps: torch.Tensor, pe: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        h = pe.to(dtype)[timesteps]
        h = F.silu(dense(self.time_embed[0], h, dtype))
        return dense(self.time_embed[2], h, dtype)


class MDM(nn.Module):
    """The text-conditioned motion diffusion denoiser (predicts x0)."""

    def __init__(self, cfg: MDMConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.latent_dim
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_position_encoding(cfg.max_len, d)),
            persistent=False)
        self.input_process = _InputProcess(cfg.input_feats, d)
        self.embed_timestep = TimestepEmbedder(d)
        self.embed_text = nn.Linear(cfg.clip_dim, d)
        self.seqTransEncoder = TransformerEncoder(cfg.num_layers, d, cfg.num_heads,
                                                  cfg.ff_size)
        self.output_process = _OutputProcess(d, cfg.input_feats)

    def frames_to_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, F, T) motion -> (B, T, C*F) token sequence."""
        B, C, Fe, T = x.shape
        return x.permute(0, 3, 1, 2).reshape(B, T, C * Fe)

    def tokens_to_frames(self, h: torch.Tensor) -> torch.Tensor:
        B, T, _ = h.shape
        return h.reshape(B, T, self.cfg.njoints, self.cfg.nfeats).permute(0, 2, 3, 1)

    def embed_tokens(self, x: torch.Tensor, timesteps: torch.Tensor,
                     enc_text: Optional[torch.Tensor]) -> torch.Tensor:
        """[cond token; frame tokens] + pe, in the compute dtype."""
        dt = self.cfg.torch_dtype
        emb = self.embed_timestep(timesteps, self.pe, dt)  # (B, d)
        if enc_text is not None:
            emb = emb + dense(self.embed_text, enc_text, dt)
        h = dense(self.input_process.poseEmbedding, self.frames_to_tokens(x), dt)
        xseq = torch.cat([emb[:, None, :], h], dim=1)
        return xseq + self.pe.to(dt)[None, : xseq.shape[1]]

    def output_head(self, encoded: torch.Tensor) -> torch.Tensor:
        """Strip the condition token; (B, S, d) -> (B, C, F, T) fp32 motion."""
        out = dense(self.output_process.poseFinal, encoded[:, 1:], self.cfg.torch_dtype)
        return self.tokens_to_frames(out).float()

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                enc_text: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, C, F, T), timesteps (B,), enc_text (B, clip_dim) pre-masked.
        Parity: MDM.forward :315-364 (trans_enc)."""
        xseq = self.embed_tokens(x, timesteps, enc_text)
        out = self.seqTransEncoder(xseq, dtype=self.cfg.torch_dtype,
                                   use_fused=self.cfg.fused)
        return self.output_head(out)


class StyleDiffusion(nn.Module):
    """Frozen MDM prior + trainable style encoder; the style path borrows the
    prior's embedding and output modules (StyleDiffusion.forward :602-625)."""

    def __init__(self, cfg: MDMConfig):
        super().__init__()
        self.cfg = cfg
        self.mdm = MDM(cfg)
        self.style_encoder = TransformerEncoder(cfg.num_layers, cfg.latent_dim,
                                                cfg.num_heads, cfg.ff_size)

    def denoise_prior(self, x, timesteps, enc_text=None):
        return self.mdm(x, timesteps, enc_text)

    def embed_tokens(self, x, timesteps, enc_text=None):
        """Pre-encoder half of forward."""
        return self.mdm.embed_tokens(x, timesteps, enc_text)

    def output_head(self, encoded):
        """Post-encoder half of forward."""
        return self.mdm.output_head(encoded)

    def forward(self, x, timesteps, enc_text=None):
        xseq = self.embed_tokens(x, timesteps, enc_text)
        out = self.style_encoder(xseq, dtype=self.cfg.torch_dtype,
                                 use_fused=self.cfg.fused)
        return self.output_head(out)
