"""MDM denoiser, the style-transfer model and the humanml residual-code model
in PyTorch.

Counterpart of motionstyle/models/denoiser.py. Module and parameter names
follow the reference's state dict (mdm_forstyledataset.py), so a prior
checkpoint loads with its own keys: input_process.poseEmbedding,
embed_timestep.time_embed.{0,2}, embed_text, seqTransEncoder.layers.{i},
output_process.poseFinal.

As in the JAX package: batch-first (B, S, D); the CLIP embedding is hoisted
out of the forward (callers pass enc_text, already masked); compute runs in
cfg.dtype with fp32 parameters and an fp32 output; there is no key-padding
mask on the denoiser.

StyleDiffusion holds the frozen prior ('mdm'), the trainable style encoder
('style_encoder') and the frozen semantic discriminator ('mu_query',
'sigma_query', 'motion_enc_encoder'), as the JAX model does.

Training forwards: `deterministic=False` applies the JAX model's dropout
(the positional-encoding dropout of _apply_pe and the encoder layers' three
sites) with masks drawn from an explicit torch.Generator. A caller that
re-seeds the generator redraws the same masks, which a step recomputed under
torch.utils.checkpoint needs. With cfg.fused_train the encoder stacks of a
training forward run the CUDA training layer, except under cfg.quant_int8,
where they run the plain layers as the JAX model's do; with cfg.fused an
inference forward runs the CUDA inference layer, and with cfg.quant_int8
(which implies it) the int8 CUDA layer.

MDM also takes the reference's other architectures (cfg.arch, JAX
denoiser.py:136-149, :180-203): 'trans_dec', the post-LN decoder over the
frame tokens with the condition embedding as its one-token memory (with
cfg.emb_trans_dec the condition token leads the sequence too), and 'gru', a
GRU over the frame tokens plus the condition embedding. StyleDiffusion stays
trans_enc only, as in the JAX package. DiffuseTransfer is the humanml
variant (DiffuseTrasnfer, sic, :628-760): the condition is the CLIP text
plus the residual style_code - content_code, through its own
transfer_encoder (plain layers, as the JAX module runs it).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from motionstyle_torch.models.transformer import (
    GRUStack, TransformerDecoder, TransformerEncoder, dense)


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
    dropout: float = 0.1
    # train-time condition dropout (CFG), applied by mask_cond
    cond_mask_prob: float = 0.1
    # route the encoder stacks through the fused CUDA layer at inference
    fused: bool = False
    # int8 serving: inference forwards run the int8 CUDA layer (implies fused)
    quant_int8: bool = False
    # route the encoder stacks of training forwards through the fused CUDA
    # training layer (forward and backward kernels)
    fused_train: bool = False
    # with fused_train: the forward keeps the softmax probabilities and qkv,
    # and the attention backward reads them instead of recomputing them
    fused_train_store: bool = False
    # with fused_train: the kernels generate the dropout masks themselves from
    # per-(clip, layer) seeds (Philox, kernel 10) instead of reading mask
    # arrays; the draws differ from the masks mode's, the statistics agree
    fused_train_prng: bool = False
    # 'trans_enc' | 'trans_dec' | 'gru' (the reference's --arch)
    arch: str = "trans_enc"
    # trans_dec: the condition token also leads the decoder's sequence
    emb_trans_dec: bool = False

    def __post_init__(self):
        # either variant of the fused training layer implies it, as the JAX
        # CLIs normalize it (motionstyle/cli/model_util.py:50-53, :74-81)
        if self.fused_train_store or self.fused_train_prng:
            object.__setattr__(self, "fused_train", True)

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

    def __init__(self, cfg: MDMConfig, stack: bool = True):
        """stack=False leaves out the sequence model (encoder, decoder or
        GRU): DiffuseTransfer borrows only the embeddings and heads."""
        super().__init__()
        self.cfg = cfg
        d = cfg.latent_dim
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_position_encoding(cfg.max_len, d)),
            persistent=False)
        self.input_process = _InputProcess(cfg.input_feats, d)
        self.embed_timestep = TimestepEmbedder(d)
        self.embed_text = nn.Linear(cfg.clip_dim, d)
        if cfg.arch not in ("trans_enc", "trans_dec", "gru"):
            raise ValueError("Please choose correct architecture [trans_enc, trans_dec, gru]")
        if cfg.arch == "gru" and cfg.dtype != "float32":
            # the JAX GRU's scan carries the compute dtype while its cell
            # computes in fp32, so it runs in float32 only
            raise ValueError("arch='gru' runs in dtype float32 only")
        if stack and cfg.arch == "trans_enc":
            self.seqTransEncoder = TransformerEncoder(cfg.num_layers, d, cfg.num_heads,
                                                      cfg.ff_size, cfg.dropout)
        elif stack and cfg.arch == "trans_dec":
            self.seqTransDecoder = TransformerDecoder(cfg.num_layers, d, cfg.num_heads,
                                                      cfg.ff_size, cfg.dropout)
        elif stack:
            self.gru = GRUStack(d, d, cfg.num_layers)
        self.output_process = _OutputProcess(d, cfg.input_feats)

    def frames_to_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, F, T) motion -> (B, T, C*F) token sequence."""
        B, C, Fe, T = x.shape
        return x.permute(0, 3, 1, 2).reshape(B, T, C * Fe)

    def tokens_to_frames(self, h: torch.Tensor) -> torch.Tensor:
        B, T, _ = h.shape
        return h.reshape(B, T, self.cfg.njoints, self.cfg.nfeats).permute(0, 2, 3, 1)

    def apply_pe(self, xseq: torch.Tensor, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """+ the positional encoding, then its dropout in a training forward
        (JAX _apply_pe, denoiser.py:162-166)."""
        xseq = xseq + self.pe.to(xseq.dtype)[None, : xseq.shape[1]]
        if not deterministic and self.cfg.dropout > 0.0:
            keep = 1.0 - self.cfg.dropout
            bits = torch.rand(xseq.shape, generator=generator, device=xseq.device)
            xseq = xseq * ((bits < keep).to(xseq.dtype) / keep)
        return xseq

    def embed_frames(self, x: torch.Tensor, timesteps: torch.Tensor,
                     enc_text: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(condition embedding (B, d): the timestep's + the text's, frame
        tokens (B, T, d)), in the compute dtype."""
        dt = self.cfg.torch_dtype
        emb = self.embed_timestep(timesteps, self.pe, dt)
        if enc_text is not None:
            emb = emb + dense(self.embed_text, enc_text, dt)
        return emb, dense(self.input_process.poseEmbedding, self.frames_to_tokens(x), dt)

    def embed_tokens(self, x: torch.Tensor, timesteps: torch.Tensor,
                     enc_text: Optional[torch.Tensor], deterministic: bool = True,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[cond token; frame tokens] + pe, in the compute dtype."""
        emb, h = self.embed_frames(x, timesteps, enc_text)
        return self.lead_with_condition(emb, h, deterministic, generator)

    def lead_with_condition(self, emb: torch.Tensor, h: torch.Tensor,
                            deterministic: bool = True,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[emb; h] + pe: the condition token leads the frame tokens."""
        return self.apply_pe(torch.cat([emb[:, None, :], h], dim=1), deterministic, generator)

    def run_encoder(self, encoder: TransformerEncoder, xseq: torch.Tensor,
                    deterministic: bool = True,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """An encoder stack routed as the JAX model routes it
        (motionstyle/models/denoiser.py:185-187, :267-269): the inference
        kernel with cfg.fused or cfg.quant_int8 at inference (the int8 one
        with cfg.quant_int8), the training kernels with cfg.fused_train in a
        training forward (store-probs with cfg.fused_train_store, in-kernel
        dropout with cfg.fused_train_prng) unless cfg.quant_int8, else the
        plain layers."""
        cfg = self.cfg
        return encoder(xseq, dtype=cfg.torch_dtype, use_fused=cfg.fused or cfg.quant_int8,
                       fused_train=cfg.fused_train, deterministic=deterministic,
                       generator=generator, store_probs=cfg.fused_train_store,
                       use_int8=cfg.quant_int8, in_kernel_prng=cfg.fused_train_prng)

    def output_head(self, encoded: torch.Tensor) -> torch.Tensor:
        """Strip the condition token; (B, S, d) -> (B, C, F, T) fp32 motion."""
        out = dense(self.output_process.poseFinal, encoded[:, 1:], self.cfg.torch_dtype)
        return self.tokens_to_frames(out).float()

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                enc_text: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, C, F, T), timesteps (B,), enc_text (B, clip_dim) pre-masked.
        Parity: MDM.forward :315-364 (JAX :168-203)."""
        cfg = self.cfg
        if cfg.arch == "trans_enc":
            xseq = self.embed_tokens(x, timesteps, enc_text, deterministic, generator)
            return self.output_head(self.run_encoder(self.seqTransEncoder, xseq,
                                                     deterministic, generator))
        dt = cfg.torch_dtype
        emb, h = self.embed_frames(x, timesteps, enc_text)
        if cfg.arch == "trans_dec":
            xseq = (self.lead_with_condition(emb, h, deterministic, generator)
                    if cfg.emb_trans_dec else self.apply_pe(h, deterministic, generator))
            out = self.seqTransDecoder(xseq, emb[:, None, :], dt, deterministic, generator)
            if cfg.emb_trans_dec:
                out = out[:, 1:]
        else:  # gru
            out = self.gru(self.apply_pe(h + emb[:, None, :], deterministic, generator))
        out = dense(self.output_process.poseFinal, out, dt)
        return self.tokens_to_frames(out).float()


class StyleDiffusion(nn.Module):
    """Frozen MDM prior + trainable style encoder + frozen semantic
    discriminator; the style path borrows the prior's embedding and output
    modules (StyleDiffusion.forward :602-625)."""

    def __init__(self, cfg: MDMConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.latent_dim
        self.mdm = MDM(cfg)
        self.style_encoder = TransformerEncoder(cfg.num_layers, d, cfg.num_heads,
                                                cfg.ff_size, cfg.dropout)
        # the semantic discriminator (MotionEncoder :11), registered after the
        # style encoder so the seeded draws of the modules above stay as they were
        self.mu_query = nn.Parameter(torch.zeros(1, d))
        self.sigma_query = nn.Parameter(torch.zeros(1, d))
        self.motion_enc_encoder = TransformerEncoder(cfg.num_layers, d, cfg.num_heads,
                                                     cfg.ff_size, cfg.dropout)

    def denoise_prior(self, x, timesteps, enc_text=None, deterministic=True, generator=None):
        return self.mdm(x, timesteps, enc_text, deterministic, generator)

    def embed_tokens(self, x, timesteps, enc_text=None, deterministic=True, generator=None):
        """Pre-encoder half of forward."""
        return self.mdm.embed_tokens(x, timesteps, enc_text, deterministic, generator)

    def output_head(self, encoded):
        """Post-encoder half of forward."""
        return self.mdm.output_head(encoded)

    def forward(self, x, timesteps, enc_text=None, deterministic=True, generator=None):
        xseq = self.embed_tokens(x, timesteps, enc_text, deterministic, generator)
        return self.output_head(self.mdm.run_encoder(self.style_encoder, xseq,
                                                     deterministic, generator))

    def encode_motion(self, x: torch.Tensor, frame_mask: Optional[torch.Tensor] = None,
                      deterministic: bool = True,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """MotionEncoder.forward :90-124 -> mu (B, d) through the plain
        (unfused) layers, as the JAX package runs it; gradients reach x.
        Deterministic as the finetune calls it; deterministic=False is the
        semantic trainer's training forward (dropout from `generator`).
        x (B, C, F, T); frame_mask (B, T) with True = valid frame."""
        return _encode_motion_mu(self.mdm, self.mu_query, self.sigma_query,
                                 self.motion_enc_encoder, x, frame_mask, deterministic,
                                 generator)

    @staticmethod
    def is_trainable(name: str) -> bool:
        """True for the trainable parameters (parameters_wo_enc :588): the
        style encoder's only (JAX trainable_param_filter, :417-419)."""
        return name.startswith("style_encoder.")


class DiffuseTransfer(nn.Module):
    """humanml variant: the condition is the CLIP text plus the residual
    style_code - content_code (DiffuseTrasnfer, sic, :628-760; JAX :327-388).
    Holds the prior's embeddings and heads ('mdm', without its stack), the
    semantic discriminator ('mu_query', 'sigma_query', 'motion_enc_encoder')
    and the trainable 'transfer_encoder'."""

    def __init__(self, cfg: MDMConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.latent_dim
        self.mdm = MDM(cfg, stack=False)
        self.mu_query = nn.Parameter(torch.zeros(1, d))
        self.sigma_query = nn.Parameter(torch.zeros(1, d))
        self.motion_enc_encoder = TransformerEncoder(cfg.num_layers, d, cfg.num_heads,
                                                     cfg.ff_size, cfg.dropout)
        self.transfer_encoder = TransformerEncoder(cfg.num_layers, d, cfg.num_heads,
                                                   cfg.ff_size, cfg.dropout)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, enc_text: torch.Tensor,
                style_code: torch.Tensor, content_code: torch.Tensor,
                deterministic: bool = True, uncond: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Denoise x_t on text + the style-content residual (:733-760):
        input_mu = enc_text + (style_code - content_code); uncond zeroes the
        whole condition (force_mask); a training forward drops it per clip
        with cfg.cond_mask_prob (mask_cond, bits from `generator`)."""
        input_mu = enc_text + (style_code - content_code)
        if uncond:
            input_mu = torch.zeros_like(input_mu)
        elif not deterministic and self.cfg.cond_mask_prob > 0.0:
            input_mu = mask_cond(input_mu, self.cfg.cond_mask_prob, generator)
        xseq = self.mdm.embed_tokens(x, timesteps, input_mu, deterministic, generator)
        out = self.transfer_encoder(xseq, dtype=self.cfg.torch_dtype,
                                    deterministic=deterministic, generator=generator)
        return self.mdm.output_head(out)

    def encode_motion(self, x: torch.Tensor, frame_mask: Optional[torch.Tensor] = None,
                      deterministic: bool = True,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The semantic discriminator's mu (B, d), as StyleDiffusion's."""
        return _encode_motion_mu(self.mdm, self.mu_query, self.sigma_query,
                                 self.motion_enc_encoder, x, frame_mask, deterministic,
                                 generator)


def _encode_motion_mu(mdm: MDM, mu_query, sigma_query, encoder: TransformerEncoder,
                      x: torch.Tensor, frame_mask: Optional[torch.Tensor],
                      deterministic: bool = True,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[mu token; sigma token; frame tokens] + pe through the discriminator's
    encoder with a key-padding mask over the frames; returns the mu token
    (JAX _encode_motion_mu, denoiser.py:390-406)."""
    dt = mdm.cfg.torch_dtype
    B, T = x.shape[0], x.shape[-1]
    h = dense(mdm.input_process.poseEmbedding, mdm.frames_to_tokens(x), dt)
    d = h.shape[-1]
    xseq = torch.cat([mu_query.to(dt).expand(B, 1, d), sigma_query.to(dt).expand(B, 1, d), h],
                     dim=1)
    xseq = mdm.apply_pe(xseq, deterministic, generator)
    if frame_mask is None:
        frame_mask = torch.ones((B, T), dtype=torch.bool, device=x.device)
    kpm = torch.cat([torch.ones((B, 2), dtype=torch.bool, device=x.device),
                     frame_mask.to(device=x.device, dtype=torch.bool)], dim=1)
    return encoder(xseq, kpm, dtype=dt, deterministic=deterministic, generator=generator)[:, 0]


def mask_cond(enc_text: torch.Tensor, cond_mask_prob: float,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Training-time CFG condition dropout: zero each clip's condition with
    probability cond_mask_prob (parity: mask_cond :288-296, JAX :409-415)."""
    if cond_mask_prob <= 0.0:
        return enc_text
    keep = torch.rand((enc_text.shape[0], 1), generator=generator,
                      device=enc_text.device) < 1.0 - cond_mask_prob
    return enc_text * keep.to(enc_text.dtype)
