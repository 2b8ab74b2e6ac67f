"""The T2M (Guo et al.) generator stack of the port: the text-conditioned
VAE motion generator (CompV6) and the length estimator, which produce the
t2m/ assets the evaluation consumes.

Counterpart of motionstyle/eval/t2m_generator.py (parity: modules.py —
TextVAEDecoder :123, TextDecoder :187, AttLayer :232, TextEncoderBiGRU :270,
MotionLenEstimatorBiGRU :389; trainers.py CompTrainerV6 :211,
LengthEstTrainer :748). The modules follow the reference's torch layout;
*_SPEC maps each onto the JAX package's flax tree, both ways, so
t2m_generator.pkl (flax trees of numpy) crosses packages.

Randomness: the VAE's z noise is drawn per step from a torch.Generator on
the generator's device where the JAX package splits a key; a caller pins it
by passing the draws (generate's z_noise, train_step's noise). The
teacher-forcing coin of train_step is the global np.random.rand(), as in
the JAX package. Everything runs on the generator's device (the card
unless `device` names another; raises without a card) in true fp32.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from motionstyle_torch.cli.model_util import resolve_device
from motionstyle_torch.eval.evaluators import (
    MOVEMENT_SPEC, MovementConvEncoder, host_lengths, jax_from_state, prefixed, run_gru,
    state_from_jax, true_fp32)
from motionstyle_torch.eval.trainers import DECODER_SPEC, ClippedAdam, MovementConvDecoder
from motionstyle_torch.models.denoiser import sinusoidal_position_encoding
from motionstyle_torch.models.params import seeded_init_


class _StepGRU(nn.Module):
    """emb + sinusoidal step code, stacked GRU cells seeded from the text
    latent (z2init); the shared body of TextVAEDecoder and TextDecoder."""

    def __init__(self, text_size: int, input_size: int, hidden_size: int, n_layers: int):
        super().__init__()
        self.emb = nn.Sequential(nn.Linear(input_size, hidden_size), nn.LayerNorm(hidden_size),
                                 nn.LeakyReLU(0.2))
        self.z2init = nn.Linear(text_size, hidden_size * n_layers)
        self.gru = nn.ModuleList([nn.GRUCell(hidden_size, hidden_size) for _ in range(n_layers)])
        self.register_buffer("pe", torch.from_numpy(sinusoidal_position_encoding(2000,
                                                                                  hidden_size)),
                             persistent=False)

    def get_init_hidden(self, latent: torch.Tensor) -> List[torch.Tensor]:
        return list(self.z2init(latent).chunk(len(self.gru), dim=-1))

    def _cells(self, inputs, hidden, p):
        h_in = self.emb(inputs) + self.pe[p]
        new_hidden = []
        for cell, h in zip(self.gru, hidden):
            h_in = cell(h_in, h)
            new_hidden.append(h_in)
        return h_in, new_hidden

    def spec(self) -> list:
        out = [("emb.0", ("emb", "emb_0"), "dense"), ("emb.1", ("emb", "emb_1"), "ln"),
               ("z2init", ("z2init",), "dense")]
        return out + [(f"gru.{i}", (f"gru_{i}",), "gru_cell") for i in range(len(self.gru))]


class TextVAEDecoder(_StepGRU):
    """One autoregressive step: (input, hidden list, step index) -> pose."""

    def __init__(self, text_size: int = 512, input_size: int = 128 + 263,
                 output_size: int = 263, hidden_size: int = 1024, n_layers: int = 1):
        super().__init__(text_size, input_size, hidden_size, n_layers)
        self.output = nn.Sequential(nn.Linear(hidden_size, hidden_size),
                                    nn.LayerNorm(hidden_size), nn.LeakyReLU(0.2),
                                    nn.Linear(hidden_size, output_size))

    def forward(self, inputs, hidden, p):
        h, new_hidden = self._cells(inputs, hidden, p)
        return self.output(h), new_hidden

    def spec(self) -> list:
        return super().spec() + [("output.0", ("out_0",), "dense"),
                                 ("output.1", ("out_1",), "ln"),
                                 ("output.3", ("out_3",), "dense")]


class TextDecoder(_StepGRU):
    """The VAE's prior or posterior: one step -> (z, mu, logvar, hidden),
    z = mu + exp(logvar / 2) * noise with noise (B, output_size) given."""

    def __init__(self, text_size: int = 512, input_size: int = 263, output_size: int = 128,
                 hidden_size: int = 1024, n_layers: int = 1):
        super().__init__(text_size, input_size, hidden_size, n_layers)
        self.mu_net = nn.Linear(hidden_size, output_size)
        self.logvar_net = nn.Linear(hidden_size, output_size)

    def forward(self, inputs, hidden, p, noise):
        h, new_hidden = self._cells(inputs, hidden, p)
        mu, logvar = self.mu_net(h), self.logvar_net(h)
        return mu + torch.exp(0.5 * logvar) * noise, mu, logvar, new_hidden

    def spec(self) -> list:
        return super().spec() + [("mu_net", ("mu_net",), "dense"),
                                 ("logvar_net", ("logvar_net",), "dense")]


class AttLayer(nn.Module):
    """Additive attention over the word sequence; parity modules.py:232."""

    def __init__(self, query_dim: int, key_dim: int, value_dim: int = 512):
        super().__init__()
        self.W_q = nn.Linear(query_dim, value_dim)
        self.W_k = nn.Linear(key_dim, value_dim, bias=False)
        self.W_v = nn.Linear(key_dim, value_dim)
        self.value_dim = value_dim

    def forward(self, query, key_mat):
        q = self.W_q(query)[:, :, None]
        w = (self.W_k(key_mat) @ q) / np.sqrt(self.value_dim)
        co = torch.softmax(w, dim=1)
        return (self.W_v(key_mat) * co).sum(dim=1), co

    SPEC = [("W_q", ("W_q",), "dense"), ("W_k", ("W_k",), "dense_nobias"),
            ("W_v", ("W_v",), "dense")]


class _TextBiGRU(nn.Module):
    def __init__(self, word_size: int, pos_size: int, hidden_size: int):
        super().__init__()
        self.pos_emb = nn.Linear(pos_size, word_size)
        self.input_emb = nn.Linear(word_size, hidden_size)
        self.gru = nn.GRU(hidden_size, hidden_size, batch_first=True, bidirectional=True)
        self.hidden = nn.Parameter(torch.randn(2, 1, hidden_size))

    def run(self, word_embs, pos_onehot, cap_lens, return_sequence: bool = False):
        x = self.input_emb(word_embs + self.pos_emb(pos_onehot))
        h0 = self.hidden.expand(2, x.shape[0], self.gru.hidden_size)
        return run_gru(self.gru, x, cap_lens, h0, return_sequence)

    SPEC = [("pos_emb", ("pos_emb",), "dense"), ("input_emb", ("input_emb",), "dense"),
            ("gru", ("gru",), "gru"), ("hidden", ("hidden",), "param")]


class TextEncoderBiGRU(_TextBiGRU):
    """Bidirectional text encoder returning (per-step word_hids, last
    hidden); parity: modules.py:270-309."""

    def __init__(self, word_size: int = 300, pos_size: int = 15, hidden_size: int = 512):
        super().__init__(word_size, pos_size, hidden_size)

    def forward(self, word_embs, pos_onehot, cap_lens):
        gru_last, word_hids = self.run(word_embs, pos_onehot, cap_lens, return_sequence=True)
        return word_hids, gru_last


class MotionLenEstimatorBiGRU(_TextBiGRU):
    """Length classifier over unit-length buckets; parity modules.py:389."""

    def __init__(self, word_size: int = 300, pos_size: int = 15, hidden_size: int = 512,
                 output_size: int = 50):
        super().__init__(word_size, pos_size, hidden_size)
        nd = 512
        layers = []
        for d_in, d_out in ((hidden_size * 2, nd), (nd, nd // 2), (nd // 2, nd // 4)):
            layers += [nn.Linear(d_in, d_out), nn.LayerNorm(d_out), nn.LeakyReLU(0.2)]
        self.output = nn.Sequential(*layers, nn.Linear(nd // 4, output_size))

    def forward(self, word_embs, pos_onehot, cap_lens):
        return self.output(self.run(word_embs, pos_onehot, cap_lens))

    SPEC = _TextBiGRU.SPEC + [(f"output.{i}", (f"out_{i}",), "ln" if i % 3 == 1 else "dense")
                              for i in (0, 1, 3, 4, 6, 7, 9)]


class LengthEstTrainer:
    """Cross-entropy training of the length estimator (optax.adam, no
    clipping); parity trainers.py:748."""

    def __init__(self, output_size: int = 50, lr: float = 1e-4, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.model = seeded_init_(MotionLenEstimatorBiGRU(output_size=output_size),
                                  seed).to(self.device)
        self.opt = ClippedAdam(self.model.parameters(), lr, max_norm=None)

    def load_jax_params(self, tree: dict) -> "LengthEstTrainer":
        self.model.load_state_dict(state_from_jax(MotionLenEstimatorBiGRU.SPEC, tree))
        return self

    def jax_params(self) -> dict:
        return jax_from_state(MotionLenEstimatorBiGRU.SPEC, self.model.state_dict())

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=self.device)

    @torch.no_grad()
    def logits(self, word_embs, pos_ohot, cap_lens) -> torch.Tensor:
        with true_fp32():
            return self.model(self._t(word_embs), self._t(pos_ohot), np.asarray(cap_lens))

    def update(self, word_embs, pos_ohot, cap_lens, m_lens, unit_length: int = 4) -> dict:
        labels = torch.as_tensor(np.asarray(m_lens) // unit_length, dtype=torch.int64,
                                 device=self.device)
        self.opt.zero_grad()
        with true_fp32():
            logits = self.model(self._t(word_embs), self._t(pos_ohot), np.asarray(cap_lens))
            loss = F.cross_entropy(logits, labels)
            loss.backward()
            self.opt.step()
        acc = (logits.argmax(-1) == labels).float().mean()
        return {"loss": float(loss.detach()), "acc": float(acc)}


def huber(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """optax.huber_loss at delta 1, elementwise."""
    return F.huber_loss(pred, target, reduction="none", delta=1.0)


class CompV6Generator(nn.Module):
    """Compact T2M (Guo et al. CompV6) motion generator: text BiGRU + word
    attention + per-step VAE prior + autoregressive movement decoder +
    movement conv decoder, with its optimizer
    (clip_by_global_norm(0.5) + adam).

    Parity: trainers.py CompTrainerV6 (:211-460) — generate (:382-448:
    attention vector, prior z, decoder step, movement decode) and the
    teacher-forced or free-running training step with the posterior KL
    (:277-380, backward_G :450-460)."""

    def __init__(self, dim_pose: int = 263, dim_z: int = 128, hidden: int = 1024,
                 text_hidden: int = 512, unit_length: int = 4, lr: float = 2e-4,
                 lambda_rec_mov: float = 1.0, lambda_rec_mot: float = 1.0,
                 lambda_kld: float = 0.01, seed: int = 0, device="cuda"):
        super().__init__()
        self.unit_length, self.dim_pose, self.dim_z = unit_length, dim_pose, dim_z
        mov_dim = 512
        self.text_enc = TextEncoderBiGRU(hidden_size=text_hidden)
        self.att = AttLayer(hidden, 2 * text_hidden, value_dim=text_hidden)
        self.seq_pri = TextDecoder(2 * text_hidden, mov_dim + text_hidden, dim_z, hidden, 1)
        self.seq_post = TextDecoder(2 * text_hidden, mov_dim * 2 + text_hidden, dim_z, hidden, 1)
        self.seq_dec = TextVAEDecoder(2 * text_hidden, mov_dim + text_hidden + dim_z, mov_dim,
                                      hidden, 1)
        self.mov_enc = MovementConvEncoder(dim_pose - 4, output_size=mov_dim)
        # the movement decoder reconstructs the full pose, foot contacts too
        self.mov_dec = MovementConvDecoder(mov_dim, output_size=dim_pose)
        seeded_init_(self, seed)
        self.device = resolve_device(device)
        self.to(self.device)
        self.lambdas = (lambda_rec_mov, lambda_rec_mot, lambda_kld)
        self.opt = ClippedAdam(self.parameters(), lr)

    def spec(self) -> list:
        out = prefixed(_TextBiGRU.SPEC, "text_enc", ("text_enc",))
        out += prefixed(AttLayer.SPEC, "att", ("att",))
        for name in ("seq_pri", "seq_post", "seq_dec"):
            out += prefixed(getattr(self, name).spec(), name, (name,))
        out += prefixed(MOVEMENT_SPEC, "mov_enc", ("mov_enc",))
        return out + prefixed(DECODER_SPEC, "mov_dec", ("mov_dec",))

    def load_jax_params(self, tree: dict) -> "CompV6Generator":
        """The JAX generator's params (the pickle's "generator" tree)."""
        self.load_state_dict(state_from_jax(self.spec(), tree))
        return self

    def jax_params(self) -> dict:
        return jax_from_state(self.spec(), self.state_dict())

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=self.device) \
            if not torch.is_tensor(a) else a.to(self.device, torch.float32)

    def _mov_in0(self, B: int) -> torch.Tensor:
        zeros = torch.zeros((B, self.unit_length, self.dim_pose - 4), device=self.device)
        return self.mov_enc(zeros)[:, 0]

    def _noise(self, B: int, generator) -> torch.Tensor:
        return torch.randn((B, self.dim_z), generator=generator, device=self.device)

    @torch.no_grad()
    def generate(self, word_embs, pos_ohot, cap_lens, m_lens, mov_len: int,
                 generator: Optional[torch.Generator] = None,
                 z_noise: Optional[torch.Tensor] = None):
        """Sample motions (parity trainers.py:382-448): returns (motions (B,
        mov_len * unit_length, dim_pose), movements (B, mov_len, 512), the
        prior's mus (mov_len * B, dim_z)). z_noise (mov_len, B, dim_z) pins
        the prior's draws; else they come from `generator`."""
        with true_fp32():
            word_embs, pos_ohot = self._t(word_embs), self._t(pos_ohot)
            B = word_embs.shape[0]
            word_hids, hidden = self.text_enc(word_embs, pos_ohot, cap_lens)
            h_pri = self.seq_pri.get_init_hidden(hidden)
            h_dec = self.seq_dec.get_init_hidden(hidden)
            mov_in = self._mov_in0(B)
            mov_units = host_lengths(m_lens, 1 << 30).to(self.device) // self.unit_length
            movs, mus = [], []
            for i in range(mov_len):
                att_vec, _ = self.att(h_dec[-1], word_hids)
                # clamped: shorter clips must not index the step code with
                # negative steps
                tta = torch.clamp(mov_units - i, min=0)
                noise = z_noise[i].to(self.device) if z_noise is not None \
                    else self._noise(B, generator)
                z, mu, _, h_pri = self.seq_pri(torch.cat([mov_in, att_vec], -1), h_pri, tta,
                                               noise)
                fake_mov, h_dec = self.seq_dec(torch.cat([mov_in, att_vec, z], -1), h_dec, tta)
                movs.append(fake_mov[:, None])
                mus.append(mu)
                mov_in = fake_mov
            fake_movements = torch.cat(movs, dim=1)
            return self.mov_dec(fake_movements), fake_movements, torch.cat(mus, 0)

    def train_step(self, word_embs, pos_ohot, cap_lens, motions, m_lens,
                   generator: Optional[torch.Generator] = None, tf_ratio: float = 0.4,
                   noise: Optional[torch.Tensor] = None) -> dict:
        """One teacher-forced (probability tf_ratio, the global numpy coin)
        or free-running VAE step; returns the loss logs. noise (mov_len, 2,
        B, dim_z) pins the prior's and the posterior's draws of each step;
        else they come from `generator`."""
        teacher_force = bool(np.random.rand() < tf_ratio)
        motions, m_lens_h = self._t(motions), np.asarray(m_lens)
        B, T = motions.shape[:2]
        mov_len = T // self.unit_length
        self.opt.zero_grad()
        with true_fp32():
            word_embs, pos_ohot = self._t(word_embs), self._t(pos_ohot)
            with torch.no_grad():
                movements = self.mov_enc(motions[..., :-4])
            word_hids, hidden = self.text_enc(word_embs, pos_ohot, cap_lens)
            h_pri = self.seq_pri.get_init_hidden(hidden)
            h_post = self.seq_post.get_init_hidden(hidden)
            h_dec = self.seq_dec.get_init_hidden(hidden)
            mov_in = self._mov_in0(B)
            # validity masks: clips shorter than the window arrive zero-padded;
            # the losses skip the padded tails and tta stays >= 0
            m_lens_d = torch.as_tensor(m_lens_h, dtype=torch.int64, device=self.device)
            mov_lens = m_lens_d // self.unit_length
            mov_valid = (torch.arange(mov_len, device=self.device)[None]
                         < mov_lens[:, None]).float()
            frame_valid = (torch.arange(T, device=self.device)[None] < m_lens_d[:, None]).float()
            movs, kld_terms = [], []
            for i in range(mov_len):
                att_vec, _ = self.att(h_dec[-1], word_hids)
                tta = torch.clamp(mov_lens - i, min=0)
                n_pri, n_post = ((noise[i, 0].to(self.device), noise[i, 1].to(self.device))
                                 if noise is not None
                                 else (self._noise(B, generator), self._noise(B, generator)))
                _, mu_pri, lv_pri, h_pri = self.seq_pri(torch.cat([mov_in, att_vec], -1), h_pri,
                                                        tta, n_pri)
                z_post, mu_post, lv_post, h_post = self.seq_post(
                    torch.cat([mov_in, movements[:, i], att_vec], -1), h_post, tta, n_post)
                fake_mov, h_dec = self.seq_dec(torch.cat([mov_in, att_vec, z_post], -1), h_dec,
                                               tta)
                movs.append(fake_mov[:, None])
                # per-sample KL, masked to live steps
                kld_el = gaussian_kl(mu_post, lv_post, mu_pri, lv_pri)
                kld_terms.append(torch.sum(kld_el.sum(-1) * mov_valid[:, i]))
                mov_in = movements[:, i] if teacher_force else fake_mov.detach()
            fake_movements = torch.cat(movs, dim=1)
            fake_motions = self.mov_dec(fake_movements)
            l_mov_rec, l_mot_rec, l_kld = self.lambdas

            def masked_mean(err, valid):
                w = valid[..., None]
                return torch.sum(err * w) / torch.clamp(torch.sum(w) * err.shape[-1], min=1.0)

            loss_mot = masked_mean(huber(fake_motions, motions), frame_valid)
            loss_mov = masked_mean(huber(fake_movements, movements), mov_valid)
            loss_kld = sum(kld_terms) / torch.clamp(torch.sum(mov_valid), min=1.0)
            loss = loss_mot * l_mot_rec + loss_mov * l_mov_rec + loss_kld * l_kld
            loss.backward()
            self.opt.step()
        return {k: float(v.detach()) for k, v in (("loss", loss), ("loss_mot_rec", loss_mot),
                                                  ("loss_mov_rec", loss_mov),
                                                  ("loss_kld", loss_kld))}


def gaussian_kl(mu1, logvar1, mu2, logvar2) -> torch.Tensor:
    """KL(N(mu1, e^logvar1) || N(mu2, e^logvar2)), elementwise."""
    sigma1 = torch.exp(0.5 * logvar1)
    sigma2 = torch.exp(0.5 * logvar2)
    return (torch.log(sigma2 / sigma1)
            + (torch.exp(logvar1) + (mu1 - mu2) ** 2) / (2 * torch.exp(logvar2)) - 0.5)


def kl_criterion(mu1, logvar1, mu2, logvar2) -> torch.Tensor:
    """Gaussian KL summed and averaged over the batch; parity
    trainers.py:261-269."""
    return gaussian_kl(mu1, logvar1, mu2, logvar2).sum() / mu1.shape[0]
