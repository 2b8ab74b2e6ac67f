"""The T2M evaluator stack of the port: the movement conv encoder and the
text and motion BiGRU co-embedding encoders, whose state dicts are the
reference's 't2m/text_mot_match/model/finest.tar' layout key for key.

Counterpart of motionstyle/eval/evaluators.py (parity:
data_loaders/humanml/networks/modules.py MovementConvEncoder :79,
TextEncoderBiGRUCo :311, MotionEncoderBiGRUCo :353, and
evaluator_wrapper.py:95-186). The GRUs are nn.GRU, the convolutions
nn.Conv1d and the projections nn.Linear, in fp32: the JAX package runs them
outside any Pallas kernel. Variable lengths follow the JAX package's masked
state updates: a row past its length keeps its state, and a row of length 0
keeps h0 (pack_padded_sequence takes no length 0, so those rows are packed at
length 1 and their results replaced). The reference's Dropout(0.2) in the
movement encoder is an Identity here, as the JAX module has none; the
indices of the reference's nn.Sequential stay, so finest.tar loads with
load_state_dict.

On the card cuDNN's convolutions and RNNs default to TF32; the evaluator's
calls run inside true_fp32(), so the embeddings on the card are the CPU's
yardstick. The seeded evaluator (no checkpoint) draws from torch generators
and differs from the JAX package's by design.
"""
from __future__ import annotations

import contextlib
import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from motionstyle_torch.cli.model_util import resolve_device
from motionstyle_torch.models.params import seeded_init_

POS_ENUMERATOR = {
    "VERB": 0, "NOUN": 1, "DET": 2, "ADP": 3, "NUM": 4, "AUX": 5, "PRON": 6,
    "ADJ": 7, "ADV": 8, "Loc_VIP": 9, "Body_VIP": 10, "Obj_VIP": 11,
    "Act_VIP": 12, "Desc_VIP": 13, "OTHER": 14,
}
VIP_DICT = {
    "Loc_VIP": ("left", "right", "clockwise", "counterclockwise", "anticlockwise",
                "forward", "back", "backward", "up", "down", "straight", "curve"),
    "Body_VIP": ("arm", "chin", "foot", "feet", "face", "hand", "mouth", "leg",
                 "waist", "eye", "knee", "shoulder", "thigh"),
    "Obj_VIP": ("stair", "dumbbell", "chair", "window", "floor", "car", "ball",
                "handrail", "baseball", "basketball"),
    "Act_VIP": ("walk", "run", "swing", "pick", "bring", "kick", "put", "squat",
                "throw", "hop", "dance", "jump", "turn", "stumble", "dance", "stop",
                "sit", "lift", "lower", "raise", "wash", "stand", "kneel", "stroll",
                "rub", "bend", "balance", "flap", "jog", "shuffle", "lean", "rotate",
                "spin", "spread", "climb"),
    "Desc_VIP": ("slowly", "carefully", "fast", "careful", "slow", "quickly",
                 "happy", "angry", "sad", "happily", "angrily", "sadly"),
}


class WordVectorizer:
    """GloVe lookup + POS one-hots with VIP word classes.

    Loads '{prefix}_data.npy' / '{prefix}_words.pkl' / '{prefix}_idx.pkl' from
    meta_root when present (parity: word_vectorizer.py:46-79); otherwise a
    deterministic hash-based 300-d embedding stands in, the JAX package's
    numbers."""

    def __init__(self, meta_root: Optional[str] = None, prefix: str = "our_vab",
                 dim_word: int = 300):
        self.dim_word = dim_word
        self.word2vec = None
        if meta_root and os.path.exists(os.path.join(meta_root, f"{prefix}_data.npy")):
            vectors = np.load(os.path.join(meta_root, f"{prefix}_data.npy"))
            with open(os.path.join(meta_root, f"{prefix}_words.pkl"), "rb") as f:
                words = pickle.load(f)
            with open(os.path.join(meta_root, f"{prefix}_idx.pkl"), "rb") as f:
                word2idx = pickle.load(f)
            self.word2vec = {w: vectors[word2idx[w]] for w in words}

    def _hash_vec(self, word: str) -> np.ndarray:
        seed = np.frombuffer(word.encode("utf-8").ljust(8, b"\0")[:8], dtype=np.uint64)[0]
        rng = np.random.RandomState(int(seed % (2 ** 31)))
        return rng.randn(self.dim_word).astype(np.float32) * 0.1

    def _pos_onehot(self, pos: str) -> np.ndarray:
        vec = np.zeros(len(POS_ENUMERATOR), dtype=np.float32)
        vec[POS_ENUMERATOR.get(pos, POS_ENUMERATOR["OTHER"])] = 1
        return vec

    def __getitem__(self, item: str):
        word, pos = item.rsplit("/", 1) if "/" in item else (item, "OTHER")
        if self.word2vec is not None:
            word_vec = self.word2vec.get(word, self.word2vec.get("unk", np.zeros(self.dim_word)))
        else:
            word_vec = self._hash_vec(word)
        vip_pos = next((k for k, v in VIP_DICT.items() if word in v), None)
        return word_vec, self._pos_onehot(vip_pos or pos)


@contextlib.contextmanager
def true_fp32():
    """cuDNN's convolutions and RNNs and cuBLAS's matmuls in IEEE fp32 (no
    TF32) inside the scope; the process's settings are restored after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def host_lengths(lengths, limit: int) -> torch.Tensor:
    """Lengths as a CPU int64 tensor clipped to [0, limit] (packing reads
    them on the host)."""
    if torch.is_tensor(lengths):
        lengths = lengths.detach().cpu()
    return torch.as_tensor(np.asarray(lengths), dtype=torch.int64).clamp(0, limit)


def run_gru(gru: nn.GRU, x: torch.Tensor, lengths, h0: torch.Tensor,
            return_sequence: bool = False):
    """x (B, T, D), lengths (B,), h0 (num_dir, B, H) -> the final hidden
    state concatenated over directions (B, num_dir * H); with
    return_sequence also the per-step outputs (B, T, num_dir * H): zero at
    t >= length, the backward half flipped within each valid length
    (word_hids[t].backward = b[length - 1 - t], the pad_packed + flip
    convention of modules.py:294-307). The JAX package's TorchGRU."""
    B, T, _ = x.shape
    lens = host_lengths(lengths, T)
    packed = pack_padded_sequence(x, lens.clamp(min=1), batch_first=True, enforce_sorted=False)
    seq, h_n = gru(packed, h0.contiguous())
    live = (lens > 0).to(x.device)
    h_n = torch.where(live[None, :, None], h_n, h0)  # length 0 keeps h0
    out = torch.cat(list(h_n), dim=-1)
    if not return_sequence:
        return out
    seq, _ = pad_packed_sequence(seq, batch_first=True, total_length=T)
    ts = torch.arange(T, device=x.device)[None, :]
    lens_d = lens.to(x.device)[:, None]
    valid = (ts < lens_d)[..., None]
    H = gru.hidden_size
    seq_f = torch.where(valid, seq[..., :H], 0.0)
    if not gru.bidirectional:
        return out, seq_f
    flip = (lens_d - 1 - ts).clamp(0, T - 1)
    seq_b = torch.gather(seq[..., H:], 1, flip[..., None].expand(B, T, H))
    return out, torch.cat([seq_f, torch.where(valid, seq_b, 0.0)], dim=-1)


class MovementConvEncoder(nn.Module):
    """Two stride-2 conv1d blocks + linear; parity modules.py:79-99."""

    def __init__(self, input_size: int, hidden_size: int = 512, output_size: int = 512):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv1d(input_size, hidden_size, 4, 2, 1), nn.Identity(), nn.LeakyReLU(0.2),
            nn.Conv1d(hidden_size, output_size, 4, 2, 1), nn.Identity(), nn.LeakyReLU(0.2))
        self.out_net = nn.Linear(output_size, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, D) -> (B, T // 4, output_size)."""
        return self.out_net(self.main(x.transpose(1, 2)).transpose(1, 2))


def _co_embed_head(hidden_size: int, output_size: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(hidden_size * 2, hidden_size), nn.LayerNorm(hidden_size),
                         nn.LeakyReLU(0.2), nn.Linear(hidden_size, output_size))


class _BiGRUEncoder(nn.Module):
    """input_emb + bidirectional GRU started from the learned `hidden`."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.input_emb = nn.Linear(input_size, hidden_size)
        self.gru = nn.GRU(hidden_size, hidden_size, batch_first=True, bidirectional=True)
        self.hidden = nn.Parameter(torch.randn(2, 1, hidden_size))

    def run(self, inputs: torch.Tensor, lengths, return_sequence: bool = False):
        h0 = self.hidden.expand(2, inputs.shape[0], self.gru.hidden_size)
        return run_gru(self.gru, self.input_emb(inputs), lengths, h0, return_sequence)


class TextEncoderBiGRUCo(_BiGRUEncoder):
    def __init__(self, word_size: int = 300, pos_size: int = 15, hidden_size: int = 512,
                 output_size: int = 512):
        super().__init__(word_size, hidden_size)
        self.pos_emb = nn.Linear(pos_size, word_size)
        self.output_net = _co_embed_head(hidden_size, output_size)

    def forward(self, word_embs, pos_onehot, cap_lens):
        return self.output_net(self.run(word_embs + self.pos_emb(pos_onehot), cap_lens))


class MotionEncoderBiGRUCo(_BiGRUEncoder):
    def __init__(self, input_size: int = 512, hidden_size: int = 1024, output_size: int = 512):
        super().__init__(input_size, hidden_size)
        self.output_net = _co_embed_head(hidden_size, output_size)

    def forward(self, inputs, m_lens):
        return self.output_net(self.run(inputs, m_lens))


# ---------------------------------------------------------------------------
# flax trees <-> the port's state dicts (the reference's torch layout)
# ---------------------------------------------------------------------------
# A spec lists (state-dict prefix, flax path, kind). Kinds: "dense" (kernel
# (in, out) <-> weight (out, in)), "dense_nobias", "ln" (scale <-> weight),
# "conv" (kernel (k, in, out) <-> Conv1d weight (out, in, k)), "deconv"
# (flax ConvTranspose kernel (k, in, out) <-> ConvTranspose1d weight
# (in, out, k), the taps reversed: torch flips the kernel, flax does not),
# "gru" (nn.GRU's eight leaves, one name in both), "gru_cell" (nn.GRUCell's
# four) and "param" (one array as it is).

_GRU_LEAVES = tuple(f"{kind}_{name}" for name in ("l0", "l0_reverse")
                    for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
_CELL_LEAVES = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


def _pairs(prefix: str, kind: str):
    """(state-dict key, flax leaf name, to-state fn, to-flax fn) of one entry."""
    same = (lambda a: a, lambda a: a)
    if kind in ("dense", "dense_nobias"):
        out = [(f"{prefix}.weight", "kernel", lambda a: a.T, lambda a: a.T)]
        return out + ([] if kind == "dense_nobias" else [(f"{prefix}.bias", "bias", *same)])
    if kind == "ln":
        return [(f"{prefix}.weight", "scale", *same), (f"{prefix}.bias", "bias", *same)]
    if kind == "conv":
        return [(f"{prefix}.weight", "kernel", lambda a: a.transpose(2, 1, 0),
                 lambda a: a.transpose(2, 1, 0)), (f"{prefix}.bias", "bias", *same)]
    if kind == "deconv":
        return [(f"{prefix}.weight", "kernel", lambda a: a[::-1].transpose(1, 2, 0),
                 lambda a: a.transpose(2, 0, 1)[::-1]), (f"{prefix}.bias", "bias", *same)]
    if kind in ("gru", "gru_cell"):
        return [(f"{prefix}.{leaf}", leaf, *same)
                for leaf in (_GRU_LEAVES if kind == "gru" else _CELL_LEAVES)]
    if kind == "param":
        return [(prefix, None, *same)]
    raise ValueError(f"unknown spec kind {kind!r}")


def _node(tree: dict, path: tuple):
    for p in path:
        tree = tree[p]
    return tree


def state_from_jax(spec, tree: dict) -> Dict[str, torch.Tensor]:
    """A flax param tree (numpy or jax arrays) -> the port's state dict."""
    out = {}
    for prefix, path, kind in spec:
        node = _node(tree, path)
        for key, leaf, to_state, _ in _pairs(prefix, kind):
            a = np.asarray(node if leaf is None else node[leaf], dtype=np.float32)
            out[key] = torch.from_numpy(np.array(to_state(a), order="C"))
    return out


def jax_from_state(spec, sd: Dict) -> dict:
    """The port's state dict (tensors or numpy) -> a flax tree of numpy."""
    tree: dict = {}
    for prefix, path, kind in spec:
        for key, leaf, _, to_flax in _pairs(prefix, kind):
            v = sd[key]
            a = v.detach().cpu().float().numpy() if torch.is_tensor(v) else np.asarray(v)
            a = np.ascontiguousarray(to_flax(a.astype(np.float32)))
            if leaf is None:
                _ensure(tree, path[:-1])[path[-1]] = a
            else:
                _ensure(tree, path)[leaf] = a
    return tree


def _ensure(tree: dict, path: tuple) -> dict:
    for p in path:
        tree = tree.setdefault(p, {})
    return tree


def prefixed(spec, state_prefix: str, flax_path: tuple = ()):
    """A module's spec nested under a parent's prefix and flax path."""
    return [(f"{state_prefix}.{p}" if state_prefix else p, tuple(flax_path) + tuple(path), kind)
            for p, path, kind in spec]


MOVEMENT_SPEC = [("main.0", ("conv1",), "conv"), ("main.3", ("conv2",), "conv"),
                 ("out_net", ("out_net",), "dense")]
_COGRU_SPEC = [("input_emb", ("input_emb",), "dense"), ("gru", ("gru",), "gru"),
               ("hidden", ("hidden",), "param"),
               ("output_net.0", ("output_net", "net_0"), "dense"),
               ("output_net.1", ("output_net", "net_1"), "ln"),
               ("output_net.3", ("output_net", "net_3"), "dense")]
TEXT_SPEC = _COGRU_SPEC + [("pos_emb", ("pos_emb",), "dense")]
MOTION_SPEC = _COGRU_SPEC


def _as_numpy(sd: Dict) -> Dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in sd.items()}


def convert_movement_encoder(sd: Dict[str, np.ndarray]) -> dict:
    """Reference torch state dict -> flax tree (torch Conv1d weight (out, in,
    k) -> flax Conv kernel (k, in, out)); the JAX package's converter."""
    return jax_from_state(MOVEMENT_SPEC, _as_numpy(sd))


def convert_cogru_encoder(sd: Dict[str, np.ndarray], has_pos: bool) -> dict:
    return jax_from_state(TEXT_SPEC if has_pos else MOTION_SPEC, _as_numpy(sd))


def export_movement_encoder(tree: dict) -> Dict[str, np.ndarray]:
    """Inverse of convert_movement_encoder: flax tree -> reference state dict."""
    return _as_numpy(state_from_jax(MOVEMENT_SPEC, tree))


def export_cogru_encoder(tree: dict, has_pos: bool) -> Dict[str, np.ndarray]:
    return _as_numpy(state_from_jax(TEXT_SPEC if has_pos else MOTION_SPEC, tree))


class EvaluatorWrapper:
    """FID / R-precision co-embedding API on one device (the card unless
    `device` names another; raises without a card); parity:
    EvaluatorMDMWrapper. Without a checkpoint the encoders are seeded
    (models/params.py::seeded_init_ from `seed`)."""

    def __init__(self, dataset_name: str = "humanml", checkpoint_path: Optional[str] = None,
                 dim_pose: Optional[int] = None, unit_length: int = 4, device="cuda",
                 seed: int = 0):
        self.dim_pose = dim_pose or (263 if dataset_name == "humanml" else 251)
        # only the humanml/kit layouts end in 4 foot-contact channels; posrot
        # layouts feed their full features
        self.strip_fc = self.dim_pose in (263, 251)
        self.unit_length = unit_length
        self.device = resolve_device(device)
        in_dim = self.dim_pose - 4 if self.strip_fc else self.dim_pose
        self.movement_enc = seeded_init_(MovementConvEncoder(in_dim), seed)
        self.text_enc = seeded_init_(TextEncoderBiGRUCo(), seed + 1)
        self.motion_enc = seeded_init_(MotionEncoderBiGRUCo(), seed + 2)
        if checkpoint_path:
            ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=False)
            self.movement_enc.load_state_dict(ckpt["movement_encoder"])
            self.text_enc.load_state_dict(ckpt["text_encoder"])
            self.motion_enc.load_state_dict(ckpt["motion_encoder"])
            print(f"Loading Evaluation Model Wrapper (Epoch {ckpt.get('epoch', '?')}) "
                  "Completed!!")
        for m in (self.movement_enc, self.text_enc, self.motion_enc):
            m.to(self.device).eval().requires_grad_(False)

    def load_jax_params(self, movement_params: dict, text_params: dict,
                        motion_params: dict) -> "EvaluatorWrapper":
        """Carry the JAX wrapper's three flax trees (each with or without
        its {"params": ...} level) into the encoders."""
        for module, spec, tree in ((self.movement_enc, MOVEMENT_SPEC, movement_params),
                                   (self.text_enc, TEXT_SPEC, text_params),
                                   (self.motion_enc, MOTION_SPEC, motion_params)):
            module.load_state_dict(state_from_jax(spec, tree.get("params", tree)))
        return self

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=self.device)

    @torch.no_grad()
    def motion_embeddings(self, motions, m_lens) -> torch.Tensor:
        """motions (B, T, dim_pose), m_lens (B,) host -> (B, 512) on the device."""
        motions = self._t(motions)
        feats = motions[..., :-4] if self.strip_fc else motions
        with true_fp32():
            movements = self.movement_enc(feats)
            return self.motion_enc(movements, np.asarray(m_lens) // self.unit_length)

    def get_motion_embeddings(self, motions, m_lens) -> np.ndarray:
        return self.motion_embeddings(motions, m_lens).cpu().numpy()

    @torch.no_grad()
    def get_co_embeddings(self, word_embs, pos_ohot, cap_lens, motions, m_lens):
        with true_fp32():
            text_emb = self.text_enc(self._t(word_embs), self._t(pos_ohot), np.asarray(cap_lens))
        return text_emb.cpu().numpy(), self.get_motion_embeddings(motions, m_lens)
