"""Model + diffusion factory and checkpoint assembly for the port.

Counterpart of motionstyle/cli/model_util.py (parity: utils/model_util.py —
creat_serval_diffusion :26, get_transfer_args dims table :108-167,
create_gaussian_diffusion :170-201). The prior (--mdm_path) and the finetuned
style encoder (--model_path) are reference-layout torch checkpoints loaded
into one StyleDiffusion; a missing file falls back to a seeded
initialisation with a warning, and the CLIP text tower to a seeded tower
(seed 42) unless --clip_weights is given. The seeded fallbacks draw from
torch's generator, so they differ from the JAX package's PRNGKey draws.

A semantic discriminator checkpoint (--semantic_discriminator_path) loads
into the model's mu/sigma queries and motion encoder; without one they are
seeded. Not on this slice: LoRA adapters, --style_strength/--style_mix.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from motionstyle_torch.diffusion.schedule import make_schedule
from motionstyle_torch.models import clip_text
from motionstyle_torch.models.denoiser import MDMConfig, StyleDiffusion
from motionstyle_torch.models.params import from_torch_state_dict, seeded_init_

DATASET_DIMS = {
    "humanml": (263, 1),
    "kit": (251, 1),
    "bandai-1_posrot": (190, 1),
    "bandai-2_posrot": (190, 1),
    "stylexia_posrot": (181, 1),
}

CLIP_SEED = 42  # the seeded text tower, as the JAX package's PRNGKey(42)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: 'cuda' unless the caller asks for
    another one. No silent fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device cpu) "
                           "to run on the CPU")
    return dev


def get_transfer_config(args) -> MDMConfig:
    njoints, nfeats = DATASET_DIMS.get(args.dataset, (25, 6))
    # --quant_int8 runs inside the fused layer, so it implies --fused
    # (motionstyle/cli/model_util.py:68-71)
    quant_int8 = bool(getattr(args, "quant_int8", 0))
    fused = bool(getattr(args, "fused", 0)) or quant_int8
    if (getattr(args, "fused_train_store", 0) or getattr(args, "fused_train_prng", 0)) \
            and hasattr(args, "fused_train"):
        args.fused_train = 1  # the args object too (motionstyle/cli/model_util.py:50-53)
    return MDMConfig(
        njoints=njoints, nfeats=nfeats, latent_dim=args.latent_dim, ff_size=1024,
        num_layers=args.layers, num_heads=4, clip_dim=512, dropout=0.1,
        cond_mask_prob=getattr(args, "cond_mask_prob", 0.1), fused=fused,
        quant_int8=quant_int8,
        # --fused_train_store and --fused_train_prng imply --fused_train (the
        # config's __post_init__), as in the JAX package (:74-81)
        fused_train=bool(getattr(args, "fused_train", 0)),
        fused_train_store=bool(getattr(args, "fused_train_store", 0)),
        fused_train_prng=bool(getattr(args, "fused_train_prng", 0)),
        # explicit --dtype wins; the fused kernels (bf16 and int8) default to
        # their designed bf16 input, everything else to fp32, as in the JAX
        # package (:86-88)
        dtype=getattr(args, "dtype", None) or ("bfloat16" if fused else "float32"),
    )


def load_torch_state_dict(path: str) -> dict:
    sd = torch.load(path, map_location="cpu")
    return {k: v for k, v in sd.items() if torch.is_tensor(v)}


def _maybe_load(path: str, what: str):
    if path and os.path.exists(path):
        print(f"loading {what} from {path}")
        return load_torch_state_dict(path)
    if path:
        print(f"WARNING: {what} checkpoint not found at {path!r}; using seeded init")
    else:
        print(f"WARNING: no {what} checkpoint given; using seeded init")
    return None


class ModelBundle:
    """The style-transfer model and text tower on one device, with a
    per-caption memo of the text tower (it is deterministic per caption).
    encode_text may be called from many request threads at once."""

    def __init__(self, model: StyleDiffusion, clip: clip_text.ClipTextEncoder,
                 cfg: MDMConfig, device: torch.device, memo_size: int = 1024):
        self.model, self.clip, self.cfg, self.device = model, clip, cfg, device
        self._memo: dict = {}
        self._memo_size = memo_size
        self._memo_lock = threading.Lock()

    def encode_text(self, texts, dataset: str) -> np.ndarray:
        """(len(texts), clip_dim) float32 text features, memoised per caption."""
        with self._memo_lock:
            missing = [t for t in dict.fromkeys(texts) if (t, dataset) not in self._memo]
            if missing:
                enc = clip_text.encode_text(self.clip, missing, dataset=dataset)
                for t, e in zip(missing, enc.float().cpu().numpy()):
                    if len(self._memo) >= self._memo_size:
                        self._memo.pop(next(iter(self._memo)))  # oldest first
                    e.setflags(write=False)
                    self._memo[(t, dataset)] = e
            return np.stack([self._memo[(t, dataset)] for t in texts])


def build_model(args, device="cuda") -> ModelBundle:
    dev = resolve_device(device)
    cfg = get_transfer_config(args)
    model = seeded_init_(StyleDiffusion(cfg), args.seed)
    mdm_sd = _maybe_load(getattr(args, "mdm_path", ""), "MDM prior")
    if mdm_sd is not None:
        model.load_state_dict(from_torch_state_dict(mdm_sd, cfg, part="mdm"), strict=False)
    sem_path = getattr(args, "semantic_discriminator_path", "")
    if sem_path and os.path.exists(sem_path):
        print(f"loading semantic discriminator from {sem_path}")
        model.load_state_dict(from_torch_state_dict(load_torch_state_dict(sem_path), cfg,
                                                    part="semantic"), strict=False)
    model_path = getattr(args, "model_path", "")
    if model_path and os.path.exists(model_path):
        print(f"load style diffusion model: {model_path}")
        style_sd = load_torch_state_dict(model_path)
        if any("lora" in k for k in style_sd):
            raise NotImplementedError("LoRA adapter checkpoints are not served by "
                                      "the PyTorch port yet")
        model.load_state_dict(from_torch_state_dict(style_sd, cfg, part="style_encoder"),
                              strict=False)
    clip = clip_text.ClipTextEncoder()
    clip_w = getattr(args, "clip_weights", "")
    if clip_w and os.path.exists(clip_w):
        print(f"loading CLIP text tower from {clip_w}")
        clip.load_clip_state_dict(load_torch_state_dict(clip_w))
    else:
        seeded_init_(clip, CLIP_SEED, stds=clip_text.INIT_STDS)
    return ModelBundle(model.to(dev).eval(), clip.to(dev).eval(), cfg, dev)


def creat_serval_diffusion(args, timestep_respacing: str = "", device="cuda") -> tuple:
    """(bundle, respaced schedule, full schedule), parity model_util.py:26-30."""
    bundle = build_model(args, device)
    sched_respaced = make_schedule(args.noise_schedule, args.diffusion_steps,
                                   timestep_respacing or None, device=bundle.device)
    sched_full = make_schedule(args.noise_schedule, args.diffusion_steps,
                               device=bundle.device)
    return bundle, sched_respaced, sched_full


creat_ddpm_ddim_diffusion = creat_serval_diffusion  # the same pair, as in the JAX package


def warn_if_clip_fallback(args) -> bool:
    """Record args.clip_fallback and warn when semantic guidance would
    optimise features without pretrained semantics: no --clip_weights
    checkpoint means a seeded tower whose features carry no semantics, no
    CLIP_BPE_PATH merges means byte-level token ids. Returns the flag."""
    clip_w = getattr(args, "clip_weights", "")
    bpe = os.environ.get("CLIP_BPE_PATH", "")
    weights_fb = not (clip_w and os.path.exists(clip_w))
    tok_fb = not (bpe and os.path.exists(bpe))
    args.clip_fallback = bool(weights_fb or tok_fb)
    if args.clip_fallback and getattr(args, "semantic_guidance", 0):
        missing = [m for m, fb in (("weights (--clip_weights)", weights_fb),
                                   ("BPE merges (CLIP_BPE_PATH)", tok_fb)) if fb]
        print("=" * 70)
        print("WARNING: semantic guidance is running with a FALLBACK CLIP text")
        print(f"tower (missing: {', '.join(missing)}). The Ls CLIP-cosine term")
        print("optimises features with no pretrained semantics.")
        print('Recorded as "clip_fallback": true in args.json.')
        print("=" * 70)
    return args.clip_fallback
