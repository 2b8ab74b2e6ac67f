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
seeded. --style_strength and --style_mix rescale or blend the style encoder's
task vector against the encoder the finetune started from (_style_base), and
load_named_styles reads the serve CLI's --styles. Wherever a style
checkpoint is read (--model_path, a --styles entry, a --style_mix entry), a
LoRA adapter file (adapter{step}.pt, models/lora.py) is taken too: its
factors merged onto the base of the run that wrote it (apply_style_adapter).
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from motionstyle_torch.diffusion.schedule import make_schedule
from motionstyle_torch.models import clip_text, lora
from motionstyle_torch.models.denoiser import MDMConfig, StyleDiffusion
from motionstyle_torch.models.params import (
    convert_encoder, from_torch_state_dict, seeded_init_)

DATASET_DIMS = {
    "humanml": (263, 1),
    "kit": (251, 1),
    "bandai-1_posrot": (190, 1),
    "bandai-2_posrot": (190, 1),
    "stylexia_posrot": (181, 1),
}

CLIP_SEED = 42  # the seeded text tower, as the JAX package's PRNGKey(42)

# the value of "package" in the args.json of a run this package wrote
PACKAGE = "motionstyle_torch"


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
        model.style_encoder.load_state_dict(style_encoder_state(cfg, model_path, args.seed, dev))
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


def _style_base(cfg: MDMConfig, model_path: str, seed: int) -> dict:
    """The style encoder the finetune of `model_path` STARTED from, as a
    TransformerEncoder state dict (fp32, CPU): the --resume_checkpoint that
    the run's args.json records, else the seeded initialisation of a run
    this package wrote (its args.json says "package": "motionstyle_torch";
    the finetune starts the encoder from seeded_init_ with the run's seed).
    A LoRA run resumed from an adapter carried over the factors only, onto
    the run's own start: its base is that start.

    A run without a resume_checkpoint that the JAX package wrote started
    from the JAX package's threefry-seeded init, which differs from this
    package's by design (ROADMAP §3 D): it is refused, because a task vector
    (or an adapter) against a wrong base would corrupt every strength, every
    mix and every merge."""
    from motionstyle_torch.train.finetune import find_resume_checkpoint

    args_path = os.path.join(os.path.dirname(model_path), "args.json")
    saved = {}
    if os.path.exists(args_path):
        import json

        with open(args_path) as f:
            saved = json.load(f)
    rc = saved.get("resume_checkpoint", "") or ""
    if rc:
        orig = rc
        if os.path.isdir(rc):
            # the file the trainer resumed from (train/finetune.py::_load_checkpoint)
            rc = ((saved.get("lora_rank", 0) > 0 and find_resume_checkpoint(rc, "adapter"))
                  or find_resume_checkpoint(rc, "model") or "")
        if not (rc and os.path.exists(rc)):
            # falling back to a seeded init here would silently corrupt every
            # task vector: strength 0 would no longer recover the pre-finetune
            # model and blends would mix against a wrong base
            raise SystemExit(
                f"style base: args.json records resume_checkpoint {orig!r} "
                "but no checkpoint exists there; restore the warm-start "
                "file (or fix args.json) before using --style_strength/"
                "--style_mix or an adapter")
        sd = load_torch_state_dict(rc)
        if not lora.is_adapter_state_dict(sd):
            print(f"style base: resume checkpoint {rc}")
            return convert_encoder(sd, "seqTransEncoder", cfg.num_layers)
    if saved.get("package") != PACKAGE:
        raise SystemExit(
            f"style base: {args_path} records no resume_checkpoint and was not "
            "written by motionstyle_torch, so the finetune started from the JAX "
            "package's seeded init, which this package cannot rebuild; finetune "
            "from a --resume_checkpoint (or with this package) before using "
            "--style_strength/--style_mix or an adapter")
    seed = saved.get("seed", seed)
    print(f"style base: the seeded init of seed {seed}")
    model = seeded_init_(StyleDiffusion(cfg), seed)
    return {k: v.detach().float().clone() for k, v in model.style_encoder.state_dict().items()}


def apply_style_adapter(cfg: MDMConfig, adapter_sd: dict, path: str, seed: int,
                        device="cpu") -> dict:
    """The style encoder a LoRA adapter file gives, as a TransformerEncoder
    state dict (fp32, CPU): its factors merged onto the encoder its run
    started from (_style_base, as --style_strength and --style_mix take it),
    the merge run on `device`; on the trainer's device it is bit-equal to
    the merged model{step}.pt the run wrote. The file describes itself
    (the rank from the factors' shapes, the scale from 'lora.alpha'). The
    JAX package's apply_style_adapter (motionstyle/cli/model_util.py:286-299)."""
    factors, alpha = lora.import_lora(adapter_sd)
    dev = torch.device(device)
    base = {k: v.to(dev) for k, v in _style_base(cfg, path, seed).items()}
    merged = lora.merge_lora(base, {site: {k: v.to(dev) for k, v in pair.items()}
                                    for site, pair in factors.items()}, alpha)
    rank = lora.lora_rank(factors)
    print(f"style adapter: merged rank-{rank} LoRA (alpha {alpha or rank}) onto the "
          "recorded base")
    return {k: v.float().cpu() for k, v in merged.items()}


def style_encoder_state(cfg: MDMConfig, path: str, seed: int, device="cpu") -> dict:
    """A style checkpoint as a TransformerEncoder state dict (fp32, CPU): a
    finetuned encoder (model{step}.pt), or a LoRA adapter (adapter{step}.pt)
    merged onto its run's base on `device` (apply_style_adapter)."""
    sd = load_torch_state_dict(path)
    if lora.is_adapter_state_dict(sd):
        return apply_style_adapter(cfg, sd, path, seed, device)
    return convert_encoder(sd, "seqTransEncoder", cfg.num_layers)


def strength_of(base: dict, finetuned: dict, strength: float) -> dict:
    """base + strength * (finetuned - base), leaf by leaf in fp32."""
    return {k: base[k] + strength * (finetuned[k] - base[k]) for k in base}


def apply_style_mix(bundle: ModelBundle, args) -> bool:
    """Blend several finetuned styles into one encoder (task arithmetic):

        style_encoder <- base + sum_i w_i * (finetuned_i - base)

    --style_mix "ckptA.pt:0.6,ckptB.pt:0.4": each entry a style-finetuned
    checkpoint sharing this model's prior and warm start, or an adapter of
    such a run (merged onto its base on the model's device). Replaces the
    loaded model's own encoder (list it with a weight to keep it). The JAX
    package's apply_style_mix (motionstyle/cli/model_util.py:222-253).
    Returns True when a mix was applied."""
    spec = getattr(args, "style_mix", "") or ""
    if not spec:
        return False
    base = _style_base(bundle.cfg, getattr(args, "model_path", ""), args.seed)
    total = {k: v.clone() for k, v in base.items()}
    device = next(bundle.model.parameters()).device  # an adapter entry merges there
    for entry in spec.split(","):
        path, _, w = entry.rpartition(":")
        if not path:
            raise SystemExit(f"--style_mix entry {entry!r} is not path:weight")
        weight = float(w)
        ft = style_encoder_state(bundle.cfg, path, args.seed, device)
        total = {k: total[k] + weight * (ft[k] - base[k]) for k in total}
        print(f"style_mix: + {weight} x ({os.path.basename(path)} - base)")
    # copied in place: the packed-kernel cache sees the new parameter versions
    bundle.model.style_encoder.load_state_dict(total)
    return True


def apply_style_strength(bundle: ModelBundle, args) -> bool:
    """Scale the learned style task vector in place:

        style_encoder <- base + strength * (finetuned - base)

    where base is the encoder the finetune started from (_style_base).
    Strength 0 recovers the pre-finetune encoder bit for bit, 1 is a no-op,
    > 1 exaggerates the style. The JAX package's apply_style_strength
    (motionstyle/cli/model_util.py:256-283). Returns True when applied."""
    strength = float(getattr(args, "style_strength", 1.0))
    if strength == 1.0:
        return False
    base = _style_base(bundle.cfg, getattr(args, "model_path", ""), args.seed)
    finetuned = {k: v.detach().float().cpu()
                 for k, v in bundle.model.style_encoder.state_dict().items()}
    bundle.model.style_encoder.load_state_dict(strength_of(base, finetuned, strength))
    print(f"style_strength {strength}: style encoder = base + "
          f"{strength} x (finetuned - base)")
    return True


def load_named_styles(args, spec: str, cfg: MDMConfig, device="cpu") -> dict:
    """'name=ckpt[,name2=ckpt2]' -> {name: style-encoder state dict (fp32,
    CPU)} for multi-style serving, each with the CLI's --style_strength
    applied against its own run's base. Only the style encoder differs
    between styles (the prior and the text tower are frozen), so only it is
    loaded; the engine serves each through a view of the served model
    (parallel/inference.py::Sampler.prepare_params). An entry may be a LoRA
    adapter, merged onto its run's base on `device`. The JAX package's
    load_named_styles (motionstyle/cli/model_util.py:350-373)."""
    strength = float(getattr(args, "style_strength", 1.0))
    styles = {}
    for part in filter(None, (s.strip() for s in spec.split(","))):
        name, _, path = part.partition("=")
        name = name.strip()
        if not path or not name:
            raise SystemExit(f"--styles entries must be name=path: {part!r}")
        if "/" in name:
            raise SystemExit(f"style names must not contain '/': {name!r}")
        if not os.path.exists(path):
            raise SystemExit(f"style checkpoint not found: {path}")
        state = style_encoder_state(cfg, path, args.seed, device)
        if strength != 1.0:
            state = strength_of(_style_base(cfg, path, args.seed), state, strength)
        styles[name] = state
    return styles
