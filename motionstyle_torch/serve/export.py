"""Ahead-of-time export of the serving plan with torch.export.

Counterpart of motionstyle/serve/export.py, whose StableHLO modules become
torch.export programs (.pt2). The whole serving plan (the min-latency DDIM
inpainting chain of parallel/inference.py::Sampler) is traced once into an
ExportedProgram with a symbolic batch dim, its parameters an INPUT of the
program (torch.func.functional_call), so one program serves every batch
size and every named style. A serving host needs the artifact, torch and
this package's ops module (motionstyle_torch.ops.fused_encoder, which
registers kernels 1 and 2 as the custom operators a --fused 1 or
--quant_int8 1 program calls): no checkpoint and no model rebuild.

Layout of an artifact directory:

    meta.json                 serving contract (shapes, cond spec, dump
                              pick, mask name, dataset, bucket grid), the
                              format, torch's version and the platforms
    plans/sample_<p>.pt2      the sampler plan for platform p (cuda or cpu):
                              fn(params, init_image, enc_text, mask, motion,
                              noise[, step_noise]) -> the x0 dump stack
    plans/text_<p>.pt2        the CLIP text tower, (b, 77) ids -> (b, 512)
    params.pt                 the tensors, stored once: the served model's
                              prior and style encoder under 'model/', the
                              text tower under 'text/', each named style's
                              style encoder under 'styles/<name>/'

A program holds the devices it was traced on, so a platform's program is
traced on that platform, and load_artifact refuses a platform (or a CUDA
compute capability) the artifact was not exported for. Noise: the JAX plan
draws threefry noise inside the module from the item seeds; here
ExportedSampler draws it outside with the live sampler's per-seed generators
(parallel/inference.py::item_noise) and passes it in, so an artifact's
answer per seed is the live engine's. A JAX StableHLO artifact is refused by
name: artifacts do not cross packages (checkpoints do).
"""
from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

FORMAT = "torch.export"
FORMAT_VERSION = 1
_PARAMS_FILE = "params.pt"
# the custom operators of kernels 1 and 2 (ops/fused_encoder.py)
CUSTOM_OP_NAMESPACE = "motionstyle"
# the largest batch a program's symbolic batch dim admits
MAX_BATCH = 1024


def platform_record(platform: str) -> dict:
    """meta.json's record of one platform: cuda with the compute capability
    of the card it was traced on, or cpu."""
    if platform == "cuda":
        major, minor = torch.cuda.get_device_capability()
        return {"platform": "cuda", "capability": f"{major}.{minor}"}
    if platform != "cpu":
        raise ValueError(f"platforms are cuda and cpu, not {platform!r}")
    return {"platform": "cpu"}


def served_params(model: nn.Module) -> dict:
    """The tensors a style forward reads, detached: the prior's embeddings,
    output head and positional-encoding buffer ('mdm.*' but the prior's own
    encoder stack, which the style path replaces by the style encoder) and
    the style encoder ('style_encoder.*')."""
    named = dict(model.named_parameters())
    named.update(model.named_buffers())
    return {k: v.detach() for k, v in named.items()
            if k.startswith(("mdm.", "style_encoder."))
            and not k.startswith("mdm.seqTransEncoder.")}


def custom_ops_in(program) -> list:
    """Names of the motionstyle custom-operator nodes of an exported program,
    one per call (16 for an 8-layer denoiser called twice)."""
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith(CUSTOM_OP_NAMESPACE + ".")]


class _SamplePlan(nn.Module):
    """The live sampler's computation (Sampler.make_run) with the model's
    tensors as an input: its model_fn_builder gets the model called
    through torch.func.functional_call. The sampler and the model are plain
    attributes, not submodules, so nothing of them is stored inside the
    program."""

    def __init__(self, sampler, model):
        super().__init__()
        object.__setattr__(self, "sampler", sampler)
        object.__setattr__(self, "model", model)

    def forward(self, params, init_image, enc_text, mask, motion, noise, step_noise=None):
        from motionstyle_torch.diffusion.ddpm import Inpainting

        model = self.model
        run = self.sampler.make_run(tuple(noise.shape))
        return run(lambda *args: torch.func.functional_call(model, params, args), init_image,
                   {"enc_text": enc_text}, Inpainting(mask, motion), noise, step_noise, None,
                   None)


def export_sampler_plan(sampler, item_shape: tuple, enc_dim: int):
    """Trace the sampler on its device with a symbolic batch dim ->
    (ExportedProgram, params). The program is `fn(params, init_image
    (b, C, F, T), enc_text (b, enc_dim), mask, motion, noise[, step_noise
    (S, b, ...)])` and returns the sampler's output (the x0 dump stack on
    the serving plan)."""
    from torch.export import Dim

    model, dev = sampler.params, sampler.device
    params = served_params(model)
    B = 2
    shape = (B,) + tuple(item_shape)
    gen = torch.Generator(device="cpu").manual_seed(0)
    rand = lambda *s: torch.randn(s, generator=gen).to(dev)  # noqa: E731
    example = [params, rand(*shape), rand(B, enc_dim), torch.ones(shape, device=dev),
               rand(*shape), rand(*shape)]
    b = Dim("b", min=1, max=MAX_BATCH)
    dims = [{k: None for k in params}, {0: b}, {0: b}, {0: b}, {0: b}, {0: b}]
    if sampler.needs_step_noise():
        example.append(rand(sampler.n_live_steps(), *shape))
        dims.append({1: b})
    with torch.no_grad():
        program = torch.export.export(_SamplePlan(sampler, model), tuple(example),
                                      dynamic_shapes=tuple(dims), strict=False)
    return program, params


class _TextPlan(nn.Module):
    def __init__(self, clip):
        super().__init__()
        object.__setattr__(self, "clip", clip)

    def forward(self, params, ids):
        return torch.func.functional_call(self.clip, params, (ids,))


def export_text_plan(clip):
    """Trace the CLIP text tower ((b, 77) int64 ids -> (b, embed_dim)) with a
    symbolic batch dim -> (ExportedProgram, params). Tokenising stays on the
    host (models/clip_text.py::text_ids)."""
    from torch.export import Dim

    from motionstyle_torch.models.clip_text import CONTEXT_LENGTH

    dev = clip.text_projection.device
    params = {k: v.detach() for k, v in clip.named_parameters()}
    ids = torch.zeros((2, CONTEXT_LENGTH), dtype=torch.int64, device=dev)
    ids[:, 0], ids[:, 1] = clip.cfg.vocab_size - 2, clip.cfg.vocab_size - 1
    b = Dim("b", min=1, max=MAX_BATCH)
    with torch.no_grad():
        program = torch.export.export(_TextPlan(clip), (params, ids),
                                      dynamic_shapes=({k: None for k in params}, {0: b}),
                                      strict=False)
    return program, params


def _cpu(tensors: dict, prefix: str) -> dict:
    return {prefix + k: v.detach().cpu().contiguous() for k, v in tensors.items()}


def _save_program(program, path: str) -> None:
    """torch.export.save without the example inputs the program keeps from
    tracing (they hold a copy of every parameter)."""
    program._example_inputs = None
    torch.export.save(program, path)


def save_artifact(path: str, meta: dict, sample_plans: dict, params: dict,
                  text_plans: Optional[dict] = None, text_params: Optional[dict] = None,
                  styles: Optional[dict] = None) -> None:
    """Write an artifact directory. sample_plans/text_plans: {platform:
    ExportedProgram}; params: served_params of the model (stored once for
    every platform); styles: {name: style-encoder state dict}."""
    plans_dir = os.path.join(path, "plans")
    os.makedirs(plans_dir, exist_ok=True)
    meta = dict(meta)
    meta["format"] = FORMAT
    meta["format_version"] = FORMAT_VERSION
    meta["torch_version"] = torch.__version__
    meta["platforms"] = [platform_record(p) for p in sorted(sample_plans)]
    meta["has_text_plan"] = bool(text_plans)
    meta["styles"] = sorted(styles or {})
    for platform, program in sample_plans.items():
        _save_program(program, os.path.join(plans_dir, f"sample_{platform}.pt2"))
    for platform, program in (text_plans or {}).items():
        _save_program(program, os.path.join(plans_dir, f"text_{platform}.pt2"))
    tensors = _cpu(params, "model/")
    for name, state in (styles or {}).items():
        if "/" in name:
            raise ValueError(f"style name must not contain '/': {name!r}")
        tensors |= _cpu(state, f"styles/{name}/")
    if text_plans:
        tensors |= _cpu(text_params, "text/")
    torch.save(tensors, os.path.join(path, _PARAMS_FILE))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)


class ExportedSampler:
    """A loaded sampler plan with the Sampler's surface for
    serve/engine.py::ServingEngine: the same __call__ batch dict (with
    per-item 'item_seeds', which it turns into the live sampler's noise),
    needs_step_noise, n_live_steps and prepare_params. The batch dim is
    symbolic, so any batch size runs."""

    def __init__(self, meta: dict, program, params: dict, device: torch.device):
        self.meta = meta
        self.item_shape = tuple(meta["item_shape"])
        self.device = device
        self.params = {k: v.to(device) for k, v in params.items()}  # on the card once
        self.program = program
        self._call = program.module()

    def needs_step_noise(self) -> bool:
        return bool(self.meta["needs_step_noise"])

    def n_live_steps(self) -> int:
        return int(self.meta["n_steps"])

    def prepare_params(self, encoder_state: dict) -> dict:
        """A named style's parameters: the served ones with the style encoder
        replaced by encoder_state (a TransformerEncoder state dict), placed
        on the device once; the prior's tensors are shared, not copied."""
        return self.params | {f"style_encoder.{k}": v.to(self.device, torch.float32)
                              for k, v in encoder_state.items()}

    def __call__(self, batch: dict, generator: Optional[torch.Generator] = None,
                 params: Optional[dict] = None) -> torch.Tensor:
        from motionstyle_torch.parallel.inference import item_noise

        for k in ("noise", "step_noise"):
            if k in batch:
                raise ValueError(f"an exported plan draws its noise from item_seeds; "
                                 f"pinned '{k}' is the live Sampler's test hook")
        if "item_seeds" not in batch:
            raise ValueError("exported plans require per-item 'item_seeds'")
        init = batch.get("init_image")
        inp = batch.get("inpainting")
        if init is None or inp is None:
            raise ValueError("the exported plan takes init_image and inpainting")
        shape = tuple(np.shape(init))
        if shape[1:] != self.item_shape:
            raise ValueError(f"item shape {shape[1:]} != exported {self.item_shape}")
        cond = batch.get("cond", {})
        want = sorted(self.meta["cond_spec"])
        if sorted(cond) != want:
            raise ValueError(f"cond keys {sorted(cond)} != exported {want}")
        dev = self.device
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
        noise, step_noise = item_noise(batch["item_seeds"], self.item_shape, dev,
                                       self.n_live_steps() if self.needs_step_noise() else 0)
        args = [self.params if params is None else params, as_t(init),
                as_t(cond["enc_text"]), as_t(inp.mask), as_t(inp.motion), noise]
        if step_noise is not None:
            args.append(step_noise)
        with torch.no_grad():
            return self._call(*args)


class ExportedTextEncoder:
    """Host tokenising (clip_text.text_ids, with the dataset recorded in
    meta) + the exported text tower; returns (n, embed_dim) float32."""

    def __init__(self, program, dataset: str, params: dict, device: torch.device):
        self._call = program.module()
        self.dataset = dataset
        self.device = device
        self.params = {k: v.to(device) for k, v in params.items()}

    def __call__(self, texts) -> np.ndarray:
        from motionstyle_torch.models.clip_text import text_ids

        ids = torch.as_tensor(text_ids(texts, self.dataset), device=self.device)
        with torch.no_grad():
            return self._call(self.params, ids).float().cpu().numpy()


class Artifact:
    """A loaded artifact: `.sampler` for the engine, `.encode_text` for the
    request path, `.meta` for the serving configuration, `.styles` {name:
    style-encoder state dict} the one program serves by parameter swap."""

    def __init__(self, meta: dict, sampler: ExportedSampler,
                 encode_text: Optional[Callable], styles: Optional[dict] = None):
        self.meta = meta
        self.sampler = sampler
        self.encode_text = encode_text
        self.styles = styles or {}


def load_artifact(path: str, device="cuda") -> Artifact:
    """Load an artifact on `device`: the card unless the caller asks for
    another device, and without a card it raises, as the CLIs'
    resolve_device does (no silent fallback to the CPU). Refuses a JAX
    StableHLO artifact, another format version, and a platform or CUDA
    compute capability it was not exported for."""
    # the custom operators of kernels 1 and 2 must exist before a program
    # that calls them is deserialised
    import motionstyle_torch.ops.fused_encoder  # noqa: F401

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        if "jax_version" in meta:
            raise ValueError(
                f"{path} is a JAX StableHLO artifact (motionstyle.serve.export); artifacts "
                "do not cross packages, checkpoints do: export the checkpoint with "
                "python -m motionstyle_torch.cli.export_model")
        raise ValueError(f"{path}: artifact format {meta.get('format')!r} != {FORMAT!r}")
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"artifact format version {meta.get('format_version')} != "
                         f"supported {FORMAT_VERSION}")
    device = torch.device(device or "cuda")
    records = {r["platform"]: r for r in meta["platforms"]}
    if device.type not in records:
        raise ValueError(f"artifact was exported for {sorted(records)}; this process "
                         f"serves on {device.type}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to load the artifact on "
                               "the CPU")
        want = records["cuda"]["capability"]
        major, minor = torch.cuda.get_device_capability(device)
        if f"{major}.{minor}" != want:
            raise ValueError(f"artifact was exported for compute capability {want}; this "
                             f"card is {major}.{minor}")
    plans_dir = os.path.join(path, "plans")
    tensors = torch.load(os.path.join(path, _PARAMS_FILE), map_location="cpu")
    groups: dict = {}
    for name, t in tensors.items():
        head, _, rest = name.partition("/")
        if head == "styles":
            style, _, key = rest.partition("/")
            groups.setdefault("styles", {}).setdefault(style, {})[key] = t
        else:
            groups.setdefault(head, {})[rest] = t
    program = torch.export.load(os.path.join(plans_dir, f"sample_{device.type}.pt2"))
    encode = None
    if meta.get("has_text_plan"):
        encode = ExportedTextEncoder(
            torch.export.load(os.path.join(plans_dir, f"text_{device.type}.pt2")),
            meta["dataset"], groups["text"], device)
    return Artifact(meta, ExportedSampler(meta, program, groups["model"], device),
                    encode, styles=groups.get("styles"))
