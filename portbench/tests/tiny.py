"""Tiny sizes for the CPU tests: the cells' drivers end to end on the CPU
(the port's fused layers take their plain twins there) at small widths."""
from __future__ import annotations

import time

CLIP = {"vocab_size": 49408, "context_length": 77, "width": 64, "heads": 4, "layers": 2,
        "embed_dim": 64, "text_context": 22}
CONFIG = {"latent_dim": 64, "num_layers": 2, "ff_size": 128, "clip_dim": 64,
          "diffusion_steps": 20, "clip": CLIP}
TRAFFIC = {
    "humanml_generate": {"clips": 4, "check_among": 1},
    "xia_transfer": {"clips": 8, "library": 20, "check_among": 4, "check_calls": 2,
                     "skip_steps": 14},
    "humanml_transfer": {"clips": 8, "library": 20, "check_among": 4, "check_calls": 2,
                         "skip_steps": 14},
    "xia_pretrain": {"batch": 8, "corpus": {"layout": "xia", "clips": 12, "min_frames": 40,
                                            "max_frames": 120}},
}
FP32 = {"dtype": "float32", "fused": False, "fused_train": False}


def overrides(cell: str, **config) -> dict:
    cfg = dict(CONFIG, **config)
    if cell.startswith("xia"):
        cfg["clip"] = dict(CLIP, text_context=77)
    return {"config": cfg, "traffic": TRAFFIC[cell]}


def run(cell: str, seed: int = 5, seconds: float = 0.5, trace: bool = False,
        control: bool = False, fault=None, **config) -> tuple:
    from portbench.harness import cell as cellmod

    return cellmod.run(cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                       control=control, fault=fault, overrides=overrides(cell, **config))


def checks(rows) -> dict:
    return {k: v for k, v, _ in rows}
