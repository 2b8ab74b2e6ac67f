"""Progressive prior distillation CLI of the PyTorch port: halve the DDIM
sampling grid --stages times.

Counterpart of motionstyle/cli/distill_prior.py, with its flags and its
args.json. After K stages mdm_{N}step.pt samples with N = diffusion_steps /
2^K DDIM steps (diffusion/distillation.py has the math); every stage writes
its student:

  save_dir/mdm_{N}step.pt   - the stage's student prior, for --mdm_path

The student forward is the prior's plain fp32 layers under a gradient; under
MOTIONSTYLE_PALLAS_ATTN=1 their self-attention runs kernel 4 on the card,
forward and backward, in the teacher's and the student's forwards alike.
--fused 1 and --quant_int8 1 are refused before the first step: the fused
inference layers have no backward (the JAX CLI fails at its first step).
--fused_train has no effect, as in the JAX package: the student forward is
deterministic, and the training layers run only training forwards.

Run:  python -m motionstyle_torch.cli.distill_prior \\
        --dataset stylexia_posrot --data_dir .../style_xia \\
        --mdm_path save/prior/mdm.pt --save_dir save/distilled \\
        --diffusion_steps 64 --stages 3 --steps_per_stage 400 [--device cuda]

Sample a stage-K student on its grid: --mdm_path save/distilled/mdm_8step.pt
with make_schedule(..., 64, "ddim8") and sampling.sample_loop(method="ddim").

Every dataset the loaders take is taken (stylexia_posrot, bandai-1_posrot,
bandai-2_posrot, humanml, kit); --num_frames goes to the loader as the JAX
CLI passes it, and no dataset reads it. --native_loader 1 and --prefetch N
take the C++ batch assembly and a prefetching thread (native/loader.py);
--profile DIR writes a torch.profiler trace of the stages' step loops
(utils.profile_trace), which the JAX CLI parses and ignores.
"""
from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from os.path import join as pjoin

import numpy as np

from motionstyle_torch.cli import model_util
from motionstyle_torch.cli.parser_util import (
    add_base_options, add_data_options, add_diffusion_options, add_model_options)
from motionstyle_torch.data.collate import get_dataset_loader, require_batches
from motionstyle_torch.diffusion.distillation import DistillConfig, ProgressiveDistiller
from motionstyle_torch.train import logging as logger
from motionstyle_torch.utils import profile_trace


def parse_args(argv=None):
    parser = ArgumentParser()
    add_base_options(parser)
    add_data_options(parser)
    add_diffusion_options(parser)
    add_model_options(parser)
    parser.add_argument("--save_dir", required=True, type=str)
    parser.add_argument("--lr", default=1e-4, type=float)
    parser.add_argument("--weight_decay", default=0.0, type=float)
    parser.add_argument("--stages", default=3, type=int,
                        help="number of halvings: diffusion_steps -> /2^stages")
    parser.add_argument("--steps_per_stage", default=400, type=int)
    parser.add_argument("--distill_guidance", default=0.0, type=float,
                        help="> 0: distill the classifier-free-GUIDED teacher at this "
                             "fixed scale; the student then samples guided outputs with a "
                             "plain conditional forward (guidance_param 1.0)")
    parser.add_argument("--num_frames", default=60, type=int,
                        help="passed to the loader as the JAX CLI passes it; no "
                             "dataset reads it")
    parser.add_argument("--log_interval", default=50, type=int)
    return parser.parse_args(argv)


def check_supported(args) -> None:
    """Raise NotImplementedError for what this slice of the port does not run."""
    if args.arch != "trans_enc":
        raise NotImplementedError(f"--arch {args.arch}: StyleDiffusion is trans_enc only")


def main(argv=None):
    args = parse_args(argv)
    check_supported(args)
    # the factory expects the style-inpainting arg surface
    args.semantic_discriminator_path = ""
    args.model_path = ""

    n = args.diffusion_steps
    for k in range(args.stages):
        if n % 2:
            raise SystemExit(f"--stages {args.stages}: grid size {n} at stage {k} is odd; "
                             "pick diffusion_steps divisible by 2^stages")
        n //= 2

    os.makedirs(args.save_dir, exist_ok=True)
    args.package = model_util.PACKAGE  # which package wrote the run
    with open(pjoin(args.save_dir, "args.json"), "w") as fw:
        json.dump(vars(args), fw, indent=4, sort_keys=True)
    logger.configure(args.save_dir, format_strs=("stdout", "csv"))

    loader = require_batches(get_dataset_loader(args.dataset, args.batch_size, args.num_frames,
                                                split="train", data_root=args.data_dir or None,
                                                native=bool(args.native_loader),
                                                prefetch=args.prefetch),
                             "distill_prior")
    bundle, _, _ = model_util.creat_serval_diffusion(args, device=args.device)
    if not args.mdm_path:
        print("WARNING: no --mdm_path teacher checkpoint; distilling a seeded prior "
              "(smoke runs only)")
    cfg = DistillConfig(save_dir=args.save_dir, lr=args.lr, weight_decay=args.weight_decay,
                        steps_per_stage=args.steps_per_stage, log_interval=args.log_interval,
                        seed=args.seed, guidance=args.distill_guidance)
    distiller = ProgressiveDistiller(cfg, bundle.model, args.noise_schedule,
                                     args.diffusion_steps)

    class EncodedBatches:
        """Re-iterable (run_stage cycles it until its budget)."""

        def __iter__(self):
            for motion, cond in loader:
                yield motion.astype(np.float32), {
                    "enc_text": bundle.encode_text(list(cond["y"]["text"]), args.dataset),
                    "mask": cond["y"]["mask"][:, :1, :1, :].astype(np.float32),
                }

    paths = []
    data = EncodedBatches()
    n = args.diffusion_steps
    with profile_trace(args.profile, enabled=bool(args.profile)):
        for _ in range(args.stages):
            loss = distiller.run_stage(n, data)
            n //= 2
            paths.append(distiller.save(n))
            print(f"[stage done] {2 * n}-step teacher -> {n}-step student "
                  f"(final loss {loss:.5f})")
    print(f"[Done] distilled checkpoints: {paths}")
    return paths


if __name__ == "__main__":
    main()
