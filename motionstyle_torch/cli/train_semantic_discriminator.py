"""Semantic-discriminator training CLI of the PyTorch port.

Counterpart of motionstyle/cli/train_semantic_discriminator.py, with its
flags and its args.json: trains the discriminator (train/semantic.py)
against a pretrained prior (--mdm_path, e.g. from cli/pretrain_prior.py) and
writes save_dir/semantic_discriminator.pt, the --semantic_discriminator_path
checkpoint the finetune and the demo of either package load. With
--fused_train 1 (or --fused_train_store 1 / --fused_train_prng 1, which
imply it) the prior's training forwards and backwards run the CUDA training
kernels.

Run:  python -m motionstyle_torch.cli.train_semantic_discriminator \\
        --dataset stylexia_posrot --data_dir .../style_xia \\
        --mdm_path save/prior/mdm.pt --save_dir ./save/semantic \\
        --num_steps 600 --batch_size 16 [--fused_train 1] [--device cuda]

Every dataset the loaders take is taken; --num_frames goes to the loader as
the JAX CLI passes it, and no dataset reads it; --dropout_rng_impl is
accepted for the JAX package's sake only (the port draws from torch
generators). --native_loader 1 and --prefetch N take the C++ batch assembly
and a prefetching thread (native/loader.py); --profile DIR writes a
torch.profiler trace of the step loop (utils.profile_trace), which the JAX
CLI parses and ignores. The JAX CLI takes no mesh flags.
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
from motionstyle_torch.train import logging as logger
from motionstyle_torch.train.semantic import SemanticConfig, SemanticTrainer
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
    parser.add_argument("--num_steps", default=600, type=int)
    parser.add_argument("--num_frames", default=60, type=int,
                        help="passed to the loader as the JAX CLI passes it; no "
                             "dataset reads it")
    parser.add_argument("--log_interval", default=50, type=int)
    parser.add_argument("--save_interval", default=0, type=int)
    parser.add_argument("--dropout_rng_impl", default="rbg", choices=["rbg", "threefry"],
                        help="the JAX package's dropout bit generator; the port draws "
                             "from torch generators whatever it says")
    return parser.parse_args(argv)


def check_supported(args) -> None:
    """Raise NotImplementedError for what this slice of the port does not run."""
    if args.arch != "trans_enc":
        raise NotImplementedError(f"--arch {args.arch}: StyleDiffusion is trans_enc only")


def main(argv=None):
    args = parse_args(argv)
    check_supported(args)
    args.semantic_discriminator_path = ""
    args.model_path = ""
    if not args.mdm_path:
        print("WARNING: no --mdm_path; training the discriminator against a random prior "
              "aligns mu with a meaningless space")

    os.makedirs(args.save_dir, exist_ok=True)
    with open(pjoin(args.save_dir, "args.json"), "w") as fw:
        json.dump(vars(args), fw, indent=4, sort_keys=True)
    logger.configure(args.save_dir, format_strs=("stdout", "csv"))

    data = require_batches(get_dataset_loader(args.dataset, args.batch_size, args.num_frames,
                                              split="train", data_root=args.data_dir or None,
                                              native=bool(args.native_loader),
                                              prefetch=args.prefetch),
                           "train_semantic_discriminator")
    bundle, _, sched_full = model_util.creat_serval_diffusion(args, device=args.device)
    cfg = SemanticConfig(save_dir=args.save_dir, lr=args.lr, weight_decay=args.weight_decay,
                         num_steps=args.num_steps, log_interval=args.log_interval,
                         save_interval=args.save_interval, cond_mask_prob=args.cond_mask_prob,
                         seed=args.seed)
    trainer = SemanticTrainer(cfg, bundle.model, sched_full)
    print("Total discriminator params: %.2fM trainable" % (
        sum(p.numel() for p in bundle.model.parameters() if p.requires_grad) / 1e6))

    step = 0
    with profile_trace(args.profile, enabled=bool(args.profile)):
        while step < args.num_steps:
            for motion, cond in data:
                if step >= args.num_steps:
                    break
                batch = {
                    "x_start": motion.astype(np.float32),
                    "frame_mask": cond["y"]["mask"][:, 0, 0, :].astype(bool),
                    "mask": cond["y"]["mask"][:, :1, :1, :].astype(np.float32),
                }
                loss = trainer.run_step(batch)
                if args.log_interval and step % args.log_interval == 0:
                    print(f"semantic step[{step}]: loss[{loss:0.5f}]")
                    logger.dumpkvs()
                step += 1
    path = trainer.save()
    print(f"[Done] semantic discriminator saved: {path}")
    return path


if __name__ == "__main__":
    main()
