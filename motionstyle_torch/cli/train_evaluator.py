"""Evaluator-stack training CLI of the PyTorch port: the movement autoencoder,
then the contrastive text-motion match on top of the frozen movement
encoder; writes finest.tar in the reference layout.

Counterpart of motionstyle/cli/train_evaluator.py, with its flags and its
args.json (parity: data_loaders/humanml/networks/trainers.py DecompTrainerV3
:25, TextMotionMatchTrainer :879). The checkpoint loads into the port's
EvaluatorWrapper, the JAX package's and the reference's, and is what
cli/eval_metrics.py's --evaluator_checkpoint takes, for any dataset the
loaders take (the posrot layouts too, which the reference's evaluator never
covered):

  save_dir/finest.tar  - movement_encoder / text_encoder / motion_encoder

The encoders train on the run's device (the card unless --device says
otherwise) in true fp32. The weights start from seeded draws of torch
generators (seed, seed + 1), so a run differs from the JAX CLI's run of the
same seed; each step's negative shift comes from the global numpy stream
seeded with --seed, as in the JAX CLI.

Run:  python -m motionstyle_torch.cli.train_evaluator \\
        --dataset stylexia_posrot --data_dir .../style_xia \\
        --save_dir ./save/evaluator --ae_steps 400 --match_steps 800 [--device cuda]
"""
from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from os.path import join as pjoin

import numpy as np

from motionstyle_torch.cli.model_util import resolve_device
from motionstyle_torch.data.collate import get_dataset_loader, require_batches
from motionstyle_torch.eval.evaluators import WordVectorizer
from motionstyle_torch.eval.motion_loaders import embed_texts, tokens_or_fallback
from motionstyle_torch.eval.trainers import (
    MovementAETrainer, TextMotionMatchTrainer, save_evaluator)
from motionstyle_torch.train import logging as logger


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--dataset", default="humanml", type=str)
    parser.add_argument("--data_dir", default="", type=str)
    parser.add_argument("--save_dir", required=True, type=str)
    parser.add_argument("--batch_size", default=32, type=int)
    parser.add_argument("--num_frames", default=60, type=int)
    parser.add_argument("--lr", default=1e-4, type=float)
    parser.add_argument("--ae_steps", default=400, type=int)
    parser.add_argument("--match_steps", default=800, type=int)
    parser.add_argument("--glove_dir", default="", type=str)
    parser.add_argument("--log_interval", default=100, type=int)
    parser.add_argument("--seed", default=10, type=int)
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to run on (cuda unless asked)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    os.makedirs(args.save_dir, exist_ok=True)
    with open(pjoin(args.save_dir, "args.json"), "w") as fw:
        json.dump(vars(args), fw, indent=4, sort_keys=True)
    logger.configure(args.save_dir, format_strs=("stdout", "csv"))

    data = require_batches(
        get_dataset_loader(args.dataset, args.batch_size, args.num_frames, split="train",
                           data_root=args.data_dir or None),
        "train_evaluator")
    dim_pose = data.dataset.t2m_dataset.mean.shape[0]
    wv = WordVectorizer(args.glove_dir or None)
    np.random.seed(args.seed)

    # ---- stage 1: movement autoencoder ----
    ae = MovementAETrainer(dim_pose=dim_pose, lr=args.lr, seed=args.seed, device=device)
    step = 0
    while step < args.ae_steps:
        for motion, cond in data:
            if step >= args.ae_steps:
                break
            logs = ae.update(motion[:, :, 0, :].transpose(0, 2, 1).astype(np.float32))
            if step % args.log_interval == 0:
                print(f"ae step[{step}]: loss[{logs['loss']:0.5f}] rec[{logs['loss_rec']:0.5f}]")
            step += 1

    # ---- stage 2: contrastive co-embedding (movement encoder frozen) ----
    match = TextMotionMatchTrainer(ae.enc.state_dict(), dim_pose=dim_pose, lr=args.lr,
                                   seed=args.seed + 1, device=device)
    step = 0
    while step < args.match_steps:
        for motion, cond in data:
            if step >= args.match_steps:
                break
            texts = list(cond["y"]["text"])
            we, po, cl = embed_texts(wv, tokens_or_fallback(cond, texts))
            m_lens = np.asarray(cond["y"]["lengths"], dtype=np.int32)
            logs = match.update(we, po, cl,
                                motion[:, :, 0, :].transpose(0, 2, 1).astype(np.float32), m_lens)
            if step % args.log_interval == 0:
                print(f"match step[{step}]: loss[{logs['loss']:0.5f}] "
                      f"pos[{logs['loss_pos']:0.5f}] neg[{logs['loss_neg']:0.5f}]")
            step += 1

    path = save_evaluator(pjoin(args.save_dir, "finest.tar"), ae.enc, match.text_enc,
                          match.motion_enc, epoch=args.match_steps)
    print(f"[Done] evaluator saved: {path}")
    return path


if __name__ == "__main__":
    main()
