"""T2M generator + length-estimator training CLI of the PyTorch port (the
Comp_v6 asset path).

Counterpart of motionstyle/cli/train_t2m_generator.py, with its flags, its
args.json and its checkpoint (parity: data_loaders/humanml/networks/
trainers.py CompTrainerV6 :211, LengthEstTrainer :748). It trains the
length estimator, then the CompV6 generator, on the run's device (the card
unless --device says otherwise) in true fp32, and writes

  save_dir/t2m_generator.pkl - {"generator", "length_estimator"} as flax
                               trees of numpy + the size keys, the JAX
                               CLI's layout: either package loads it

With --run_eval it then runs the T2M protocol with the trained generator as
the generated-motion source (eval/motion_loaders.CompV6GeneratedDataset)
against --evaluator_checkpoint (a seeded evaluator without one) and prints
the metrics. Only the humanml/kit layouts (foot-contact channels) are taken,
as in the JAX CLI; the posrot layouts are refused with its message. The
weights start from seeded torch draws and the z noise and length draws come
from torch generators, so a run differs from the JAX CLI's of the same seed;
the teacher-forcing coin is the global numpy stream seeded with --seed.

Run:  python -m motionstyle_torch.cli.train_t2m_generator \\
        --dataset humanml --data_dir processed_data/HumanML3D \\
        --save_dir ./save/t2m_gen --gen_steps 2000 --len_steps 500 \\
        [--run_eval --evaluator_checkpoint save/evaluator/finest.tar] [--device cuda]
"""
from __future__ import annotations

import json
import os
import pickle
from argparse import ArgumentParser
from os.path import join as pjoin

import numpy as np
import torch

from motionstyle_torch.cli.model_util import resolve_device
from motionstyle_torch.data.collate import get_dataset_loader, require_batches
from motionstyle_torch.eval.evaluators import EvaluatorWrapper, WordVectorizer
from motionstyle_torch.eval.motion_loaders import (
    CompV6GeneratedDataset, embed_texts, evaluate_matching_and_fid, tokens_or_fallback)
from motionstyle_torch.eval.t2m_generator import CompV6Generator, LengthEstTrainer
from motionstyle_torch.train import logging as logger


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--dataset", default="humanml", type=str)
    parser.add_argument("--data_dir", default="", type=str)
    parser.add_argument("--save_dir", required=True, type=str)
    parser.add_argument("--batch_size", default=16, type=int)
    parser.add_argument("--num_frames", default=64, type=int)
    parser.add_argument("--lr", default=2e-4, type=float)
    parser.add_argument("--gen_steps", default=1000, type=int)
    parser.add_argument("--len_steps", default=400, type=int)
    parser.add_argument("--dim_z", default=128, type=int)
    parser.add_argument("--hidden", default=1024, type=int)
    parser.add_argument("--text_hidden", default=512, type=int)
    parser.add_argument("--glove_dir", default="", type=str)
    parser.add_argument("--log_interval", default=100, type=int)
    parser.add_argument("--seed", default=10, type=int)
    parser.add_argument("--run_eval", action="store_true",
                        help="after training, run the T2M protocol with the generator as "
                             "the generated-motion source")
    parser.add_argument("--evaluator_checkpoint", default="", type=str)
    parser.add_argument("--num_eval_samples", default=32, type=int)
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to run on (cuda unless asked)")
    return parser


def save_t2m(path: str, gen: CompV6Generator, len_est: LengthEstTrainer, args,
             dim_pose: int, out_size: int) -> str:
    """t2m_generator.pkl in the JAX CLI's layout (:129-136)."""
    with open(path, "wb") as f:
        pickle.dump({"generator": gen.jax_params(), "length_estimator": len_est.jax_params(),
                     "dim_pose": dim_pose, "dim_z": args.dim_z, "hidden": args.hidden,
                     "text_hidden": args.text_hidden, "len_output_size": out_size}, f)
    return path


def load_t2m(path: str, device="cuda") -> tuple:
    """(CompV6Generator, LengthEstTrainer) from a t2m_generator.pkl written
    by either package, on `device` (the card unless another is named)."""
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    gen = CompV6Generator(dim_pose=ckpt["dim_pose"], dim_z=ckpt["dim_z"], hidden=ckpt["hidden"],
                          text_hidden=ckpt["text_hidden"], device=device)
    len_est = LengthEstTrainer(output_size=ckpt["len_output_size"], device=device)
    return gen.load_jax_params(ckpt["generator"]), len_est.load_jax_params(
        ckpt["length_estimator"])


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
        "train_t2m_generator")
    dim_pose = data.dataset.t2m_dataset.mean.shape[0]
    # posrot layouts have no foot-contact channels; CompV6's movement stage
    # takes dim_pose - 4 only for the fc layouts (mirrors the eval stack)
    if dim_pose not in (263, 251):
        raise SystemExit(
            "train_t2m_generator targets the humanml/kit (fc-channel) layouts the "
            "reference's Comp_v6 assets cover; the posrot style datasets are evaluated via "
            "cli/eval_metrics with cli/train_evaluator.py instead")
    wv = WordVectorizer(args.glove_dir or None)
    np.random.seed(args.seed)
    # the humanml loader pads to max_motion_length (196); train on
    # --num_frames windows like the reference's window-sampled training set
    T_crop = max(4, (args.num_frames // 4) * 4)

    def window(motion, cond):
        mot = motion[:, :, 0, :].transpose(0, 2, 1).astype(np.float32)[:, :T_crop]
        lens = np.minimum(np.asarray(cond["y"]["lengths"], np.int32), T_crop)
        return mot, lens

    # ---- length estimator ----
    out_size = T_crop // 4 + 1
    len_est = LengthEstTrainer(output_size=out_size, lr=args.lr, seed=args.seed, device=device)
    step = 0
    while step < args.len_steps:
        for motion, cond in data:
            if step >= args.len_steps:
                break
            we, po, cl = embed_texts(wv, tokens_or_fallback(cond, list(cond["y"]["text"])))
            _, lens = window(motion, cond)
            logs = len_est.update(we, po, cl, lens)
            if step % args.log_interval == 0:
                print(f"len step[{step}]: loss[{logs['loss']:0.4f}] acc[{logs['acc']:0.3f}]")
            step += 1

    # ---- CompV6 generator ----
    gen = CompV6Generator(dim_pose=dim_pose, dim_z=args.dim_z, hidden=args.hidden,
                          text_hidden=args.text_hidden, lr=args.lr, seed=args.seed + 1,
                          device=device)
    rng = torch.Generator(device=device).manual_seed(args.seed + 2)
    step = 0
    while step < args.gen_steps:
        for motion, cond in data:
            if step >= args.gen_steps:
                break
            we, po, cl = embed_texts(wv, tokens_or_fallback(cond, list(cond["y"]["text"])))
            mot, lens = window(motion, cond)
            logs = gen.train_step(we, po, cl, mot, lens, generator=rng)
            if step % args.log_interval == 0:
                print(f"gen step[{step}]: loss[{logs['loss']:0.4f}] "
                      f"mot[{logs['loss_mot_rec']:0.4f}] kld[{logs['loss_kld']:0.4f}]")
            step += 1

    path = save_t2m(pjoin(args.save_dir, "t2m_generator.pkl"), gen, len_est, args, dim_pose,
                    out_size)
    print(f"[Done] generator + length estimator saved: {path}")

    if args.run_eval:
        if args.num_eval_samples < 2:
            raise SystemExit("--num_eval_samples must be >= 2 (diversity needs at least two "
                             "samples)")
        test_loader = require_batches(
            get_dataset_loader(args.dataset, args.batch_size, args.num_frames, split="test",
                               data_root=args.data_dir or None),
            "train_t2m_generator --run_eval (test split)")
        comp = CompV6GeneratedDataset(gen, len_est, test_loader, wv, seed=args.seed,
                                      num_samples_limit=args.num_eval_samples)
        evaluator = EvaluatorWrapper(args.dataset,
                                     checkpoint_path=args.evaluator_checkpoint or None,
                                     dim_pose=dim_pose, device=device)
        gt_items, gen_items = [], []
        for motion, cond in test_loader:
            toks = tokens_or_fallback(cond, list(cond["y"]["text"]))
            for b in range(motion.shape[0]):
                gt_items.append((cond["y"]["text"][b], motion[b, :, 0, :].T,
                                 int(cond["y"]["lengths"][b]), toks[b]))
            if len(gt_items) >= args.num_eval_samples:
                break
        for i in range(min(len(comp), args.num_eval_samples)):
            caption, m, length, tokens, _ = comp[i]
            gen_items.append((caption, m, length, tokens))
        n = min(len(gt_items), len(gen_items))
        metrics = evaluate_matching_and_fid(evaluator, wv, gt_items[:n], gen_items[:n],
                                            diversity_times=min(300, n - 1))
        print(json.dumps({k: round(float(v), 4) for k, v in metrics.items()}))
    return path


if __name__ == "__main__":
    main()
