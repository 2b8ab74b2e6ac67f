"""Prior pretraining CLI of the PyTorch port: train the text-conditioned MDM
prior and write the two files the finetune consumes.

Counterpart of motionstyle/cli/pretrain_prior.py, with its flags, its
args.json and its total --num_steps budget on resume:

  save_dir/mdm.pt                - the prior, for --mdm_path
  save_dir/model_pretrained.pt   - its encoder, a warm start for --resume_checkpoint
  save_dir/mdm_ema.pt            - with --ema_rate, the averaged prior

With --fused_train 1 every training forward and backward of the prior's
encoder runs the CUDA training kernels (--fused_train_store 1: the
store-probs pair; --fused_train_prng 1: dropout generated inside the kernels
from per-(clip, layer) seeds); both imply --fused_train 1.

Run:  python -m motionstyle_torch.cli.pretrain_prior \\
        --dataset stylexia_posrot --data_dir .../style_xia \\
        --save_dir ./save/prior --num_steps 600 --batch_size 64 \\
        --fused_train_prng 1 [--device cuda]

Every dataset the loaders take is taken (stylexia_posrot, bandai-1_posrot,
bandai-2_posrot, humanml, kit); --num_frames goes to the loader as the JAX
CLI passes it (motionstyle/cli/pretrain_prior.py:110-115), and no dataset
reads it.
--dropout_rng_impl is accepted for the JAX package's sake only: the port
draws every dropout mask and seed from torch generators. --native_loader 1
and --prefetch N take the C++ batch assembly and a prefetching thread
(native/loader.py); --profile DIR writes a torch.profiler trace of the step
loop (utils.profile_trace), which the JAX CLI parses and ignores.

Scale-out (parallel/mesh.py), under torchrun, one process per rank:
--data_parallel 1 splits the batch over the ranks; --model_parallel N splits
the encoder layers over N of them; --pipeline_parallel N GPipe-schedules the
prior's encoder stack over N stages (parallel/pipeline.py), each batch in
--pipeline_micro microbatches (0: the largest divisor of the shard's batch
up to 2N); --fsdp 1 shards the prior and its moments over 'data'. The JAX
CLI's exits hold: --model_parallel and --pipeline_parallel exclude each
other, --fused_train takes data parallelism only, --fsdp needs
--data_parallel 1 and no pipeline. Rank 0 alone writes the files; mdm*.pt
and opt*.pt stay layout-independent, so a pipelined run resumes on a plain
one and back.
"""
from __future__ import annotations

import json
import os
import time
from argparse import ArgumentParser
from os.path import join as pjoin

import numpy as np

from motionstyle_torch.cli import model_util
from motionstyle_torch.cli.parser_util import (
    add_base_options, add_data_options, add_diffusion_options, add_model_options)
from motionstyle_torch.data.collate import get_dataset_loader, require_batches
from motionstyle_torch.diffusion.resample import SCHEDULE_SAMPLERS
from motionstyle_torch.parallel import mesh as mesh_lib
from motionstyle_torch.train import logging as logger
from motionstyle_torch.train.pretrain import PretrainConfig, PriorTrainer
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
    parser.add_argument("--num_steps", default=600, type=int,
                        help="the TOTAL step budget: a resumed run does the remainder")
    parser.add_argument("--num_frames", default=60, type=int,
                        help="passed to the loader as the JAX CLI passes it; no "
                             "dataset reads it")
    parser.add_argument("--log_interval", default=50, type=int)
    parser.add_argument("--save_interval", default=0, type=int)
    parser.add_argument("--lr_anneal_steps", default=0, type=int,
                        help="linear LR decay to 0 over this many steps (0 = constant LR)")
    parser.add_argument("--grad_accum", default=1, type=int,
                        help="split each batch into N sequential microbatches with one "
                             "optimizer update per batch; must divide --batch_size")
    parser.add_argument("--schedule_sampler", default="uniform",
                        choices=list(SCHEDULE_SAMPLERS),
                        help="timestep sampler; loss_second_moment importance-samples t "
                             "by sqrt(E[loss^2])")
    parser.add_argument("--dropout_rng_impl", default="rbg", choices=["rbg", "threefry"],
                        help="the JAX package's dropout bit generator; the port draws "
                             "from torch generators whatever it says")
    parser.add_argument("--data_parallel", default=0, type=int,
                        help="1 = split the batch over the ranks torchrun starts")
    parser.add_argument("--model_parallel", default=1, type=int,
                        help="tensor-parallel degree over a 'model' dim of the ranks")
    parser.add_argument("--pipeline_parallel", default=1, type=int,
                        help="GPipe stages of the prior's encoder over a 'pipe' dim of the "
                             "ranks (parallel/pipeline.py); excludes --model_parallel and "
                             "--fused_train")
    parser.add_argument("--pipeline_micro", default=0, type=int,
                        help="microbatches per pipeline (0 = auto)")
    parser.add_argument("--fsdp", default=0, type=int,
                        help="1 = shard the prior and Adam's moments over 'data' (needs "
                             "--data_parallel 1)")
    parser.add_argument("--ema_rate", default=0.0, type=float,
                        help="EMA rate of the prior's weights (e.g. 0.9999); writes "
                             "mdm_ema.pt and ema{step:09d}.pt; 0 = off")
    parser.add_argument("--resume_checkpoint", default="", type=str,
                        help="a mdm{step:09d}.pt written by --save_interval, or the save "
                             "dir holding them; the optimizer state comes from the sibling "
                             "opt{step:09d}.pt")
    return parser.parse_args(argv)


def check_supported(args) -> None:
    """Raise NotImplementedError for what the port does not run."""
    if args.arch != "trans_enc":
        raise NotImplementedError(f"--arch {args.arch}: StyleDiffusion is trans_enc only")


def main(argv=None):
    args = parse_args(argv)
    check_supported(args)
    with mesh_lib.distributed(args.device):
        return run(args)


def run(args):
    # the factory expects the style-inpainting arg surface
    args.semantic_discriminator_path = ""
    args.model_path = ""
    main_rank = mesh_lib.is_main()

    os.makedirs(args.save_dir, exist_ok=True)
    if main_rank:
        with open(pjoin(args.save_dir, "args.json"), "w") as fw:
            json.dump(vars(args), fw, indent=4, sort_keys=True)
    logger.configure(args.save_dir, format_strs=("stdout", "csv") if main_rank else ())

    data = require_batches(get_dataset_loader(args.dataset, args.batch_size, args.num_frames,
                                              split="train", data_root=args.data_dir or None,
                                              native=bool(args.native_loader),
                                              prefetch=args.prefetch),
                           "pretrain_prior")
    bundle, _, sched_full = model_util.creat_serval_diffusion(args, device=args.device)
    mesh = mesh_lib.cli_training_mesh(bool(args.data_parallel), args.model_parallel,
                                      args.batch_size, label="pretraining",
                                      fused_train=bundle.cfg.fused_train,
                                      pipeline_parallel=args.pipeline_parallel,
                                      device=args.device)
    cfg = PretrainConfig(save_dir=args.save_dir, lr=args.lr, weight_decay=args.weight_decay,
                         num_steps=args.num_steps, log_interval=args.log_interval,
                         save_interval=args.save_interval, cond_mask_prob=args.cond_mask_prob,
                         seed=args.seed, lr_anneal_steps=args.lr_anneal_steps,
                         grad_accum=args.grad_accum, resume_checkpoint=args.resume_checkpoint,
                         schedule_sampler=args.schedule_sampler, ema_rate=args.ema_rate,
                         pipeline_micro=args.pipeline_micro)
    if args.fsdp and mesh is None:
        raise SystemExit("--fsdp needs a mesh: pass --data_parallel 1")
    trainer = PriorTrainer(cfg, bundle.model, sched_full, mesh=mesh, fsdp=bool(args.fsdp))
    print("Total prior params: %.2fM" % (
        sum(p.numel() for p in bundle.model.mdm.parameters()) / 1e6))

    # --num_steps is the TOTAL budget: a resumed run does the remainder
    trainer.install_preemption_handler()
    with profile_trace(args.profile, enabled=bool(args.profile)):
        while trainer.step + trainer.resume_step < args.num_steps:
            for motion, cond in data:
                if trainer.step + trainer.resume_step >= args.num_steps or trainer.preempted:
                    break
                t0 = time.perf_counter()
                batch = {
                    "x_start": motion.astype(np.float32),
                    "enc_text": bundle.encode_text(list(cond["y"]["text"]), args.dataset),
                    "mask": cond["y"]["mask"][:, :1, :1, :].astype(np.float32),
                }
                loss = trainer.run_step(batch)  # a 0-d tensor on the device
                step = trainer.step + trainer.resume_step - 1
                if args.log_interval and step % args.log_interval == 0:
                    if main_rank:
                        print(f"prior step[{step}]: loss[{float(loss):0.5f}] "
                              f"({time.perf_counter() - t0:.3f} s)")
                    logger.dumpkvs()
            if trainer.preempted:
                path = trainer.save_step()
                trainer.restore_signal_handlers()
                print(f"[Preempted] prior checkpoint saved: {path}")
                return args.save_dir
    trainer.restore_signal_handlers()
    mdm_path, warm_path = trainer.save()
    print(f"[Done] prior saved: {mdm_path} + {warm_path}")
    return args.save_dir


if __name__ == "__main__":
    main()
