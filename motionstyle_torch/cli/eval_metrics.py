"""T2M metric evaluation CLI of the PyTorch port: sample the prior over a
split and report FID / R-precision / matching / diversity /
multimodality.

Counterpart of motionstyle/cli/eval_metrics.py, with its flags, its key set
and its printed JSON. It scores the prior (or a distilled student): a
checkpoint given as --model_path is moved into --mdm_path, as in the JAX
CLI (:86-87); no style adapter is read. A student of
cli/distill_prior.py is scored on its grid with --mdm_path
mdm_{n}step.pt --timestep_respacing ddim{n} --use_ddim 1.

The prior samples on the card: with --fused 1 every denoiser layer is
kernel 1, with --quant_int8 1 kernel 2, and with --fused 0 under
MOTIONSTYLE_PALLAS_ATTN=1 the plain layers' self-attention is kernel 4;
classifier-free guidance (--guidance_param not 0 or 1) runs the conditioned
and unconditioned halves as one forward of twice --batch_size. The sampling
noise comes from a torch.Generator on the device seeded with --seed +
replication, so the samples differ from the JAX CLI's for one seed; the
loader's order, the multimodality batches, the R-precision pools and the
diversity draws come from numpy and are the JAX CLI's. The evaluator
(--evaluator_checkpoint, a finest.tar of either package or the reference;
seeded without one) runs on the same device in true fp32.

Run:  python -m motionstyle_torch.cli.eval_metrics \\
        --dataset humanml --data_dir processed_data/HumanML3D \\
        --mdm_path save/prior/mdm.pt --fused 1 \\
        [--evaluator_checkpoint save/evaluator/finest.tar] \\
        [--num_samples 256] [--mm_num_samples 32] [--device cuda]

--native_loader 1 and --prefetch N take the C++ batch assembly of the style
datasets and a prefetching thread (native/loader.py) for the ground-truth
loader, as the flags' help says; the JAX CLI parses them and ignores them.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from motionstyle_torch.cli import model_util
from motionstyle_torch.cli.parser_util import (
    add_data_options, add_diffusion_options, add_model_options, validate_sampling_args)
from motionstyle_torch.data.collate import get_dataset_loader
from motionstyle_torch.diffusion import forecast_sampling, parallel_sampling, sampling
from motionstyle_torch.diffusion.ddpm import cfg_model_fn
from motionstyle_torch.eval.evaluators import EvaluatorWrapper, WordVectorizer
from motionstyle_torch.eval.motion_loaders import (
    GeneratedMotionDataset, evaluate_matching_and_fid, evaluate_multimodality,
    tokens_or_fallback)
from motionstyle_torch.utils import fixseed

# the window of each dataset (motionstyle/cli/eval_metrics.py:96)
LONG_WINDOW = ("humanml", "bandai-1_posrot", "bandai-2_posrot")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_data_options(parser)
    add_model_options(parser)
    add_diffusion_options(parser)
    parser.add_argument("--model_path", default="", type=str)
    parser.add_argument("--evaluator_checkpoint", default="", type=str)
    parser.add_argument("--glove_dir", default="", type=str)
    parser.add_argument("--batch_size", default=32, type=int)
    parser.add_argument("--num_samples", default=256, type=int)
    parser.add_argument("--mm_num_samples", default=0, type=int)
    parser.add_argument("--mm_num_repeats", default=10, type=int)
    parser.add_argument("--guidance_param", default=2.5, type=float)
    parser.add_argument("--parallel_window", default=0, type=int,
                        help="if >0, sample with the parallel-in-time Picard sampler using "
                             "this window of timesteps per batched forward")
    parser.add_argument("--forecast_stride", default=1, type=int,
                        help="if >1, call the denoiser every Nth step and forecast its x0 "
                             "in between (approximate; the metrics show its cost)")
    parser.add_argument("--forecast_order", default=1, type=int, choices=[0, 1, 2],
                        help="forecast extrapolation order (0 hold / 1 linear / 2 quadratic)")
    parser.add_argument("--timestep_respacing", default="", type=str,
                        help="sample on a respaced grid, e.g. ddim8 for a progressively "
                             "distilled prior; empty = full schedule")
    parser.add_argument("--use_ddim", default=0, type=int,
                        help="sample with eta=0 DDIM instead of ancestral DDPM (required "
                             "for distilled priors)")
    parser.add_argument("--seed", default=10, type=int)
    parser.add_argument("--split", default="test", choices=["test", "train"],
                        help="dataset split providing captions + ground truth")
    parser.add_argument("--replication_times", default=1, type=int,
                        help="T2M protocol replications: re-generate + re-evaluate this many "
                             "times and report mean and 95%% conf interval")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to run on (cuda unless asked)")
    return parser


def check_supported(args) -> None:
    """Raise NotImplementedError for what this slice of the port does not run."""
    if args.arch != "trans_enc":
        raise NotImplementedError(f"--arch {args.arch}: StyleDiffusion is trans_enc only")


def main(argv=None):
    args = build_parser().parse_args(argv)
    validate_sampling_args(args)
    check_supported(args)
    device = model_util.resolve_device(args.device)

    # the prior is scored, so a checkpoint given as --model_path fills the
    # prior's slot: build_model's --model_path loads a style encoder, which
    # the prior never reads (the JAX CLI's :81-87)
    if args.model_path and not args.mdm_path:
        args.mdm_path, args.model_path = args.model_path, ""
    args.semantic_discriminator_path = ""

    # the loader's order draws from the global numpy stream
    fixseed(args.seed)

    max_frames = 196 if args.dataset in LONG_WINDOW else 76
    loader = get_dataset_loader(args.dataset, args.batch_size, max_frames, split=args.split,
                                data_root=args.data_dir or None,
                                native=bool(args.native_loader), prefetch=args.prefetch)
    if len(loader) == 0:
        raise SystemExit(
            f"{args.dataset} split '{args.split}' yields no batches — metrics over nothing "
            "are meaningless (missing splits file? batch_size larger than the split?); fix "
            "the split or use --split train")

    bundle, sched_respaced, sched_full = model_util.creat_serval_diffusion(
        args, args.timestep_respacing, device=device)
    if args.timestep_respacing:
        sched_full = sched_respaced
    method = "ddim" if args.use_ddim else "ddpm"
    model = bundle.model

    def model_fn(x, t, c):
        return model.denoise_prior(x, t, c.get("enc_text"))

    def sample_batch_fn(texts, lengths, shape, generator):
        enc = torch.as_tensor(bundle.encode_text(list(texts), args.dataset), device=device)
        cond = {"enc_text": enc}
        fn = model_fn
        if args.guidance_param not in (0.0, 1.0):
            fn = cfg_model_fn(model_fn, torch.full((shape[0],), args.guidance_param,
                                                   device=device))
        shape = tuple(shape)
        if args.parallel_window > 0:
            sample, sweeps = parallel_sampling.parallel_sample_loop(
                sched_full, fn, cond, generator, shape=shape, method=method,
                window=args.parallel_window)
            print(f"  parallel sampler: {int(sweeps)} sweeps for "
                  f"{sched_full.num_timesteps} steps")
            return sample
        if args.forecast_stride > 1:
            return forecast_sampling.forecast_sample_loop(
                sched_full, fn, cond, generator, shape=shape, method=method,
                stride=args.forecast_stride, order=args.forecast_order)
        return sampling.sample_loop(sched_full, fn, cond, generator, shape=shape,
                                    method=method)

    wv = WordVectorizer(args.glove_dir or None)
    evaluator = EvaluatorWrapper(args.dataset, checkpoint_path=args.evaluator_checkpoint or None,
                                 dim_pose=bundle.cfg.njoints, device=device)

    # ground truth in the space the generated items use (the T2M evaluator's
    # statistics where the dataset has them)
    def to_eval_space(motion_td):
        ds = loader.dataset
        if hasattr(ds, "mean_for_eval"):
            denormed = ds.t2m_dataset.inv_transform(motion_td)
            return (denormed - ds.mean_for_eval) / ds.std_for_eval
        return motion_td

    def one_replication(rep: int) -> dict:
        print(f"generating evaluation samples (replication {rep}) ...")
        seed = args.seed + rep
        gen = GeneratedMotionDataset(
            sample_batch_fn, loader, mm_num_samples=args.mm_num_samples,
            mm_num_repeats=args.mm_num_repeats, num_samples_limit=args.num_samples,
            generator=torch.Generator(device=device).manual_seed(seed), seed=seed)
        gt_items, gen_items = [], []
        for motion, cond in loader:
            batch_tokens = tokens_or_fallback(cond, cond["y"]["text"])
            for b in range(motion.shape[0]):
                gt_items.append((cond["y"]["text"][b], to_eval_space(motion[b, :, 0, :].T),
                                 int(cond["y"]["lengths"][b]), batch_tokens[b]))
            if len(gt_items) >= len(gen):
                break
        for i in range(len(gen)):
            caption, motion, length, tokens, _ = gen[i]
            gen_items.append((caption, motion, length, tokens))

        n = min(len(gt_items), len(gen_items))
        metrics = evaluate_matching_and_fid(evaluator, wv, gt_items[:n], gen_items[:n],
                                            diversity_times=min(300, n - 1), seed=rep)
        if gen.mm_generated_motion:
            metrics["multimodality"] = evaluate_multimodality(
                evaluator, gen.mm_generated_motion,
                mm_num_times=min(10, args.mm_num_repeats - 1))
        return {k: float(v) for k, v in metrics.items()}

    reps = [one_replication(r) for r in range(max(1, args.replication_times))]
    out = {k: round(float(np.mean([r[k] for r in reps])), 4) for k in reps[0]}
    if len(reps) > 1:
        # 95% confidence interval over replications (T2M protocol reporting)
        for k in list(out):
            vals = np.asarray([r[k] for r in reps])
            out[f"{k}_conf"] = round(float(1.96 * vals.std() / np.sqrt(len(vals))), 4)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
