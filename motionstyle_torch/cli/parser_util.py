"""Argument parsing of the finetune and demo CLIs (the port's own copy of
motionstyle/cli/parser_util.py: finetune_inpainting_style_args,
eval_inpainting_style_args with the args.json round trip, and their option
groups; parity: utils/parser_util.py). Flag names, groups and defaults are
the JAX package's, so one command line drives either package; --device names
a torch device ('cuda' unless asked). Flags of parts that are not ported yet
are parsed and refused by the CLIs (check_supported).
"""
from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser

# flags that belong to one run and are never taken from a checkpoint's
# args.json (motionstyle/cli/parser_util.py:37-48)
RUN_LOCAL_FLAGS = ("skip_render", "model_path", "output_dir", "fused", "parallel_window",
                   "forecast_stride", "forecast_order", "model_parallel", "pipeline_parallel",
                   "pipeline_micro", "sequence_parallel", "quant_int8", "fused_train",
                   "fused_train_store", "fused_train_prng", "dtype", "native_loader",
                   "prefetch", "style_strength", "style_mix", "long_frames")


def _str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if str(v).lower() in ("1", "true", "t", "yes", "y"):
        return True
    if str(v).lower() in ("0", "false", "f", "no", "n"):
        return False
    raise ValueError(f"expected a boolean, got {v!r}")


def add_base_options(parser):
    group = parser.add_argument_group("base")
    group.add_argument("--device", default="cuda", type=str,
                       help="torch device to run on (cuda unless asked)")
    group.add_argument("--profile", default="", type=str,
                       help="write a torch.profiler trace of the hot loop to this directory")
    group.add_argument("--seed", default=10, type=int, help="For fixing random seed.")
    group.add_argument("--batch_size", default=64, type=int, help="Batch size during training.")


def add_diffusion_options(parser):
    group = parser.add_argument_group("diffusion")
    group.add_argument("--noise_schedule", default="cosine", choices=["linear", "cosine"], type=str)
    group.add_argument("--diffusion_steps", default=1000, type=int)
    group.add_argument("--sigma_small", default=True, type=_str2bool)


def add_model_options(parser):
    group = parser.add_argument_group("model")
    group.add_argument("--arch", default="trans_enc", choices=["trans_enc", "trans_dec", "gru"],
                       type=str)
    group.add_argument("--emb_trans_dec", default=False, type=_str2bool)
    group.add_argument("--layers", default=8, type=int)
    group.add_argument("--latent_dim", default=512, type=int)
    group.add_argument("--cond_mask_prob", default=0.1, type=float)
    group.add_argument("--lambda_rcxyz", default=0.0, type=float)
    group.add_argument("--lambda_vel", default=0.0, type=float)
    group.add_argument("--lambda_fc", default=0.0, type=float)
    group.add_argument("--unconstrained", action="store_true")
    group.add_argument("--mdm_path", default="", type=str,
                       help="pretrained MDM prior checkpoint (.pt)")
    group.add_argument("--clip_weights", default="", type=str,
                       help="optional CLIP text-tower .pt; seeded if absent")
    group.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                       help="transformer compute dtype; default float32, or bfloat16 "
                            "with --fused 1 or --quant_int8 1")
    group.add_argument("--fused", default=0, type=int,
                       help="run inference forwards through the fused CUDA encoder layer")
    group.add_argument("--quant_int8", default=0, type=int,
                       help="int8 serving: run inference forwards through the int8 CUDA "
                            "encoder layer (int8 x int8 -> int32 matmuls with per-row and "
                            "per-channel scales, bf16 attention); implies --fused 1")
    group.add_argument("--fused_train", default=0, type=int,
                       help="run the encoder stacks of training forwards through the "
                            "fused CUDA training layer (forward and backward kernels; "
                            "bf16 matmuls with fp32 sums, tanh-approximate gelu)")
    group.add_argument("--fused_train_prng", default=0, type=int,
                       help="with the fused training layer, generate the dropout masks "
                            "inside the kernels from per-(clip, layer) seeds (counter-based "
                            "Philox) instead of mask arrays (implies --fused_train 1)")
    group.add_argument("--fused_train_store", default=0, type=int,
                       help="with the fused training layer, keep the softmax probabilities "
                            "and qkv in the forward and read them in the attention backward "
                            "(implies --fused_train 1)")


def add_data_options(parser):
    group = parser.add_argument_group("dataset")
    group.add_argument("--dataset", default="humanml",
                       choices=["humanml", "bandai-2_posrot", "bandai-1_posrot",
                                "stylexia_posrot"], type=str)
    group.add_argument("--data_dir", default="", type=str)
    group.add_argument("--native_loader", default=0, type=int,
                       help="assemble batches with the C++ ingest library "
                            "(motionstyle_torch/native; raises when it does not build)")
    group.add_argument("--prefetch", default=0, type=int,
                       help="overlap batch assembly with the device step by "
                            "keeping N batches ready in a background thread")


def add_finetune_options(parser):
    group = parser.add_argument_group("training")
    group.add_argument("--save_dir", required=True, type=str)
    group.add_argument("--semantic_discriminator_path", default="", type=str)
    group.add_argument("--overwrite", action="store_true")
    group.add_argument("--train_platform_type", default="TensorboardPlatform",
                       choices=["NoPlatform", "ClearmlPlatform", "TensorboardPlatform"], type=str)
    group.add_argument("--lr", default=1e-4, type=float)
    group.add_argument("--weight_decay", default=0.0, type=float)
    group.add_argument("--lr_anneal_steps", default=0, type=int)
    group.add_argument("--log_interval", default=1, type=int)
    group.add_argument("--save_interval", default=100, type=int)
    group.add_argument("--num_steps", default=24, type=int)
    group.add_argument("--parallel_finetune", default=0, type=int, help="not ported")
    group.add_argument("--data_parallel", default=0, type=int, help="not ported")
    group.add_argument("--model_parallel", default=1, type=int, help="not ported")
    group.add_argument("--fsdp", default=0, type=int, help="not ported")
    group.add_argument("--orbax_checkpoints", default=0, type=int, help="not ported")
    group.add_argument("--num_frames", default=60, type=int)
    group.add_argument("--lora_rank", default=0, type=int,
                       help="> 0: train rank-r LoRA factors on the style encoder's dense "
                            "weights instead of the encoder (models/lora.py); writes "
                            "adapter{step}.pt beside the merged model{step}.pt")
    group.add_argument("--lora_alpha", default=0.0, type=float,
                       help="LoRA scale numerator (scale = alpha / rank); 0 = rank")
    group.add_argument("--resume_checkpoint", default="", type=str)
    group.add_argument("--dropout_rng_impl", default="rbg", choices=["rbg", "threefry"],
                       help="JAX-only; the port draws dropout from torch generators")
    group.add_argument("--skip_render", action="store_true",
                       help="skip the BVH/mp4 visualization outputs")
    group.add_argument("--auto_stop", default=0, type=int, help="not ported")
    group.add_argument("--auto_stop_ratio", default=0.90, type=float)
    group.add_argument("--auto_stop_content", default=0.6, type=float)
    group.add_argument("--auto_stop_interval", default=0, type=int)
    group.add_argument("--auto_stop_fine", default=5, type=int)


def add_style_inpainting_options(parser):
    group = parser.add_argument_group("style inpainting")
    group.add_argument("--inpainting_mask", default="root_horizontal", type=str)
    group.add_argument("--inpainting_model_path", type=str, default="")
    group.add_argument("--skip_steps", type=int, default=700)
    group.add_argument("--style_finetune", type=int, default=1)
    group.add_argument("--semantic_guidance", type=int, default=1)
    group.add_argument("--use_ddim", type=int, default=1)
    group.add_argument("--Ls", type=float, default=10)
    group.add_argument("--style_example", type=str, default="")
    return group


def finetune_inpainting_style_args(argv=None):
    parser = ArgumentParser()
    add_base_options(parser)
    add_data_options(parser)
    add_finetune_options(parser)
    add_diffusion_options(parser)
    add_model_options(parser)
    add_style_inpainting_options(parser)
    return parser.parse_args(argv)


def add_sampling_options(parser):
    group = parser.add_argument_group("inpainting module")
    group.add_argument("--semantic_discriminator_path", default="", type=str)
    group.add_argument("--model_path", required=True, type=str)
    group.add_argument("--output_dir", default="", type=str)
    group.add_argument("--num_samples", default=1, type=int)
    group.add_argument("--num_repetitions", default=1, type=int)
    group.add_argument("--guidance_param", default=2.5, type=float)
    group.add_argument("--parallel_window", default=0, type=int,
                       help="if >0, the humanml demo's prior content uses the "
                            "Picard-parallel sampler with this many timesteps a forward")
    group.add_argument("--forecast_stride", default=1, type=int,
                       help="if >1, the humanml demo's prior content calls the denoiser "
                            "every Nth step and forecasts its x0 in between")
    group.add_argument("--forecast_order", default=1, type=int, choices=[0, 1, 2],
                       help="forecast extrapolation order (only with --forecast_stride >1)")
    group.add_argument("--long_frames", default=0, type=int,
                       help="restyle this many frames of a longer content clip by "
                            "chained windows (0 = one window)")
    group.add_argument("--style_strength", default=1.0, type=float,
                       help="scale the style task vector (0 = the base, 1 = the "
                            "finetuned style, >1 exaggerated)")
    group.add_argument("--style_mix", default="", type=str,
                       help="blend finetuned styles 'ckptA.pt:0.6,ckptB.pt:0.4'")
    group.add_argument("--model_parallel", default=1, type=int, help="not ported")
    group.add_argument("--pipeline_parallel", default=1, type=int, help="not ported")
    group.add_argument("--pipeline_micro", default=0, type=int)
    group.add_argument("--sequence_parallel", default=1, type=int, help="not ported")
    group.add_argument("--skip_render", action="store_true")
    return group


def add_generate_options(parser):
    group = parser.add_argument_group("generate")
    group.add_argument("--motion_length", default=6.0, type=float)
    group.add_argument("--input_text", default="", type=str)
    group.add_argument("--text_prompt", default="", type=str)
    group.add_argument("--input_content", default="", type=str)


def get_args_per_group_name(parser, args, group_name) -> list:
    for group in parser._action_groups:
        if group.title == group_name:
            return [a.dest for a in group._group_actions if hasattr(args, a.dest)]
    return []


def parse_and_load_from_model(parser, argv=None):
    """Parse argv (sys.argv[1:] when None), then take the dataset, model,
    diffusion, style-inpainting and sampling flags from the args.json beside
    --model_path, except the run-local flags (RUN_LOCAL_FLAGS) and every flag
    given on the command line (abbreviations included)."""
    add_data_options(parser)
    add_model_options(parser)
    add_diffusion_options(parser)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    to_overwrite = [a for group in ("dataset", "model", "diffusion", "style inpainting",
                                    "inpainting module")
                    for a in get_args_per_group_name(parser, args, group)
                    if a not in RUN_LOCAL_FLAGS]
    opt_to_dest = {opt: action.dest for action in parser._actions
                   for opt in action.option_strings}

    def dest_of(tok: str):
        name = tok.split("=", 1)[0]
        if name in opt_to_dest:
            return opt_to_dest[name]
        # argparse takes unambiguous prefixes (--skip_st): protect those too
        hits = {d for o, d in opt_to_dest.items() if o.startswith(name)}
        return hits.pop() if len(hits) == 1 else None

    given = {dest_of(tok) for tok in argv if tok.startswith("--")} - {None}
    to_overwrite = [a for a in to_overwrite if a not in given]

    args_path = os.path.join(os.path.dirname(args.model_path), "args.json")
    if not os.path.exists(args_path):
        raise FileNotFoundError(f"Arguments json file was not found: {args_path}")
    with open(args_path) as fr:
        model_args = json.load(fr)
    for a in to_overwrite:
        if a in model_args:
            setattr(args, a, model_args[a])
        elif "cond_mode" in model_args:
            args.unconstrained = model_args["cond_mode"] == "no_cond"
        else:
            print(f"Warning: was not able to load [{a}], using default value "
                  f"[{getattr(args, a)}] instead.")
    if args.cond_mask_prob == 0:
        args.guidance_param = 1
    return args


def eval_inpainting_style_args(argv=None):
    parser = ArgumentParser()
    add_base_options(parser)
    add_generate_options(parser)
    add_style_inpainting_options(parser)
    add_sampling_options(parser)
    return validate_sampling_args(parse_and_load_from_model(parser, argv))


def validate_sampling_args(args):
    """Fail on contradictory sampler opt-ins (motionstyle/cli/parser_util.py:
    350-364): --parallel_window and --forecast_stride, or two mesh layouts."""
    if args.parallel_window > 0 and args.forecast_stride > 1:
        raise SystemExit("--parallel_window and --forecast_stride are mutually exclusive "
                         "sampler opt-ins; pass at most one")
    layouts = [f"--{n} {getattr(args, n)}" for n in
               ("model_parallel", "pipeline_parallel", "sequence_parallel")
               if getattr(args, n, 1) > 1]
    if len(layouts) > 1:
        raise SystemExit(f"{' and '.join(layouts)} are mutually exclusive mesh layouts; "
                         "pass at most one")
    return args
