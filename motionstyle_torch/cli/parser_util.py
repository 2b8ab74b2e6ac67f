"""Argument parsing of the finetune CLI (the port's own copy of
motionstyle/cli/parser_util.py's finetune_inpainting_style_args and its
option groups; parity: utils/parser_util.py). Flag names, groups and
defaults are the JAX package's, so one command line drives either package;
--device names a torch device ('cuda' unless asked). Flags of parts that are
not ported yet are parsed and refused by the CLI (check_supported).
"""
from __future__ import annotations

from argparse import ArgumentParser


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
    group.add_argument("--profile", default="", type=str, help="not ported")
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
                            "with --fused 1")
    group.add_argument("--fused", default=0, type=int,
                       help="run inference forwards through the fused CUDA encoder layer")
    group.add_argument("--quant_int8", default=0, type=int, help="not ported")
    group.add_argument("--fused_train", default=0, type=int,
                       help="run the encoder stacks of training forwards through the "
                            "fused CUDA training layer (forward and backward kernels; "
                            "bf16 matmuls with fp32 sums, tanh-approximate gelu)")
    group.add_argument("--fused_train_prng", default=0, type=int, help="not ported")
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
    group.add_argument("--native_loader", default=0, type=int, help="not ported")
    group.add_argument("--prefetch", default=0, type=int, help="not ported")


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
    group.add_argument("--lora_rank", default=0, type=int, help="not ported")
    group.add_argument("--lora_alpha", default=0.0, type=float, help="not ported")
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
