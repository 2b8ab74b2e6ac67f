"""Export a finetuned style checkpoint as a deployable torch.export artifact.

Counterpart of motionstyle/cli/export_model.py. The min-latency serving plan
(the same DDIM inpainting chain cli/serve.py runs live, serve.build_sampler)
is traced with torch.export (serve/export.py) into one program with a
symbolic batch dim per platform, with the parameters stored once beside it:

    python -m motionstyle_torch.cli.export_model \\
        --model_path save/.../model000000032.pt --dataset stylexia_posrot \\
        --fused 1 --platforms cuda --output artifacts/angry_jump
    python -m motionstyle_torch.cli.serve --artifact artifacts/angry_jump

--platforms takes cuda and cpu; each platform's program is traced on that
platform. A --fused 1 or --quant_int8 1 plan calls kernel 1 or kernel 2 (as
custom operators), which run on the card only, so it exports for cuda and
refuses cpu, as the JAX CLI refuses cpu for a plan with Pallas calls. A plain
plan may take both. --model_path and --styles take LoRA adapters too: the
artifact holds the merged encoder. The serving host needs torch and this package's ops
module (motionstyle_torch.ops.fused_encoder).
"""
from __future__ import annotations

import os
import time
from argparse import ArgumentParser


def build_parser() -> ArgumentParser:
    from motionstyle_torch.cli.parser_util import (
        add_base_options, add_diffusion_options, add_model_options)

    parser = ArgumentParser()
    add_base_options(parser)
    add_diffusion_options(parser)
    add_model_options(parser)
    parser.add_argument("--dataset", default="stylexia_posrot", type=str)
    parser.add_argument("--model_path", required=True, type=str,
                        help="finetuned style checkpoint (full model{step}.pt or LoRA "
                             "adapter{step}.pt) baked into the artifact")
    parser.add_argument("--output", required=True, type=str,
                        help="artifact directory to write")
    parser.add_argument("--inpainting_mask", default="root_horizontal", type=str)
    parser.add_argument("--skip_steps", default=700, type=int)
    parser.add_argument("--timestep_respacing", default="ddim20", type=str)
    parser.add_argument("--buckets", default="1,2,4,8", type=str,
                        help="serving bucket grid recorded in the artifact (the plan "
                             "has a symbolic batch dim and serves any size)")
    parser.add_argument("--platforms", default="cuda", type=str,
                        help="platforms to trace a program for: cuda, cpu or both")
    parser.add_argument("--text_plan", default=1, type=int,
                        help="also export the CLIP text tower so the serving host can "
                             "encode captions without model code")
    parser.add_argument("--style_strength", default=1.0, type=float)
    parser.add_argument("--styles", default="", type=str,
                        help="extra named styles 'name=ckpt[,n2=ckpt2]' stored in the "
                             "artifact; the one program serves all of them")
    return parser


def parse_args(argv=None):
    from motionstyle_torch.cli.serve import REFUSED

    args = build_parser().parse_args(argv)
    for flag, asks, what in REFUSED:
        if hasattr(args, flag) and asks(getattr(args, flag)):
            raise NotImplementedError(
                f"--{flag} {getattr(args, flag)}: {what} is not exported by "
                "motionstyle_torch")
    args.platforms = [p.strip() for p in args.platforms.split(",") if p.strip()]
    bad = sorted(set(args.platforms) - {"cuda", "cpu"})
    if bad or not args.platforms:
        raise SystemExit(f"--platforms takes cuda and cpu, got {bad or 'none'}")
    if (args.fused or args.quant_int8) and args.platforms != ["cuda"]:
        raise SystemExit("--fused/--quant_int8 plans call kernel 1 or 2, which run on "
                         "the card only; export them with --platforms cuda")
    return args


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    from motionstyle_torch.cli import model_util
    from motionstyle_torch.cli.serve import build_sampler
    from motionstyle_torch.serve import export as sx

    t0 = time.perf_counter()
    buckets = sorted({int(b) for b in args.buckets.split(",")})
    plans, text_plans = {}, {}
    for platform in args.platforms:
        args.device = platform
        bundle, sampler, item_shape, pick = build_sampler(args)
        # the cond schema from the text tower itself, not the config
        enc_dim = int(np.asarray(bundle.encode_text(["probe"], args.dataset)).shape[1])
        print(f"exporting the sample plan (symbolic batch) for {platform} ...", flush=True)
        plans[platform], params = sx.export_sampler_plan(sampler, item_shape, enc_dim)
        if args.text_plan:
            print(f"exporting the text plan for {platform} ...", flush=True)
            text_plans[platform], text_params = sx.export_text_plan(bundle.clip)
    styles = (model_util.load_named_styles(args, args.styles, bundle.cfg, bundle.device)
              if args.styles else {})
    if styles:
        print(f"storing styles {sorted(styles)} in params.pt")
    meta = {
        "buckets": buckets,
        "dataset": args.dataset,
        "item_shape": list(item_shape),
        "cond_spec": {"enc_text": [[enc_dim], "float32"]},
        "inpainting_mask": args.inpainting_mask,
        "needs_step_noise": sampler.needs_step_noise(),
        "n_steps": sampler.n_live_steps(),
        "dump_pick": pick,
        "model_path": args.model_path,
        "timestep_respacing": args.timestep_respacing,
        "skip_steps": args.skip_steps,
        "style_strength": args.style_strength,
        "fused": bool(args.fused), "quant_int8": bool(args.quant_int8),
        "custom_ops": sorted(set(sx.custom_ops_in(next(iter(plans.values()))))),
    }
    sx.save_artifact(args.output, meta, plans, params,
                     text_plans if args.text_plan else None,
                     text_params if args.text_plan else None, styles=styles)
    total = sum(os.path.getsize(os.path.join(dp, f))
                for dp, _, fs in os.walk(args.output) for f in fs)
    print(f"wrote {args.output}: platforms {args.platforms}, buckets {buckets}, "
          f"{total / 1e6:.1f} MB total, {time.perf_counter() - t0:.1f} s", flush=True)
    return args.output


if __name__ == "__main__":
    main()
