"""Style-transfer demo CLI of the PyTorch port: transfer a finetuned style onto
one content motion and write results.npy.

Counterpart of motionstyle/cli/demo_style_transfer.py on its stylexia path
with --skip_render (parity: sample/demo_style_transfer.py): the args.json
beside --model_path supplies the run's model and data flags
(parser_util.eval_inpainting_style_args), the content clip is z-normed and
padded to the 76-frame window, the caption is 'A person is {content}
{style}', and the clip is restyled by root_horizontal inpainting over DDIM-20
with the demo's skip (--skip_steps of --diffusion_steps), early-stopped at
t=4 and picked as the JAX CLI picks (sampling.min_latency_plan: 2 denoiser
calls at skip 14). The sample is denormalised and decoded to joints
(core/features.py::recover_from_ric). results.npy has the JAX CLI's schema:
motion (N, J, 3, T), text, lengths, num_samples, num_repetitions and the
denormalised hml_vec under "hml".

With --fused 1 every encoder layer runs the CUDA layer of kernel 1, with
--quant_int8 1 the int8 CUDA layer of kernel 2. Noise comes from a
torch.Generator seeded with --seed on the device, so a sample differs from
the JAX CLI's for the same seed.

Run:  python -m motionstyle_torch.cli.demo_style_transfer \\
        --model_path save/ft/350angry_jumping/model000000024.pt \\
        --input_content 306neutral_running.npy --skip_render [--quant_int8 1]

Not on this slice (each raises before any work, naming its ROADMAP item):
rendering and BVH output, the humanml and bandai datasets, long-form
transfer, style strength and mixes, the parallel and forecast samplers of
the humanml branch, mesh serving and profiling.
"""
from __future__ import annotations

import os
import shutil
import time
from os.path import join as pjoin

import numpy as np
import torch

from motionstyle_torch.cli import model_util
from motionstyle_torch.cli.parser_util import eval_inpainting_style_args
from motionstyle_torch.core.features import recover_from_ric
from motionstyle_torch.data.collate import get_dataset_loader
from motionstyle_torch.data.masks import get_inpainting_mask
from motionstyle_torch.diffusion import sampling
from motionstyle_torch.diffusion.ddpm import Inpainting

DATASETS = {"stylexia_posrot": dict(max_frames=76, joints=20, example="350angry_jumping.npy")}

# flag, when it asks for something not ported, what it needs
REFUSED = (
    ("long_frames", lambda v: v > 0, "long-form transfer (ROADMAP §1 item 6)"),
    ("style_mix", bool, "style mixes (ROADMAP §1 item 6)"),
    ("style_strength", lambda v: v != 1.0, "style strength (ROADMAP §1 item 6)"),
    # the JAX demo reaches the parallel and the forecast samplers only on its
    # humanml branch (motionstyle/cli/demo_style_transfer.py:121-165)
    ("parallel_window", lambda v: v > 0,
     "the Picard-parallel sampler of the humanml branch (ROADMAP §1 item 10)"),
    ("forecast_stride", lambda v: v > 1,
     "the forecast sampler of the humanml branch (ROADMAP §1 item 10)"),
    ("model_parallel", lambda v: v > 1, "model-parallel serving (ROADMAP §1 item 11)"),
    ("pipeline_parallel", lambda v: v > 1, "pipeline-parallel serving (ROADMAP §1 item 11)"),
    ("sequence_parallel", lambda v: v > 1, "sequence-parallel serving (ROADMAP §1 item 11)"),
    ("profile", bool, "profiling (ROADMAP §1 item 12)"),
)


def check_supported(args) -> None:
    """Raise NotImplementedError for what this slice of the port does not run."""
    for flag, asks, what in REFUSED:
        if asks(getattr(args, flag)):
            raise NotImplementedError(
                f"--{flag} {getattr(args, flag)}: {what} is not ported to motionstyle_torch")
    if not args.skip_render:
        raise NotImplementedError(
            "rendering, BVH output and foot-skate cleanup are not ported to motionstyle_torch "
            "(ROADMAP §1 item 1: the post chain, core/skeleton.py, core/params.py); "
            "pass --skip_render")
    if args.dataset not in DATASETS:
        raise NotImplementedError(
            f"--dataset {args.dataset}: only stylexia_posrot is ported to motionstyle_torch "
            "(ROADMAP §1 item 10: humanml and bandai loaders)")
    if args.arch != "trans_enc":
        raise NotImplementedError(f"--arch {args.arch}: StyleDiffusion is trans_enc only")


def caption(args, name: str) -> str:
    """'A person is {content} {style}' from the content file and the
    checkpoint's directory (parity :129-136), or --input_text."""
    if args.input_text:
        return args.input_text
    contents = args.input_content.split("_")[-1][:-4]
    style_label = name.split("_")[0][3:]
    return f"A person is {contents} {style_label}"


def main(argv=None):
    args = eval_inpainting_style_args(argv)
    check_supported(args)
    spec = DATASETS[args.dataset]
    name = os.path.basename(os.path.dirname(args.model_path))

    # a run-specific subdirectory is always nested (reference :42-52): using
    # --output_dir itself would remove the user's whole directory
    run_name = (f"style_transfer_from_stylexample_{name}_to_contentmotion_"
                f"{os.path.basename(args.input_content)[:-4]}_seed{args.seed}")
    out_path = pjoin(args.output_dir or os.path.dirname(args.model_path), run_name)
    if args.input_text:
        out_path += "_" + args.input_text.replace(" ", "_").replace(".", "")
    if os.path.exists(out_path):
        shutil.rmtree(out_path)
    os.makedirs(out_path)

    print("creating data loader...")
    args.batch_size = args.num_samples
    ds = get_dataset_loader(args.dataset, args.batch_size, split="test",
                            data_root=args.data_dir or None).dataset

    print("creating model and diffusion...")
    bundle, sched_ddim, _ = model_util.creat_serval_diffusion(
        args, timestep_respacing="ddim20", device=args.device)
    dev, model = bundle.device, bundle.model

    def load_clip(fname):
        path = fname if os.path.isfile(fname) else pjoin(ds.opt.motion_dir, fname)
        motion, length = ds.process_np_motion(path)
        return torch.as_tensor(motion.T[None, :, None, :], dtype=torch.float32, device=dev), length

    if not args.style_example:
        args.style_example = spec["example"]
    load_clip(args.style_example)  # read as the JAX CLI reads it; only its renders use it

    texts = [caption(args, name)] * args.num_samples
    print(f'caption: "{texts[0]}"')
    enc_text = torch.as_tensor(bundle.encode_text(texts, args.dataset), device=dev)

    content, m_length = load_clip(args.input_content)
    content = content.expand(args.num_samples, -1, -1, -1).contiguous()
    mask = torch.as_tensor(get_inpainting_mask(args.inpainting_mask, tuple(content.shape),
                                               dataset=args.dataset),
                           dtype=torch.float32, device=dev)
    inpainting = Inpainting(mask, content)

    def model_fn(x, t, cond):
        return model(x, t, cond["enc_text"])

    # the posrot datasets take the x0 prediction 5 steps before the chain's
    # end (:259-260); min_latency_plan stops the chain at t=4 where that pick
    # allows it, with the same output
    skip = int(args.skip_steps / args.diffusion_steps * sched_ddim.num_timesteps)
    stop, pick = sampling.min_latency_plan(sched_ddim.num_timesteps, skip)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    all_motions, all_hml, all_lengths, all_text = [], [], [], []
    for rep_i in range(args.num_repetitions):
        print(f"### Start sampling [repetitions #{rep_i}]")
        t0 = time.perf_counter()
        dump = sampling.sample_loop(
            sched_ddim, model_fn, {"enc_text": enc_text}, generator,
            shape=tuple(content.shape), init_image=content, method="ddim",
            skip_timesteps=skip, stop_timesteps=stop, inpainting=inpainting,
            dump_all_xstart=True)
        sample = dump[pick][:, :, 0, :].permute(0, 2, 1).cpu().numpy()
        print(f"sampling took {time.perf_counter() - t0:.4f} s ({len(dump)} denoiser calls, "
              f"batch {args.num_samples}, on {dev})")
        denorm = ds.inv_transform(sample)
        all_hml.append(denorm)
        joints = recover_from_ric(torch.as_tensor(denorm, dtype=torch.float32), spec["joints"])
        all_motions.append(joints.numpy().transpose(0, 2, 3, 1))  # B J 3 T
        all_lengths.append(np.full(args.num_samples, m_length))
        all_text += texts
        print(f"created {len(all_motions) * args.batch_size} samples")

    npy_path = pjoin(out_path, "results.npy")
    print(f"saving results file to [{npy_path}]")
    np.save(npy_path, {
        "motion": np.concatenate(all_motions, axis=0), "text": all_text,
        "lengths": np.concatenate(all_lengths, axis=0), "num_samples": args.num_samples,
        "num_repetitions": args.num_repetitions,
        # the JAX CLI's extra key: the denormalised hml_vec outputs
        "hml": np.concatenate(all_hml, axis=0),
    })
    print(f"[Done] Results are at [{os.path.abspath(out_path)}]")
    return out_path


if __name__ == "__main__":
    main()
