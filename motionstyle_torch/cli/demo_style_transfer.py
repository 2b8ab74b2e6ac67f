"""Style-transfer demo CLI of the PyTorch port: transfer a finetuned style onto
one content motion and write results.npy, IK-fitted BVH and videos.

Counterpart of motionstyle/cli/demo_style_transfer.py on every dataset it
takes (parity: sample/demo_style_transfer.py): the args.json beside
--model_path supplies the run's model and data flags
(parser_util.eval_inpainting_style_args). On stylexia and bandai the content
clip is z-normed and padded to the window (76 and 196 frames), the caption
is 'A person is {content} {style}' (on bandai 'A person {content}s
{style}' from the bandai naming scheme), and the clip is restyled by
root_horizontal inpainting over DDIM-20 with the demo's skip (--skip_steps
of --diffusion_steps), early-stopped at t=4 and picked as the JAX CLI picks
(sampling.min_latency_plan: 2 denoiser calls at skip 14). On humanml the
content is generated from the frozen prior at 196 frames from the same
caption: a 1000-step DDPM chain under classifier-free guidance 2.5
(ddpm.cfg_model_fn, one forward of the doubled batch a step), or the
Picard-parallel sampler (--parallel_window) or the forecast sampler
(--forecast_stride); the transfer then runs under --guidance_param's
guidance and keeps the chain's final sample (no dump pick, :221-224). The
sample is denormalised and decoded to joints (core/features.py::
recover_from_ric). results.npy has the JAX CLI's schema:
motion (N, J, 3, T), text, lengths, num_samples, num_repetitions and the
denormalised hml_vec under "hml". Without --skip_render it then writes what
the JAX CLI writes (:414-475): the content clip and the style example as
IK-fitted BVH (post/ik.py::fit_joints_bvh, 100 Adam steps on the run's
device), the first sample foot-skate cleaned twice (post/footskate.py, on the
host) and IK-fitted to out_transferred_motion.bvh, 2 + --num_repetitions
videos (post/render.py: mp4, or gif without ffmpeg) and, with more than one
repetition and ffmpeg, their hstack sample00.mp4; on humanml the content is
foot-skate cleaned first and no BVH is written (:427-451). --skip_render
returns before any of that.

With --fused 1 every encoder layer runs the CUDA layer of kernel 1, with
--quant_int8 1 the int8 CUDA layer of kernel 2. Noise comes from a
torch.Generator seeded with --seed on the device, so a sample differs from
the JAX CLI's for the same seed.

--style_strength scales the finetuned style's task vector and --style_mix
blends several finetuned styles (model_util.apply_style_strength /
apply_style_mix; the two are mutually exclusive). --long_frames N restyles
the first N frames of a content clip longer than the window by chained
windows (diffusion/longform.py, overlap 10): each window's generator is
seeded from a base seed drawn from the demo's generator, and results.npy and
the post chain cover all N frames; on humanml the prior generates N frames
of content by free window continuation first.

Run:  python -m motionstyle_torch.cli.demo_style_transfer \\
        --model_path save/ft/350angry_jumping/model000000024.pt \\
        --input_content 306neutral_running.npy [--skip_render] [--quant_int8 1]

--profile DIR writes a torch.profiler trace of the sampling repetitions
(utils.profile_trace), as the JAX CLI traces them (:338-392).

Mesh serving (parallel/), under torchrun, one process per rank, as the JAX
CLI serves on a mesh (:227-336): --model_parallel N runs the transfer
through ShardedSampler on a (data x model) mesh with the encoder layers
split over N ranks (with --fused 1 or --quant_int8 1 the kernels run
instead on every rank with the whole weights, as GSPMD gathers them for the
JAX CLI's Pallas call); --pipeline_parallel N GPipe-schedules the style
encoder over N stages (--pipeline_micro microbatches); --sequence_parallel N
splits the frames over N ranks. The data dim takes the largest divisor of
the sample count that the rest of the world allows, and must fill the world.
Every rank samples; rank 0 alone writes the outputs.

    torchrun --standalone --nproc_per_node 2 -m motionstyle_torch.cli.\
        demo_style_transfer --model_path ... --model_parallel 2
"""
from __future__ import annotations

import os
import shutil
import subprocess
import time
from os.path import join as pjoin

import numpy as np
import torch

from motionstyle_torch.cli import model_util
from motionstyle_torch.cli.finetune_style_diffusion import skeleton_assets
from motionstyle_torch.cli.parser_util import eval_inpainting_style_args
from motionstyle_torch.core.features import recover_from_ric
from motionstyle_torch.data.collate import get_dataset_loader
from motionstyle_torch.data.masks import BVH_JOINT_NAMES, get_inpainting_mask
from motionstyle_torch.diffusion import sampling
from motionstyle_torch.diffusion.ddpm import Inpainting, cfg_model_fn
from motionstyle_torch.diffusion.forecast_sampling import forecast_sample_loop
from motionstyle_torch.diffusion.longform import longform_sample
from motionstyle_torch.diffusion.parallel_sampling import parallel_sample_loop
from motionstyle_torch.parallel import mesh as mesh_lib
from motionstyle_torch.post.footskate import remove_fs
from motionstyle_torch.post.ik import fit_joints_bvh
from motionstyle_torch.post.render import plot_3d_motion
from motionstyle_torch.utils import profile_trace

# per dataset: the window, the joints of its skeleton, fps, the default style
# example (motionstyle/cli/demo_style_transfer.py:37-41, :74-76)
DATASETS = {
    "stylexia_posrot": dict(max_frames=76, joints=20, fps=20, example="350angry_jumping.npy"),
    "bandai-1_posrot": dict(max_frames=196, joints=21, fps=20,
                            example="dataset-2_walk-turn-right_feminine_018.npy"),
    "bandai-2_posrot": dict(max_frames=196, joints=21, fps=20,
                            example="dataset-2_walk-turn-right_feminine_018.npy"),
    "humanml": dict(max_frames=196, joints=22, fps=20,
                    example="dataset-2_walk-turn-right_feminine_018.npy"),
}
PRIOR_GUIDANCE = 2.5  # the humanml content's classifier-free guidance (:144-176)
# the prior content's generator: --seed plus this, so its draws are not the
# transfer's (the JAX CLI folds 1 into its key, :126)
PRIOR_SEED = 0x5EED

LAYOUTS = ("model_parallel", "pipeline_parallel", "sequence_parallel")


def check_supported(args) -> None:
    """Raise NotImplementedError for what the port does not run; a mesh
    layout that does not divide the world raises the JAX CLI's ValueError
    (:241-247, :273-283, :315-320) before any work."""
    if args.arch != "trans_enc":
        raise NotImplementedError(f"--arch {args.arch}: StyleDiffusion is trans_enc only")
    world = mesh_lib.world_size()
    for flag in LAYOUTS:
        n = getattr(args, flag)
        if n > 1 and world % n != 0:
            raise ValueError(f"--{flag} {n} does not divide the visible device count {world}")


def sharded_sampler(args, model, sched_ddim, skip: int, stop, dump_all_xstart: bool,
                    dev):
    """The JAX CLI's mesh serving (:227-336): a ShardedSampler over the
    (data x model|pipe|seq) mesh that --model_parallel, --pipeline_parallel
    or --sequence_parallel asks for, or None without one."""
    import math

    from motionstyle_torch.parallel.inference import ShardedSampler
    from motionstyle_torch.parallel.pipeline import pipelined_style_model_fn_builder
    from motionstyle_torch.parallel.sequence import seq_parallel_style_model_fn_builder

    flag = next((f for f in LAYOUTS if getattr(args, f) > 1), None)
    if flag is None:
        return None
    par, world = getattr(args, flag), mesh_lib.world_size()
    guided = args.dataset == "humanml" and args.guidance_param not in (0, 1)
    dp = math.gcd(world // par, max(1, args.num_samples))
    axis = flag.split("_")[0]
    mesh = mesh_lib.make_mesh(dp * par, device=args.device, **{flag: par})
    if flag == "pipeline_parallel":
        if model.cfg.num_layers % par:
            raise ValueError(f"--pipeline_parallel {par} does not divide the encoder depth "
                             f"{model.cfg.num_layers}")
        per_shard = max(1, args.num_samples * (2 if guided else 1) // dp)
        n_micro = min(args.pipeline_micro or per_shard, per_shard)
        while per_shard % n_micro:
            n_micro -= 1
        inner = pipelined_style_model_fn_builder(model, mesh, n_micro)
        mesh_lib.say(f"serving over a ({dp} data x {par} pipe) mesh, {n_micro} microbatches")
    elif flag == "sequence_parallel":
        inner = seq_parallel_style_model_fn_builder(model, mesh)
        mesh_lib.say(f"serving over a ({dp} data x {par} seq) mesh")
    else:
        inner = lambda params: (  # noqa: E731
            lambda x, t, c: params(x, t, c.get("enc_text")))
        mesh_lib.say(f"serving over a ({dp} data x {par} {axis}) mesh")

    def builder(params):
        fn = inner(params)
        if not guided:
            return fn
        # the guidance scale of the rank's rows
        return lambda x, t, c: cfg_model_fn(fn, torch.full(
            (x.shape[0],), args.guidance_param, device=dev))(x, t, c)

    return ShardedSampler(mesh, sched_ddim, builder, model, method="ddim",
                          skip_timesteps=skip, stop_timesteps=stop,
                          dump_all_xstart=dump_all_xstart)


def caption(args, name: str) -> str:
    """The transfer's caption (parity :129-136), or --input_text: 'A person
    is {content} {style}' from the content file and the checkpoint's
    directory; on bandai the bandai naming scheme ('..._{content}_{style}_
    {id}', which the reference does not parse here), 'A person moves' with
    a warning when the names do not follow it."""
    if args.input_text:
        return args.input_text
    if args.dataset.startswith("bandai"):
        cfields = os.path.basename(args.input_content)[:-4].split("_")
        nfields = name.split("_")
        if len(cfields) >= 3 and len(nfields) >= 2:
            cparts = cfields[-3].split("-")
            cparts[0] += "s"
            return f"A person {' '.join(cparts)} {nfields[-2].replace('-', ' ')}"
        print("WARNING: content/checkpoint names do not follow the bandai "
              f"'..._{{content}}_{{style}}_{{id}}' scheme ({args.input_content!r} / "
              f"{name!r}); pass --input_text for a meaningful caption")
        return "A person moves"
    contents = args.input_content.split("_")[-1][:-4]
    style_label = name.split("_")[0][3:]
    return f"A person is {contents} {style_label}"


def prior_content(args, sched_full, model, enc_text, shape, lf: int, dev) -> tuple:
    """The humanml content, generated from the frozen prior under
    classifier-free guidance 2.5 (:144-176): a 1000-step DDPM chain, or
    --parallel_window's Picard-parallel sampler, or --forecast_stride's
    forecast sampler; with --long_frames, free window continuation past the
    window (diffusion/longform.py). Noise from a generator of its own, seeded
    from --seed. Returns (content (N, C, 1, T) on dev, long content or None)."""
    prior_fn = cfg_model_fn(lambda x, t, c: model.denoise_prior(x, t, c["enc_text"]),
                            torch.full((args.num_samples,), PRIOR_GUIDANCE, device=dev))
    cond = {"enc_text": enc_text}
    gen = torch.Generator(device=dev).manual_seed((args.seed + PRIOR_SEED) & 0x7FFFFFFF)
    t0 = time.perf_counter()
    long_content = None
    if lf > 0:
        print(f"long-form humanml: generating {lf}-frame content from the prior in "
              f"windows of {shape[-1]}")

        def run_prior_window(init, inp, window_generator):
            as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
            return sampling.sample_loop(
                sched_full, prior_fn, cond, window_generator, shape=shape,
                init_image=None if init is None else as_t(init), method="ddpm",
                inpainting=None if inp is None else Inpainting(as_t(inp.mask),
                                                               as_t(inp.motion)))

        long_content = longform_sample(run_prior_window, lf, shape[-1], overlap=10,
                                       seed=sampling.draw_base_seed(gen, dev), device=dev)
        content = torch.as_tensor(long_content[..., :shape[-1]], device=dev)
    elif args.parallel_window > 0:
        content, sweeps = parallel_sample_loop(sched_full, prior_fn, cond, gen, shape=shape,
                                               method="ddpm", window=args.parallel_window)
        print(f"  parallel sampler: {int(sweeps)} sweeps for {sched_full.num_timesteps} steps")
    elif args.forecast_stride > 1:
        content = forecast_sample_loop(sched_full, prior_fn, cond, gen, shape=shape,
                                       method="ddpm", stride=args.forecast_stride,
                                       order=args.forecast_order)
        print(f"  forecast sampler: denoiser called every {args.forecast_stride} steps")
    else:
        content = sampling.sample_loop(sched_full, prior_fn, cond, gen, shape=shape,
                                       method="ddpm")
    print(f"prior content took {time.perf_counter() - t0:.4f} s")
    return content, long_content


def main(argv=None):
    args = eval_inpainting_style_args(argv)
    with mesh_lib.distributed(args.device):
        check_supported(args)
        return run(args)


def run(args):
    spec = DATASETS[args.dataset]
    main_rank = mesh_lib.is_main()
    max_frames = spec["max_frames"]
    humanml = args.dataset == "humanml"
    name = os.path.basename(os.path.dirname(args.model_path))

    # a run-specific subdirectory is always nested (reference :42-52): using
    # --output_dir itself would remove the user's whole directory
    run_name = (f"style_transfer_from_stylexample_{name}_to_contentmotion_"
                f"{os.path.basename(args.input_content)[:-4]}_seed{args.seed}")
    out_path = pjoin(args.output_dir or os.path.dirname(args.model_path), run_name)
    if args.input_text:
        out_path += "_" + args.input_text.replace(" ", "_").replace(".", "")
    if main_rank:
        if os.path.exists(out_path):
            shutil.rmtree(out_path)
        os.makedirs(out_path)

    print("creating data loader...")
    args.batch_size = args.num_samples
    ds = get_dataset_loader(args.dataset, args.batch_size, max_frames, split="test",
                            data_root=args.data_dir or None).dataset

    print("creating model and diffusion...")
    bundle, sched_ddim, sched_full = model_util.creat_serval_diffusion(
        args, timestep_respacing="ddim20", device=args.device)
    if args.style_mix:
        if args.style_strength != 1.0:
            raise SystemExit("--style_mix and --style_strength are mutually exclusive "
                             "(give the mix entry a weight instead)")
        model_util.apply_style_mix(bundle, args)
    else:
        model_util.apply_style_strength(bundle, args)
    dev, model = bundle.device, bundle.model

    def load_clip(fname):
        path = fname if os.path.isfile(fname) else pjoin(ds.opt.motion_dir, fname)
        motion, length = ds.process_np_motion(path)
        return torch.as_tensor(motion.T[None, :, None, :], dtype=torch.float32, device=dev), length

    if not args.style_example:
        args.style_example = spec["example"]
    input_motions, style_m_length = load_clip(args.style_example)

    texts = [caption(args, name)] * args.num_samples
    print(f'caption: "{texts[0]}"')
    enc_text = torch.as_tensor(bundle.encode_text(texts, args.dataset), device=dev)

    lf = args.long_frames
    if lf > 0:
        for bad in ("parallel_window", "forecast_stride") + LAYOUTS:
            if getattr(args, bad) not in (0, 1):
                raise SystemExit(f"--long_frames is incompatible with --{bad}")
        if lf <= max_frames:
            print(f"NOTE: --long_frames {lf} <= the model window {max_frames}; "
                  "running the plain path")
            lf = 0
    long_ctx = None
    if humanml:
        # the humanml content is generated from the frozen prior from the
        # same caption; m_length is the style example's (:144-176)
        print("sampling content motion from the frozen prior...")
        njoints, nfeats = model_util.DATASET_DIMS[args.dataset]
        content, long_content = prior_content(
            args, sched_full, model, enc_text, (args.num_samples, njoints, nfeats, max_frames),
            lf, dev)
        m_length = style_m_length
        if long_content is not None:
            m_length = lf
            long_ctx = (long_content, np.asarray(get_inpainting_mask(
                args.inpainting_mask, long_content.shape, dataset=args.dataset), np.float32))
    else:
        content, m_length = load_clip(args.input_content)
        content = content.expand(args.num_samples, -1, -1, -1).contiguous()
    if lf > 0 and long_ctx is None:
        # long-form transfer: restyle the full content clip by chained
        # windows instead of trimming it to the window (JAX :189-215)
        cpath = (args.input_content if os.path.isfile(args.input_content)
                 else pjoin(ds.opt.motion_dir, args.input_content))
        raw = np.load(cpath)  # (L, D) unnormalised, not trimmed
        if raw.shape[0] < lf:
            raise SystemExit(f"--long_frames {lf} exceeds the content clip's "
                             f"{raw.shape[0]} frames")
        norm = ((raw - ds.mean) / ds.std).astype(np.float32)
        long_content = np.tile(norm.T[None, :, None, :], (args.num_samples, 1, 1, 1))
        long_mask = np.asarray(get_inpainting_mask(args.inpainting_mask, long_content.shape,
                                                   dataset=args.dataset), np.float32)
        m_length = lf
        long_ctx = (long_content, long_mask)
        print(f"long-form transfer: {raw.shape[0]}-frame content -> {lf} frames in "
              f"windows of {max_frames}")
    mask = torch.as_tensor(get_inpainting_mask(args.inpainting_mask, tuple(content.shape),
                                               dataset=args.dataset),
                           dtype=torch.float32, device=dev)
    inpainting = Inpainting(mask, content)

    def model_fn(x, t, cond):
        return model(x, t, cond["enc_text"])

    if humanml and args.guidance_param not in (0, 1):  # :221-222
        model_fn = cfg_model_fn(model_fn, torch.full((args.num_samples,), args.guidance_param,
                                                     device=dev))

    # the posrot datasets take the x0 prediction 5 steps before the chain's
    # end (:259-260); min_latency_plan stops the chain at t=4 where that pick
    # allows it, with the same output. humanml takes the final sample (:224)
    dump_all_xstart = not humanml
    skip = int(args.skip_steps / args.diffusion_steps * sched_ddim.num_timesteps)
    stop, pick = sampling.min_latency_plan(sched_ddim.num_timesteps, skip)
    if not dump_all_xstart:
        stop = None
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    sharded = sharded_sampler(args, model, sched_ddim, skip, stop, dump_all_xstart, dev)
    all_motions, all_hml, all_lengths, all_text = [], [], [], []
    with profile_trace(args.profile, enabled=bool(args.profile)):
        for rep_i in range(args.num_repetitions):
            print(f"### Start sampling [repetitions #{rep_i}]")
            t0 = time.perf_counter()
            if long_ctx is not None:
                as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731

                def run_window(init, inp, window_generator):
                    res = sampling.sample_loop(
                        sched_ddim, model_fn, {"enc_text": enc_text}, window_generator,
                        shape=tuple(content.shape),
                        init_image=None if init is None else as_t(init), method="ddim",
                        skip_timesteps=skip, stop_timesteps=stop,
                        inpainting=None if inp is None else Inpainting(as_t(inp.mask),
                                                                       as_t(inp.motion)),
                        dump_all_xstart=dump_all_xstart)
                    return res[pick] if dump_all_xstart else res

                full = longform_sample(run_window, m_length, max_frames, overlap=10,
                                       seed=sampling.draw_base_seed(generator, dev),
                                       content=long_ctx[0], content_mask=long_ctx[1], device=dev)
                sample = full[:, :, 0, :].transpose(0, 2, 1)
                calls = "long-form"
            else:
                if sharded is not None:
                    res = sharded({"init_image": content, "cond": {"enc_text": enc_text},
                                   "inpainting": inpainting}, generator)
                else:
                    res = sampling.sample_loop(
                        sched_ddim, model_fn, {"enc_text": enc_text}, generator,
                        shape=tuple(content.shape), init_image=content, method="ddim",
                        skip_timesteps=skip, stop_timesteps=stop, inpainting=inpainting,
                        dump_all_xstart=dump_all_xstart)
                out = res[pick] if dump_all_xstart else res
                sample = out[:, :, 0, :].permute(0, 2, 1).cpu().numpy()
                calls = f"{len(res)} denoiser calls" if dump_all_xstart else "the whole chain"
            if main_rank:
                print(f"sampling took {time.perf_counter() - t0:.4f} s ({calls}, "
                      f"batch {args.num_samples}, on {dev})")
            denorm = ds.inv_transform(sample)
            all_hml.append(denorm)
            joints = recover_from_ric(torch.as_tensor(denorm, dtype=torch.float32), spec["joints"])
            all_motions.append(joints.numpy().transpose(0, 2, 3, 1))  # B J 3 T
            all_lengths.append(np.full(args.num_samples, m_length))
            all_text += texts
            print(f"created {len(all_motions) * args.batch_size} samples")

    if not main_rank:
        return out_path
    npy_path = pjoin(out_path, "results.npy")
    print(f"saving results file to [{npy_path}]")
    np.save(npy_path, {
        "motion": np.concatenate(all_motions, axis=0), "text": all_text,
        "lengths": np.concatenate(all_lengths, axis=0), "num_samples": args.num_samples,
        "num_repetitions": args.num_repetitions,
        # the JAX CLI's extra key: the denormalised hml_vec outputs
        "hml": np.concatenate(all_hml, axis=0),
    })
    if not args.skip_render:
        content_src = long_ctx[0] if long_ctx is not None else content.cpu().numpy()
        write_outputs(args, ds, spec, out_path, content_src, m_length,
                      input_motions.cpu().numpy(), style_m_length, all_motions, all_hml,
                      all_text, dev)
    print(f"[Done] Results are at [{os.path.abspath(out_path)}]")
    return out_path


def write_outputs(args, ds, spec, out_path, content, m_length, input_motions, style_m_length,
                  all_motions, all_hml, all_text, dev) -> None:
    """The demo's BVH and video outputs (motionstyle/cli/demo_style_transfer.py
    :414-475): three IK fits on `dev` (none on humanml), two foot-skate passes
    (three on humanml, whose prior-made content is cleaned before it is the
    contact reference) and 2 + num_repetitions renders on the host. content
    and input_motions are normalised (B, C, 1, T) numpy clips; a long-form
    content covers all m_length frames."""
    skel, real_offsets, chains, ee_names = skeleton_assets(args.dataset)
    bones = BVH_JOINT_NAMES[args.dataset]

    def joints_of(clip):
        denorm = ds.inv_transform(clip[0, :, 0, :].T)
        return denorm, recover_from_ric(torch.as_tensor(denorm, dtype=torch.float32),
                                        spec["joints"]).numpy()

    content_denorm, content_joints = joints_of(content)
    style_denorm, style_joints = joints_of(input_motions)
    ref_motion = content_joints[:m_length]
    humanml = args.dataset == "humanml"
    if humanml:
        # the prior-generated content skates: clean it before it is the
        # contact reference (:427-433)
        ref_motion, _, _, _ = remove_fs(ref_motion, ref_motion, bones, ee_names,
                                        force_on_floor=False, use_vel3=True, vel3_thr=0.02,
                                        after_butterworth=True)

    print(f"saving visualizations to [{out_path}]...")
    if not humanml:
        fit_joints_bvh(pjoin(out_path, "input_content_motion.bvh"), content_denorm[:m_length],
                       skel, real_offsets, ref_motion, names=bones, device=dev)
        fit_joints_bvh(pjoin(out_path, "input_style_example.bvh"),
                       style_denorm[:style_m_length], skel, real_offsets,
                       style_joints[:style_m_length], names=bones, device=dev)

    length = int(m_length)
    fs_motion = all_motions[0][0].transpose(2, 0, 1)[:length].copy()
    fs_motion, _, _, _ = remove_fs(fs_motion, ref_motion, bones, ee_names, force_on_floor=True,
                                   after_butterworth=True, use_vel3=True, vel3_thr=0.05)
    fs_motion, _, _, _ = remove_fs(fs_motion, fs_motion, bones, ee_names, force_on_floor=True,
                                   after_butterworth=True, use_vel3=True, vel3_thr=0.05)
    if not humanml:
        fit_joints_bvh(pjoin(out_path, "out_transferred_motion.bvh"), all_hml[0][0, :length],
                       skel, real_offsets, fs_motion, names=bones, device=dev)

    rep_files = []
    for title, motion, fname in (
            ("Input Content Motion", content_joints[:m_length], "input_content_motion00.mp4"),
            ("Input Style Motion", style_joints[:style_m_length], "input_style_motion00.mp4")):
        p = pjoin(out_path, fname)
        plot_3d_motion(p, chains, motion, title=title, dataset=args.dataset, fps=spec["fps"],
                       vis_mode="gt")
        rep_files.append(p)
    for rep_i in range(args.num_repetitions):
        caption_ = (f"style transferred motion: {all_text[rep_i * args.batch_size]}"
                    if args.guidance_param else "style transferred motion")
        p = pjoin(out_path, f"output_transferred_motion00_rep{rep_i:02d}.mp4")
        plot_3d_motion(p, chains, fs_motion, title=caption_, dataset=args.dataset,
                       fps=spec["fps"], vis_mode=args.inpainting_mask,
                       painting_features=args.inpainting_mask.split(","))
        rep_files.append(p)
    if args.num_repetitions > 1 and shutil.which("ffmpeg"):
        inputs = [a for f in rep_files for a in ("-i", f)]
        subprocess.run(["ffmpeg", "-y", "-loglevel", "warning", *inputs, "-filter_complex",
                        f"hstack=inputs={args.num_repetitions + 1}",
                        pjoin(out_path, "sample00.mp4")], check=False)


if __name__ == "__main__":
    main()
