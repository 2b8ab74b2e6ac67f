"""Few-shot style finetune CLI of the PyTorch port.

Counterpart of motionstyle/cli/finetune_style_diffusion.py (parity:
train/finetune_style_diffusion.py) on every dataset it takes: stylexia_posrot,
bandai-2_posrot (and bandai-1_posrot, which takes bandai-2's defaults, where
the JAX CLI has none and raises KeyError) and humanml. args.json config of
record, neutral content generated by the frozen prior (a 1000-step DDPM
stopped at 900, keeping the last x0, :195-212; on humanml the whole chain,
keeping the final sample, :155-167), the semantic-guidance caption edit
(:279-286; on humanml the style word spliced after each /VERB token),
training through the few-shot loss (with --parallel_finetune 1 through the
Picard-parallel unroll), --auto_stop's operating-point selection
(AutoStopEvaluator, auto_stop.json) and a final DDIM resample (:307-343).
With --fused_train 1 every training forward of the style encoder runs the
CUDA training kernels (with --fused_train_store 1, which implies it, the
store-probs forward and the stored attention backward; with
--fused_train_prng 1, which implies it too, the kernels' own Philox dropout
from per-(clip, layer) seeds instead of mask arrays); with --fused 1 the
prior's sampling runs the CUDA inference kernel; with --quant_int8 1 the
gradient-free forwards (neutral generation, --auto_stop's evaluations and the
final resample) run the int8 CUDA layer and the training forwards the plain
layers, as the JAX denoiser routes them (motionstyle/models/transformer.py:
217-218). Without --skip_render the run also writes the neutral motion's
noised and clean versions as IK-fitted BVH and video, and the style example's
reconstruction as video (:213-252, :307-343): the IK runs on the run's device,
foot-skate cleanup and rendering on the host (post/); the noised neutral is
q_sample at 0.701 T (0.301 T on humanml). With --lora_rank r
(and --lora_alpha) only rank-r adapter factors on the style encoder's dense
weights train (models/lora.py), through whichever layers the flags above
pick: each run writes the merged encoder as model{step}.pt beside the
factors as adapter{step}.pt, and --resume_checkpoint takes an adapter file
or the save dir holding one.

Run:  python -m motionstyle_torch.cli.finetune_style_diffusion \\
        --dataset stylexia_posrot --save_dir ./save/ft --data_dir .../style_xia \\
        --mdm_path prior.pt --fused 1 --fused_train 1 [--lora_rank 8] [--skip_render] \\
        [--train_platform_type NoPlatform] [--native_loader 1 --prefetch 2] \\
        [--profile trace_dir] [--device cuda]

--train_platform_type reports the losses to TensorBoard (the default, through
tensorboardX), ClearML or nowhere (train/platforms.py); --native_loader 1
assembles the batches in C++ and --prefetch N keeps N ready in a thread
(native/loader.py); --profile DIR writes a torch.profiler trace of the step
loop (utils.profile_trace).

Scale-out (parallel/mesh.py), under torchrun, one process per rank, each on
the card LOCAL_RANK names (NCCL, or gloo where ranks share a card):
--data_parallel 1 splits the batch over the ranks (the style pair whole on
every rank), --model_parallel N splits the encoder layers over N of them
(plain layers: --fused_train is refused with it, as the JAX CLI refuses
it), --fsdp 1 shards the style encoder and its moments over 'data' (one
FSDP2 unit, the encoder stack, so the training kernels get whole weights),
--orbax_checkpoints 1 also writes dcp_{step}/ (train/checkpoints.py). Every
rank runs the whole CLI; rank 0 alone writes args.json, logs, progress.csv,
model*.pt, opt*.pt and the renders, every rank its DCP shards. Each rank
builds the same global batch from the same seeded loader and trains on its
rows of it.

    torchrun --standalone --nproc_per_node 2 -m motionstyle_torch.cli.\
        finetune_style_diffusion ... --data_parallel 1 --fused_train 1
"""
from __future__ import annotations

import json
import os
import time
from os.path import join as pjoin

import numpy as np
import torch

from motionstyle_torch.cli import model_util
from motionstyle_torch.cli.parser_util import finetune_inpainting_style_args
from motionstyle_torch.core import params as skel_params
from motionstyle_torch.core.features import recover_from_ric
from motionstyle_torch.core.skeleton import Skeleton
from motionstyle_torch.data.collate import get_dataset_loader, lengths_to_mask, require_batches
from motionstyle_torch.data.masks import BVH_JOINT_NAMES, get_inpainting_mask
from motionstyle_torch.diffusion import sampling
from motionstyle_torch.diffusion.ddpm import Inpainting, q_sample
from motionstyle_torch.eval.style_metrics import transfer_report
from motionstyle_torch.parallel import mesh as mesh_lib
from motionstyle_torch.post.footskate import remove_fs
from motionstyle_torch.post.ik import fit_joints_bvh
from motionstyle_torch.post.render import plot_3d_motion
from motionstyle_torch.train import logging as logger
from motionstyle_torch.train.finetune import FinetuneConfig, StyleFinetuneTrainer
from motionstyle_torch.train.platforms import get_platform
from motionstyle_torch.utils import profile_trace

DATASET_DEFAULTS = {
    "humanml": dict(example="M008551.npy", joints=22, max_frames=196),
    "bandai-2_posrot": dict(example="dataset-2_walk-turn-right_feminine_018.npy",
                            joints=21, max_frames=196),
    "bandai-1_posrot": dict(example="dataset-1_walk-turn-right_feminine_018.npy",
                            joints=21, max_frames=196),
    "stylexia_posrot": dict(example="350angry_jumping.npy", joints=20, max_frames=76),
}

def check_supported(args) -> None:
    """Raise NotImplementedError for what the port does not run."""
    if args.arch != "trans_enc":
        raise NotImplementedError(f"--arch {args.arch}: StyleDiffusion is trans_enc only")


def skeleton_assets(dataset: str):
    """(Skeleton, metric offsets, kinematic chains, foot joint names) of a
    dataset's skeleton (motionstyle/cli/finetune_style_diffusion.py:51-62)."""
    if dataset == "humanml":
        return (Skeleton(skel_params.smpl_raw_offsets, skel_params.t2m_kinematic_chain),
                skel_params.smpl_real_offsets, skel_params.t2m_kinematic_chain,
                ["R_Ankle", "L_Ankle", "L_Foot", "R_Foot"])
    if dataset.startswith("bandai"):
        return (Skeleton(skel_params.bandai_raw_offsets, skel_params.bandai_kinematic_chain),
                skel_params.bandai_real_offsets, skel_params.bandai_kinematic_chain,
                ["Toes_R", "Toes_L", "Foot_L", "Foot_R"])
    return (Skeleton(skel_params.xia_raw_offsets, skel_params.xia_kinematic_chain),
            skel_params.xia_real_offsets, skel_params.xia_kinematic_chain,
            ["rtoes", "ltoes", "lfoot", "rfoot"])


def style_caption(dataset: str, style_example: str):
    """Neutral-content caption + style word; parity: f_s_d.py:113-138."""
    style_example = os.path.basename(style_example) if style_example else ""
    if dataset == "humanml":
        return "a figure skips in a circle", "happily"
    if dataset.startswith("bandai"):
        if not style_example:
            return "a person walks turn right normal", "feminine"
        contents = style_example.split("_")[-3].split("-")
        style_label = style_example.split("_")[-2]
        contents[0] += "s"
        return "a person " + " ".join(contents) + " normal", style_label
    if not style_example:
        return "a person is jumping neutral", "angry"
    contents = style_example.split("_")[-1][:-4]
    style_label = style_example.split("_")[0][3:]
    return "a person is " + contents + " neutral", style_label


def edit_caption_with_style(caption: str, style_label: str, dataset: str,
                            tokens: str = None) -> str:
    """Semantic-guidance caption edit (f_s_d.py:268-286): on humanml with the
    caption's tokens, the style word spliced after each /VERB token; else
    the trailing word dropped and the style inserted before the last one."""
    if dataset == "humanml" and tokens:
        words = caption.split(" ")
        verb_idx = [i - 1 for i, tok in enumerate(tokens.split("_")) if "/VERB" in tok]
        for j, idx in enumerate(verb_idx):
            words.insert(idx + 1 + j, style_label)
        return " ".join(words)
    words = caption.split(" ")
    words.pop(-1)
    words.insert(-1, style_label)
    return " ".join(words)


class AutoStopEvaluator:
    """--auto_stop: the finetune picks its own operating point
    (motionstyle/cli/finetune_style_diffusion.py:332-423). Every `interval`
    steps a transfer onto the generated neutral content is sampled with the
    live weights (the trainer's run_model on its effective_weights: with
    LoRA the merged encoder) in eval mode and pinned noise (a
    torch.Generator seeded with seed + 0xA57 for every evaluation; the
    demo's DDIM path: skip rescaled, dump_all_xstart, pick -5, or -1 with
    fewer than 5 live steps), scored with transfer_report, and the run stops at the first step that is both
    styled (ratio < --auto_stop_ratio) and content-preserving (content >
    --auto_stop_content). Once styling begins (ratio < 0.98) without the gate
    met, evaluations densify to --auto_stop_fine steps. An evaluation draws
    from no generator of the trainer's and leaves the optimizer alone."""

    NEAR_KNEE_RATIO = 0.98

    def __init__(self, args, trainer, sched_ddim, ds, neutral, input_motions, inp_mask,
                 enc_neutral, m_length):
        self.ratio_gate = float(args.auto_stop_ratio)
        self.content_gate = float(args.auto_stop_content)
        self.coarse = int(args.auto_stop_interval or args.save_interval)
        self.fine = max(1, int(args.auto_stop_fine))
        self.interval = self.coarse
        self.trace = {}
        self.selected = None
        self.m_length = int(m_length)
        self.seed = args.seed + 0xA57  # pinned noise: the metric moves with the weights only
        self.skip = int(args.skip_steps / args.diffusion_steps * sched_ddim.num_timesteps)
        self.pick = -5 if sched_ddim.num_timesteps - self.skip >= 5 else -1
        self.trainer, self.sched, self.ds = trainer, sched_ddim, ds
        self.neutral, self.inp_mask, self.enc_neutral = neutral, inp_mask, enc_neutral
        self.content_hml = self._hml(neutral)
        self.style_hml = self._hml(input_motions)

    def _hml(self, x) -> np.ndarray:
        """(1, C, 1, T) -> the denormalised (m_length, C) clip."""
        return self.ds.inv_transform(np.asarray(torch.as_tensor(x).detach().cpu())[0, :, 0, :].T
                                     )[: self.m_length]

    def due(self, step: int) -> bool:
        return step % self.interval == 0

    def _sample(self) -> torch.Tensor:
        trainer = self.trainer
        model, was_training = trainer.model, trainer.model.training
        model.eval()
        try:
            with torch.no_grad():
                weights = trainer.effective_weights()
            gen = torch.Generator(device=self.sched.device).manual_seed(self.seed)
            xs = sampling.sample_loop(
                self.sched, lambda x, t, c: trainer.run_model(weights, x, t, c.get("enc_text")),
                {"enc_text": self.enc_neutral}, gen, shape=tuple(self.neutral.shape),
                init_image=self.neutral, method="ddim", skip_timesteps=self.skip,
                inpainting=Inpainting(self.inp_mask, self.neutral), dump_all_xstart=True)
        finally:
            model.train(was_training)
        return xs[self.pick]

    def evaluate(self, step: int):
        """Score the live weights; returns (gate_met, report)."""
        rep = transfer_report(self._hml(self._sample()), self.content_hml, self.style_hml)
        self.trace[step] = {k: float(v) for k, v in rep.items()}
        ok = (rep["style_dist_ratio"] < self.ratio_gate
              and rep["content_similarity"] > self.content_gate)
        if ok:
            self.selected = step
        elif rep["style_dist_ratio"] < self.NEAR_KNEE_RATIO:
            self.interval = self.fine  # near the knee: densify
        print(f"[auto_stop] step {step}: ratio {rep['style_dist_ratio']:.3f} content "
              f"{rep['content_similarity']:.3f}" + (" -> STOP (gate met)" if ok else ""))
        return ok, rep

    def dump(self, save_dir: str):
        with open(pjoin(save_dir, "auto_stop.json"), "w") as fw:
            json.dump({"selected_step": self.selected, "ratio_gate": self.ratio_gate,
                       "content_gate": self.content_gate, "trace": self.trace},
                      fw, indent=2, sort_keys=True)


def main(argv=None):
    args = finetune_inpainting_style_args(argv)
    check_supported(args)
    with mesh_lib.distributed(args.device):
        return run(args)


def run(args):
    defaults = DATASET_DEFAULTS[args.dataset]
    if not args.style_example:
        args.style_example = defaults["example"]
    max_frames = defaults["max_frames"]
    main_rank = mesh_lib.is_main()

    if os.path.exists(args.save_dir) and not args.overwrite and os.listdir(args.save_dir):
        raise FileExistsError(f"save_dir [{args.save_dir}] already exists.")
    mesh_lib.barrier()  # every rank has looked before rank 0 writes
    args.save_dir = pjoin(args.save_dir, os.path.basename(args.style_example)[:-4])
    os.makedirs(args.save_dir, exist_ok=True)
    model_util.warn_if_clip_fallback(args)
    # which package wrote the run: a style base without a resume_checkpoint
    # is this package's seeded init only (model_util._style_base)
    args.package = model_util.PACKAGE
    if main_rank:
        with open(pjoin(args.save_dir, "args.json"), "w") as fw:
            json.dump(vars(args), fw, indent=4, sort_keys=True)
    logger.configure(args.save_dir, format_strs=("stdout", "csv") if main_rank else ())
    platform = get_platform(args.train_platform_type if main_rank else "NoPlatform",
                            args.save_dir)
    platform.report_args(args, name="Args")

    print("creating data loader...")
    data = require_batches(get_dataset_loader(args.dataset, args.batch_size, args.num_frames,
                                              split="train", data_root=args.data_dir or None,
                                              native=bool(args.native_loader),
                                              prefetch=args.prefetch),
                           "finetune_style_diffusion")

    print("creating model and diffusion...")
    bundle, sched_ddim, sched_full = model_util.creat_ddpm_ddim_diffusion(
        args, timestep_respacing="ddim20" if args.use_ddim else "", device=args.device)
    sched = sched_ddim if args.use_ddim else sched_full
    dev, cfg, model = bundle.device, bundle.cfg, bundle.model
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731

    # ---- the one style example ----
    ds = data.dataset
    style_path = args.style_example
    if not os.path.isfile(style_path):
        style_path = pjoin(ds.opt.motion_dir, args.style_example)
    motion, m_length = ds.process_np_motion(style_path)
    input_motions = as_t(motion.T[None, :, None, :])
    caption, style_label = style_caption(args.dataset, args.style_example)
    mask = as_t(lengths_to_mask([m_length], max_frames)[:, None, None, :])
    inp_mask = as_t(get_inpainting_mask(args.inpainting_mask, tuple(input_motions.shape),
                                        dataset=args.dataset))

    # ---- neutral content from the frozen prior ----
    print(f'generating neutral content for caption "{caption}" ...')
    enc_neutral = as_t(bundle.encode_text([caption], args.dataset))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    prior_fn = lambda x, t, c: model.denoise_prior(x, t, c.get("enc_text"))  # noqa: E731
    shape = (1, cfg.njoints, cfg.nfeats, max_frames)
    t0 = time.perf_counter()
    if args.dataset == "humanml":
        # the whole chain, keeping its final sample: no early stop, no x0
        # pick (f_s_d.py:155-167)
        neutral = sampling.sample_loop(
            sched_full, prior_fn, {"enc_text": enc_neutral}, gen, shape=shape,
            init_image=input_motions, method="ddpm",
            inpainting=Inpainting(inp_mask, input_motions))
    else:
        # stop at 0.9T (the reference hardcodes 900 for T=1000, f_s_d.py:195)
        xstarts = sampling.sample_loop(
            sched_full, prior_fn, {"enc_text": enc_neutral}, gen, shape=shape,
            init_image=input_motions, method="ddpm", skip_timesteps=0,
            stop_timesteps=int(0.9 * args.diffusion_steps),
            inpainting=Inpainting(inp_mask, input_motions), dump_all_xstart=True)
        neutral = xstarts[-1]
    print(f"neutral content took {time.perf_counter() - t0:.3f} s")
    if not args.skip_render and main_rank:
        render_neutral(args, ds, neutral, input_motions, inp_mask, m_length, sched_full)

    # ---- finetune ----
    if args.semantic_guidance and args.latent_dim != 512:
        raise ValueError(
            "semantic guidance compares the 512-d CLIP text embedding against the motion "
            "encoder's latent; pass --semantic_guidance 0 for other widths")
    edited_caption = edit_caption_with_style(caption, style_label, args.dataset)
    print(f'finetuning with style caption "{edited_caption}" ...')
    text_features = as_t(bundle.encode_text([edited_caption], args.dataset))
    ft_cfg = FinetuneConfig(
        save_dir=args.save_dir, lr=args.lr, weight_decay=args.weight_decay,
        lr_anneal_steps=args.lr_anneal_steps, num_steps=args.num_steps,
        log_interval=args.log_interval, save_interval=args.save_interval,
        batch_size=args.batch_size, skip_steps=args.skip_steps,
        diffusion_steps=args.diffusion_steps, use_ddim=bool(args.use_ddim),
        semantic_guidance=bool(args.semantic_guidance), ls_weight=args.Ls,
        cond_mask_prob=args.cond_mask_prob, resume_checkpoint=args.resume_checkpoint,
        seed=args.seed, parallel_unroll=bool(args.parallel_finetune),
        lora_rank=args.lora_rank, lora_alpha=args.lora_alpha,
        orbax_checkpoints=bool(args.orbax_checkpoints))
    mesh = mesh_lib.cli_training_mesh(bool(args.data_parallel), args.model_parallel,
                                      args.batch_size, label="finetune",
                                      fused_train=cfg.fused_train, device=args.device)
    if args.fsdp and mesh is None:
        raise SystemExit("--fsdp needs a mesh: pass --data_parallel 1")
    trainer = StyleFinetuneTrainer(ft_cfg, model, sched, platform, mesh=mesh,
                                   fsdp=bool(args.fsdp))
    print("Total params: %.2fM trainable" % (sum(p.numel() for p, _ in trainer.params) / 1e6))
    trainer.install_preemption_handler()
    auto = None
    if args.auto_stop:
        auto = AutoStopEvaluator(args, trainer, sched_ddim, ds, neutral, input_motions,
                                 inp_mask, enc_neutral, m_length)

    with profile_trace(args.profile, enabled=bool(args.profile)):
        step = 0
        while step < args.num_steps and not trainer.preempted \
                and (auto is None or auto.selected is None):
            for motion_b, cond in data:
                if step >= args.num_steps or trainer.preempted \
                        or (auto is not None and auto.selected is not None):
                    break
                texts = list(cond["y"]["text"])
                if args.semantic_guidance:  # f_s_d.py:268-285; humanml splices by tokens
                    tokens = cond["y"].get("tokens", [None] * len(texts))
                    texts = [edit_caption_with_style(t, style_label, args.dataset, tokens=tk)
                             for t, tk in zip(texts, tokens)]
                batch = {
                    "x_start": motion_b.astype(np.float32),
                    "content": neutral,
                    "style_target": input_motions,
                    "mask": mask,
                    "inp_mask": inp_mask,
                    "enc_text_style": enc_neutral,
                    "enc_text_t2m": bundle.encode_text(texts, args.dataset),  # memoised
                    "inp_mask_t2m": get_inpainting_mask(args.inpainting_mask, motion_b.shape,
                                                        dataset=args.dataset).astype(np.float32),
                    "frame_mask_t2m": cond["y"]["mask"][:, 0, 0, :].astype(bool),
                    "text_features": text_features,
                }
                t0 = time.perf_counter()
                terms = trainer.run_step(batch)
                sweeps = (f", {terms['picard_sweeps']:.0f} sweeps"
                          if "picard_sweeps" in terms else "")
                if main_rank:
                    print(f"step[{step}]: loss[{terms['loss']:0.5f}] "
                          f"({time.perf_counter() - t0:.3f} s{sweeps})")
                logger.dumpkvs()
                step += 1
                if auto is not None and auto.due(step) and step < args.num_steps \
                        and not trainer.preempted:
                    auto.evaluate(step)
    trainer.finish()
    if auto is not None:
        if auto.selected is None and not trainer.preempted:
            auto.evaluate(step)  # the budget ran out: record where the run ended
        if main_rank:
            auto.dump(args.save_dir)
    trainer.merge_into_model()  # with LoRA, what follows runs the merged style
    trainer.restore_signal_handlers()
    platform.close()
    if trainer.preempted:
        print(f"[Preempted] checkpoint saved in {args.save_dir}; exiting")
        return args.save_dir

    # ---- final eval: resample the style example reconstruction ----
    style_fn = lambda x, t, c: model(x, t, c.get("enc_text"))  # noqa: E731
    sample = sampling.sample_loop(
        sched_ddim, style_fn, {"enc_text": enc_neutral}, gen, shape=tuple(neutral.shape),
        init_image=neutral, method="ddim",
        skip_timesteps=int(args.skip_steps / args.diffusion_steps * sched_ddim.num_timesteps),
        inpainting=Inpainting(inp_mask, input_motions))
    if not torch.isfinite(sample).all():
        raise RuntimeError("the final style resample is not finite")
    if not args.skip_render and main_rank:
        rec = ds.inv_transform(sample[0, :, 0, :].T.cpu().numpy())
        joints = recover_from_ric(torch.as_tensor(rec, dtype=torch.float32),
                                  defaults["joints"]).numpy()
        plot_3d_motion(pjoin(args.save_dir, "style_example_rec00.mp4"),
                       skeleton_assets(args.dataset)[2], joints[:m_length], title=" ",
                       dataset=args.dataset, fps=20, vis_mode="gt")
    print(f"[Done] checkpoints + outputs in {args.save_dir}")
    return args.save_dir


def render_neutral(args, ds, neutral, input_motions, inp_mask, m_length, sched_full):
    """The noised and the clean neutral motion as IK-fitted BVH (100 Adam
    steps each, on the run's device) and video (f_s_d.py:213-252): the
    noised one is q_sample at t = 0.701 T (0.301 T on humanml,
    f_s_d.py:169/216), with noise from a generator of
    its own so that the run's other draws do not depend on rendering; the
    clean one is foot-skate cleaned first."""
    skel, real_offsets, chains, ee_names = skeleton_assets(args.dataset)
    bones = BVH_JOINT_NAMES[args.dataset]
    joint_num = DATASET_DEFAULTS[args.dataset]["joints"]
    gen = torch.Generator(device=neutral.device).manual_seed(args.seed)
    img = torch.randn(neutral.shape, generator=gen, device=neutral.device)
    frac = 0.301 if args.dataset == "humanml" else 0.701
    t_vis = torch.full((neutral.shape[0],), int(frac * args.diffusion_steps),
                       dtype=torch.long, device=neutral.device)
    noised = q_sample(sched_full, neutral, t_vis, img,
                      inpainting=Inpainting(inp_mask, input_motions))
    for tag, arr in (("generated_noised_neutral_motion", noised),
                     ("generated_neutral_motion", neutral)):
        denorm = ds.inv_transform(arr[0, :, 0, :].T.cpu().numpy())  # (T, D)
        ref = recover_from_ric(torch.as_tensor(denorm, dtype=torch.float32),
                               joint_num).numpy()[:m_length]
        if tag == "generated_neutral_motion":
            ref, _, _, _ = remove_fs(ref, ref, bones, ee_names, force_on_floor=False,
                                     interp_length=3, use_vel3=True, vel3_thr=0.03,
                                     after_butterworth=True)
        fit_joints_bvh(pjoin(args.save_dir, tag + ".bvh"), denorm[:m_length], skel,
                       real_offsets, ref, names=bones, iter_num=100, device=neutral.device)
        plot_3d_motion(pjoin(args.save_dir, tag + "00.mp4"), chains, ref,
                       title=tag.replace("_", " "), dataset=args.dataset, fps=20, vis_mode="gt")


if __name__ == "__main__":
    main()
