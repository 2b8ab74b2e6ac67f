"""The style-transfer quality protocol through the port's own CLIs (zero
external assets): the counterpart of tools/quality_protocol.py, which stays
the JAX package's runner (QUALITY.md, tests/test_quality.py).

  1. a procedural two-style corpus in the StyleXia layout (181-dim hml_vec,
     NNN{style}_{content}.npy), written by this module's own copy of the JAX
     tool's generator: the same files for the same seed in one process
     (_content_proto and _style_dir seed from Python's hash() of a tuple of
     strings, as the JAX tool does, so across processes only under one
     PYTHONHASHSEED);
  2. a prior pretrained by cli/pretrain_prior.py (mdm.pt, model_pretrained.pt)
     and, for the semantic arm, a discriminator trained by
     cli/train_semantic_discriminator.py;
  3. a few-shot finetune on one style clip by cli/finetune_style_diffusion.py
     (--mdm_path + --resume_checkpoint warm start), and optionally a second
     one with --auto_stop 1;
  4. transfers onto a held-out content clip by cli/demo_style_transfer.py,
     from the warm start, from every saved checkpoint (the ladder), from
     the auto arm's selected checkpoint and at each --strengths value (on
     humanml the demo generates its content from the prior, and the
     pre-finetune transfer is the content anchor);
  5. each scored with eval/style_metrics.transfer_report.

evaluate_mixing (--mixing) finetunes two styles from one warm start and
scores --style_mix blends against both examples; evaluate_longform restyles
a long procedural clip through --long_frames and scores it window by
window and at the seams. The corpus generator writes every family the JAX
tool writes: stylexia_posrot, bandai-2_posrot and humanml (the
Text2MotionDatasetV2 layout, with texts/ and the split files).

Run:  python -m motionstyle_torch.eval.quality_protocol [--quick] [--semantic]
        [--auto_stop] [--mixing] [--strengths 0,0.5,1] [--dataset humanml]
        [--fused_train 1] [--fused 1] [--device cuda] [--work DIR]

On the card the CLIs run the CUDA kernels their flags ask for (--fused_train:
the prior's, the discriminator's and the finetune's training forwards and
backwards; --fused: the demos' and --auto_stop's inference forwards).
chip_smoke.py's quality phase runs tests/test_quality.py's protocol and its
assertions through this module.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from os.path import join as pjoin

import numpy as np

T_FRAMES = 76
DIM = 181
POSE_START = 4

# Dataset-family profiles: both style families share the root4-first hml_vec
# structure (data/masks.py layouts); they differ in channel count, window
# length and the filename scheme the dataset parses style/content from
# (data/datasets.py StyleMotionDataset.__init__).
PROFILES = {
    "stylexia_posrot": dict(
        dim=181, frames=76,
        fname=lambda idx, style, content: f"{idx:03d}{style}_{content}.npy"),
    "bandai-2_posrot": dict(
        dim=190, frames=196,
        fname=lambda idx, style, content: f"dataset-2_{content}_{style}_{idx:03d}.npy"),
    # humanml: the Text2MotionDatasetV2 corpus format (texts/{name}.txt with
    # caption#tokens#f_tag#to_tag lines + {split}.txt); the captions carry the
    # style/content identity instead of the filename
    "humanml": dict(
        dim=263, frames=196, writer="t2m",
        fname=lambda idx, style, content: f"{content}_{style}_{idx:06d}.npy"),
}

CONTENTS = {
    # freq = base cycles per clip; vz = forward speed; bounce = root-height
    # oscillation (jumping); rooty = rest height
    "walking": dict(freq=2.0, vz=0.04, bounce=0.0, rooty=0.80),
    "jumping": dict(freq=1.0, vz=0.01, bounce=0.15, rooty=0.85),
}
STYLES = {
    # amp = amplitude of the high-frequency style component; freq_s = its
    # cycles per clip (well above the content base band)
    "neutral": dict(amp=0.02, freq_s=16.0),
    "angry": dict(amp=0.45, freq_s=16.0),
}


def make_rich_specs(n_styles: int, n_contents: int, seed: int = 0):
    """Procedural style/content spec dicts for caption-rich corpora.

    The 2x2 corpus above gives only 4 distinct captions, which puts
    R-precision at chance structurally (every 32-candidate pool holds
    duplicates of the true caption). n_styles x n_contents combos give that
    many distinct captions, making R-precision a meaningful instrument on a
    fully synthetic corpus (BASELINE.md r3). Styles differ in amplitude,
    frequency and direction of the high-frequency pose component; contents
    differ in gait frequency, speed, bounce and base pose band."""
    r = np.random.RandomState(seed + 777)
    styles = {
        f"s{i:02d}": dict(amp=float(r.uniform(0.15, 0.55)),
                          freq_s=float(r.choice([12.0, 14.0, 16.0, 18.0, 20.0])))
        for i in range(n_styles)
    }
    contents = {
        f"c{i:02d}": dict(freq=float(r.uniform(1.0, 3.5)),
                          vz=float(r.uniform(0.01, 0.05)),
                          bounce=float(r.choice([0.0, 0.10, 0.18])),
                          rooty=float(r.uniform(0.75, 0.9)))
        for i in range(n_contents)
    }
    return styles, contents


def _content_proto(name: str, dim: int = DIM):
    r = np.random.RandomState(abs(hash(("content", name))) % (2 ** 31))
    base = r.randn(dim - POSE_START) * 0.4
    amp = r.uniform(0.08, 0.35, dim - POSE_START)
    phase = r.uniform(0, 2 * np.pi, dim - POSE_START)
    harm = r.randint(1, 3, dim - POSE_START).astype(np.float64)
    return base, amp, phase, harm


def _style_dir(name: str, dim: int = DIM):
    r = np.random.RandomState(abs(hash(("style", name))) % (2 ** 31))
    d = r.randn(dim - POSE_START)
    return d / np.linalg.norm(d) * np.sqrt(dim - POSE_START)


def make_clip(style: str, content: str, seed: int,
              styles: dict = None, contents: dict = None,
              n_frames: int = T_FRAMES, dim: int = DIM) -> np.ndarray:
    """One procedural clip (T, dim) in the denormalized posrot layout
    (root4 + pose channels — shared by the StyleXia and Bandai families).
    n_frames > T_FRAMES extends the cycle pattern (the long-form content)."""
    c = (contents or CONTENTS)[content]
    s = (styles or STYLES)[style]
    base, amp, phase, harm = _content_proto(content, dim)
    sdir = _style_dir(style, dim)
    r = np.random.RandomState(seed)
    t = np.arange(n_frames) / T_FRAMES
    clip_phase = r.uniform(0, 2 * np.pi)

    out = np.zeros((n_frames, dim), dtype=np.float32)
    # root channels: yaw vel / xz vel / height (recover_root_rot_pos
    # integrates 0:3 by cumsum — keep magnitudes moderate)
    out[:, 0] = 0.002 * np.sin(2 * np.pi * c["freq"] * t + clip_phase)
    out[:, 1] = 0.003 * np.sin(2 * np.pi * 0.5 * t + clip_phase)
    out[:, 2] = c["vz"] * (1.0 + 0.2 * np.sin(2 * np.pi * c["freq"] * t + clip_phase))
    out[:, 3] = c["rooty"] + c["bounce"] * np.abs(np.sin(np.pi * c["freq"] * t + clip_phase))

    # pose channels: content base band + style high-frequency component
    tt = t[:, None]
    pose = base[None] + amp[None] * np.sin(
        2 * np.pi * c["freq"] * harm[None] * tt + phase[None] + clip_phase)
    pose = pose + s["amp"] * sdir[None] * np.sin(
        2 * np.pi * s["freq_s"] * tt + clip_phase)
    pose = pose + 0.02 * r.randn(n_frames, dim - POSE_START)
    out[:, POSE_START:] = pose
    return out



def make_corpus(root: str, clips_per_pair: int = 8, seed: int = 0,
                styles: dict = None, contents: dict = None,
                dataset: str = "stylexia_posrot") -> list:
    """Write the corpus + Mean/Std npy files; returns the filenames."""
    profile = PROFILES[dataset]
    vec_dir = pjoin(root, "new_joint_vecs")
    os.makedirs(vec_dir, exist_ok=True)
    names, all_clips = [], []
    idx = 600  # 3-digit ids outside the stylexia test split
    for style in (styles or STYLES):
        for content in (contents or CONTENTS):
            for k in range(clips_per_pair):
                clip = make_clip(style, content, seed=seed * 10007 + idx,
                                 styles=styles, contents=contents,
                                 n_frames=profile["frames"],
                                 dim=profile["dim"])
                name = profile["fname"](idx, style, content)
                np.save(pjoin(vec_dir, name), clip)
                names.append(name)
                all_clips.append(clip)
                idx += 1
    stacked = np.concatenate(all_clips, axis=0)
    np.save(pjoin(root, "Mean.npy"), stacked.mean(axis=0).astype(np.float32))
    np.save(pjoin(root, "Std.npy"),
            np.maximum(stacked.std(axis=0), 1e-3).astype(np.float32))
    if profile.get("writer") == "t2m":
        # the Text2MotionDatasetV2 scan: texts/{name}.txt + {split}.txt; the
        # caption carries the (content, style) identity
        os.makedirs(pjoin(root, "texts"), exist_ok=True)
        stems = []
        for name in names:
            stem = name[:-4]
            content, style = stem.split("_")[0], stem.split("_")[1]
            cap = f"a person is {content} {style}"
            toks = "_".join(f"{w}/OTHER" for w in cap.split())
            with open(pjoin(root, "texts", f"{stem}.txt"), "w") as f:
                f.write(f"{cap}#{toks}#0.0#0.0\n")
            stems.append(stem)
        for split in ("train", "test"):
            with open(pjoin(root, f"{split}.txt"), "w") as f:
                f.write("\n".join(stems) + "\n")
    return names


def _flag(on) -> str:
    return "1" if on else "0"


def prepare_assets(work: str, *, prior_steps: int = 500, batch_size: int = 16,
                   diffusion_steps: int = 100, latent_dim: int = 64,
                   layers: int = 2, seed: int = 10,
                   semantic_steps: int = 0, styles: dict = None,
                   dataset: str = "stylexia_posrot",
                   fused_train: bool = False, fused: bool = False,
                   device: str = "cuda") -> dict:
    """Stages 1 and 2: the corpus and a pretrained prior (reusable across
    finetune runs). semantic_steps > 0 also trains the semantic
    discriminator against the fresh prior, so the finetune can run with
    --semantic_guidance 1 (which needs latent_dim 512: the CLIP-cosine term
    compares the 512-d text embedding with mu). fused_train goes to the
    pretrain, the discriminator and the finetunes, fused to the finetunes
    (neutral generation, --auto_stop's samples) and the demos."""
    from motionstyle_torch.cli.pretrain_prior import main as pretrain_main

    if os.path.exists(work):
        shutil.rmtree(work)
    data_root = pjoin(work, "data")
    make_corpus(data_root, seed=seed, styles=styles, dataset=dataset)
    prior_dir = pjoin(work, "prior")
    common = ["--dataset", dataset, "--data_dir", data_root, "--batch_size", str(batch_size),
              "--layers", str(layers), "--latent_dim", str(latent_dim),
              "--diffusion_steps", str(diffusion_steps), "--seed", str(seed),
              "--fused_train", _flag(fused_train), "--device", device]
    pretrain_main(["--save_dir", prior_dir, "--num_steps", str(prior_steps),
                   "--log_interval", "100"] + common)
    assets = dict(work=work, data_root=data_root, dataset=dataset,
                  fused_train=fused_train, fused=fused, device=device,
                  mdm_path=pjoin(prior_dir, "mdm.pt"),
                  warm_path=pjoin(prior_dir, "model_pretrained.pt"),
                  semantic_path="",
                  prior_steps=prior_steps, batch_size=batch_size,
                  diffusion_steps=diffusion_steps, latent_dim=latent_dim,
                  layers=layers, seed=seed, semantic_steps=semantic_steps)
    if semantic_steps:
        from motionstyle_torch.cli.train_semantic_discriminator import main as sem_main

        assets["semantic_path"] = sem_main(
            ["--save_dir", pjoin(work, "semantic"), "--mdm_path", assets["mdm_path"],
             "--num_steps", str(semantic_steps)] + common)
    return assets


def _checkpoints(ft_dir: str) -> list:
    return sorted(f for f in os.listdir(ft_dir) if f.startswith("model") and f[5:14].isdigit())


def evaluate_transfer(assets: dict, *, finetune_steps: int = 24,
                      lr: float = 1e-4, tag: str = "run",
                      style_example: str = "624angry_jumping.npy",
                      content_clip: str = "600neutral_walking.npy",
                      semantic_guidance: bool = False,
                      ls_weight: float = 10.0,
                      save_interval: int = 100,
                      ladder: bool = False,
                      strengths: tuple = (),
                      auto_stop: bool = False,
                      auto_stop_ratio: float = 0.90,
                      auto_stop_content: float = 0.6) -> dict:
    """Stages 3-5: finetune through the CLI, demo before and after, score.

    ladder scores every saved checkpoint (save_interval sets how many) past
    step 1, the result's "ladder" {step: report}. auto_stop adds a separate
    finetune with --auto_stop 1 from the same warm start, its auto_stop.json
    under "auto" and, when it selected a step, a demo-path check of the
    selected checkpoint onto the held-out content ("demo_report").
    semantic_guidance needs assets prepared with semantic_steps > 0 at
    latent_dim 512. strengths runs the demo of the final checkpoint at each
    --style_strength, the result's "strength_sweep" {strength: report}. Each
    result's "seconds" holds the wall time of every stage."""
    from motionstyle_torch.cli.demo_style_transfer import main as demo_main
    from motionstyle_torch.cli.finetune_style_diffusion import main as ft_main
    from motionstyle_torch.eval.style_metrics import transfer_report

    work, data_root = assets["work"], assets["data_root"]
    diffusion_steps, seed, device = assets["diffusion_steps"], assets["seed"], assets["device"]
    skip = int(0.7 * diffusion_steps)
    seconds = {}
    sem_args = []
    if semantic_guidance:
        assert assets.get("semantic_path"), "prepare_assets(semantic_steps=...) first"
        sem_args = ["--semantic_discriminator_path", assets["semantic_path"],
                    "--Ls", str(ls_weight)]

    def finetune(save_dir: str, extra=()) -> str:
        t0 = time.perf_counter()
        out = ft_main([
            "--dataset", assets["dataset"], "--data_dir", data_root,
            "--save_dir", save_dir, "--style_example", style_example,
            "--mdm_path", assets["mdm_path"], "--resume_checkpoint", assets["warm_path"],
            "--num_steps", str(finetune_steps), "--lr", str(lr),
            "--batch_size", str(assets["batch_size"]), "--save_interval", str(save_interval),
            "--overwrite", "--train_platform_type", "NoPlatform", "--skip_render",
            "--layers", str(assets["layers"]), "--latent_dim", str(assets["latent_dim"]),
            "--diffusion_steps", str(diffusion_steps), "--skip_steps", str(skip),
            "--semantic_guidance", _flag(semantic_guidance),
            "--fused_train", _flag(assets["fused_train"]), "--fused", _flag(assets["fused"]),
            "--seed", str(seed), "--device", device,
        ] + sem_args + list(extra))
        seconds[os.path.basename(save_dir)] = time.perf_counter() - t0
        return out

    base_demo_args = []
    if assets["dataset"] == "humanml":
        # the humanml demo generates its content from the frozen prior; pass
        # a corpus caption (the filename-parse branch is xia/bandai only)
        stem = content_clip[:-4]
        base_demo_args = ["--input_text",
                          f"a person is {stem.split('_')[0]} {stem.split('_')[1]}"]

    def demo(model_path: str, out: str, extra=()) -> str:
        t0 = time.perf_counter()
        out_dir = demo_main([
            "--model_path", model_path, "--input_content", content_clip,
            "--style_example", style_example, "--data_dir", data_root,
            "--output_dir", pjoin(work, out), "--skip_render", "--seed", str(seed),
            "--fused", _flag(assets["fused"]), "--device", device]
            + base_demo_args + list(extra))
        seconds[out] = time.perf_counter() - t0
        return out_dir

    def load_hml(out_dir: str) -> np.ndarray:
        d = np.load(pjoin(out_dir, "results.npy"), allow_pickle=True).item()
        return d["hml"][0][: int(d["lengths"][0])]

    ft_dir = finetune(pjoin(work, f"ft_{tag}"))
    ckpts = _checkpoints(ft_dir)
    final_ckpt = pjoin(ft_dir, ckpts[-1])

    # the pre-finetune baseline: the same pipeline from the warm-start encoder
    pre_dir = pjoin(work, f"pre_{tag}", style_example[:-4])
    if not os.path.exists(pre_dir):
        os.makedirs(pre_dir)
        shutil.copy(pjoin(ft_dir, "args.json"), pjoin(pre_dir, "args.json"))
        shutil.copy(assets["warm_path"], pjoin(pre_dir, "model000000000.pt"))
    style_ex = np.load(pjoin(data_root, "new_joint_vecs", style_example))
    out_pre = demo(pjoin(pre_dir, "model000000000.pt"), f"demo_pre_{tag}")
    if assets["dataset"] == "humanml":
        # the content is generated from the frozen prior inside the demo; with
        # one seed the pre- and post-finetune runs transfer the same content,
        # so the pre output is the content anchor
        content = load_hml(out_pre)
    else:
        content = np.load(pjoin(data_root, "new_joint_vecs", content_clip))

    def score(model_path: str, out: str, extra=()) -> dict:
        return transfer_report(load_hml(demo(model_path, out, extra)), content, style_ex)

    rep_pre = transfer_report(load_hml(out_pre), content, style_ex)
    rep_post = score(final_ckpt, f"demo_post_{tag}")
    ladder_reports = {}
    if ladder:
        for name in ckpts:
            step = int(name[5:14])
            if name == os.path.basename(final_ckpt) or step <= 1:
                continue  # the step-1 checkpoint is close to the pre baseline
            ladder_reports[step] = score(pjoin(ft_dir, name), f"demo_{tag}_s{step}")
        ladder_reports[int(os.path.basename(final_ckpt)[5:14])] = rep_post
    auto_report = {}
    if auto_stop:
        ft_auto = finetune(pjoin(work, f"ftauto_{tag}"), [
            "--auto_stop", "1", "--auto_stop_ratio", str(auto_stop_ratio),
            "--auto_stop_content", str(auto_stop_content)])
        with open(pjoin(ft_auto, "auto_stop.json")) as fr:
            auto_report = json.load(fr)
        if auto_report.get("selected_step") is not None:
            # the selected checkpoint through the demo path, onto the held-out
            # content (the in-train evaluation transfers onto the neutral one)
            auto_report["demo_report"] = score(pjoin(ft_auto, _checkpoints(ft_auto)[-1]),
                                               f"demo_auto_{tag}")
    strength_reports = {}
    for a in strengths:
        if a == 1.0:
            strength_reports[a] = rep_post  # strength 1 is the finetuned model
            continue
        strength_reports[a] = score(final_ckpt, f"demo_{tag}_a{a}",
                                    ["--style_strength", str(a)])
    return {
        "pre": rep_pre, "post": rep_post, "ladder": ladder_reports, "auto": auto_report,
        "strength_sweep": strength_reports, "seconds": seconds,
        "config": dict(prior_steps=assets["prior_steps"], finetune_steps=finetune_steps,
                       lr=lr, diffusion_steps=diffusion_steps,
                       latent_dim=assets["latent_dim"], layers=assets["layers"], seed=seed,
                       semantic_guidance=semantic_guidance, style_example=style_example,
                       content_clip=content_clip, fused_train=assets["fused_train"],
                       fused=assets["fused"]),
    }


MIX_STYLES = dict(STYLES, proud=dict(amp=0.45, freq_s=16.0))


def evaluate_mixing(work: str, *, prior_steps: int = 1500, finetune_steps: int = 200,
                    lr: float = 1e-3, seed: int = 10,
                    weights=((1.0, 0.0), (0.5, 0.5), (0.0, 1.0)),
                    fused_train: bool = False, fused: bool = False, device: str = "cuda",
                    **asset_kw) -> dict:
    """Style mixing (--style_mix): finetune two styles from one warm start,
    blend their task vectors at several weights and score each blend's
    style distance to both style examples (tools/quality_protocol.py:433).
    A working mix interpolates: pure A is close to A and far from B, pure B
    the reverse, 50/50 between. The content is a held-out neutral walking
    clip throughout."""
    from motionstyle_torch.cli.demo_style_transfer import main as demo_main
    from motionstyle_torch.cli.finetune_style_diffusion import main as ft_main
    from motionstyle_torch.eval.style_metrics import transfer_report

    assets = prepare_assets(work, prior_steps=prior_steps, seed=seed, styles=MIX_STYLES,
                            fused_train=fused_train, fused=fused, device=device, **asset_kw)
    data_root = assets["data_root"]
    skip = int(0.7 * assets["diffusion_steps"])
    examples = {"angry": "624angry_jumping.npy", "proud": "640proud_jumping.npy"}
    ckpts = {}
    for style, example in examples.items():
        ft_dir = ft_main([
            "--dataset", "stylexia_posrot", "--data_dir", data_root,
            "--save_dir", pjoin(work, f"ft_{style}"), "--style_example", example,
            "--mdm_path", assets["mdm_path"], "--resume_checkpoint", assets["warm_path"],
            "--num_steps", str(finetune_steps), "--lr", str(lr),
            "--batch_size", str(assets["batch_size"]),
            "--overwrite", "--train_platform_type", "NoPlatform", "--skip_render",
            "--layers", str(assets["layers"]), "--latent_dim", str(assets["latent_dim"]),
            "--diffusion_steps", str(assets["diffusion_steps"]), "--skip_steps", str(skip),
            "--semantic_guidance", "0", "--seed", str(seed),
            "--fused_train", _flag(fused_train), "--fused", _flag(fused), "--device", device,
        ])
        ckpts[style] = pjoin(ft_dir, _checkpoints(ft_dir)[-1])

    content_clip = "600neutral_walking.npy"
    content = np.load(pjoin(data_root, "new_joint_vecs", content_clip))
    ex_clips = {s: np.load(pjoin(data_root, "new_joint_vecs", f)) for s, f in examples.items()}
    out = {}
    for wa, wb in weights:
        out_dir = demo_main([
            "--model_path", ckpts["angry"], "--input_content", content_clip,
            "--style_example", examples["angry"], "--data_dir", data_root,
            "--output_dir", pjoin(work, f"demo_mix_{wa}_{wb}"), "--skip_render",
            "--seed", str(seed), "--style_mix", f"{ckpts['angry']}:{wa},{ckpts['proud']}:{wb}",
            "--fused", _flag(fused), "--device", device,
        ])
        d = np.load(pjoin(out_dir, "results.npy"), allow_pickle=True).item()
        hml = d["hml"][0][: int(d["lengths"][0])]
        out[(wa, wb)] = {s: transfer_report(hml, content, ex_clips[s])["style_dist_to_example"]
                         for s in examples}
        out[(wa, wb)]["root_err"] = transfer_report(
            hml, content, ex_clips["angry"])["root_horizontal_max_abs_err"]
    return {"weights": out, "ckpts": ckpts,
            "config": dict(prior_steps=prior_steps, finetune_steps=finetune_steps, lr=lr,
                           seed=seed)}


def evaluate_longform(work: str, ft_dir: str, *, n_frames: int = 274, seed: int = 10,
                      fused: bool = False, device: str = "cuda") -> dict:
    """Long-form transfer quality (--long_frames; tools/quality_protocol.py
    :499): a long procedural neutral-walking content (the same generator,
    more cycles) restyled through the demo CLI's windowed path, scored (a)
    over its whole length, (b) window by window (stylisation must not decay
    across windows) and (c) at the decoded root's seams (no teleports at a
    window boundary)."""
    from motionstyle_torch.cli.demo_style_transfer import main as demo_main
    from motionstyle_torch.core.features import recover_root_rot_pos
    from motionstyle_torch.diffusion.longform import plan_windows
    from motionstyle_torch.eval.style_metrics import transfer_report

    import torch

    data_root = pjoin(work, "data")
    long_name = f"699neutral_walking_long{n_frames}.npy"
    clip = make_clip("neutral", "walking", seed=seed * 10007 + 699, n_frames=n_frames)
    np.save(pjoin(data_root, "new_joint_vecs", long_name), clip)
    out_dir = demo_main([
        "--model_path", pjoin(ft_dir, _checkpoints(ft_dir)[-1]),
        "--input_content", long_name, "--style_example", "624angry_jumping.npy",
        "--data_dir", data_root, "--output_dir", pjoin(work, "demo_longform"),
        "--skip_render", "--seed", str(seed), "--long_frames", str(n_frames),
        "--fused", _flag(fused), "--device", device,
    ])
    d = np.load(pjoin(out_dir, "results.npy"), allow_pickle=True).item()
    hml = d["hml"][0][:n_frames]
    style_ex = np.load(pjoin(data_root, "new_joint_vecs", "624angry_jumping.npy"))
    overall = transfer_report(hml, clip, style_ex)

    window, overlap = T_FRAMES, 10
    n_windows, stride = plan_windows(n_frames, window, overlap)
    per_window = []
    for k in range(n_windows):
        seg = slice(k * stride, min(k * stride + window, n_frames))
        per_window.append(round(float(transfer_report(
            hml[seg], clip[seg], style_ex)["style_dist_to_example"]), 4))

    _, pos = recover_root_rot_pos(torch.as_tensor(hml, dtype=torch.float32))
    step = np.linalg.norm(np.diff(pos.numpy(), axis=0), axis=-1)
    # one seam per consecutive pair of windows, centred in each overlap; the
    # interior excludes the seams' neighbourhoods, so a teleport shows
    seams = [window - overlap // 2 + k * stride for k in range(n_windows - 1)]
    seams = [s for s in seams if s - 5 < len(step)]
    seam_mask = np.zeros(len(step), dtype=bool)
    for s in seams:
        seam_mask[max(0, s - 5):s + 5] = True
    seam_steps = [float(step[max(0, s - 5):s + 5].max()) for s in seams]
    return {"overall": overall, "per_window_style_dist": per_window,
            "seam_max_step": round(max(seam_steps), 5) if seam_steps else 0.0,
            "interior_max_step": round(float(step[~seam_mask].max()), 5),
            "n_frames": n_frames}


def run_protocol(work: str, *, prior_steps: int = 1500, finetune_steps: int = 200,
                 lr: float = 1e-3, diffusion_steps: int = 100,
                 batch_size: int = 16, latent_dim: int = 64, layers: int = 2,
                 seed: int = 10, save_interval: int = 100, ladder: bool = False,
                 style_example: str = "624angry_jumping.npy",
                 content_clip: str = "600neutral_walking.npy",
                 strengths: tuple = (),
                 dataset: str = "stylexia_posrot",
                 fused_train: bool = False, fused: bool = False,
                 auto_stop: bool = False, device: str = "cuda") -> dict:
    """The whole protocol at tests/test_quality.py's defaults; on bandai and
    humanml the default clips are renamed to the family's scheme, as the JAX
    tool does."""
    if dataset != "stylexia_posrot" and style_example == "624angry_jumping.npy":
        fname = PROFILES[dataset]["fname"]
        style_example = fname(624, "angry", "jumping")
        content_clip = fname(600, "neutral", "walking")
    assets = prepare_assets(work, prior_steps=prior_steps, batch_size=batch_size,
                            diffusion_steps=diffusion_steps, latent_dim=latent_dim,
                            layers=layers, seed=seed, dataset=dataset,
                            fused_train=fused_train, fused=fused, device=device)
    return evaluate_transfer(assets, finetune_steps=finetune_steps, lr=lr,
                             save_interval=save_interval, ladder=ladder,
                             style_example=style_example, content_clip=content_clip,
                             strengths=strengths, auto_stop=auto_stop)


# tests/test_quality.py's assertions on a run_protocol(ladder=True,
# auto_stop=True) result, by name
GATE = {
    "root": "root_horizontal error < 1e-4 at pre and at every rung",
    "min_ladder": "the smallest ladder ratio < 0.90",
    "selected": "the auto arm selects a step with ratio < 0.95 and content > 0.6",
    "demo_or_rung": "the selected checkpoint's demo (or a ladder rung) has ratio < 0.98 and "
                    "content > 0.55",
    "pre": "pre has content > 0.8 and ratio > 0.92",
}


def quality_gate(res: dict) -> dict:
    """Each of GATE's clauses on the result: {name: met}."""
    pre, ladder, auto = res["pre"], res["ladder"], res["auto"]
    styled = lambda r, ratio, content: (r["style_dist_ratio"] < ratio  # noqa: E731
                                        and r["content_similarity"] > content)
    sel = auto.get("selected_step")
    demo = auto.get("demo_report")
    return {
        "root": all(r["root_horizontal_max_abs_err"] < 1e-4 for r in [pre, *ladder.values()]),
        "min_ladder": min(r["style_dist_ratio"] for r in ladder.values()) < 0.90,
        "selected": sel is not None and styled(auto["trace"][str(sel)], 0.95, 0.6),
        "demo_or_rung": demo is not None and (styled(demo, 0.98, 0.55) or any(
            styled(r, 0.98, 0.55) for r in ladder.values())),
        "pre": pre["content_similarity"] > 0.8 and pre["style_dist_ratio"] > 0.92,
    }


def format_markdown(result: dict) -> str:
    """The pre/post table, then one row per ladder rung, then the config."""
    pre, post, cfg = result["pre"], result["post"], result["config"]
    rows = [
        ("style distance to example (lower = more styled)",
         pre["style_dist_to_example"], post["style_dist_to_example"]),
        ("style-distance ratio vs content (<1 = moved toward style)",
         pre["style_dist_ratio"], post["style_dist_ratio"]),
        ("content similarity (low-pass corr, higher = preserved)",
         pre["content_similarity"], post["content_similarity"]),
        ("root_horizontal max |err| (must be ~0)",
         pre["root_horizontal_max_abs_err"], post["root_horizontal_max_abs_err"]),
    ]
    lines = ["| metric | pre-finetune | post-finetune |", "|---|---|---|"]
    for name, a, b in rows:
        lines.append(f"| {name} | {a:.4f} | {b:.4f} |")
    if result.get("ladder"):
        lines += ["", "| step | ratio | content | root err |", "|---|---|---|---|"]
        for step in sorted(result["ladder"], key=int):
            r = result["ladder"][step]
            lines.append(f"| {step} | {r['style_dist_ratio']:.4f} | "
                         f"{r['content_similarity']:.4f} | "
                         f"{r['root_horizontal_max_abs_err']:.2e} |")
    lines.append("")
    lines.append(f"config: {json.dumps(cfg)}")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--work", default="",
                   help="the working directory, removed and rewritten (default: a new "
                        "temporary directory)")
    p.add_argument("--quick", action="store_true",
                   help="small budgets (a smoke of the pipeline, weaker separation)")
    p.add_argument("--prior_steps", default=0, type=int)
    p.add_argument("--finetune_steps", default=0, type=int)
    p.add_argument("--lr", default=0.0, type=float)
    p.add_argument("--seed", default=10, type=int)
    p.add_argument("--dataset", default="stylexia_posrot", choices=sorted(PROFILES))
    p.add_argument("--strengths", default="", type=str,
                   help="comma-separated style_strength values to sweep on the final "
                        "checkpoint (e.g. '0,0.25,0.5,1,1.5')")
    p.add_argument("--auto_stop", action="store_true",
                   help="also run the --auto_stop finetune arm and report its selected step")
    p.add_argument("--mixing", action="store_true",
                   help="style mixing: two finetunes from one warm start, blended at "
                        "several --style_mix weights")
    p.add_argument("--semantic", action="store_true",
                   help="the full reference loss at latent 512: train the semantic "
                        "discriminator, then finetune with --semantic_guidance 1")
    p.add_argument("--fused_train", default=0, type=int,
                   help="the CUDA training kernels in every training forward and backward")
    p.add_argument("--fused", default=0, type=int,
                   help="the CUDA inference kernel in the demos and --auto_stop's samples")
    p.add_argument("--device", default="cuda", type=str)
    args = p.parse_args(argv)
    if not args.work:
        args.work = tempfile.mkdtemp(prefix="quality_protocol_")
        print(f"working directory: {args.work}")
    strengths = tuple(float(s) for s in args.strengths.split(",") if s)
    kw = dict(prior_steps=200, finetune_steps=8) if args.quick else {}
    if args.prior_steps:
        kw["prior_steps"] = args.prior_steps
    if args.finetune_steps:
        kw["finetune_steps"] = args.finetune_steps
    if args.lr:
        kw["lr"] = args.lr
    flags = dict(fused_train=bool(args.fused_train), fused=bool(args.fused),
                 device=args.device)
    if args.mixing:
        result = evaluate_mixing(args.work, seed=args.seed,
                                 prior_steps=kw.get("prior_steps", 1500),
                                 finetune_steps=kw.get("finetune_steps", 200),
                                 lr=kw.get("lr", 1e-3), **flags)
        print("style mixing (wa, wb) -> dist to angry / dist to proud / root err:")
        for (wa, wb), r in result["weights"].items():
            print(f"  ({wa}, {wb}): {r['angry']:.4f} / {r['proud']:.4f} / "
                  f"{r['root_err']:.2e}")
        return result
    if args.semantic:
        assets = prepare_assets(args.work, prior_steps=kw.get("prior_steps", 1500),
                                latent_dim=512, layers=2, seed=args.seed,
                                semantic_steps=600, **flags)
        result = evaluate_transfer(assets, finetune_steps=kw.get("finetune_steps", 200),
                                   lr=kw.get("lr", 1e-3), semantic_guidance=True,
                                   strengths=strengths)
    else:
        result = run_protocol(args.work, seed=args.seed, strengths=strengths,
                              dataset=args.dataset, auto_stop=args.auto_stop, **flags, **kw)
    print(format_markdown(result))
    if result.get("auto"):
        a = result["auto"]
        print(f"\nauto_stop: selected step {a.get('selected_step')} "
              f"(gates ratio<{a['ratio_gate']} content>{a['content_gate']})")
        for s in sorted(a["trace"], key=int):
            r = a["trace"][s]
            print(f"  step {s}: ratio {r['style_dist_ratio']:.3f} "
                  f"content {r['content_similarity']:.3f}")
        if a.get("demo_report"):
            r = a["demo_report"]
            print(f"  demo check @selected: ratio {r['style_dist_ratio']:.3f} "
                  f"content {r['content_similarity']:.3f} "
                  f"root_err {r['root_horizontal_max_abs_err']:.2e}")
    if result.get("strength_sweep"):
        print("\nstrength sweep (style_strength -> style_dist / content_sim / root_err):")
        for a in sorted(result["strength_sweep"]):
            r = result["strength_sweep"][a]
            print(f"  a={a}: {r['style_dist_to_example']:.4f} / "
                  f"{r['content_similarity']:.4f} / {r['root_horizontal_max_abs_err']:.2e}")
    print("stage seconds: " + json.dumps(result["seconds"]))
    return result


if __name__ == "__main__":
    main()
