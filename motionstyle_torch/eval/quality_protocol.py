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
     from the warm start, from every saved checkpoint (the ladder) and from
     the auto arm's selected checkpoint;
  5. each scored with eval/style_metrics.transfer_report.

Run:  python -m motionstyle_torch.eval.quality_protocol [--quick] [--semantic]
        [--auto_stop] [--fused_train 1] [--fused 1] [--device cuda] [--work DIR]

On the card the CLIs run the CUDA kernels their flags ask for (--fused_train:
the prior's, the discriminator's and the finetune's training forwards and
backwards; --fused: the demos' and --auto_stop's inference forwards).
chip_smoke.py's quality phase runs tests/test_quality.py's protocol and its
assertions through this module. Not on this slice (each raises, naming its
ROADMAP item): the bandai and humanml families (item 10), the style-strength
sweep, style mixing and long-form content (item 6).
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

# Dataset-family profiles (channel count, window length, the filename scheme
# the dataset parses style/content from): stylexia only, the one dataset the
# port loads; the bandai and humanml families wait for ROADMAP §1 item 10.
PROFILES = {
    "stylexia_posrot": dict(
        dim=181, frames=76,
        fname=lambda idx, style, content: f"{idx:03d}{style}_{content}.npy"),
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
    require_ported(dataset)
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
    return names


def require_ported(dataset: str) -> None:
    if dataset not in PROFILES:
        raise NotImplementedError(
            f"dataset {dataset}: the port's protocol runs stylexia_posrot only (ROADMAP §1 "
            "item 10: the bandai and humanml loaders)")


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

    require_ported(dataset)
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
    latent_dim 512. Each result's "seconds" holds the wall time of every
    stage. strengths (the style-strength sweep) waits for ROADMAP §1 item 6."""
    from motionstyle_torch.cli.demo_style_transfer import main as demo_main
    from motionstyle_torch.cli.finetune_style_diffusion import main as ft_main
    from motionstyle_torch.eval.style_metrics import transfer_report

    if strengths:
        raise NotImplementedError("strengths: --style_strength is not ported to "
                                  "motionstyle_torch (ROADMAP §1 item 6)")
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

    def demo(model_path: str, out: str) -> str:
        t0 = time.perf_counter()
        out_dir = demo_main([
            "--model_path", model_path, "--input_content", content_clip,
            "--style_example", style_example, "--data_dir", data_root,
            "--output_dir", pjoin(work, out), "--skip_render", "--seed", str(seed),
            "--fused", _flag(assets["fused"]), "--device", device])
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
    content = np.load(pjoin(data_root, "new_joint_vecs", content_clip))
    style_ex = np.load(pjoin(data_root, "new_joint_vecs", style_example))

    def score(model_path: str, out: str) -> dict:
        return transfer_report(load_hml(demo(model_path, out)), content, style_ex)

    rep_pre = score(pjoin(pre_dir, "model000000000.pt"), f"demo_pre_{tag}")
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
    return {
        "pre": rep_pre, "post": rep_post, "ladder": ladder_reports, "auto": auto_report,
        "seconds": seconds,
        "config": dict(prior_steps=assets["prior_steps"], finetune_steps=finetune_steps,
                       lr=lr, diffusion_steps=diffusion_steps,
                       latent_dim=assets["latent_dim"], layers=assets["layers"], seed=seed,
                       semantic_guidance=semantic_guidance, style_example=style_example,
                       content_clip=content_clip, fused_train=assets["fused_train"],
                       fused=assets["fused"]),
    }


def evaluate_mixing(*_, **__):
    raise NotImplementedError("style mixing (--style_mix) is not ported to motionstyle_torch "
                              "(ROADMAP §1 item 6)")


def evaluate_longform(*_, **__):
    raise NotImplementedError("long-form content (--long_frames) is not ported to "
                              "motionstyle_torch (ROADMAP §1 item 6)")


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
    """The whole protocol at tests/test_quality.py's defaults."""
    require_ported(dataset)
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
    p.add_argument("--dataset", default="stylexia_posrot")
    p.add_argument("--strengths", default="", type=str,
                   help="not ported (ROADMAP §1 item 6)")
    p.add_argument("--auto_stop", action="store_true",
                   help="also run the --auto_stop finetune arm and report its selected step")
    p.add_argument("--mixing", action="store_true", help="not ported (ROADMAP §1 item 6)")
    p.add_argument("--semantic", action="store_true",
                   help="the full reference loss at latent 512: train the semantic "
                        "discriminator, then finetune with --semantic_guidance 1")
    p.add_argument("--fused_train", default=0, type=int,
                   help="the CUDA training kernels in every training forward and backward")
    p.add_argument("--fused", default=0, type=int,
                   help="the CUDA inference kernel in the demos and --auto_stop's samples")
    p.add_argument("--device", default="cuda", type=str)
    args = p.parse_args(argv)
    require_ported(args.dataset)
    if not args.work:
        args.work = tempfile.mkdtemp(prefix="quality_protocol_")
        print(f"working directory: {args.work}")
    if args.mixing:
        evaluate_mixing()
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
    print("stage seconds: " + json.dumps(result["seconds"]))
    return result


if __name__ == "__main__":
    main()
