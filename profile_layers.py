#!/usr/bin/env python3
"""Device time of each launch inside the port's layer and attention kernels,
on one NVIDIA GPU, at the shapes their main paths use (d=512, 4 heads, ff
1024): the training layer at B=64 and B=1, S=77, with dropout masks at rate
0.1 (and at B=64 in prng mode, the dropout regenerated inside the kernels
from per-clip seeds, where the checkout has it), beside
nn.TransformerEncoderLayer's train forward at B=64; the inference layer at
B=8, S=77 and at the DDPM chain's B=64, S=197 (its attention launch apart),
beside nn.TransformerEncoderLayer (eval) and scaled_dot_product_attention;
the int8 serving layer (kernel 2) at B=8, S=77 (serving), B=1, S=77
(serving bucket 1) and B=64, S=197 (the DDPM chain's shape);
the standalone attention (kernel 4) at B=8, S=77 fp32 and bf16 and at B=2,
S=600 fp32, beside scaled_dot_product_attention with the same mask; and the
seconds per step of the 1000-step DDPM chain's last 50 steps through the
inference layer (a seeded full-width prior, B=64, T=196, the fused update);
and the prior pretraining CLI's seconds per step at batch 64, full width
(the root's own chip_smoke.pretrain_phase: --fused_train 1, then
--fused_train_prng 1, then with --grad_accum 2), on a synthetic corpus; the
humanml pretraining's (S=197) and the Xia finetune's seconds per step,
recompute and store (training_steps). The attention-half backward (kernels
7 and 9) is also timed at the humanml trainers' B=64, S=197.

    python3 profile_layers.py [ROOT ...]
    python3 profile_layers.py --steps N ROOT_A ROOT_B   # training steps only

Each ROOT is a checkout of the repository (default: the directory of this
script); the kernels are built from its sources and timed with CUDA events
(a call's milliseconds) and torch.profiler (its device time split by
launch). Give two checkouts, e.g. a `git archive` of the parent commit
unpacked into a git-ignored directory and this one, to compare them on the
same card in one run; they are measured in turns (A, B, B, A), each in its
own process. With --steps N only the end-to-end part runs (the Xia pretrain
phase and training_steps), in N pairs of turns (A B, B A, A B, ...), for
host-clock step times whose spread needs more than two turns a root. Prints
the card's name and power limit first.

Every run also prints a digest of what it returned (SHA-256 of each
tensor's bytes, in order), so two roots show which kernels give the same
bits: the backward halves (kernels 6, 7, 9) take their inputs from the
plain twins, the same in every root, so an unchanged kernel digests alike;
each backward half is also held to its twin on the same inputs (the worst
rel L2 of dx or da1 and the gradient leaves), which is what a redesign that
changes their order of sums is compared by.
In prng mode at B=64 the FFN-half backward (kernel 6) also runs on the
root's own forward's a1 and is held to its twin there (rel L2 of da1 and of
the worst gradient leaf), which shows that the forward and the backward
still draw one dropout mask.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile
import time
from functools import partial

HERE = os.path.dirname(os.path.abspath(__file__))
DDPM_SHAPE, DDPM_STEPS = (64, 181, 1, 196), 50


def ddpm_seconds_per_step(dev) -> float:
    """Host seconds per step of the DDPM chain's last DDPM_STEPS steps
    through the fused bf16 denoiser (seeded weights), the second of two runs."""
    import numpy as np
    import torch

    from motionstyle_torch.data.masks import get_inpainting_mask
    from motionstyle_torch.diffusion import sampling
    from motionstyle_torch.diffusion.ddpm import Inpainting
    from motionstyle_torch.diffusion.schedule import make_schedule
    from motionstyle_torch.models.denoiser import MDM, MDMConfig

    torch.manual_seed(0)
    model = MDM(MDMConfig(njoints=181, nfeats=1, fused=True, dtype="bfloat16")).to(dev).eval()
    rs = np.random.RandomState(6)
    content = torch.from_numpy((rs.randn(*DDPM_SHAPE) * 0.5).astype(np.float32)).to(dev)
    mask = torch.as_tensor(np.asarray(get_inpainting_mask(
        "root_horizontal", DDPM_SHAPE, dataset="stylexia_posrot"), np.float32)).to(dev)
    cond = {"enc_text": torch.from_numpy(rs.randn(DDPM_SHAPE[0], 512).astype(np.float32)).to(dev)}
    sched = make_schedule("cosine", 1000, device=dev)

    def chain():
        return sampling.sample_loop(
            sched, lambda x, t, c: model(x, t, c["enc_text"]), cond,
            torch.Generator(device=dev).manual_seed(0), shape=DDPM_SHAPE, init_image=content,
            method="ddpm", skip_timesteps=1000 - DDPM_STEPS, inpainting=Inpainting(mask, content),
            fused_update=True)

    with torch.no_grad():
        chain()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = chain()
        torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / DDPM_STEPS
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("the DDPM chain gave non-finite values")
    return secs


def digest(out) -> str:
    """SHA-256 (16 hex digits) of the bytes of every tensor in `out` (a
    tensor, or tuples, lists and dicts of them, dicts in key order)."""
    import torch

    h = hashlib.sha256()

    def walk(o):
        if isinstance(o, torch.Tensor):
            h.update(o.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
        elif isinstance(o, dict):
            for k in sorted(o):
                walk(o[k])
        elif isinstance(o, (tuple, list)):
            for v in o:
                walk(v)

    walk(out)
    return h.hexdigest()[:16]


def profile(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as Fn
    from torch.profiler import ProfilerActivity, profile as torch_profile

    import chip_smoke as cs
    from motionstyle_torch.ops import attention as at
    from motionstyle_torch.ops import fused_encoder_train as ft
    from motionstyle_torch.ops.fused_encoder import (
        additive_key_mask, fused_encoder_layer, fused_encoder_layer_int8, quantize_layer_params)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    p = cs.random_layer(gen, 512, 1024, dev)
    runs, twins = {}, {}
    for b in (64, 1):
        x = torch.randn(b, 77, 512, generator=gen).to(dev, torch.bfloat16)
        dh2 = torch.randn(b, 77, 512, generator=gen).to(dev, torch.bfloat16)
        masks = ft.make_dropout_masks(torch.Generator(device=dev).manual_seed(b),
                                      (b, 77, 512), 0.1, 1024)
        # the backward halves' inputs from the twins: the same in every root
        _, a1, attn = ft.fused_layer_train_forward_reference(x, p, 4, None, masks)
        da1, _ = ft.bwd_ffn_reference(dh2, a1, p, masks)
        runs[f"B={b} forward"] = (
            lambda x=x, m=masks: ft.fused_layer_train_forward(x, p, 4, None, m))
        runs[f"B={b} bwd_ffn"] = (
            lambda d=dh2, a=a1, m=masks: ft.fused_layer_train_bwd_ffn(d, a, p, m))
        twins[f"B={b} bwd_ffn"] = lambda d=dh2, a=a1, m=masks: ft.bwd_ffn_reference(d, a, p, m)
        runs[f"B={b} bwd_attn"] = (
            lambda d=da1, x=x, a=attn, m=masks: ft.fused_layer_train_bwd_attn(d, x, a, p, 4,
                                                                           None, m))
        twins[f"B={b} bwd_attn"] = (
            lambda d=da1, x=x, a=attn, m=masks: ft.bwd_attn_reference(d, x, a, p, 4, None, m))
        if hasattr(ft, "fused_layer_train_bwd_attn_stored"):
            _, _, _, probs, qkv = ft.fused_layer_train_forward_store_reference(x, p, 4, None,
                                                                               masks)
            runs[f"B={b} forward_store"] = (
                lambda x=x, m=masks: ft.fused_layer_train_forward_store(x, p, 4, None, m))
            runs[f"B={b} bwd_attn_stored"] = (
                lambda d=da1, x=x, a=attn, pr=probs, q=qkv, m=masks:
                ft.fused_layer_train_bwd_attn_stored(d, x, a, pr, q, p, 4, m))
            twins[f"B={b} bwd_attn_stored"] = (
                lambda d=da1, x=x, a=attn, pr=probs, q=qkv, m=masks:
                ft.bwd_attn_stored_reference(d, x, a, pr, q, p, 4, m))
        if b == 64 and hasattr(ft, "draw_dropout_seeds"):
            drop = dict(seeds=ft.draw_dropout_seeds(torch.Generator(device=dev).manual_seed(b),
                                                    1, b)[0], rate=0.1)
            runs[f"B={b} forward prng"] = (
                lambda x=x: ft.fused_layer_train_forward(x, p, 4, None, **drop))
            runs[f"B={b} bwd_ffn prng"] = (
                lambda d=dh2, a=a1: ft.fused_layer_train_bwd_ffn(d, a, p, **drop))
            runs[f"B={b} bwd_attn prng"] = (
                lambda d=da1, x=x, a=attn: ft.fused_layer_train_bwd_attn(d, x, a, p, 4, None,
                                                                         **drop))
            # kernel 6 on this root's own prng forward's a1, against its twin
            a1_own = ft.fused_layer_train_forward(x, p, 4, None, **drop)[1]
            got, got_g = ft.fused_layer_train_bwd_ffn(dh2, a1_own, p, **drop)
            want, want_g = ft.bwd_ffn_reference(dh2, a1_own, p, **drop)
            torch.cuda.synchronize()
            leaf = max(cs.rel_l2(got_g[k], want_g[k]) for k in want_g)
            print(f"  B={b} bwd_ffn prng on the forward's own a1 vs its twin: da1 rel_l2 "
                  f"{cs.rel_l2(got, want):.6g}, worst gradient leaf rel_l2 {leaf:.6g}",
                  flush=True)
        if b == 64:
            # kernels 7 and 9 at the humanml trainers' S=197, from the twins
            # (their own generator: the other runs' inputs stay as they were)
            gen197 = torch.Generator().manual_seed(197)
            x197, dh197 = (torch.randn(b, 197, 512, generator=gen197).to(dev, torch.bfloat16)
                           for _ in range(2))
            m197 = ft.make_dropout_masks(torch.Generator(device=dev).manual_seed(197),
                                         (b, 197, 512), 0.1, 1024)
            _, a197, attn197, probs197, qkv197 = ft.fused_layer_train_forward_store_reference(
                x197, p, 4, None, m197)
            da197, _ = ft.bwd_ffn_reference(dh197, a197, p, m197)
            runs["B=64 S=197 bwd_attn"] = (
                lambda: ft.fused_layer_train_bwd_attn(da197, x197, attn197, p, 4, None, m197))
            twins["B=64 S=197 bwd_attn"] = (
                lambda: ft.bwd_attn_reference(da197, x197, attn197, p, 4, None, m197))
            runs["B=64 S=197 bwd_attn_stored"] = (
                lambda: ft.fused_layer_train_bwd_attn_stored(da197, x197, attn197, probs197,
                                                             qkv197, p, 4, m197))
            twins["B=64 S=197 bwd_attn_stored"] = (
                lambda: ft.bwd_attn_stored_reference(da197, x197, attn197, probs197, qkv197, p,
                                                     4, m197))
            train_lib = torch.nn.TransformerEncoderLayer(
                512, 4, 1024, dropout=0.1, activation=partial(Fn.gelu, approximate="tanh"),
                batch_first=True).to(dev, torch.bfloat16).train()
            runs["B=64 library nn.TransformerEncoderLayer forward (train, dropout 0.1)"] = (
                lambda x=x: train_lib(x))
    eval_lib = torch.nn.TransformerEncoderLayer(
        512, 4, 1024, dropout=0.0, activation=partial(Fn.gelu, approximate="tanh"),
        batch_first=True).to(dev, torch.bfloat16).eval()
    for b, s in ((8, 77), (64, 197)):
        xi = torch.randn(b, s, 512, generator=gen).to(dev, torch.bfloat16)
        runs[f"B={b} S={s} inference layer"] = lambda xi=xi: fused_encoder_layer(xi, p, 4)
        runs[f"B={b} S={s} library nn.TransformerEncoderLayer (eval)"] = (
            lambda xi=xi: eval_lib(xi))
    qkv = torch.randn(64, 197, 3 * 512, generator=gen).to(dev, torch.bfloat16)
    heads = [t.reshape(64, 197, 4, 128).transpose(1, 2) for t in qkv.split(512, -1)]
    runs["B=64 S=197 library scaled_dot_product_attention (bf16, no mask)"] = (
        lambda: Fn.scaled_dot_product_attention(*heads))
    for b, s, dtype in ((8, 77, torch.float32), (8, 77, torch.bfloat16), (2, 600, torch.float32)):
        qkv = torch.randn(b, s, 3 * 512, generator=gen).to(dev, dtype)
        q, k, v = qkv.split(512, -1)
        kpm = torch.ones(b, s, dtype=torch.bool)
        kpm[-1, s // 2:] = False
        mask = additive_key_mask(kpm, b, s, dev)
        hd = [t.reshape(b, s, 4, 128).transpose(1, 2) for t in (q, k, v)]
        name = f"B={b} S={s} {str(dtype)[6:]}"
        runs[f"{name} attention kernel"] = (
            lambda q=q, k=k, v=v, m=mask: at.attention_kernel(q, k, v, 4, m))
        runs[f"{name} library scaled_dot_product_attention"] = (
            lambda hd=hd, m=mask, dt=dtype: Fn.scaled_dot_product_attention(
                *hd, attn_mask=m[:, None, None, :].to(dt)))

    # kernel 2 from its own generator, so the other runs' inputs (and digests)
    # stay those of checkouts that did not time it
    gen8 = torch.Generator().manual_seed(2)
    p8 = quantize_layer_params({k: v.to(dev) for k, v in cs.random_params(gen8, 512, 1024).items()})
    for b, s in ((8, 77), (1, 77), (64, 197)):
        x8 = torch.randn(b, s, 512, generator=gen8).to(dev, torch.bfloat16)
        runs[f"B={b} S={s} int8 layer"] = lambda x8=x8: fused_encoder_layer_int8(x8, p8, 4)

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    with torch.no_grad():
        for name, fn in runs.items():
            ms = cs.time_ms(fn, iters=50)
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
            total = sum(device_us(e) for e in events) / 20
            out = fn()
            vs_twin = ""
            if name in twins:  # (dx or da1, grads by name) against the twin's
                want = twins[name]()
                rel = max([cs.rel_l2(out[0], want[0])]
                          + [cs.rel_l2(out[1][k], want[1][k]) for k in want[1]])
                vs_twin = f"; vs twin: worst rel_l2 {rel:.6g}"
            print(f"  {name}: {ms:.4f} ms per call (events); device {total:.1f} us; "
                  f"digest {digest(out)}{vs_twin}", flush=True)
            for e in sorted(events, key=lambda e: -device_us(e)):
                print(f"      {device_us(e) / 20:8.1f} us  {e.key[:100]}", flush=True)
    print(f"  DDPM chain B={DDPM_SHAPE[0]} T={DDPM_SHAPE[3]}, last {DDPM_STEPS} steps, fused "
          f"update: {ddpm_seconds_per_step(dev):.6f} s per step (host clock)", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "style_xia")
        cs.write_xia_corpus(data_dir)
        _, prior = cs.pretrain_phase(card, data_dir, tmp)
        training_steps(cs, card, data_dir, prior, tmp)


def training_steps(cs, card: str, xia_dir: str, prior: str, tmp: str) -> None:
    """Seconds per step (the median after the first, from progress.csv) of
    the humanml prior pretraining (--dataset humanml, 196 frames: S=197,
    --fused_train 1, on a synthetic HumanML3D-layout corpus) and of the Xia
    finetune from `prior` with --fused_train 1 (kernels 5, 6, 7) and then
    --fused_train_store 1 (kernels 8, 6, 9): batch 64, full width, the
    root's own CLIs."""
    import csv
    import random

    import numpy as np

    from motionstyle_torch.cli.finetune_style_diffusion import main as finetune_main
    from motionstyle_torch.cli.pretrain_prior import main as pretrain_main
    from motionstyle_torch.eval.quality_protocol import make_corpus

    def step_seconds(save_dir: str) -> list:
        with open(os.path.join(save_dir, "progress.csv")) as f:
            return [float(r["step_seconds"]) for r in csv.DictReader(f)]

    common = ["--batch_size", "64", "--layers", "8", "--seed", "10", "--device", "cuda"]
    hml = os.path.join(tmp, "humanml")
    make_corpus(hml, clips_per_pair=cs.HML_CLIPS_PER_PAIR, seed=10, dataset="humanml")
    save = os.path.join(tmp, "hml_prior")
    random.seed(10)
    pretrain_main(["--dataset", "humanml", "--data_dir", hml, "--save_dir", save,
                   "--num_steps", "8", "--num_frames", "196", "--log_interval", "1",
                   "--fused_train", "1", *common])
    secs = step_seconds(save)
    print(f"  humanml pretrain --fused_train 1 (B=64, S=197): step seconds {secs}; median "
          f"after the first {float(np.median(secs[1:])):.6g} s on {card}", flush=True)
    for flag in ("--fused_train", "--fused_train_store"):
        random.seed(10)
        save = finetune_main(["--dataset", "stylexia_posrot", "--data_dir", xia_dir,
                              "--mdm_path", prior, "--save_dir",
                              os.path.join(tmp, "ft" + flag.replace("-", "_")), "--fused", "1",
                              flag, "1", "--num_steps", "8", "--skip_render",
                              "--train_platform_type", "NoPlatform", *common])
        secs = step_seconds(save)
        print(f"  Xia finetune {flag} 1 (B=64, S=77): step seconds {secs}; median after the "
              f"first {float(np.median(secs[1:])):.6g} s on {card}", flush=True)


def steps_only(root: str) -> None:
    """The end-to-end part alone: the Xia pretrain phase's seconds per step
    (chip_smoke.pretrain_phase), then training_steps from its prior."""
    sys.path.insert(0, root)
    import subprocess as sp

    import chip_smoke as cs

    card = sp.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                  capture_output=True, text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "style_xia")
        cs.write_xia_corpus(data_dir)
        _, prior = cs.pretrain_phase(card, data_dir, tmp)
        training_steps(cs, card, data_dir, prior, tmp)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] in ("--child", "--child_steps"):
        (profile if sys.argv[1] == "--child" else steps_only)(sys.argv[2])
        return 0
    args = sys.argv[1:]
    pairs = 0
    if args[:1] == ["--steps"]:  # --steps N: only the training steps, N turn pairs
        pairs, args = int(args[1]), args[2:]
    roots = [os.path.abspath(r) for r in args] or [HERE]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    build = ("import sys; from concurrent.futures import ThreadPoolExecutor as Pool; "
             "sys.path.insert(0, sys.argv[1]); from motionstyle_torch import _build; "
             "names = ('fused_encoder', 'fused_encoder_train', 'fused_encoder_int8', 'attention', "
             "'sampler_update'); "
             "list(Pool(len(names)).map(_build.build, names))")
    procs = [subprocess.Popen([sys.executable, "-c", build, r]) for r in roots]
    if any(p.wait() != 0 for p in procs):
        return 1
    order = roots if len(roots) == 1 else roots + roots[::-1]
    child = "--child"
    if pairs:
        order, child = [], "--child_steps"
        for i in range(pairs):
            order += roots if i % 2 == 0 else roots[::-1]
    for r in order:
        print(f"=== {os.path.relpath(r)}", flush=True)
        if subprocess.run([sys.executable, __file__, child, r]).returncode != 0:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
