#!/usr/bin/env python3
"""Device time of each launch inside the port's layer kernels, on one NVIDIA
GPU, at the finetune's and the serving's shapes (d=512, 4 heads, ff 1024,
S=77; training at B=64 and B=1 with dropout masks at rate 0.1, and at B=64
in prng mode, the dropout regenerated inside the kernels from per-clip seeds,
where the checkout has it; inference at B=8).

    python3 profile_layers.py [ROOT ...]

Each ROOT is a checkout of the repository (default: the directory of this
script); the kernels are built from its sources and timed with CUDA events
(a call's milliseconds) and torch.profiler (its device time split by
launch). Give two checkouts, e.g. a `git archive` of the parent commit
unpacked into a git-ignored directory and this one, to compare them on the
same card in one run; they are measured in turns (A, B, B, A), each in its
own process. Prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def profile(root: str) -> None:
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    import chip_smoke as cs
    from motionstyle_torch.ops import fused_encoder_train as ft
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    p = cs.random_layer(gen, 512, 1024, dev)
    runs = {}
    for b in (64, 1):
        x = torch.randn(b, 77, 512, generator=gen).to(dev, torch.bfloat16)
        dh2 = torch.randn(b, 77, 512, generator=gen).to(dev, torch.bfloat16)
        masks = ft.make_dropout_masks(torch.Generator(device=dev).manual_seed(b),
                                      (b, 77, 512), 0.1, 1024)
        _, a1, attn = ft.fused_layer_train_forward(x, p, 4, None, masks)
        da1, _ = ft.fused_layer_train_bwd_ffn(dh2, a1, p, masks)
        runs[f"B={b} forward"] = (
            lambda x=x, m=masks: ft.fused_layer_train_forward(x, p, 4, None, m))
        runs[f"B={b} bwd_ffn"] = (
            lambda d=dh2, a=a1, m=masks: ft.fused_layer_train_bwd_ffn(d, a, p, m))
        runs[f"B={b} bwd_attn"] = (
            lambda d=da1, x=x, a=attn, m=masks: ft.fused_layer_train_bwd_attn(d, x, a, p, 4,
                                                                           None, m))
        if hasattr(ft, "fused_layer_train_bwd_attn_stored"):
            _, _, _, probs, qkv = ft.fused_layer_train_forward_store(x, p, 4, None, masks)
            runs[f"B={b} bwd_attn_stored"] = (
                lambda d=da1, x=x, a=attn, pr=probs, q=qkv, m=masks:
                ft.fused_layer_train_bwd_attn_stored(d, x, a, pr, q, p, 4, m))
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
    xi = torch.randn(8, 77, 512, generator=gen).to(dev, torch.bfloat16)
    runs["B=8 inference layer"] = lambda: fused_encoder_layer(xi, p, 4)

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
            print(f"  {name}: {ms:.4f} ms per call (events); device {total:.1f} us", flush=True)
            for e in sorted(events, key=lambda e: -device_us(e)):
                print(f"      {device_us(e) / 20:8.1f} us  {e.key[:100]}", flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        profile(sys.argv[2])
        return 0
    roots = [os.path.abspath(r) for r in sys.argv[1:]] or [HERE]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    build = ("import sys; sys.path.insert(0, sys.argv[1]); from motionstyle_torch import "
             "_build; [_build.build(n) for n in ('fused_encoder', 'fused_encoder_train')]")
    procs = [subprocess.Popen([sys.executable, "-c", build, r]) for r in roots]
    if any(p.wait() != 0 for p in procs):
        return 1
    order = roots if len(roots) == 1 else roots + roots[::-1]
    for r in order:
        print(f"=== {os.path.relpath(r)}", flush=True)
        if subprocess.run([sys.executable, __file__, "--child", r]).returncode != 0:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
