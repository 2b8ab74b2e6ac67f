#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (motionstyle_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line with its seconds:
  1. device: the card's name and power limit (nvidia-smi); TF32 off.
  2. build: nvcc builds every kernel source under csrc/, one process per
     source, all started together; the registers and spills of the wgmma
     GEMM kernels (kernel 1's and the training forwards') from the build
     logs.
  3. kernel: the inference layer (kernel 1) against its plain PyTorch twin
     on the card at the serving shapes and past the old caps (S=197 and 300,
     D=128 with head width 32, D=384 with 6 heads), at the edges of its
     GEMMs' tiles and clusters (D=64, D=1024 with 8 heads, M=3), at the
     DDPM chain's B=64, S=197, at S=1, 256, 257 and 600 (the edges of its
     attention's register-resident and two-pass paths) and at head width
     48; kernel 1 timed at B=8, S=77 and B=64, S=197 (device time per
     launch; each GEMM launch's tile, grid and cluster beside its bound)
     beside nn.TransformerEncoderLayer and
     scaled_dot_product_attention; then the int8 layer (kernel 2) against
     its twin with a key padding mask at the serving shape, B=64 S=197, B=1,
     S=1 and 197, D=128, D=384, D=64 with F=64 and D=1024 with F=2048: its
     q, k, v planes bit-equal to the twin's, two calls bit-equal, its GEMM
     plan equal to the wrapper's mirror; each with its time, the twin's, a
     library reference and the card's bound, and kernel 2 timed launch by
     launch at B=8, S=77 and B=64, S=197 (tile, grid, cluster, bound; no
     WMMA GEMM or CUDA-core attention among them).
  4. attention_kernel: the standalone attention (kernel 4) against its plain
     version at B=8, S=77, D=512, 4 heads, at S=197 and 600, at D=128 and
     192 and at S=1, 33 and 513, fp32 and bf16 inputs, with a key padding
     mask (rel L2 <= 1e-5); gradients through its autograd Function
     bit-equal to the plain version's; its time, the plain version's,
     scaled_dot_product_attention's and the bound (at the fp32 or bf16 peak,
     and on the split-precision tensor-core route the kernel takes).
  5. golden: the port's fp32 MDM with the full-width reference weights of
     tests/goldens/mdm_model.npz against the reference output, plain and
     with MOTIONSTYLE_PALLAS_ATTN=1 (kernel 4, 8 launches); then at 599
     frames (S=600), B=2, where the default dispatch takes kernel 4, against
     the same weights' forward on the CPU.
  6. serve: the serving CLI's engine (--fused 1, full width: d=512, 8
     layers) behind MotionServer on localhost answers /healthz and
     /v1/sample requests; results are checked and the kernel launches
     counted.
  7. serve_int8: the same with --quant_int8 1, one wave of 4 requests;
     kernel 2 launched 16 times per batch, kernel 1 never.
  8. serve_unfused: the same with --fused 0 (the fp32 plain layers) under
     MOTIONSTYLE_PALLAS_ATTN=1, one wave: kernel 4 launched 16 times per
     batch, kernels 1 and 2 never.
  9. sampler_update: the fused DDPM update (kernel 3) against its plain
     version at B=64, C=181, T=196 with a root_horizontal mask: x0 and the
     sigma-0 sample bit-equal, sigma 1 within 2e-6, kept channels
     noise-free, the noise's moments, seed behaviour; its time, the plain
     version's, an unfused update's and the bound.
 10. ddpm_fused: the 50-step tail of the 1000-step DDPM chain (the golden
     prior through kernel 1, B=64, T=196, root_horizontal inpainting) with
     sample_loop(fused_update=True): 50 launches of kernel 3, every dumped
     x0's kept channels equal to the content; then fused and unfused
     updates in turns, seconds per step and clips/s; then the same tail
     with the prior under quant_int8 (kernel 2), seconds per step and
     clips/s.
 11. train_kernel: the five training kernels (forward, FFN-half and
     attention-half backward, store-probs forward and stored attention-half
     backward) against their twins at the finetune's shapes (B=64 and B=1,
     S=77, full width, dropout masks at rate 0.1 and 0), past the old caps
     (S=197, D=384), at the edges of the forwards' wgmma GEMM tiles and
     clusters (D=64 with one head and F=64, D=1024 with 8 heads, B=3 S=1)
     and at S=257 and 300 (the tensor-core attention's tiled route, which
     writes kernel 8's probs there); the store forward's out, a1 and attn
     bit-equal to the forward's, its probs against probs_twin; their
     times, the twins', a library layer's and the card's bounds, and
     kernels 5-9 launch by launch (device time, tile, grid, cluster, the
     weight gradients' slices, bound) at B=64 and B=1 and in prng mode at
     B=64, none of them the WMMA gemm_kernel; two calls of kernels 6, 7
     and 9 on the same inputs bit-equal, and the backward's plan on the card
     equal to the wrapper's mirror at every shape; then the same in prng mode (kernel 10: the dropout bits
     regenerated inside the kernels from per-clip seeds, also at rate 0.5),
     with determinism and seed sensitivity, rate 1e-9 against the
     deterministic layer, the keep fraction at rate 0.5, a finite difference
     through the layer with store off and on, and the prng times beside the
     masks times, in turns; prng mode is also checked at the pretrain's
     microbatch (B=32).
 12. pretrain: the prior pretraining CLI at full width (batch 64) on a
     synthetic Xia corpus written from a seed: 4 steps with --fused_train 1,
     4 with --fused_train_prng 1 (like for like: the seconds per step of the
     two dropout modes), then 4 with --fused_train_prng 1 --grad_accum 2
     --ema_rate 0.999 --schedule_sampler loss_second_moment; losses, the
     written mdm.pt, model_pretrained.pt and mdm_ema.pt, seconds per step and
     every kernel's launches, with no mask arrays drawn in the prng runs.
 13. pretrain_unfused: the same CLI with --fused_train 0, 2 steps without
     MOTIONSTYLE_PALLAS_ATTN and 2 with it =1 from the same seed: kernel 4
     launched 8 times per forward with it, never without; the first losses
     within rel 1e-4; seconds per step of both; the second step of each
     under torch.profiler, its device time (kernel 4's apart) beside its host
     clock.
 14. finetune: the finetune CLI (--fused 1, batch 64, full width, the golden
     prior, the same corpus) runs a few steps with --fused_train 1, the same
     with --parallel_finetune 1 (the Picard-parallel unroll), then
     --fused_train_store 1 with and without --parallel_finetune 1 (in
     turns: sequential, parallel, parallel, sequential); losses (the store
     run's first equal to the recompute run's), the saved checkpoint, the
     style encoder's movement, every kernel's launches (the parallel runs:
     8 x (2 + Picard sweeps) forwards a step), seconds per step, sweeps per
     step and peak memory; then 2 steps with --fused_train_prng 1 from the
     pretrain phase's mdm.pt, every training launch in prng mode; then the
     loss called directly at full width with dropout 0, parallel unroll
     against sequential (rot_mse and every style-encoder gradient leaf);
     then a short store run under torch.profiler.
 15. semantic: the semantic-discriminator CLI at full width (batch 64,
     --fused_train 1) from the pretrain phase's prior for a few steps:
     losses, seconds per step, the frozen prior and style encoder bit-equal,
     kernels 5, 6 and 7 launched 8 times a step; then 2 finetune steps with
     --semantic_guidance 1 from the new checkpoint.
 16. demo: the demo CLI on the store run's model*.pt and args.json, 8
     samples, --skip_render, with --fused 1 and with --quant_int8 1:
     results.npy, the kept root channels, the kernels' launches and the
     int8 result's deviation from the bf16 one.
 17. quality: the port's quality protocol (eval/quality_protocol.py) through
     the port's CLIs with --fused_train 1 --fused 1: tests/test_quality.py's
     protocol (latent 64, prior 1500 steps, finetune 250 with a rung every
     50, the --auto_stop arm) gated by that file's assertions, then the d512
     semantic arm (prior 1500, discriminator 600, finetune 200, a rung every
     25) gated by root error < 1e-4 and finite metrics; each arm's table and
     every stage's seconds.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before it. Without
a CUDA device, or without the rest of the repository beside it, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from functools import partial

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "mdm_model.npz")

# the serving shape: a bucket of 8 clips of 76 frames + the condition token
B, S, D, H, F = 8, 77, 512, 4, 1024
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# kernel vs twin gates (bf16 output: one bf16 ulp at |y| in [2, 4) is 1.6e-2)
LAYER_MAX_ABS, LAYER_REL_L2, STACK_REL_L2 = 3e-2, 1e-2, 2e-2
GOLDEN_ATOL = 2e-4  # tests/test_models.py:35
KERNEL_SOURCES = ("fused_encoder", "fused_encoder_train", "fused_encoder_int8", "attention",
                  "sampler_update")
TRAIN_KERNELS = {  # wrapper -> the TPU kernel it replaces
    "fused_layer_train_forward": "motionstyle/ops/fused_encoder_train.py:154",
    "fused_layer_train_bwd_ffn": "motionstyle/ops/fused_encoder_train.py:183",
    "fused_layer_train_bwd_attn": "motionstyle/ops/fused_encoder_train.py:243",
    "fused_layer_train_forward_store": "motionstyle/ops/fused_encoder_train.py:317",
    "fused_layer_train_bwd_attn_stored": "motionstyle/ops/fused_encoder_train.py:364",
}
FINETUNE_STEPS, FINETUNE_BATCH, FINETUNE_LAYERS = 3, 64, 8
# the pretrain phase's last run splits each batch of FINETUNE_BATCH clips
# into this many microbatches
PRETRAIN_ACCUM = 2
# (B, S, D, H, F) of the inference layer past the old caps: S = 197 (humanml
# and bandai clips + the condition token) and 300; head width 32 (the CLIs'
# --latent_dim 128 with 4 heads); D = 384 with 6 heads and F = 1536 (a
# LayerNorm cluster of 3 or 6); and at the edges of the GEMMs' tiles and
# clusters: D = 64 (one head, F = 64: a cluster of one, a half-empty tile),
# D = 1024 with 8 heads and F = 2048 (the largest cluster) and B=3, S=1
# (M = 3: one tile, nearly all rows TMA's zero fill)
KERNEL_EXTRA_SHAPES = ((B, 197, D, H, F), (B, 300, D, H, F), (B, S, 128, 4, F),
                       (B, S, 384, 6, 1536), (B, S, 64, 1, 64), (B, S, 1024, 8, 2048),
                       (3, 1, D, H, F))
# the inference layer at the DDPM chain's shape (bench.py's B=64, T=196: S=197),
# at the edges of its attention's two paths: S=1 and 256 (the score row in
# registers), 257 and 600 (two passes over the key tiles), and at head width
# 48, which no CLI asks for but the kernel takes (not a multiple of 32)
DDPM_LAYER = (64, 197)
KERNEL_ATTENTION_SHAPES = ((*DDPM_LAYER, D, H, F), (B, 1, D, H, F), (B, 256, D, H, F),
                           (B, 257, D, H, F), (B, 600, D, H, F), (B, S, 192, 4, F))
# the int8 layer (kernel 2) against its twin: the serving shape, the DDPM
# chain's B=64, S=197 (128-row tiles), serving bucket 1 (B=1), S=1 and 197,
# head width 32, D = 384 with 6 heads, and at the edges of its GEMMs: D = 64
# with F = 64 (K = 64 under a stage's 128 int8 values: TMA's zero fill) and
# D = 1024 with F = 2048 (a LayerNorm cluster of 8 at BN = 128); rel L2 on
# the fp32 output (the two differ by summation order, and a code flip where
# that moves a value across a rounding tie)
INT8_SHAPES = ((B, S, D, H, F), (*DDPM_LAYER, D, H, F), (1, S, D, H, F), (B, 1, D, H, F),
               (B, 197, D, H, F), (B, S, 128, 4, F), (B, S, 384, 6, 1536), (B, S, 64, 1, 64),
               (B, S, 1024, 8, 2048))
INT8_REL_L2 = 2e-3


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    yield
    print(f"[{name}] done in {time.perf_counter() - t0:.3f} s", flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")
    print(f"  ok: {what}", flush=True)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def time_ms(fn, iters: int = 100) -> float:
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def event_device_us(e) -> float:
    """A torch.profiler event's own device time, us (the attribute's name
    differs across PyTorch versions)."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_profile(fn, iters: int = 20) -> list:
    """Device time of one call of fn by kernel name, us, largest first:
    torch.profiler's CUDA time over `iters` calls. A profile that records no
    device time, or a kernel a number of times that is not a multiple of
    `iters` (a profile that lost some calls' events: it reads as a fraction
    of the time), is taken again, at most twice; empty if none records any."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    rows = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and event_device_us(e) > 0]
        rows = sorted(((e.key, event_device_us(e) / iters) for e in events), key=lambda r: -r[1])
        if rows and all(e.count % iters == 0 for e in events):
            return rows
    return rows


def device_us(fn, iters: int = 20) -> str:
    """Device time of one call of fn (every launch summed) as text, "not
    measured" when the profiler records none."""
    rows = device_profile(fn, iters)
    return f"{sum(us for _, us in rows):.4g} us" if rows else "not measured"


def layer_bound(b: int, s: int, d: int, h: int, f: int) -> tuple:
    """(bound_ms, bound_by, flops, bytes) of one layer: tensor-core operations
    at the bf16 peak against each input read once and the output written
    once, at the card's memory rate."""
    m = b * s
    flops = 2 * m * d * 3 * d + 2 * 2 * b * s * s * d + 2 * m * d * d + 2 * 2 * m * d * f
    weights = (3 * d * d + d * d + 2 * d * f) * 2
    vectors = (3 * d + d + 4 * d + f + d) * 4
    nbytes = 2 * m * d * 2 + weights + vectors
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


# kernel 1's four GEMM launches in launch order (fused_encoder_layer_plan's)
GEMM_LAUNCHES = ("qkv_gemm", "ln1_gemm", "ffn_up_gemm", "ln2_gemm")


def print_gemm_registers(lib_path: str) -> None:
    """Each wgmma GEMM kernel's registers and spills as ptxas reported them
    (-v) in the build log beside the library: kernel 1's (qkv_gemm, ...),
    kernel 2's (qkv_s8_gemm, ...), the training forwards' (qkv_train_gemm,
    ...) and backward halves' (up_bwd_gemm, ..., dw2_gemm, ...), the dropout
    site's prng mode as a third template argument."""
    import re

    with open(lib_path[:-3] + ".log") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"((?:qkv_store_train|qkv_train|ffn_up_train|ln1_train|ln2_train|up_bwd|"
                      r"ln2_bwd|du_bwd|ln1_bwd|dattn_bwd|dx_bwd|dwqkv|dwo|dw1|dw2|qkv_s8|ffn_up_s8|"
                      r"ln1_s8|ln2_s8|qkv|ffn_up|ln1|ln2)_gemm)ILi(\d+)ELi(\d+)E(?:Lb([01])E)?",
                      line)
        if m and "Compiling entry function" in line:
            after = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", after)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", after)
            prng = "" if m.group(4) is None else f", {'true' if m.group(4) == '1' else 'false'}"
            print(f"  {m.group(1)}<{m.group(2)}, {m.group(3)}{prng}>: "
                  f"{regs.group(1) if regs else '?'} registers, "
                  f"{spill.group(1) if spill else '?'} B spill stores, "
                  f"{spill.group(2) if spill else '?'} B spill loads", flush=True)


def gemm_bounds(b: int, s: int, d: int, f: int) -> list:
    """(flops, bytes) of each of kernel 1's GEMM launches, in GEMM_LAUNCHES
    order: each input read once (activations, weight, fp32 vectors), each
    output written once (q, k, v; h1 in fp32 and bf16; ff; the bf16 out)."""
    m = b * s
    return [(2 * m * d * 3 * d, m * d * 2 + 3 * d * d * 2 + 3 * d * 4 + 3 * m * d * 2),
            (2 * m * d * d, 2 * m * d * 2 + d * d * 2 + 3 * d * 4 + m * d * 4 + m * d * 2),
            (2 * m * d * f, m * d * 2 + f * d * 2 + f * 4 + m * f * 2),
            (2 * m * f * d, m * f * 2 + m * d * 4 + d * f * 2 + 3 * d * 4 + m * d * 2)]


def gemm_plan(b: int, s: int, d: int, f: int, train: bool = False, int8: bool = False) -> list:
    """The tile, grid and cluster of each GEMM launch, as the C launcher
    picks them on this card (fused_encoder_layer_plan; with train, the
    training forward's fused_layer_train_forward_plan; with int8, kernel 2's
    fused_encoder_layer_int8_plan)."""
    import ctypes

    from motionstyle_torch import _build

    lib, fn = (("fused_encoder_train", "fused_layer_train_forward_plan") if train
               else ("fused_encoder_int8", "fused_encoder_layer_int8_plan") if int8
               else ("fused_encoder", "fused_encoder_layer_plan"))
    out = (ctypes.c_int * 28)()
    rc = getattr(_build.load(lib), fn)(b, s, d, f, out)
    check(rc == 0, f"{fn} B={b} S={s} D={d} F={f} returned 0")
    keys = ("bm", "bn", "grid_x", "grid_y", "cluster", "threads", "smem")
    return [dict(zip(keys, out[7 * i:7 * i + 7])) for i in range(4)]


def print_gemm_launches(rows: list, b: int, s: int, d: int, f: int) -> None:
    """Each GEMM launch's plan and device time (torch.profiler rows of one
    layer call) beside its bound, then the four together."""
    total_us = total_bound = 0.0
    for name, plan, (flops, nbytes) in zip(GEMM_LAUNCHES, gemm_plan(b, s, d, f),
                                           gemm_bounds(b, s, d, f)):
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e6, nbytes / PEAK_BYTES * 1e6
        us = sum(u for key, u in rows if f"{name}<" in key)
        total_us, total_bound = total_us + us, total_bound + max(t_ops, t_bytes)
        print(f"  B={b} S={s} {name}: tile {plan['bm']}x{plan['bn']}, grid "
              f"{plan['grid_x']}x{plan['grid_y']}, cluster {plan['cluster']}, "
              f"{plan['threads']} threads, {plan['smem']} B shared; device "
              f"{f'{us:.6g} us' if rows else 'not measured'}, bound {max(t_ops, t_bytes):.6g} us "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}: {flops / 1e9:.4g} GFLOP, "
              f"{nbytes / 1e6:.4g} MB)", flush=True)
    print(f"  B={b} S={s} four GEMM launches: device "
          f"{f'{total_us:.6g} us' if rows else 'not measured'}, bound {total_bound:.6g} us",
          flush=True)


def random_params(gen, d: int, f: int) -> dict:
    """One encoder layer's fp32 parameters by kernel name, on the CPU."""
    import torch

    def r(*shape, std=1.0):
        return torch.randn(*shape, generator=gen) * std

    return {"in_proj_weight": r(3 * d, d, std=d ** -0.5), "in_proj_bias": r(3 * d, std=0.1),
            "out_proj_weight": r(d, d, std=d ** -0.5), "out_proj_bias": r(d, std=0.1),
            "linear1_weight": r(f, d, std=d ** -0.5), "linear1_bias": r(f, std=0.1),
            "linear2_weight": r(d, f, std=f ** -0.5), "linear2_bias": r(d, std=0.1),
            "norm1_weight": 1 + r(d, std=0.1), "norm1_bias": r(d, std=0.1),
            "norm2_weight": 1 + r(d, std=0.1), "norm2_bias": r(d, std=0.1)}


def random_layer(gen, d: int, f: int, device):
    """random_params on the card in the bf16 kernels' format."""
    from motionstyle_torch.ops.fused_encoder import pack

    return pack({k: v.to(device) for k, v in random_params(gen, d, f).items()})


def kernel_phase(device) -> dict:
    """Kernel vs twin on the card; returns the kernel's record fields."""
    import torch
    import torch.nn.functional as Fn

    from motionstyle_torch.ops.fused_encoder import (
        fused_encoder_layer, fused_encoder_layer_reference)

    gen = torch.Generator().manual_seed(0)
    p = random_layer(gen, D, F, device)
    record = {}
    for b, s, masked in ((B, S, False), (1, S, False), (2, 13, True)):
        x = torch.randn(b, s, D, generator=gen).to(device, torch.bfloat16)
        kpm = None
        if masked:
            kpm = torch.ones(b, s, dtype=torch.bool)
            kpm[1, 8:] = False
            kpm = kpm.to(device)
        got = fused_encoder_layer(x, p, H, kpm)
        torch.cuda.synchronize()
        want = fused_encoder_layer_reference(x, p, H, kpm)
        torch.cuda.synchronize()
        err, rel = float((got.float() - want.float()).abs().max()), rel_l2(got, want)
        print(f"  layer B={b} S={s} mask={masked}: max_abs {err:.6g} rel_l2 {rel:.6g}",
              flush=True)
        check(err <= LAYER_MAX_ABS and rel <= LAYER_REL_L2,
              f"layer B={b} S={s} within max_abs {LAYER_MAX_ABS} and rel_l2 {LAYER_REL_L2}")
        if (b, s) == (B, S):
            record["max_abs_err"] = err

    # past the old caps (S <= 256 and D in {128, 256, 512} with head width 64
    # or 128): longer sequences and the widths the port's CLIs can ask for.
    # An fp32 input gives the fp32 output (the kernel rounds the input to
    # bf16 itself), so the gate reads the sums before the output's rounding:
    # at these shapes |y| reaches [4, 8), where one bf16 ulp is 0.03125.
    for b, s, d, h, f in KERNEL_EXTRA_SHAPES + KERNEL_ATTENTION_SHAPES:
        pe = random_layer(gen, d, f, device)
        x = torch.randn(b, s, d, generator=gen).to(device, torch.bfloat16).float()
        kpm = torch.ones(b, s, dtype=torch.bool)
        kpm[-1, s // 2:] = False
        kpm = kpm.to(device)
        got = fused_encoder_layer(x, pe, h, kpm)
        torch.cuda.synchronize()
        want = fused_encoder_layer_reference(x, pe, h, kpm)
        err, rel = float((got.float() - want.float()).abs().max()), rel_l2(got, want)
        print(f"  layer B={b} S={s} D={d} H={h} F={f} (masked): max_abs {err:.6g} "
              f"rel_l2 {rel:.6g}", flush=True)
        check(err <= LAYER_MAX_ABS and rel <= LAYER_REL_L2,
              f"layer B={b} S={s} D={d} H={h} F={f} within max_abs {LAYER_MAX_ABS} and "
              f"rel_l2 {LAYER_REL_L2}")

    layers = [random_layer(gen, D, F, device) for _ in range(8)]
    x = torch.randn(B, S, D, generator=gen).to(device, torch.bfloat16)
    got, want = x, x
    for lp in layers:
        got = fused_encoder_layer(got, lp, H)
        want = fused_encoder_layer_reference(want, lp, H)
    torch.cuda.synchronize()
    rel = rel_l2(got, want)
    print(f"  8-layer stack B={B} S={S}: rel_l2 {rel:.6g}", flush=True)
    check(rel <= STACK_REL_L2, f"8-layer stack within rel_l2 {STACK_REL_L2}")

    x = torch.randn(B, S, D, generator=gen).to(device, torch.bfloat16)
    lib = torch.nn.TransformerEncoderLayer(
        D, H, F, dropout=0.0, activation=partial(Fn.gelu, approximate="tanh"),
        batch_first=True).to(device, torch.bfloat16).eval()
    with torch.no_grad():
        record["ms"] = time_ms(lambda: fused_encoder_layer(x, p, H))
        record["plain_ms"] = time_ms(lambda: fused_encoder_layer_reference(x, p, H))
        record["library_ms"] = time_ms(lambda: lib(x))
        rows = device_profile(lambda: fused_encoder_layer(x, p, H))
    print_gemm_launches(rows, B, S, D, F)
    bound_ms, bound_by, flops, nbytes = layer_bound(B, S, D, H, F)
    record.update(bound_ms=bound_ms, bound_by=bound_by)
    print(f"  B={B} S={S}: kernel_ms {record['ms']:.6g} reference_ms "
          f"{record['plain_ms']:.6g} library_ms {record['library_ms']:.6g} "
          f"bound_ms {bound_ms:.6g} ({bound_by}: {flops / 1e9:.4g} GFLOP, "
          f"{nbytes / 1e6:.4g} MB)", flush=True)
    ddpm_layer_timing(p, lib, gen, device)
    return record


def ddpm_layer_timing(p, lib, gen, device) -> None:
    """Kernel 1 at the DDPM chain's shape (DDPM_LAYER): CUDA events per call,
    torch.profiler's device time per launch (the attention launch apart from
    the GEMMs), the layer's bound; beside it nn.TransformerEncoderLayer (bf16,
    eval) and, as the attention launch's yardstick,
    scaled_dot_product_attention's bf16 device time on q, k, v of the same
    shape, with the attention launch's own bound."""
    import torch
    import torch.nn.functional as Fn

    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer

    b, s = DDPM_LAYER
    x = torch.randn(b, s, D, generator=gen).to(device, torch.bfloat16)
    qkv = torch.randn(b, s, 3 * D, generator=gen).to(device, torch.bfloat16)
    heads = [t.reshape(b, s, H, D // H).transpose(1, 2) for t in qkv.split(D, -1)]
    with torch.no_grad():
        ms = time_ms(lambda: fused_encoder_layer(x, p, H), iters=20)
        lib_ms = time_ms(lambda: lib(x), iters=20)
        rows = device_profile(lambda: fused_encoder_layer(x, p, H), iters=10)
        lib_us = device_us(lambda: lib(x), iters=10)
        sdpa_us = device_us(lambda: Fn.scaled_dot_product_attention(*heads), iters=10)
    bound_ms, bound_by, flops, nbytes = layer_bound(b, s, D, H, F)
    attn_flops, attn_bytes = 4 * b * s * s * D, 4 * b * s * D * 2
    attn_bound = max(attn_flops / PEAK_BF16_FLOPS, attn_bytes / PEAK_BYTES) * 1e3
    launches = "; ".join(f"{us:.6g} us {name[:70]}" for name, us in rows) or "not measured"
    print(f"  B={b} S={s}: kernel_ms {ms:.6g} (events); device time (torch.profiler) "
          f"{sum(us for _, us in rows):.6g} us per call, by launch: {launches}; bound_ms "
          f"{bound_ms:.6g} ({bound_by}: {flops / 1e9:.4g} GFLOP, {nbytes / 1e6:.4g} MB); "
          f"library nn.TransformerEncoderLayer (bf16, eval) {lib_ms:.6g} ms, device {lib_us}; "
          f"attention launch bound {attn_bound:.6g} ms (bytes: {attn_bytes / 1e6:.4g} MB of q, "
          f"k, v, out; {attn_flops / 1e9:.4g} GFLOP at the bf16 peak); "
          f"scaled_dot_product_attention (bf16, no mask) device {sdpa_us}", flush=True)
    print_gemm_launches(rows, b, s, D, F)


def int8_layer_bound(b: int, s: int, d: int, h: int, f: int, masked: bool) -> tuple:
    """(bound_ms, bound_by, int8 ops, bf16 flops, bytes) of one int8 layer:
    the four GEMMs at the int8 peak plus the attention products at the bf16
    peak, against each input read once (bf16 x, int8 weights, fp32 scales
    and vectors, the fp32 mask) and the bf16 output written once."""
    m = b * s
    ops = 2 * m * (3 * d * d + d * d + 2 * d * f)
    flops = 2 * 2 * b * s * s * d
    weights = 3 * d * d + d * d + 2 * d * f
    vectors = (3 * d + d + f + d) * 4 + (3 * d + d + 4 * d + f + d) * 4
    nbytes = 2 * m * d * 2 + weights + vectors + (b * s * 4 if masked else 0)
    t_ops = ops / PEAK_INT8_OPS + flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            ops, flops, nbytes)


# kernel 2's launches in launch order, by the names the profiler gives them;
# its two fp32 row-code launches (attn, then ff) share one name and one row
INT8_LAUNCHES = ("quant_rows_kernel<__nv_bfloat16>", "qkv_s8_gemm", "forward_tc",
                 "quant_rows_kernel<float>", "ln1_s8_gemm", "ffn_up_s8_gemm", "ln2_s8_gemm")


def int8_gemm_bounds(b: int, s: int, d: int, h: int, f: int, masked: bool = False) -> list:
    """(int8 ops, bf16 flops, bytes) of each of kernel 2's launches in
    INT8_LAUNCHES order (the row codes of attn and ff together): each input
    read once (x or the activation a launch codes; a GEMM's row codes and
    scales, int8 weight, fp32 column scales and vectors, residual; the
    mask), each output written once (row codes and scales; q, k, v in bf16;
    attn, h1 and ff in fp32 and h1's codes and scales; the bf16 out). The
    operations add up to int8_layer_bound's; the bytes count what each
    launch moves, the intermediates too."""
    m = b * s

    def codes(k):  # an (M, K) matrix's row codes and scales
        return m * k + m * 4

    return [(0, 0, m * d * 2 + codes(d)),
            (2 * m * d * 3 * d, 0, codes(d) + 3 * d * d + 2 * 3 * d * 4 + 3 * m * d * 2),
            (0, 4 * b * s * s * d, 3 * m * d * 2 + (b * s * 4 if masked else 0) + m * d * 4),
            (0, 0, m * d * 4 + codes(d) + m * f * 4 + codes(f)),
            (2 * m * d * d, 0, codes(d) + d * d + 4 * d * 4 + m * d * 2 + m * d * 4 + codes(d)),
            (2 * m * d * f, 0, codes(d) + f * d + 2 * f * 4 + m * f * 4),
            (2 * m * f * d, 0, codes(f) + d * f + 4 * d * 4 + m * d * 4 + m * d * 2)]


def int8_plan(b: int, s: int, d: int, f: int) -> list:
    """Kernel 2's GEMM plan as its C launcher picks it on this card
    (fused_encoder_layer_int8_plan), checked against the wrapper's plain
    mirror (ops.fused_encoder.int8_layer_plan)."""
    import torch

    from motionstyle_torch.ops.fused_encoder import int8_layer_plan

    plans = gemm_plan(b, s, d, f, int8=True)
    mirror = int8_layer_plan(b, s, d, f, torch.cuda.get_device_properties(0).multi_processor_count)
    same = all((c["bm"], c["bn"], c["grid_x"], c["grid_y"], c["cluster"], c["threads"], c["smem"])
               == (py["bm"], py["bn"], py["gx"], py["gy"], py["cluster"], py["threads"], py["smem"])
               for c, py in zip(plans, mirror))
    check(same, f"int8 plan B={b} S={s} D={d} F={f}: the C launcher's equals the wrapper's mirror")
    return plans


def print_int8_launches(rows: list, b: int, s: int, d: int, h: int, f: int) -> None:
    """Each launch of kernel 2 with its device time (torch.profiler rows of
    one call) beside its bound, the GEMMs with their plan, then the launches
    together; none may be the WMMA GEMM or the CUDA-core attention."""
    plan_of = dict(zip(("qkv_s8_gemm", "ln1_s8_gemm", "ffn_up_s8_gemm", "ln2_s8_gemm"),
                       int8_plan(b, s, d, f)))
    total_us = total_bound = 0.0
    for name, (ops, flops, nbytes) in zip(INT8_LAUNCHES, int8_gemm_bounds(b, s, d, h, f)):
        t_ops = (ops / PEAK_INT8_OPS + flops / PEAK_BF16_FLOPS) * 1e6
        t_bytes = nbytes / PEAK_BYTES * 1e6
        us = sum(u for k, u in rows if name in k)
        total_us, total_bound = total_us + us, total_bound + max(t_ops, t_bytes)
        plan = plan_of.get(name)
        shape = ("" if plan is None else
                 f"tile {plan['bm']}x{plan['bn']}, grid {plan['grid_x']}x{plan['grid_y']}, "
                 f"cluster {plan['cluster']}, {plan['threads']} threads, {plan['smem']} B "
                 f"shared; ")
        print(f"  int8 B={b} S={s} {name}: {shape}device "
              f"{f'{us:.6g} us' if rows else 'not measured'}, bound {max(t_ops, t_bytes):.6g} us "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}: {ops / 1e9:.4g} GOP int8, "
              f"{flops / 1e9:.4g} GFLOP bf16, {nbytes / 1e6:.4g} MB)", flush=True)
    others = [(k, u) for k, u in rows if not any(n in k for n in INT8_LAUNCHES)]
    print(f"  int8 B={b} S={s} {len(INT8_LAUNCHES)} launch names: device "
          f"{f'{total_us:.6g} us' if rows else 'not measured'}, bound {total_bound:.6g} us; "
          f"other device rows: {others or 'none'}", flush=True)
    check(bool(rows) and all(any(n in k for k, _ in rows) for n in INT8_LAUNCHES)
          and not any("gemm_kernel<" in k or "forward_kernel<" in k for k, _ in rows),
          f"int8 B={b} S={s}: the profile names every launch of the design, none the WMMA GEMM "
          f"or the CUDA-core attention")


def int8_kernel_phase(device) -> dict:
    """Kernel 2 against its twin on the card at INT8_SHAPES (a key padding
    mask on the last clip): the fp32 output within INT8_REL_L2, the q, k and
    v planes its attention read bit-equal to the twin's int8_dot and
    rounding (int8_qkv_reference), two calls bit-equal, and the C plan of its
    GEMM launches equal to the wrapper's mirror; its time, the twin's and the
    bound at the serving shape; each launch's device time beside its bound,
    tile, grid and cluster at B=8, S=77 and B=64, S=197; the four
    torch._int_mm products and scaled_dot_product_attention at the serving
    shapes as a library reference (no one library call computes the layer).
    Returns the kernel's record fields."""
    import torch
    import torch.nn.functional as Fn

    from motionstyle_torch.ops.fused_encoder import (
        fused_encoder_layer_int8, fused_encoder_layer_int8_reference, int8_qkv_reference,
        quantize_layer_params)

    gen = torch.Generator().manual_seed(2)
    record = {}
    n0 = fused_encoder_layer_int8.launches
    for b, s, d, h, f in INT8_SHAPES:
        p8 = quantize_layer_params({k: v.to(device)
                                    for k, v in random_params(gen, d, f).items()})
        # bf16 values in an fp32 tensor: the fp32 output, before a rounding
        x = torch.randn(b, s, d, generator=gen).to(device, torch.bfloat16).float()
        kpm = torch.ones(b, s, dtype=torch.bool)
        kpm[-1, s // 2:] = False
        kpm = kpm.to(device)
        got, planes = fused_encoder_layer_int8(x, p8, h, kpm, return_qkv=True)
        again = fused_encoder_layer_int8(x, p8, h, kpm)
        torch.cuda.synchronize()
        want = fused_encoder_layer_int8_reference(x, p8, h, kpm)
        want_planes = int8_qkv_reference(x, p8, h)
        err, rel = float((got - want).abs().max()), rel_l2(got, want)
        where = f"B={b} S={s} D={d} H={h} F={f} (masked)"
        print(f"  int8 layer {where}: max_abs {err:.6g} rel_l2 {rel:.6g}", flush=True)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()) and rel <= INT8_REL_L2,
              f"int8 layer {where} finite and within rel_l2 {INT8_REL_L2}")
        check(torch.equal(planes.view(torch.int16), want_planes.view(torch.int16)),
              f"int8 layer {where}: q, k, v planes bit-equal to the twin's int8_dot + rounding")
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"int8 layer {where}: two calls give the same bits")
        int8_plan(b, s, d, f)
        if (b, s, d) == (B, S, D):
            record["max_abs_err"] = err
            p_serve = p8

    x = torch.randn(B, S, D, generator=gen).to(device, torch.bfloat16)
    n1 = fused_encoder_layer_int8.launches
    fused_encoder_layer_int8(x, p_serve, H)
    per_call = fused_encoder_layer_int8.launches - n1
    x64 = torch.randn(*DDPM_LAYER, D, generator=gen).to(device, torch.bfloat16)
    with torch.no_grad():
        record["ms"] = time_ms(lambda: fused_encoder_layer_int8(x, p_serve, H))
        record["plain_ms"] = time_ms(lambda: fused_encoder_layer_int8_reference(x, p_serve, H),
                                     iters=20)
        rows = device_profile(lambda: fused_encoder_layer_int8(x, p_serve, H))
        ms64 = time_ms(lambda: fused_encoder_layer_int8(x64, p_serve, H), iters=20)
        rows64 = device_profile(lambda: fused_encoder_layer_int8(x64, p_serve, H), iters=10)
    fused_encoder_layer_int8.launches = n0  # checks and timings are not the main path's
    # the library reference: int8 x int8 -> int32 products at the layer's four
    # GEMM shapes and the bf16 attention at its shape, one call each
    m = B * S
    a8 = torch.randint(-127, 128, (m, max(D, F)), generator=gen, dtype=torch.int8).to(device)
    gemms = [(a8[:, :D].contiguous(), p_serve["in_proj_weight"].t().contiguous()),
             (a8[:, :D].contiguous(), p_serve["out_proj_weight"].t().contiguous()),
             (a8[:, :D].contiguous(), p_serve["linear1_weight"].t().contiguous()),
             (a8[:, :F].contiguous(), p_serve["linear2_weight"].t().contiguous())]
    qkv = torch.randn(3, B, H, S, D // H, generator=gen).to(device, torch.bfloat16)

    def library():
        for a, w in gemms:
            torch._int_mm(a, w)
        Fn.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])

    with torch.no_grad():
        int_mm_ms = time_ms(library)
    record["library_ms"] = None
    bound_ms, bound_by, ops, flops, nbytes = int8_layer_bound(B, S, D, H, F, masked=False)
    record.update(bound_ms=bound_ms, bound_by=bound_by, int_mm_ms=int_mm_ms)
    print(f"  int8 B={B} S={S}: kernel_ms {record['ms']:.6g} reference_ms "
          f"{record['plain_ms']:.6g} bound_ms {bound_ms:.6g} ({bound_by}: {ops / 1e9:.4g} GOP "
          f"int8, {flops / 1e9:.4g} GFLOP bf16, {nbytes / 1e6:.4g} MB); four torch._int_mm + "
          f"scaled_dot_product_attention {int_mm_ms:.6g} ms (no one library call computes "
          f"the layer); {per_call} wrapper launch per layer call (8 CUDA launches inside)",
          flush=True)
    print_int8_launches(rows, B, S, D, H, F)
    bound64, by64, ops64, flops64, nbytes64 = int8_layer_bound(*DDPM_LAYER, D, H, F, masked=False)
    print(f"  int8 B={DDPM_LAYER[0]} S={DDPM_LAYER[1]}: kernel_ms {ms64:.6g} (events); bound_ms "
          f"{bound64:.6g} ({by64}: {ops64 / 1e9:.4g} GOP int8, {flops64 / 1e9:.4g} GFLOP bf16, "
          f"{nbytes64 / 1e6:.4g} MB)", flush=True)
    print_int8_launches(rows64, *DDPM_LAYER, D, H, F)
    check(per_call == 1, "int8 layer: one counted launch per layer call")
    return record


# the finetune's shapes for the training layer: the semantic branch's
# batch of 64 and the unroll's single clip, 76 frames + the condition token
TRAIN_BATCHES, TRAIN_RATES = (64, 1), (0.1, 0.0)
# (B, S, D, H, F) of the training kernels past the old caps (S <= 128, D in
# {128, 256, 512}, head width 64 or 128); then, for the forwards' wgmma
# GEMMs, the edges of their tiles and clusters as kernel 1's: D = 64 with one
# head and F = 64 (a cluster of one, a half-empty tile), D = 1024 with 8
# heads and F = 2048 (the largest cluster), B=3, S=1 (M = 3); and S = 257
# and 300, where the tensor-core attention takes its two-pass tiled route
# and writes kernel 8's probs from there
TRAIN_EXTRA_SHAPES = ((16, 197, D, H, F), (16, S, 384, 6, 1536), (8, S, 64, 1, 64),
                      (8, S, 1024, 8, 2048), (3, 1, D, H, F), (4, 257, D, H, F),
                      (4, 300, D, H, F))
GRAD_REL_L2, GRAD_MAX_REL = 1e-2, 3e-2
TRAIN_NAMES = tuple(TRAIN_KERNELS)
# kernel 10: the dropout that kernels 5-9 generate in prng mode (no launch of
# its own; its launches are the prng-mode launches of kernels 5-9)
PRNG_NAME = "fused_layer_train_prng_dropout"
PRNG_REPLACES = "motionstyle/ops/fused_encoder_train.py:118"


def train_bounds(b: int, s: int, d: int, h: int, f: int, masked: bool) -> dict:
    """(bound_ms, bound_by, flops, bytes) of the five training kernels:
    tensor-core operations at the bf16 peak (counting what the backward
    halves recompute) against each input read once and each output written
    once at the card's memory rate."""
    m = b * s
    attn_core = 2 * b * s * s * d  # one S x S x D product over all heads
    weights_ffn, weights_attn = 2 * d * f * 2, (3 * d * d + d * d) * 2
    vec_ffn, vec_attn = (f + d + 4 * d) * 4, (3 * d + d) * 4
    mask_bytes = (m * (2 * d + f) * 2) if masked else 0
    stored_bytes = b * h * s * s * 2 + m * 3 * d * 2  # probs and qkv, bf16
    fwd_flops = 2 * m * d * 3 * d + 2 * attn_core + 2 * m * d * d + 2 * 2 * m * d * f
    fwd_bytes = (m * d * 2 + mask_bytes + weights_ffn + weights_attn + vec_ffn + vec_attn
                 + m * d * 2 + m * d * 4 + m * d * 2)
    # the attention half's inputs and outputs besides its recompute: da1, x,
    # attn, m0 in; dx and the four weight and bias gradients out
    attn_io = (m * d * 4 + m * d * 2 + m * d * 2 + (m * d * 2 if masked else 0) + weights_attn
               + m * d * 4 + (3 * d * d + d * d) * 4 + 4 * d * 4)
    work = {
        "fused_layer_train_forward": (fwd_flops, fwd_bytes),
        "fused_layer_train_bwd_ffn": (
            6 * 2 * m * d * f,
            m * d * 4 + m * d * 4 + (m * (f + d) * 2 if masked else 0) + weights_ffn + vec_ffn
            + m * d * 4 + 2 * d * f * 4 + (f + 5 * d) * 4),
        "fused_layer_train_bwd_attn": (
            2 * 2 * m * d * d + 3 * 2 * m * d * 3 * d + 5 * attn_core, attn_io + 3 * d * 4),
        "fused_layer_train_forward_store": (fwd_flops, fwd_bytes + stored_bytes),
        # no qkv GEMM and no scores: dattn, dWo, dWqkv, dx and four S x S products
        "fused_layer_train_bwd_attn_stored": (
            2 * 2 * m * d * d + 2 * 2 * m * d * 3 * d + 4 * attn_core, attn_io + stored_bytes),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
                     flops, nbytes)
    return out


# kernels 5 and 8's five launches in launch order: the qkv GEMM (kernel 8's
# stores qkv and q_s), the tensor-core attention, then the GEMMs of LN1,
# FFN-up and LN2 (fused_layer_train_forward_plan's order for the four GEMMs)
TRAIN_LAUNCHES = ("qkv_train_gemm", "forward_tc", "ln1_train_gemm", "ffn_up_train_gemm",
                  "ln2_train_gemm")


def train_gemm_bounds(b: int, s: int, d: int, h: int, f: int, masked: bool = True,
                      store: bool = False) -> list:
    """(flops, bytes) of each of kernel 5's launches (kernel 8's with store),
    in TRAIN_LAUNCHES order: each input read once (activations, weight, fp32
    vectors, the bf16 dropout mask of the launch's site in masks mode), each
    output written once (q, k, v, or kernel 8's q_s and qkv; attn, and
    kernel 8's probs; a1, h1 in fp32 and bf16; g; the bf16 out). Their
    operations are train_bounds' forward's."""
    m = b * s
    mask = 2 if masked else 0  # bytes of a mask element
    qkv_out = m * d * 2 + 3 * m * d * 2 if store else 3 * m * d * 2
    return [(2 * m * d * 3 * d, m * d * 2 + 3 * d * d * 2 + 3 * d * 4 + qkv_out),
            (2 * 2 * b * s * s * d, 3 * m * d * 2 + m * d * 2 + (b * h * s * s * 2 if store else 0)),
            (2 * m * d * d, m * d * 2 + d * d * 2 + 3 * d * 4 + m * d * 2 + m * d * mask
             + m * d * 4 + m * d * 4 + m * d * 2),
            (2 * m * d * f, m * d * 2 + f * d * 2 + f * 4 + m * f * mask + m * f * 2),
            (2 * m * f * d, m * f * 2 + d * f * 2 + 3 * d * 4 + m * d * 4 + m * d * mask
             + m * d * 2)]


def print_train_launches(name: str, rows: list, b: int, s: int, d: int, h: int, f: int,
                         masked: bool, store: bool) -> None:
    """Each launch of kernel 5 (or 8) with its device time (torch.profiler
    rows of one call) beside its bound, the GEMMs with their plan, then the
    five together."""
    plans = gemm_plan(b, s, d, f, train=True)
    plan_of = dict(zip(("qkv_train_gemm", "ln1_train_gemm", "ffn_up_train_gemm",
                        "ln2_train_gemm"), plans))
    total_us = total_bound = 0.0
    for launch, (flops, nbytes) in zip(TRAIN_LAUNCHES,
                                       train_gemm_bounds(b, s, d, h, f, masked, store)):
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e6, nbytes / PEAK_BYTES * 1e6
        key = ("qkv_store_train_gemm<" if store and launch == "qkv_train_gemm"
               else launch if launch == "forward_tc" else f"{launch}<")
        us = sum(u for k, u in rows if key in k)
        total_us, total_bound = total_us + us, total_bound + max(t_ops, t_bytes)
        plan = plan_of.get(launch)
        shape = ("" if plan is None else
                 f"tile {plan['bm']}x{plan['bn']}, grid {plan['grid_x']}x{plan['grid_y']}, "
                 f"cluster {plan['cluster']}, {plan['threads']} threads, {plan['smem']} B "
                 f"shared; ")
        print(f"  {name} B={b} S={s} {key.rstrip('<')}: {shape}device "
              f"{f'{us:.6g} us' if rows else 'not measured'}, bound {max(t_ops, t_bytes):.6g} us "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}: {flops / 1e9:.4g} GFLOP, "
              f"{nbytes / 1e6:.4g} MB)", flush=True)
    others = [(k, u) for k, u in rows
              if not any(n in k for n in TRAIN_LAUNCHES + ("qkv_store_train_gemm",))]
    print(f"  {name} B={b} S={s} five launches: device "
          f"{f'{total_us:.6g} us' if rows else 'not measured'}, bound {total_bound:.6g} us; "
          f"other device rows: {others or 'none'}", flush=True)
    check(not any("gemm_kernel<" in k or "forward_kernel<" in k for k, _ in rows),
          f"{name} B={b} S={s} launches neither the WMMA GEMM nor the CUDA-core attention")


# kernels 6, 7 and 9's launches in launch order; their GEMMs' plans come from
# fused_layer_train_backward_plan (ops.fused_encoder_train.BACKWARD_GEMMS)
TRAIN_BWD_LAUNCHES = {
    "fused_layer_train_bwd_ffn": (
        "ln_recompute_kernel", "up_bwd_gemm", "ln2_bwd_gemm", "du_bwd_gemm", "ln1_bwd_gemm",
        "dw2_gemm", "dw1_gemm", "reduce_rows_kernel"),
    "fused_layer_train_bwd_attn": (
        "dropout_bwd_kernel", "dattn_bwd_gemm", "qkv_store_train_gemm",
        "attention_bwd_rows_kernel", "attention_bwd_cols_kernel", "dwqkv_gemm", "dwo_gemm",
        "dx_bwd_gemm", "reduce_rows_kernel"),
    "fused_layer_train_bwd_attn_stored": (
        "dropout_bwd_kernel", "dattn_bwd_gemm", "attention_bwd_rows_kernel",
        "attention_bwd_cols_kernel", "dwqkv_gemm", "dwo_gemm", "dx_bwd_gemm",
        "reduce_rows_kernel"),
}


def train_bwd_gemm_bounds(b: int, s: int, d: int, h: int, f: int, masked: bool = True) -> dict:
    """(flops, bytes) of each launch of kernels 6, 7 and 9, by kernel, in
    TRAIN_BWD_LAUNCHES order: each input read once (activations, residuals,
    weight, fp32 vectors and LayerNorm statistics, the bf16 mask of the
    launch's dropout site in masks mode), each output written once (the
    launch's activations or gradients; the last pass's bias and LayerNorm
    gradients). The blocks' column sums and the weight gradients' slices are
    the design's scratch and count in neither. The operations add up to
    train_bounds' of the three kernels: the attention backward's rows launch
    counts the scores (kernel 7), dp and dq, its cols launch dk and dv (it
    forms the scores and dp again, which the bound does not count)."""
    m, mk = b * s, (2 if masked else 0)
    core = 2 * b * s * s * d  # one S x S x D product over all heads
    stats = b * h * s * 3 * 4  # the rows' (max, sum, delta)
    probs = b * h * s * s * 2
    dropout = (0, m * d * 4 + m * d * mk + m * d * 2)
    dattn = (2 * m * d * d, m * d * 2 + d * d * 2 + m * d * 2)
    wgrads = [(2 * m * 3 * d * d, 3 * m * d * 2 + m * d * 2 + 3 * d * d * 4),
              (2 * m * d * d, 2 * m * d * 2 + d * d * 4)]
    dx = (2 * m * 3 * d * d, 3 * m * d * 2 + 3 * d * d * 2 + 2 * m * d * 4)
    reduce_attn = (0, 4 * d * 4)
    return {
        "fused_layer_train_bwd_ffn": [
            (0, m * d * 4 + 2 * d * 4 + m * 2 * 4 + m * d * 2),
            (2 * m * d * f, m * d * 2 + f * d * 2 + f * 4 + m * f * mk + m * f * 2 + m * f * 4),
            (2 * m * f * d, m * f * 2 + d * f * 2 + 4 * d * 4 + m * d * 4 + m * 2 * 4
             + m * d * 4 + m * d * mk + m * d * 4 + m * d * 2),
            (2 * m * d * f, m * d * 2 + d * f * 2 + m * f * 4 + m * f * mk + m * f * 2),
            (2 * m * f * d, m * f * 2 + f * d * 2 + 2 * m * d * 4 + m * 2 * 4 + d * 4 + m * d * 4),
            (2 * m * d * f, m * d * 2 + m * f * 2 + d * f * 4),
            (2 * m * f * d, m * f * 2 + m * d * 2 + f * d * 4),
            (0, (f + 5 * d) * 4)],
        "fused_layer_train_bwd_attn": [
            dropout, dattn,
            (2 * m * d * 3 * d, m * d * 2 + 3 * d * d * 2 + 3 * d * 4 + m * d * 2 + 3 * m * d * 2),
            (3 * core, m * d * 2 + m * d * 2 + 2 * m * d * 2 + stats + m * d * 2),
            (2 * core, m * d * 2 + m * d * 2 + 2 * m * d * 2 + m * d * 2 + stats + 2 * m * d * 2),
            *wgrads, dx, reduce_attn],
        "fused_layer_train_bwd_attn_stored": [
            dropout, dattn,
            (2 * core, probs + m * d * 2 + 2 * m * d * 2 + stats + m * d * 2),
            (2 * core, probs + m * d * 2 + m * d * 2 + m * d * 2 + stats + 2 * m * d * 2),
            *wgrads, dx, reduce_attn],
    }


def train_bwd_plan(b: int, s: int, d: int, f: int) -> dict:
    """The plan of the backward's GEMM launches as the C launcher picks it
    on this card (fused_layer_train_backward_plan), by kernel name, each
    checked against the wrapper's plain mirror (ops.fused_encoder_train.
    backward_plan), which sizes the partial buffers."""
    import ctypes

    import torch

    from motionstyle_torch import _build
    from motionstyle_torch.ops import fused_encoder_train as ft

    n = len(ft.BACKWARD_GEMMS)
    out = (ctypes.c_int * (8 * n))()
    rc = _build.load("fused_encoder_train").fused_layer_train_backward_plan(b, s, d, f, out)
    check(rc == 0, f"fused_layer_train_backward_plan B={b} S={s} D={d} F={f} returned 0")
    keys = ("bm", "bn", "grid_x", "grid_y", "cluster", "threads", "smem", "split")
    plans = [dict(zip(keys, out[8 * i:8 * i + 8])) for i in range(n)]
    mirror = ft.backward_plan(b, s, d, f, torch.cuda.get_device_properties(0).multi_processor_count)
    same = all((c["bm"], c["bn"], c["grid_x"], c["grid_y"], c["cluster"], c["split"])
               == (py["bm"], py["bn"], py["gx"], py["gy"], py["cluster"], py["split"])
               for c, py in zip(plans, mirror))
    check(same, f"backward plan B={b} S={s} D={d} F={f}: the C launcher's equals the wrapper's "
                f"mirror (which sizes the partial buffers)")
    return dict(zip(ft.BACKWARD_GEMMS, plans))


def print_train_bwd_launches(name: str, rows: list, b: int, s: int, d: int, h: int, f: int,
                             masked: bool) -> None:
    """Each launch of kernel 6, 7 or 9 with its device time (torch.profiler
    rows of one call) beside its bound, the GEMMs with their plan, then the
    launches together; none may be the WMMA gemm_kernel."""
    plans = train_bwd_plan(b, s, d, f)
    total_us = total_bound = 0.0
    for launch, (flops, nbytes) in zip(TRAIN_BWD_LAUNCHES[name],
                                       train_bwd_gemm_bounds(b, s, d, h, f, masked)[name]):
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e6, nbytes / PEAK_BYTES * 1e6
        us = sum(u for k, u in rows if launch in k)
        total_us, total_bound = total_us + us, total_bound + max(t_ops, t_bytes)
        plan = plans.get(launch)
        shape = ("" if plan is None else
                 f"tile {plan['bm']}x{plan['bn']}, grid {plan['grid_x']}x{plan['grid_y']}"
                 f"x{plan['split']}, cluster {plan['cluster']}, {plan['threads']} threads, "
                 f"{plan['smem']} B shared; ")
        print(f"  {name} B={b} S={s} {launch}: {shape}device "
              f"{f'{us:.6g} us' if rows else 'not measured'}, bound {max(t_ops, t_bytes):.6g} us "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}: {flops / 1e9:.4g} GFLOP, "
              f"{nbytes / 1e6:.4g} MB)", flush=True)
    others = [(k, u) for k, u in rows if not any(n in k for n in TRAIN_BWD_LAUNCHES[name])]
    print(f"  {name} B={b} S={s} {len(TRAIN_BWD_LAUNCHES[name])} launches: device "
          f"{f'{total_us:.6g} us' if rows else 'not measured'}, bound {total_bound:.6g} us; "
          f"other device rows: {others or 'none'}", flush=True)
    check(not any("gemm_kernel<" in k for k, _ in rows),
          f"{name} B={b} S={s}: no launch is the WMMA gemm_kernel")


def probs_twin(x, p, h: int, kmask=None):
    """The bf16 probabilities (B, H, S, S) kernel 8's attention launch
    stores, as the Pallas body rounds them, written out here apart from the
    store twin: qkv from bf16 x and weights with fp32 sums; per head s =
    bf16(q / sqrt(dh)) bf16(k)^T + mask; p = exp(s - max) / sum, then bf16."""
    import math

    import torch

    b, s, d = x.shape
    bf = torch.bfloat16
    qkv = x.to(bf).float() @ p["in_proj_weight"].to(bf).float().t() + p["in_proj_bias"].float()
    q, k, _ = qkv.split(d, dim=-1)
    heads = lambda t: t.reshape(b, s, h, -1).transpose(1, 2)  # noqa: E731
    scores = (heads((q * (1.0 / math.sqrt(d // h))).to(bf).float())
              @ heads(k.to(bf).float()).transpose(-1, -2))
    if kmask is not None:
        scores = scores + kmask[:, None, None, :]
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True)).to(bf)


def _grad_gate(got, want):
    rel = rel_l2(got, want)
    mx = float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-12))
    return rel, mx, rel <= GRAD_REL_L2 and mx <= GRAD_MAX_REL


def draw_seeds(gen, b: int, device):
    """(b,) int32 per-clip seeds over the full 32-bit range, on `device`."""
    from motionstyle_torch.ops.fused_encoder_train import draw_dropout_seeds

    return draw_dropout_seeds(gen, 1, b)[0].to(device)


def check_train_kernels(p, b: int, s: int, d: int, h: int, f: int, rate: float, gen, device,
                        records: dict, prng: bool = False) -> tuple:
    """Kernels 5-9 against their twins on the same inputs at one shape, and
    kernel 8's forward bit-equal to kernel 5's: with bf16 dropout masks, or
    with prng (kernel 10 inside them) the same per-clip seeds for kernel and
    twin, where the same seeds must give the same output and other seeds
    another. Returns the inputs the timings reuse: (x, dh2, drop, a1, attn,
    da1, probs, qkv), drop being the wrappers' dropout keywords."""
    import torch

    from motionstyle_torch.ops import fused_encoder_train as ft

    where = f"{'prng' if prng else 'masks'} B={b} S={s} D={d} H={h} F={f} rate={rate}"
    x = torch.randn(b, s, d, generator=gen).to(device, torch.bfloat16)
    dh2 = torch.randn(b, s, d, generator=gen).to(device, torch.bfloat16)
    drop = {}
    if rate > 0 and prng:
        drop = dict(seeds=draw_seeds(gen, b, device), rate=rate)
    elif rate > 0:
        drop = dict(masks=ft.make_dropout_masks(
            torch.Generator(device=device).manual_seed(b), (b, s, d), rate, f))
    # the gate reads the fp32 output (the kernel's sums before the output's
    # bf16 rounding); the bf16 output is held to rel_l2
    f32 = dict(out_dtype=torch.float32)
    out32, _, _ = ft.fused_layer_train_forward(x, p, h, None, **f32, **drop)
    out, a1, attn = ft.fused_layer_train_forward(x, p, h, None, **drop)
    out32_s, _, _, _, _ = ft.fused_layer_train_forward_store(x, p, h, None, **f32, **drop)
    out_s, a1_s, attn_s, probs, qkv = ft.fused_layer_train_forward_store(x, p, h, None, **drop)
    if prng:
        again = ft.fused_layer_train_forward(x, p, h, None, **f32, **drop)[0]
        other = ft.fused_layer_train_forward(x, p, h, None, **f32, rate=rate,
                                             seeds=drop["seeds"] + 1)[0]
    torch.cuda.synchronize()
    r_out, r_a1, r_attn, _, r_qkv = ft.fused_layer_train_forward_store_reference(
        x, p, h, None, **f32, **drop)
    r_probs = probs_twin(x, p, h)
    err, rel, rel16 = float((out32 - r_out).abs().max()), rel_l2(out32, r_out), rel_l2(out, r_out)
    rel_a1 = rel_l2(a1, r_a1)
    rel_p, rel_qkv = rel_l2(probs, r_probs), rel_l2(qkv, r_qkv)
    err_p = float((probs.float() - r_probs.float()).abs().max())
    print(f"  train fwd {where}: max_abs {err:.6g} rel_l2 {rel:.6g} (bf16 output: max_abs "
          f"{float((out.float() - r_out).abs().max()):.6g} rel_l2 {rel16:.6g}) a1 rel_l2 "
          f"{rel_a1:.6g} attn rel_l2 {rel_l2(attn, r_attn):.6g}; stored probs max_abs "
          f"{err_p:.6g} rel_l2 {rel_p:.6g}, qkv rel_l2 {rel_qkv:.6g}", flush=True)
    check(err <= LAYER_MAX_ABS and max(rel, rel16, rel_a1, rel_p, rel_qkv) <= LAYER_REL_L2,
          f"train forward and store forward {where} within max_abs {LAYER_MAX_ABS} and "
          f"rel_l2 {LAYER_REL_L2}")
    same = all(torch.equal(u, v) for u, v in
               ((out32, out32_s), (out, out_s), (a1, a1_s), (attn, attn_s)))
    check(same, f"store forward's out (bf16 and fp32), a1 and attn bit-equal to the "
                f"forward's at {where}")
    if prng:
        check(torch.equal(out32, again) and not torch.equal(out32, other),
              f"{where}: the same seeds give the same output, seeds + 1 another")
    for name in ("fused_layer_train_forward", "fused_layer_train_forward_store"):
        rec = records[PRNG_NAME if prng else name]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)

    # each backward half from the same inputs as its twin, twice: the second
    # call must give the same bits (no atomics, sums in a fixed order); the
    # partial buffers sized by the plan the launcher follows
    train_bwd_plan(b, s, d, f)
    da1, g_ffn = ft.fused_layer_train_bwd_ffn(dh2, a1, p, **drop)
    again_ffn = ft.fused_layer_train_bwd_ffn(dh2, a1, p, **drop)
    torch.cuda.synchronize()
    r_da1, r_ffn = ft.bwd_ffn_reference(dh2, a1, p, **drop)
    dx, g_attn = ft.fused_layer_train_bwd_attn(r_da1, x, attn, p, h, None, **drop)
    again_attn = ft.fused_layer_train_bwd_attn(r_da1, x, attn, p, h, None, **drop)
    dx_s, g_attn_s = ft.fused_layer_train_bwd_attn_stored(r_da1, x, attn, probs, qkv, p, h,
                                                          **drop)
    again_stored = ft.fused_layer_train_bwd_attn_stored(r_da1, x, attn, probs, qkv, p, h, **drop)
    torch.cuda.synchronize()
    for kname, first, second in (("kernel 6", (da1, g_ffn), again_ffn),
                                 ("kernel 7", (dx, g_attn), again_attn),
                                 ("kernel 9", (dx_s, g_attn_s), again_stored)):
        check(torch.equal(first[0], second[0])
              and all(torch.equal(first[1][k], second[1][k]) for k in first[1]),
              f"{kname} {where}: two calls on the same inputs give the same bits")
    r_dx, r_attn_g = ft.bwd_attn_reference(r_da1, x, attn, p, h, None, **drop)
    r_dx_s, r_attn_g_s = ft.bwd_attn_stored_reference(r_da1, x, attn, probs, qkv, p, h, **drop)
    pairs = ([("fused_layer_train_bwd_ffn", "da1", da1, r_da1)]
             + [("fused_layer_train_bwd_ffn", k, g_ffn[k], r_ffn[k]) for k in r_ffn]
             + [("fused_layer_train_bwd_attn", "dx", dx, r_dx)]
             + [("fused_layer_train_bwd_attn", k, g_attn[k], r_attn_g[k]) for k in r_attn_g]
             + [("fused_layer_train_bwd_attn_stored", "dx", dx_s, r_dx_s)]
             + [("fused_layer_train_bwd_attn_stored", k, g_attn_s[k], r_attn_g_s[k])
                for k in r_attn_g_s])
    worst = {}
    for kname, leaf, got, want in pairs:
        rel, mx, ok = _grad_gate(got, want)
        rec = records[PRNG_NAME if prng else kname]
        rec["max_abs_err"] = max(rec["max_abs_err"], float((got - want).abs().max()))
        worst[kname] = max(worst.get(kname, 0.0), rel)
        if not ok:
            check(False, f"{kname} {leaf} {where}: rel_l2 {rel:.6g}, max_abs/max {mx:.6g} "
                         f"over {tuple(want.shape)}")
    print(f"  train bwd {where}: worst rel_l2 by kernel {worst}", flush=True)
    check(True, f"train backward {where}: every gradient leaf, da1 and dx of kernels 6, 7 and 9 "
                f"within rel_l2 {GRAD_REL_L2} and max_abs/max {GRAD_MAX_REL}")
    return x, dh2, drop, a1, attn, r_da1, probs, qkv


def check_prng_limits(p, gen, device) -> None:
    """The prng mode's limits on the card, at B=64, S=77, full width: rate
    1e-9 against the deterministic layer (atol 1e-5, as the JAX package's
    TPU test); the keep fraction of the regenerated bits at rate 0.5 within
    5 sigma over every element of the three sites (the kernels use these
    bits: they match their twins at rate 0.5 above)."""
    import math

    import torch

    from motionstyle_torch.ops import fused_encoder_train as ft

    b = TRAIN_BATCHES[0]
    x = torch.randn(b, S, D, generator=gen).to(device, torch.bfloat16)
    seeds = draw_seeds(gen, b, device)
    det = ft.fused_layer_train_forward(x, p, H, None, out_dtype=torch.float32)[0]
    tiny = ft.fused_layer_train_forward(x, p, H, None, out_dtype=torch.float32, seeds=seeds,
                                        rate=1e-9)[0]
    err = float((tiny - det).abs().max())
    print(f"  prng rate 1e-9 vs deterministic B={b} S={S}: max_abs {err:.6g}", flush=True)
    check(err <= 1e-5, "prng rate 1e-9 equals the deterministic layer within 1e-5")
    thresh, _ = ft.prng_threshold(0.5)
    kept = n = 0
    for site, width in ((0, D), (1, F), (2, D)):
        bits = ft.dropout_bits(seeds, site, S, width)
        kept += int((bits < thresh).sum())
        n += bits.numel()
    frac, sigma = kept / n, 0.5 / math.sqrt(n)
    print(f"  prng keep fraction at rate 0.5: {frac:.6f} over {n} elements "
          f"({abs(frac - 0.5) / sigma:.3g} sigma)", flush=True)
    check(abs(frac - 0.5) <= 5 * sigma, "prng keep fraction at rate 0.5 within 5 sigma")


def prng_finite_difference(device) -> None:
    """The gradient of the fused layer in prng mode against a central finite
    difference through the same kernels, store off and on (the JAX
    package's TPU check, tests/test_fused_train.py:323-362, and its 5e-2
    bound), at B=4, S=20, D=128, 4 heads, F=256, rate 0.1. The direction
    takes each gradient entry's sign, scaled by its leaf's rms (x's too), so
    the directional derivative does not cancel to a small sum and each
    entry moves by 1 % of its leaf's scale, above the bf16 rounding of
    weights and input: with the right bits the two agreed to ~1 % in a CPU
    rehearsal of the twins, with another clip's bits they missed by ~20 %."""
    import torch

    from motionstyle_torch.ops import fused_encoder_train as ft

    gen = torch.Generator().manual_seed(7)
    b, s, d, h, f = 4, 20, 128, 4, 256
    base = {k: v.to(device) for k, v in random_params(gen, d, f).items()}
    x = torch.randn(b, s, d, generator=gen).to(device)
    seeds = draw_seeds(gen, b, device)
    eps = 1e-2
    for store in (False, True):
        def loss(pd, xx):
            return torch.sin(ft.fused_encoder_layer_train(
                xx, pd, h, store_probs=store, seeds=seeds, rate=0.1)).sum()

        leaves = {k: v.clone().requires_grad_(True) for k, v in base.items()}
        xt = x.clone().requires_grad_(True)
        loss(leaves, xt).backward()
        rms = lambda t: t.pow(2).mean().sqrt()  # noqa: E731
        vp = {k: torch.sign(leaves[k].grad) * rms(base[k]) for k in base}
        vx = torch.sign(xt.grad) * rms(x)
        with torch.no_grad():
            plus = loss({k: base[k] + eps * vp[k] for k in base}, x + eps * vx)
            minus = loss({k: base[k] - eps * vp[k] for k in base}, x - eps * vx)
        fd = float((plus - minus) / (2 * eps))
        an = sum(float((leaves[k].grad * vp[k]).sum()) for k in base) + float((xt.grad * vx).sum())
        rel = abs(fd - an) / abs(an)
        print(f"  prng finite difference store={store}: fd {fd:.6g} analytic {an:.6g} "
              f"(rel {rel:.3g})", flush=True)
        check(rel < 5e-2, f"prng gradient (store={store}) matches a central finite difference "
                          f"within 5e-2")


def train_kernel_phase(device) -> tuple:
    """Kernels 5-9 against their twins on the card at B=64 and B=1, S=77,
    full width, masks at rate 0.1 and 0, then past the old caps; the same in
    prng mode at rate 0.1 (and 0.5 at B=64, 0.1 at the pretrain's microbatch
    B=32); times at B=64, rate 0.1. Returns each kernel's record fields by
    name and the kernels' times at B=1."""
    import torch
    import torch.nn.functional as Fn

    from motionstyle_torch.ops import fused_encoder_train as ft

    gen = torch.Generator().manual_seed(1)
    p = random_layer(gen, D, F, device)
    records = {n: {"max_abs_err": 0.0} for n in TRAIN_NAMES + (PRNG_NAME,)}
    timing_inputs, prng_inputs = {}, {}
    for b in TRAIN_BATCHES:
        for rate in TRAIN_RATES:
            inputs = check_train_kernels(p, b, S, D, H, F, rate, gen, device, records)
            if rate > 0:
                timing_inputs[b] = inputs
                prng_inputs[b] = check_train_kernels(p, b, S, D, H, F, rate, gen, device,
                                                     records, prng=True)
    check_train_kernels(p, TRAIN_BATCHES[0], S, D, H, F, 0.5, gen, device, records, prng=True)
    # the prng pretrain run's microbatch, the shape of kernel 10's main path
    check_train_kernels(p, FINETUNE_BATCH // PRETRAIN_ACCUM, S, D, H, F, 0.1, gen, device,
                        records, prng=True)
    for b, s, d, h, f in TRAIN_EXTRA_SHAPES:
        layer = random_layer(gen, d, f, device)
        for prng in (False, True):
            check_train_kernels(layer, b, s, d, h, f, 0.1, gen, device, records, prng=prng)
    check_prng_limits(p, gen, device)
    prng_finite_difference(device)

    def runs_at(inputs):
        x, dh2, drop, a1, attn, da1, probs, qkv = inputs
        return {
            "fused_layer_train_forward": (
                lambda: ft.fused_layer_train_forward(x, p, H, None, **drop),
                lambda: ft.fused_layer_train_forward_reference(x, p, H, None, **drop)),
            "fused_layer_train_bwd_ffn": (
                lambda: ft.fused_layer_train_bwd_ffn(dh2, a1, p, **drop),
                lambda: ft.bwd_ffn_reference(dh2, a1, p, **drop)),
            "fused_layer_train_bwd_attn": (
                lambda: ft.fused_layer_train_bwd_attn(da1, x, attn, p, H, None, **drop),
                lambda: ft.bwd_attn_reference(da1, x, attn, p, H, None, **drop)),
            "fused_layer_train_forward_store": (
                lambda: ft.fused_layer_train_forward_store(x, p, H, None, **drop),
                lambda: ft.fused_layer_train_forward_store_reference(x, p, H, None, **drop)),
            "fused_layer_train_bwd_attn_stored": (
                lambda: ft.fused_layer_train_bwd_attn_stored(da1, x, attn, probs, qkv, p, H,
                                                             **drop),
                lambda: ft.bwd_attn_stored_reference(da1, x, attn, probs, qkv, p, H, **drop)),
        }

    counts0 = {n: (getattr(ft, n).launches, getattr(ft, n).prng_launches) for n in TRAIN_NAMES}
    # the unroll's shape (B=1): kernel times only, for the finetune's breakdown
    b = TRAIN_BATCHES[0]
    prng_ms, prng_plain_ms = {}, {}
    with torch.no_grad():
        ms_b1 = {n: time_ms(kern, iters=50) for n, (kern, _) in runs_at(timing_inputs[1]).items()}
        print(f"  B=1 S={S} kernel ms: {ms_b1}", flush=True)
        # masks and prng mode in turns on the same card (masks, prng, prng, masks)
        turns = {True: [], False: []}
        for prng in (False, True, True, False):
            runs = runs_at(prng_inputs[b] if prng else timing_inputs[b])
            turns[prng].append({n: time_ms(kern, iters=50) for n, (kern, _) in runs.items()})
        for name, (_, twin) in runs_at(timing_inputs[b]).items():
            records[name]["ms"] = min(t[name] for t in turns[False])
            records[name]["plain_ms"] = time_ms(twin, iters=10)
        for name, (_, twin) in runs_at(prng_inputs[b]).items():
            prng_ms[name] = min(t[name] for t in turns[True])
            prng_plain_ms[name] = time_ms(twin, iters=10)
        # kernels 5 and 8 launch by launch (torch.profiler), at both batches
        # in masks mode and at B=64 in prng mode
        for bb, inputs, mode in ((b, timing_inputs[b], "masks"), (1, timing_inputs[1], "masks"),
                                 (b, prng_inputs[b], "prng")):
            xx, drop = inputs[0], inputs[2]
            for name, store in (("fused_layer_train_forward", False),
                                ("fused_layer_train_forward_store", True)):
                fn = getattr(ft, name)
                rows = device_profile(lambda: fn(xx, p, H, None, **drop), iters=10)
                print_train_launches(f"{name} ({mode})", rows, bb, S, D, H, F,
                                     masked=mode == "masks", store=store)
            # kernels 6, 7 and 9 launch by launch
            runs = runs_at(inputs)
            for name in TRAIN_BWD_LAUNCHES:
                rows = device_profile(runs[name][0], iters=10)
                print(f"  {name} ({mode}) B={bb} S={S}:", flush=True)
                print_train_bwd_launches(name, rows, bb, S, D, H, F, masked=mode == "masks")
    for name in TRAIN_NAMES:  # timing launches are not the main path's
        getattr(ft, name).launches, getattr(ft, name).prng_launches = counts0[name]
    print(f"  B={b} S={S} rate 0.1, masks vs prng mode (kernel 10 inside), in turns "
          f"(masks, prng, prng, masks), ms: " + "; ".join(
              f"{n} {[round(t[n], 6) for t in turns[False]]} vs "
              f"{[round(t[n], 6) for t in turns[True]]}" for n in TRAIN_NAMES), flush=True)
    x, dh2 = timing_inputs[b][:2]
    lib = torch.nn.TransformerEncoderLayer(
        D, H, F, dropout=0.1, activation=partial(Fn.gelu, approximate="tanh"),
        batch_first=True).to(device, torch.bfloat16).train()
    xl = x.detach().clone().requires_grad_(True)
    with torch.no_grad():
        lib_fwd = time_ms(lambda: lib(x), iters=50)
    # the library layer's forward computes kernels 5's and 8's function (it
    # keeps no residuals); no one call computes a backward half
    for name in TRAIN_NAMES:
        records[name]["library_ms"] = lib_fwd if "forward" in name else None
    # kernel 10 has no launch of its own: its record is the forward in prng
    # mode (kernel 5 with kernel 10 generating its three sites) against the
    # prng twin, the forward's bound without mask traffic and the library
    # layer's forward in train mode (which draws its own dropout masks)
    fwd = TRAIN_NAMES[0]
    records[PRNG_NAME].update(ms=prng_ms[fwd], plain_ms=prng_plain_ms[fwd], library_ms=lib_fwd)
    prng_bound = train_bounds(b, S, D, H, F, masked=False)
    records[PRNG_NAME].update(bound_ms=prng_bound[fwd][0], bound_by=prng_bound[fwd][1])
    for name in TRAIN_NAMES:
        bound_ms, bound_by, flops, nbytes = prng_bound[name]
        print(f"  {name} prng mode B={b} S={S}: kernel_ms {prng_ms[name]:.6g} (masks "
              f"{records[name]['ms']:.6g}) reference_ms {prng_plain_ms[name]:.6g} bound_ms "
              f"{bound_ms:.6g} ({bound_by}: {flops / 1e9:.4g} GFLOP, {nbytes / 1e6:.4g} MB, no "
              f"masks)", flush=True)

    def lib_pair():
        lib(xl).backward(dh2)

    pair_ms = time_ms(lib_pair, iters=20)
    bounds = train_bounds(b, S, D, H, F, masked=True)
    for name, (bound_ms, bound_by, flops, nbytes) in bounds.items():
        records[name].update(bound_ms=bound_ms, bound_by=bound_by)
        r = records[name]
        print(f"  {name} B={b} S={S}: kernel_ms {r['ms']:.6g} reference_ms "
              f"{r['plain_ms']:.6g} library_ms {r['library_ms']} bound_ms {bound_ms:.6g} "
              f"({bound_by}: {flops / 1e9:.4g} GFLOP, {nbytes / 1e6:.4g} MB)", flush=True)
    for label, names in (("recompute", TRAIN_NAMES[:3]),
                         ("store-probs", (TRAIN_NAMES[3], TRAIN_NAMES[1], TRAIN_NAMES[4]))):
        fb = sum(records[n]["ms"] for n in names)
        print(f"  layer forward + backward ({label}): kernels {fb:.6g} ms", flush=True)
    for label, names in (("recompute", TRAIN_NAMES[:3]),
                         ("store-probs", (TRAIN_NAMES[3], TRAIN_NAMES[1], TRAIN_NAMES[4]))):
        fb = sum(prng_ms[n] for n in names)
        print(f"  layer forward + backward ({label}, prng): kernels {fb:.6g} ms", flush=True)
    print(f"  library nn.TransformerEncoderLayer (bf16, train, dropout 0.1) forward + "
          f"backward {pair_ms:.6g} ms", flush=True)
    return records, ms_b1, prng_ms


def golden_model(device, **cfg_kw):
    """The port's MDM with tests/goldens/mdm_model.npz's full-width weights
    on `device`, eval mode; returns (model, the golden arrays, its state
    dict)."""
    import numpy as np

    from motionstyle_torch.models.denoiser import MDM, MDMConfig
    from motionstyle_torch.models.params import from_torch_state_dict

    g = np.load(GOLDEN)
    sd = {k[len("sd__"):]: g[k] for k in g.files if k.startswith("sd__")}
    cfg = MDMConfig(njoints=181, nfeats=1, **cfg_kw)
    model = MDM(cfg)
    model.load_state_dict({k[len("mdm."):]: v for k, v in from_torch_state_dict(sd, cfg).items()})
    return model.to(device).eval(), g, sd


def golden_phase(device):
    """The port's fp32 MDM with the golden prior's weights against the
    reference output; returns the prior's state dict."""
    import numpy as np
    import torch

    model, g, sd = golden_model(device)
    with torch.no_grad():
        out = model(torch.as_tensor(g["x"], device=device),
                    torch.as_tensor(g["t"], device=device),
                    torch.as_tensor(g["enc_text"], device=device))
    err = float(np.abs(out.cpu().numpy() - g["out"]).max())
    print(f"  fp32 MDM vs reference out: max_abs {err:.6g}", flush=True)
    check(out.shape == g["out"].shape and err <= GOLDEN_ATOL,
          f"golden MDM forward within atol {GOLDEN_ATOL}")
    return sd


def _post(base: str, payload: dict) -> tuple:
    req = urllib.request.Request(base + "/v1/sample", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        res = json.load(r)
    return res, time.perf_counter() - t0


def serve_phase(golden_sd, card: str, flag: str, waves: int, value: int = 1, kernel=None,
                others: tuple = ()) -> int:
    """Serve through the CLI's engine behind MotionServer with `flag`
    ("--fused" or "--quant_int8") set to `value` (--fused 0: the unfused
    fp32 denoiser), `waves` waves of 4 concurrent HTTP requests;
    returns the launches of `kernel` (by default the flag's: kernel 1 or 2)
    counted during the served traffic, 16 per batch (8 layers x 2 denoiser
    calls), and checks that none of `others` (by default the other of
    kernels 1 and 2) was launched."""
    import numpy as np
    import torch

    from motionstyle_torch.cli import serve
    from motionstyle_torch.data.masks import get_inpainting_mask
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer, fused_encoder_layer_int8
    from motionstyle_torch.serve.engine import Request
    from motionstyle_torch.serve.server import MotionServer

    if kernel is None:
        kernel, other = ((fused_encoder_layer, fused_encoder_layer_int8) if flag == "--fused"
                         else (fused_encoder_layer_int8, fused_encoder_layer))
        others = (other,)
    label = f"{flag} {value}"

    njoints, nframes = serve.DATASET_DIMS["stylexia_posrot"]
    mask_full = np.asarray(get_inpainting_mask(
        "root_horizontal", (1, njoints, 1, nframes), dataset="stylexia_posrot"),
        np.float32)[0]
    mask = mask_full[:, 0, 0].astype(bool)  # the kept (root) channels
    with tempfile.TemporaryDirectory() as tmp:
        mdm_path = os.path.join(tmp, "mdm_golden.pt")
        torch.save({k: torch.as_tensor(v) for k, v in golden_sd.items()}, mdm_path)
        args = serve.parse_args([
            *label.split(), "--dataset", "stylexia_posrot", "--mdm_path", mdm_path,
            # no style checkpoint ships with the repo: a seeded style encoder
            "--model_path", os.path.join(tmp, "model000000000.pt"),
            "--max_wait_ms", "20", "--port", "0"])
        engine, decode, handle = serve.build_engine(args)
    check(engine.sampler.n_live_steps() == 2, "min-latency plan: 2 denoiser calls per batch")
    engine.warmup(decode({"content": np.zeros((nframes, njoints), np.float32)}))
    server = MotionServer(engine, port=0, decode=decode, handle=handle).start_background()
    base = f"http://127.0.0.1:{server.port}"
    rng = np.random.RandomState(0)
    contents = [rng.randn(nframes, njoints).astype(np.float32) * 0.5 for _ in range(8)]
    try:
        # the main path: every count from here to the end of the phase
        for k in (kernel, *others):
            k.launches = 0
        batches0 = engine.stats()["batches"]

        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            check(json.load(r) == {"status": "ok"}, "/healthz answers")

        # batching invariance: one request alone, and in two batches of the
        # same bucket (4) with other companions at other positions
        encs = [decode({"content": c, "text": f"clip {i}"}).cond["enc_text"]
                for i, c in enumerate(contents)]

        def req(i, seed):
            return Request({"enc_text": encs[i]}, contents[i].T[:, None, :], mask_full, seed)

        solo = engine.sample(req(0, 11))
        futs_a = [engine.submit(r) for r in (req(0, 11), req(1, 12), req(2, 13), req(3, 14))]
        batch_a = [f.result(timeout=120) for f in futs_a]
        futs_b = [engine.submit(r) for r in (req(4, 15), req(5, 16), req(0, 11), req(6, 17))]
        batch_b = [f.result(timeout=120) for f in futs_b]
        sizes = engine._batcher.stats.batch_sizes[-3:]
        check(sizes == [1, 4, 4], f"engine batches of sizes [1, 4, 4] (got {sizes})")
        within = float(np.abs(batch_a[0] - batch_b[2]).max())
        across = float(np.abs(batch_a[0] - solo).max())
        print(f"  same request, two batches of bucket 4: max_abs {within:.6g}; "
              f"alone (bucket 1) vs bucket 4: max_abs {across:.6g}", flush=True)
        check(within <= 1e-5, "request agrees with itself across batches of one bucket")

        # HTTP traffic: waves of concurrent /v1/sample requests
        results, latencies, lock = [], [], threading.Lock()

        def client(i, seed):
            res, dt = _post(base, {"content": contents[i].tolist(),
                                   "text": "a person walks angrily", "seed": seed})
            with lock:
                results.append((i, np.asarray(res["motion"], np.float32)))
                latencies.append(dt)

        t0 = time.perf_counter()
        for wave in range(waves):
            threads = [threading.Thread(target=client, args=(i, 100 * wave + i))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            check(not any(t.is_alive() for t in threads), f"wave {wave} answered")
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        stats = engine.stats()
        batches = stats["batches"] - batches0
        launches, stray = kernel.launches, {k.__name__: k.launches for k in others}
    finally:
        server.close()

    check(len(results) == 4 * waves, f"{4 * waves} concurrent /v1/sample requests answered")
    for i, motion in results:
        if motion.shape != (njoints, 1, nframes) or not np.isfinite(motion).all():
            check(False, f"result shape {motion.shape} finite {np.isfinite(motion).all()}")
        if not np.array_equal(motion[mask], contents[i].T[:, None, :][mask]):
            check(False, "root_horizontal channels equal the content")
    check(True, "every result finite, (181, 1, 76), root_horizontal channels exact")
    lat = np.sort(np.asarray(latencies) * 1e3)
    p50, p95 = float(np.percentile(lat, 50)), float(np.percentile(lat, 95))
    print(f"  HTTP ({label}): {len(results)} requests in {wall:.4f} s: p50 {p50:.4f} ms, "
          f"p95 {p95:.4f} ms, {len(results) / wall:.4f} clips/s on {card}", flush=True)
    print(f"  engine: batch p50 {stats['batch_p50_ms']} ms (2 denoiser calls + noise), "
          f"submit-to-result p50 {stats['latency_p50_ms']} ms, mean batch "
          f"{stats['mean_batch_size']:.4g}", flush=True)
    print(f"  {kernel.__name__} launches {launches} over {batches} batches "
          f"(8 layers x 2 denoiser calls each); other kernels' launches {stray}", flush=True)
    check(launches == 16 * batches and batches > 0,
          f"{kernel.__name__} launch counter == 16 x batches served")
    check(not any(stray.values()), f"{sorted(stray)} never launched with {label}")
    return launches


def write_xia_corpus(root: str, seed: int = 0, clips: int = 120) -> None:
    """A synthetic Xia-layout corpus (181-dim new_joint_vecs/*.npy, Mean.npy,
    Std.npy) from a seed, as tests/test_cli.py:13-22 writes one, large
    enough for batches of 64 (the Xia set holds ~570 clips)."""
    import numpy as np

    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "new_joint_vecs"))
    styles = ("angry", "childlike", "depressed", "neutral", "old", "proud", "sexy",
              "strutting")
    contents = ("jumping", "running", "walking", "punching", "kicking")
    names = ["350angry_jumping.npy"] + [
        f"{100 + i:03d}{styles[i % len(styles)]}_{contents[i % len(contents)]}.npy"
        for i in range(clips)]
    for name in names:
        frames = int(rs.randint(40, 160))
        np.save(os.path.join(root, "new_joint_vecs", name),
                (rs.randn(frames, 181) * 0.5).astype(np.float32))
    np.save(os.path.join(root, "Mean.npy"), (rs.randn(181) * 0.1).astype(np.float32))
    np.save(os.path.join(root, "Std.npy"), (np.abs(rs.randn(181)) + 0.5).astype(np.float32))


PRETRAIN_STEPS = 4


def _prior_counts(ft) -> dict:
    """Launches and prng-mode launches of kernels 5-9, and mask draws."""
    out = {n: (getattr(ft, n).launches, getattr(ft, n).prng_launches) for n in TRAIN_NAMES}
    out["make_dropout_masks"] = ft.make_dropout_masks.calls
    return out


def _zero_counts(ft) -> None:
    for n in TRAIN_NAMES:
        getattr(ft, n).launches = getattr(ft, n).prng_launches = 0
    ft.make_dropout_masks.calls = 0


def pretrain_phase(card: str, data_dir: str, tmp_root: str) -> tuple:
    """The prior pretraining CLI at full width (d=512, 8 layers, 4 heads, ff
    1024, batch 64, 76 frames: S=77, 181 features) on the synthetic corpus,
    4 steps with --fused_train 1 (mask arrays), 4 with --fused_train_prng 1
    (kernel 10; the same run otherwise, so the two seconds per step compare
    the dropout modes alone), then 4 with --fused_train_prng 1 --grad_accum
    2 --ema_rate 0.999 --schedule_sampler loss_second_moment. Each run's
    counts are set to 0 just before it and read just after. Checks finite
    losses, the written checkpoints and every kernel's launches, and that
    the prng runs draw no mask arrays. Returns (the last run's counts, its
    mdm.pt)."""
    import csv

    import numpy as np
    import torch

    from motionstyle_torch.cli.pretrain_prior import main as pretrain_main
    from motionstyle_torch.ops import fused_encoder_train as ft

    layers, seed, batch = FINETUNE_LAYERS, 10, FINETUNE_BATCH
    runs = {}
    accum_flags = ["--grad_accum", str(PRETRAIN_ACCUM), "--ema_rate", "0.999",
                   "--schedule_sampler", "loss_second_moment"]
    for label, flags, prng, accum in (
            ("--fused_train 1", ["--fused_train", "1"], False, 1),
            ("--fused_train_prng 1", ["--fused_train_prng", "1"], True, 1),
            ("--fused_train_prng 1 " + " ".join(accum_flags),
             ["--fused_train_prng", "1", *accum_flags], True, PRETRAIN_ACCUM)):
        save_dir = os.path.join(tmp_root, f"prior_{len(runs)}")
        random.seed(seed)  # the loader's crops and captions
        # the main path: every count from here to the end of the run
        _zero_counts(ft)
        t0 = time.perf_counter()
        pretrain_main(["--dataset", "stylexia_posrot", "--data_dir", data_dir, "--save_dir",
                       save_dir, "--batch_size", str(batch), "--layers", str(layers),
                       "--num_steps", str(PRETRAIN_STEPS), "--log_interval", "1", "--seed",
                       str(seed), *flags, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _prior_counts(ft)
        with open(os.path.join(save_dir, "progress.csv")) as f:
            rows = list(csv.DictReader(f))
        losses = [float(r["prior_loss"]) for r in rows]
        secs = [float(r["step_seconds"]) for r in rows]
        steady = float(np.median(secs[1:]))
        print(f"  pretrain {label}: {PRETRAIN_STEPS} steps in {wall:.4f} s (whole CLI run on "
              f"{card}); losses {losses}; step seconds {secs}; median after the first "
              f"{steady:.6g} s = {batch / steady:.6g} clips/s", flush=True)
        check(len(losses) == PRETRAIN_STEPS and bool(np.isfinite(losses).all()),
              f"pretrain {label}: losses finite")
        files = sorted(n for n in os.listdir(save_dir) if n.endswith(".pt"))
        want_files = ["mdm.pt", "model_pretrained.pt"] + (["mdm_ema.pt"] if "--ema_rate" in flags else [])
        check(files == sorted(want_files), f"pretrain {label}: writes {sorted(want_files)}")
        per_step = layers * accum
        fwd, ffn, attn = TRAIN_NAMES[:3]
        want = {n: (0, 0) for n in TRAIN_NAMES}
        for n in (fwd, ffn, attn):
            want[n] = (per_step * PRETRAIN_STEPS, per_step * PRETRAIN_STEPS if prng else 0)
        want["make_dropout_masks"] = 0 if prng else layers * PRETRAIN_STEPS
        print(f"  pretrain {label}: (launches, prng launches) {counts}", flush=True)
        check(counts == want, f"pretrain {label}: {per_step} launches of kernels 5, 6 and 7 per "
                              f"step ({'all in prng mode, no mask arrays' if prng else 'mask arrays, one draw per layer'}), "
                              f"none of kernels 8 and 9")
        runs[label] = (counts, steady, os.path.join(save_dir, "mdm.pt"))
    print("  pretrain seconds per step after the first: " + "; ".join(
        f"{label} {secs:.6g} ({batch / secs:.6g} clips/s)"
        for label, (_, secs, _) in runs.items()) + f" on {card}", flush=True)
    return runs[label][0], runs[label][2]


def finetune_phase(golden_sd, card: str, kernel_ms_b1: dict, kernel_ms_b64: dict,
                   tmp_root: str, data_dir: str, prior_path: str) -> tuple:
    """The finetune CLI at full width, --fused 1 and a batch of 64, for a few
    steps from the golden prior, four runs in turns from the same seed and
    corpus: --fused_train 1 (kernels 5, 6, 7), the same with
    --parallel_finetune 1 (the Picard-parallel unroll: kernel 5 in the
    gradient-free sweeps, then one differentiable forward at B = 6 x 1), then
    --fused_train_store 1 --parallel_finetune 1 and --fused_train_store 1
    (kernels 8, 6, 9; the sweeps on kernel 5); then 2 steps of
    --fused_train_prng 1 (kernels 5, 6, 7 with kernel 10, no mask arrays)
    from the pretrain phase's prior (prior_path). Each run's counts are set
    to 0 just before it and read just after. Returns each masks path's
    training kernel launches, the parallel runs' launches, the prng run's
    counts, the function that builds the CLI's arguments and the store run's
    last model*.pt."""
    import csv

    import numpy as np
    import torch

    from motionstyle_torch.cli.finetune_style_diffusion import main as finetune_main
    from motionstyle_torch.models.denoiser import MDMConfig, StyleDiffusion
    from motionstyle_torch.models.params import convert_encoder, seeded_init_
    from motionstyle_torch.ops import fused_encoder_train as ft
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer

    steps, layers, seed = FINETUNE_STEPS, FINETUNE_LAYERS, 10
    counted = [getattr(ft, n) for n in TRAIN_NAMES] + [fused_encoder_layer]
    mdm_path = os.path.join(tmp_root, "mdm_golden.pt")
    torch.save({k: torch.as_tensor(v) for k, v in golden_sd.items()}, mdm_path)

    def finetune_args(data_dir: str, save_dir: str, num_steps: int, train_flag: str,
                      prior: str = mdm_path, extra=()) -> list:
        return ["--dataset", "stylexia_posrot", "--data_dir", data_dir, "--mdm_path", prior,
                "--save_dir", save_dir, "--fused", "1", train_flag, "1",
                "--batch_size", str(FINETUNE_BATCH), "--layers", str(layers),
                "--num_steps", str(num_steps), "--skip_render",
                "--train_platform_type", "NoPlatform", "--seed", str(seed), "--device", "cuda",
                *extra]

    def run(train_flag: str, save_root: str, steps: int = steps, prior: str = mdm_path,
            extra=()) -> dict:
        label = " ".join([f"{train_flag} 1", *extra])
        torch.cuda.reset_peak_memory_stats()
        # the Xia loader draws captions and crops from Python's global random
        # (as the reference's loader does): seed it so every run sees one batch
        random.seed(seed)
        # the main path: every count from here to the end of the run
        for k in counted:
            k.launches = 0
        _zero_counts(ft)
        t0 = time.perf_counter()
        save_dir = finetune_main(finetune_args(data_dir, save_root, steps, train_flag, prior,
                                               extra))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in counted}
        launches["counts"] = _prior_counts(ft)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with open(os.path.join(save_dir, "progress.csv")) as f:
            rows = list(csv.DictReader(f))
        ckpts = sorted(n for n in os.listdir(save_dir) if n.startswith("model"))
        sd = torch.load(os.path.join(save_dir, ckpts[-1]), map_location="cpu")
        trained = convert_encoder(sd, "seqTransEncoder", layers)
        init = seeded_init_(StyleDiffusion(MDMConfig(njoints=181, nfeats=1, num_layers=layers)),
                            seed).style_encoder.state_dict()
        moved = max(float((trained[k] - init[k]).abs().max()) for k in init)
        losses = [float(r["loss"]) for r in rows]
        secs = [float(r["step_seconds"]) for r in rows]
        sweeps = [int(float(r["picard_sweeps"])) for r in rows if r.get("picard_sweeps")]
        print(f"  {label}: {steps} steps in {wall:.4f} s (whole CLI run on {card}); losses "
              f"{losses}; step seconds {secs}; peak memory {peak_gb:.4g} GB"
              + (f"; Picard sweeps per step {sweeps}" if sweeps else ""), flush=True)
        check(len(losses) == steps and bool(np.isfinite(losses).all()),
              f"{label}: finetune losses finite")
        check(ckpts[-1] == f"model{steps:09d}.pt" and set(trained) == set(init),
              f"{label}: {ckpts[-1]} loads back with convert_encoder ({layers} layers)")
        print(f"  {label}: style encoder moved by max_abs {moved:.6g} from its seeded start",
              flush=True)
        check(moved > 0.0, f"{label}: the style encoder's weights moved")
        return dict(launches=launches, losses=losses, secs=secs, sweeps=sweeps, peak_gb=peak_gb,
                    model_path=os.path.join(save_dir, ckpts[-1]), label=label)

    # DDIM-20 skip 700 of 1000: 6 unrolled steps, each recomputed under
    # checkpoint, plus the semantic branch's forward; 8 layers each
    unroll = 6
    fwd, bwd = layers * (1 + 2 * unroll) * steps, layers * (1 + unroll) * steps
    par = ["--parallel_finetune", "1"]
    # in turns: sequential, parallel, parallel, sequential
    rec = run("--fused_train", os.path.join(tmp_root, "ft"))
    rec_p = run("--fused_train", os.path.join(tmp_root, "ft_par"), extra=par)
    store_p = run("--fused_train_store", os.path.join(tmp_root, "ft_store_par"), extra=par)
    store = run("--fused_train_store", os.path.join(tmp_root, "ft_store"))
    launches, losses, secs = rec["launches"], rec["losses"], rec["secs"]
    launches_s, losses_s, secs_s = store["launches"], store["losses"], store["secs"]

    want = dict.fromkeys(TRAIN_NAMES, 0)
    want.update(fused_layer_train_forward=fwd, fused_layer_train_bwd_ffn=bwd,
                fused_layer_train_bwd_attn=bwd)
    train = {n: launches[n] for n in TRAIN_NAMES}
    print(f"  --fused_train 1: training kernel launches {train} over {steps} steps; inference "
          f"layer launches {launches['fused_encoder_layer']} (neutral generation 100 x 8, "
          f"final resample {unroll} x 8)", flush=True)
    check(train == want, f"--fused_train 1: training kernel launches == {want} over {steps} steps")
    for r in (rec, rec_p, store_p, store):
        check(r["launches"]["fused_encoder_layer"] == layers * (100 + unroll),
              f"{r['label']}: inference kernel launches == 8 x (100 neutral DDPM steps + 6 DDIM "
              "steps)")
    want_s = dict.fromkeys(TRAIN_NAMES, 0)
    want_s.update(fused_layer_train_forward_store=fwd, fused_layer_train_bwd_ffn=bwd,
                  fused_layer_train_bwd_attn_stored=bwd)
    train_s = {n: launches_s[n] for n in TRAIN_NAMES}
    print(f"  --fused_train_store 1: training kernel launches {train_s} over {steps} steps",
          flush=True)
    check(train_s == want_s,
          f"--fused_train_store 1: training kernel launches == {want_s} over {steps} steps "
          f"(kernels 5 and 7 never)")
    # the parallel unroll: per step the semantic branch's forward and the one
    # differentiable forward (kernel 5, or 8 with store), each with its
    # backward (kernels 6 and 7, or 6 and 9), and one kernel-5 forward per
    # Picard sweep (no gradient, so never the store kernel)
    for r, f_name, attn_name in ((rec_p, TRAIN_NAMES[0], TRAIN_NAMES[2]),
                                 (store_p, TRAIN_NAMES[3], TRAIN_NAMES[4])):
        swept = layers * sum(r["sweeps"])
        want_p = dict.fromkeys(TRAIN_NAMES, 0)
        want_p[f_name] = want_p.get(f_name, 0) + 2 * layers * steps
        want_p[TRAIN_NAMES[0]] += swept
        want_p[TRAIN_NAMES[1]] = want_p[attn_name] = 2 * layers * steps
        got = {n: r["launches"][n] for n in TRAIN_NAMES}
        print(f"  {r['label']}: training kernel launches {got} over {steps} steps (Picard "
              f"sweeps {r['sweeps']})", flush=True)
        check(len(r["sweeps"]) == steps and all(1 <= n <= 4 * unroll + 16 for n in r["sweeps"]),
              f"{r['label']}: Picard sweeps per step recorded, each within 1 and max_sweeps "
              f"({4 * unroll + 16})")
        check(got == want_p, f"{r['label']}: training kernel launches == {want_p} (8 x (2 + "
                             f"sweeps) forwards, 8 x 2 of each backward half)")
    # the store forward is bit-equal to the recompute forward, so the first
    # loss (before any update) is the same; later losses differ by the
    # stored backward's bf16 p in the softmax VJP
    first = abs(losses_s[0] - losses[0]) / abs(losses[0])
    later = max(abs(a - b) / abs(b) for a, b in zip(losses_s[1:], losses[1:]))
    print(f"  store vs recompute losses: first |diff| {abs(losses_s[0] - losses[0]):.6g} "
          f"(rel {first:.6g}); later max rel {later:.6g}", flush=True)
    check(first <= 1e-6, "store run's first loss equals the recompute run's (rel <= 1e-6)")
    check(later <= 2e-2, "store run's later losses within 2e-2 relative of the recompute run's")

    for label, names, sec in (
            ("--fused_train 1", TRAIN_NAMES[:3], secs),
            ("--fused_train_store 1", (TRAIN_NAMES[3], TRAIN_NAMES[1], TRAIN_NAMES[4]), secs_s)):
        f_name, ffn_name, attn_name = names
        kernel_s = (layers * sum(kernel_ms_b64[n] for n in names)
                    + layers * unroll * (2 * kernel_ms_b1[f_name] + kernel_ms_b1[ffn_name]
                                         + kernel_ms_b1[attn_name])) / 1e3
        steady = float(np.median(sec[1:])) if len(sec) > 1 else sec[0]
        print(f"  {label} per step: training kernel time (launches x the kernel times "
              f"measured above at B=64 and B=1) {kernel_s:.6g} s of a median {steady:.6g} s "
              f"step after the first ({100 * kernel_s / steady:.4g} %)", flush=True)
    print("  finetune in turns (sequential, parallel, parallel, sequential), seconds per step "
          "after the first, Picard sweeps per step, launches per step of kernels 1 and 5-9, "
          f"peak memory, on {card}:", flush=True)
    for r in (rec, rec_p, store_p, store):
        per_step = {n: r["launches"][n] / steps for n in TRAIN_NAMES}
        per_step["fused_encoder_layer (whole run)"] = r["launches"]["fused_encoder_layer"]
        print(f"    {r['label']}: {r['secs'][1:]} (median {float(np.median(r['secs'][1:])):.6g} "
              f"s); sweeps {r['sweeps'] or '-'}; {per_step}; {r['peak_gb']:.4g} GB", flush=True)

    # in-kernel dropout (kernel 10) from the port's own pretrained prior
    prng_steps = 2
    prng = run("--fused_train_prng", os.path.join(tmp_root, "ft_prng"), prng_steps, prior_path)
    counts = prng["launches"]["counts"]
    fwd_p, bwd_p = layers * (1 + 2 * unroll) * prng_steps, layers * (1 + unroll) * prng_steps
    want_p = {n: (0, 0) for n in TRAIN_NAMES}
    want_p.update({TRAIN_NAMES[0]: (fwd_p, fwd_p), TRAIN_NAMES[1]: (bwd_p, bwd_p),
                   TRAIN_NAMES[2]: (bwd_p, bwd_p), "make_dropout_masks": 0})
    print(f"  --fused_train_prng 1 from the pretrained prior: (launches, prng launches) "
          f"{counts} over {prng_steps} steps", flush=True)
    check(counts == want_p, f"--fused_train_prng 1: every launch of kernels 5, 6 and 7 in prng "
                            f"mode ({fwd_p}, {bwd_p}, {bwd_p} over {prng_steps} steps), no mask "
                            f"arrays, kernels 8 and 9 never")
    parallel = {k.__name__: rec_p["launches"][k.__name__] + store_p["launches"][k.__name__]
                for k in counted}
    return launches, launches_s, parallel, counts, finetune_args, store["model_path"]


# rot_mse and the style encoder's gradients, parallel unroll against
# sequential at full width on the card: the Picard states agree to an RMS of
# tol * tol_floor = 1e-3 (the DDIM threshold), under the bf16 rounding of the
# kernels' input (4e-3 relative), so each x0 prediction differs by at most a
# few bf16 flips through 8 layers: rot_mse within the stack's gate
# (STACK_REL_L2, 2e-2) and each gradient leaf within 5e-2 rel L2 (GRAD_REL_L2
# of one layer's backward, 1e-2, through 8 layers and 6 steps)
PARALLEL_ROT_REL, PARALLEL_GRAD_REL = STACK_REL_L2, 5e-2


def parallel_unroll_gate(golden_sd, device) -> None:
    """The port's few_shot_style_finetune_loss called directly at full width
    on one batch, the parallel unroll against the sequential one: the golden
    prior, a seeded style encoder, dropout and cond_mask_prob 0 (the CLI has
    no flag for them, as the JAX CLI has none), --fused_train's kernels and
    the same pinned noise; rot_mse and every style-encoder gradient leaf."""
    import torch

    from motionstyle_torch.data.masks import get_inpainting_mask
    from motionstyle_torch.diffusion.schedule import make_schedule
    from motionstyle_torch.models.denoiser import MDMConfig, StyleDiffusion
    from motionstyle_torch.models.params import from_torch_state_dict, seeded_init_
    from motionstyle_torch.train.finetune import FinetuneConfig, StyleFinetuneTrainer

    cfg = MDMConfig(njoints=181, nfeats=1, dropout=0.0, cond_mask_prob=0.0, fused=True,
                    fused_train=True, dtype="bfloat16")
    model = seeded_init_(StyleDiffusion(cfg), 10)
    model.load_state_dict(from_torch_state_dict(golden_sd, cfg, part="mdm"), strict=False)
    model = model.to(device).eval()
    sched = make_schedule("cosine", 1000, "ddim20", device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    Bt, T = FINETUNE_BATCH, 76
    randn = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    inp = torch.as_tensor(get_inpainting_mask("root_horizontal", (1, 181, 1, T),
                                              dataset="stylexia_posrot"),
                          dtype=torch.float32, device=device)
    mask = torch.ones((1, 1, 1, T), device=device)
    mask[..., 60:] = 0.0
    batch = {"x_start": randn(Bt, 181, 1, T), "content": randn(1, 181, 1, T),
             "style_target": randn(1, 181, 1, T), "mask": mask, "inp_mask": inp,
             "enc_text_style": randn(1, 512), "enc_text_t2m": randn(Bt, 512)}
    noise = randn(1, 181, 1, T)
    t = torch.zeros((Bt,), dtype=torch.int64, device=device)
    out = {}
    for parallel in (False, True):
        trainer = StyleFinetuneTrainer(
            FinetuneConfig(save_dir="unused", cond_mask_prob=0.0, semantic_guidance=False,
                           parallel_unroll=parallel), model, sched)
        model.zero_grad(set_to_none=True)
        terms = trainer.loss_terms(batch, t, 0, noise=noise)
        terms["loss"].backward()
        out[parallel] = (terms["rot_mse"].detach().float(),
                         {n: p.grad.detach().float().clone()
                          for n, p in model.named_parameters() if p.grad is not None},
                         int(terms.get("picard_sweeps", 0)))
    (rot_s, g_s, _), (rot_p, g_p, sweeps) = out[False], out[True]
    rot_rel = rel_l2(rot_p, rot_s)
    grad_rel = {n: rel_l2(g_p[n], g_s[n]) for n in g_s}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"  parallel vs sequential unroll at full width (B={Bt}, 6 steps, {sweeps} Picard "
          f"sweeps): rot_mse {rot_p.tolist()} against {rot_s.tolist()}, rel L2 {rot_rel:.6g}; "
          f"gradient rel L2 max {grad_rel[worst]:.6g} ({worst}), median "
          f"{sorted(grad_rel.values())[len(grad_rel) // 2]:.6g} over {len(grad_rel)} leaves",
          flush=True)
    check(g_s.keys() == g_p.keys() and len(g_s) == 12 * FINETUNE_LAYERS,
          "parallel unroll: gradients reach the style encoder's leaves only")
    check(rot_rel <= PARALLEL_ROT_REL, f"parallel unroll: rot_mse within rel L2 "
                                       f"{PARALLEL_ROT_REL} of the sequential unroll's")
    check(grad_rel[worst] <= PARALLEL_GRAD_REL,
          f"parallel unroll: every style-encoder gradient leaf within rel L2 {PARALLEL_GRAD_REL} "
          "of the sequential unroll's")


SEMANTIC_STEPS = 4


@contextmanager
def frozen_modules_watch(out: dict):
    """Around a SemanticTrainer's life: a copy of every parameter it freezes
    when it is built, held against the model when it saves (out["frozen"]:
    the parameter count, out["changed"]: the names not bit-equal)."""
    import torch

    from motionstyle_torch.train import semantic

    init, save = semantic.SemanticTrainer.__init__, semantic.SemanticTrainer.save

    def watched_init(self, *a, **k):
        init(self, *a, **k)
        self._frozen_copy = {n: p.detach().clone() for n, p in self.model.named_parameters()
                             if not p.requires_grad}

    def watched_save(self):
        params = dict(self.model.named_parameters())
        out["frozen"] = len(self._frozen_copy)
        out["changed"] = [n for n, v in self._frozen_copy.items()
                          if not torch.equal(params[n].detach(), v)]
        return save(self)

    semantic.SemanticTrainer.__init__, semantic.SemanticTrainer.save = watched_init, watched_save
    try:
        yield
    finally:
        semantic.SemanticTrainer.__init__, semantic.SemanticTrainer.save = init, save


def semantic_phase(card: str, data_dir: str, tmp_root: str, prior_path: str,
                   finetune_args) -> dict:
    """The semantic-discriminator CLI at full width (d=512, 8 layers, batch
    64, --fused_train 1) for a few steps from the pretrain phase's prior:
    seconds per step, losses, the prior's and the style encoder's parameters
    bit-equal from the trainer's start to its save, kernels 5, 6 and 7
    launched 8 times a step each (the prior's training forward and its
    backward to mu). Then 2 finetune steps with --semantic_guidance 1 and
    --semantic_discriminator_path at the new checkpoint. Returns each run's
    launches of kernels 1 and 5-9, summed."""
    import csv

    import numpy as np
    import torch

    from motionstyle_torch.cli.finetune_style_diffusion import main as finetune_main
    from motionstyle_torch.cli.train_semantic_discriminator import main as sem_main
    from motionstyle_torch.ops import fused_encoder_train as ft
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer

    layers, seed = FINETUNE_LAYERS, 10
    counted = [getattr(ft, n) for n in TRAIN_NAMES] + [fused_encoder_layer]
    total = dict.fromkeys((k.__name__ for k in counted), 0)
    save_dir = os.path.join(tmp_root, "semantic")
    watch = {}
    random.seed(seed)
    # the main path: every count from here to the end of the run
    for k in counted:
        k.launches = 0
    _zero_counts(ft)
    t0 = time.perf_counter()
    with frozen_modules_watch(watch):
        path = sem_main(["--dataset", "stylexia_posrot", "--data_dir", data_dir, "--mdm_path",
                         prior_path, "--save_dir", save_dir, "--batch_size",
                         str(FINETUNE_BATCH), "--layers", str(layers), "--num_steps",
                         str(SEMANTIC_STEPS), "--log_interval", "1", "--seed", str(seed),
                         "--fused_train", "1", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k.__name__: k.launches for k in counted}
    with open(os.path.join(save_dir, "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["semantic_loss"]) for r in rows]
    secs = [float(r["step_seconds"]) for r in rows]
    print(f"  semantic discriminator --fused_train 1: {SEMANTIC_STEPS} steps in {wall:.4f} s "
          f"(whole CLI run on {card}); losses {losses}; step seconds {secs}; median after the "
          f"first {float(np.median(secs[1:])):.6g} s", flush=True)
    check(len(losses) == SEMANTIC_STEPS and bool(np.isfinite(losses).all()),
          "semantic: losses finite")
    print(f"  semantic: {watch.get('frozen')} frozen parameters, changed {watch.get('changed')}",
          flush=True)
    check(watch.get("frozen", 0) > 0 and watch["changed"] == [],
          "semantic: the prior's and the style encoder's parameters bit-equal after the steps")
    sd = torch.load(path, map_location="cpu")
    check({"muQuery", "sigmaQuery"} <= set(sd) and len(sd) == 2 + 12 * layers,
          f"semantic: semantic_discriminator.pt holds the queries and a {layers}-layer encoder")
    per_step = layers * SEMANTIC_STEPS
    want = dict.fromkeys(TRAIN_NAMES, 0)
    want.update({TRAIN_NAMES[0]: per_step, TRAIN_NAMES[1]: per_step, TRAIN_NAMES[2]: per_step})
    print(f"  semantic: launches {got}", flush=True)
    check({n: got[n] for n in TRAIN_NAMES} == want and got["fused_encoder_layer"] == 0,
          f"semantic: kernels 5, 6, 7 launched {layers} times a step each (the prior's training "
          "forward and backward), kernels 8, 9 and 1 never")
    for n in total:
        total[n] += got[n]

    # the full reference loss: the finetune with semantic guidance from it
    steps = 2
    random.seed(seed)
    for k in counted:
        k.launches = 0
    _zero_counts(ft)
    t0 = time.perf_counter()
    ft_dir = finetune_main(finetune_args(data_dir, os.path.join(tmp_root, "ft_semantic"), steps,
                                         "--fused_train", prior_path,
                                         ["--semantic_guidance", "1",
                                          "--semantic_discriminator_path", path]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k.__name__: k.launches for k in counted}
    with open(os.path.join(ft_dir, "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    cos = [float(r["text_cosine"]) for r in rows]
    losses = [float(r["loss"]) for r in rows]
    print(f"  finetune --semantic_guidance 1 from the trained discriminator: {steps} steps in "
          f"{wall:.4f} s; losses {losses}; text_cosine {cos}; launches {got}", flush=True)
    check(len(losses) == steps and bool(np.isfinite(losses + cos).all()),
          "semantic: the guided finetune's losses and text cosines finite")
    for n in total:
        total[n] += got[n]
    return total


# tests/test_quality.py's protocol (latent 64, 2 layers, T=100 cosine, prior
# 1500 steps, finetune 250 at lr 1e-3 with checkpoints every 50, the ladder
# and the auto arm), then QUALITY.md's d512 semantic arm (prior 1500,
# discriminator 600, finetune 200 at lr 1e-3, a rung every 25)
QUALITY_ARGS = dict(prior_steps=1500, finetune_steps=250, lr=1e-3, save_interval=50)
SEMANTIC_ARM = dict(prior_steps=1500, semantic_steps=600, finetune_steps=200, lr=1e-3,
                    save_interval=25)


def quality_kernel1(finetunes: int, evaluations: int, demos: int, layers: int = 2) -> int:
    """Kernel 1's launches in a quality arm at T=100: a finetune's neutral
    generation (DDPM 99..90) and final resample (DDIM-20 skip 14: 6 steps),
    6 denoiser calls an --auto_stop evaluation, 2 a demo (stopped at t=4)."""
    return layers * (finetunes * (10 + 6) + evaluations * 6 + demos * 2)


def quality_table(res: dict) -> str:
    rows = {"pre": res["pre"], **{str(k): v for k, v in sorted(res["ladder"].items())}}
    return "; ".join(f"{k}: ratio {r['style_dist_ratio']:.6g} content "
                     f"{r['content_similarity']:.6g} root {r['root_horizontal_max_abs_err']:.3g}"
                     for k, r in rows.items())


def quality_phase(card: str, tmp_root: str) -> dict:
    """The port's quality protocol (motionstyle_torch/eval/quality_protocol.py)
    through the port's CLIs with --fused_train 1 and --fused 1: first
    tests/test_quality.py's protocol, gated by its assertions unchanged, then
    the d512 semantic arm, gated by root error < 1e-4 at every rung and finite
    metrics. Prints every stage's wall time and each arm's ratio/content
    table. Returns the launches of kernels 1 and 5-9 over the phase."""
    import math

    import torch

    from motionstyle_torch.eval import quality_protocol as qp
    from motionstyle_torch.ops import fused_encoder_train as ft
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer

    counted = [getattr(ft, n) for n in TRAIN_NAMES] + [fused_encoder_layer]
    flags = dict(fused_train=True, fused=True, device="cuda")
    # the main path: every count from here to the end of the phase
    for k in counted:
        k.launches = 0
    _zero_counts(ft)
    random.seed(10)
    t0 = time.perf_counter()
    res = qp.run_protocol(os.path.join(tmp_root, "quality"), ladder=True, auto_stop=True,
                          **QUALITY_ARGS, **flags)
    wall = time.perf_counter() - t0
    arm64 = {k.__name__: k.launches for k in counted}
    print(f"  quality (latent 64): {wall:.4f} s on {card}; stage seconds "
          f"{json.dumps(res['seconds'])}; launches {arm64}", flush=True)
    print(f"  quality (latent 64) table: {quality_table(res)}", flush=True)
    auto, ladder = res["auto"], res["ladder"]
    print("  quality (latent 64) auto_stop: selected " + str(auto.get("selected_step")) + "; "
          + "; ".join(f"{s}: ratio {r['style_dist_ratio']:.6g} content "
                      f"{r['content_similarity']:.6g}"
                      for s, r in sorted(auto["trace"].items(), key=lambda kv: int(kv[0])))
          + f"; demo check {auto.get('demo_report')}", flush=True)
    # tests/test_quality.py's assertions, unchanged
    for name, met in qp.quality_gate(res).items():
        check(met, "quality: " + qp.GATE[name])
    demos = 2 + (len(ladder) - 1) + (auto.get("demo_report") is not None)
    check(arm64["fused_encoder_layer"] == quality_kernel1(2, len(auto["trace"]), demos),
          f"quality (latent 64): kernel 1 launched in both finetunes, the {len(auto['trace'])} "
          f"--auto_stop evaluations and the {demos} demos")

    t0 = time.perf_counter()
    arm = dict(SEMANTIC_ARM)
    assets = qp.prepare_assets(os.path.join(tmp_root, "quality_d512"),
                               prior_steps=arm.pop("prior_steps"), latent_dim=512, layers=2,
                               semantic_steps=arm.pop("semantic_steps"), **flags)
    prepared = time.perf_counter() - t0
    res = qp.evaluate_transfer(assets, ladder=True, semantic_guidance=True, **arm)
    wall = time.perf_counter() - t0
    d512 = {k.__name__: k.launches - arm64[k.__name__] for k in counted}
    print(f"  quality (d512 semantic arm): {wall:.4f} s on {card}; corpus, prior and "
          f"discriminator {prepared:.4f} s; stage seconds {json.dumps(res['seconds'])}; "
          f"launches {d512}", flush=True)
    print(f"  quality (d512 semantic arm) table: {quality_table(res)}", flush=True)
    reps = [res["pre"], *res["ladder"].values()]
    check(d512["fused_encoder_layer"] == quality_kernel1(1, 0, 2 + len(res["ladder"]) - 1),
          "quality (d512 semantic arm): kernel 1 launched in the finetune and every demo")
    check(len(res["ladder"]) == SEMANTIC_ARM["finetune_steps"] // SEMANTIC_ARM["save_interval"]
          and all(r["root_horizontal_max_abs_err"] < 1e-4 for r in reps)
          and all(math.isfinite(v) for r in reps for v in r.values()),
          "quality (d512 semantic arm): root error < 1e-4 and finite metrics at pre and every "
          "rung")
    return {k.__name__: k.launches for k in counted}


def profile_finetune(args_of) -> None:
    """One more short finetune run (2 steps, --fused_train_store 1) under
    torch.profiler: device time by kernel name over the whole CLI run
    (neutral generation included), the device's busy time against the run's
    wall time. Its launches are not the main path's and are not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from motionstyle_torch.cli.finetune_style_diffusion import main as finetune_main

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "style_xia")
        write_xia_corpus(data_dir)
        argv = args_of(data_dir, os.path.join(tmp, "ft"), 2, "--fused_train_store")
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            finetune_main(argv)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total_us = sum(event_device_us(e) for e in events)
    if total_us <= 0:
        print("  profiler: no device time recorded", flush=True)
        return
    print(f"  profiler (2 steps + neutral generation + resample): device busy "
          f"{total_us / 1e6:.4f} s of {wall:.4f} s wall ({100 * total_us / 1e6 / wall:.4g} %); "
          f"top device time by kernel:", flush=True)
    for e in sorted(events, key=lambda e: -event_device_us(e))[:12]:
        print(f"    {event_device_us(e) / 1e3:10.3f} ms {e.count:7d} x  {e.key[:90]}", flush=True)


DEMO_CONTENT = "103neutral_punching.npy"  # a neutral clip of write_xia_corpus's corpus
DEMO_SAMPLES = 8
RESULT_KEYS = {"motion", "text", "lengths", "num_samples", "num_repetitions", "hml"}


def demo_phase(model_path: str, data_dir: str, out_root: str, card: str) -> int:
    """The demo CLI on the finetune phase's model*.pt and args.json (full
    width, DDIM-20 skip 14 early-stopped at t=4), --skip_render, 8 samples,
    once with --fused 1 and once with --quant_int8 1: results.npy's schema
    and shapes, finite values, the content's root_horizontal channels kept,
    each run's kernel launches, and the int8 hml's mean relative deviation
    from the bf16 hml (the JAX package's own bound for an int8 sampling
    chain, tests/test_fused_encoder.py::test_int8_sampling_chain_bounded_
    deviation). Returns kernel 2's launches in its run."""
    import numpy as np
    import torch

    from motionstyle_torch.cli.demo_style_transfer import main as demo_main
    from motionstyle_torch.data.datasets import StyleMotionDataset, get_opt
    from motionstyle_torch.data.masks import get_inpainting_mask
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer, fused_encoder_layer_int8

    ds = StyleMotionDataset(get_opt("stylexia_posrot", data_dir), split="test")
    content, _ = ds.process_np_motion(os.path.join(ds.opt.motion_dir, DEMO_CONTENT))
    keep = np.asarray(get_inpainting_mask("root_horizontal", (1, 181, 1, 76),
                                          dataset="stylexia_posrot"))[0, :, 0, 0] > 0
    root = ds.inv_transform(content)[:, keep]
    hml, launches = {}, {}
    for flag, kernel, other in (("--fused", fused_encoder_layer, fused_encoder_layer_int8),
                                ("--quant_int8", fused_encoder_layer_int8, fused_encoder_layer)):
        # the main path: every count from here to the end of the run
        kernel.launches = other.launches = 0
        t0 = time.perf_counter()
        out = demo_main(["--model_path", model_path, "--input_content", DEMO_CONTENT,
                         "--data_dir", data_dir, "--skip_render", "--num_samples",
                         str(DEMO_SAMPLES), "--output_dir", os.path.join(out_root, flag[2:]),
                         flag, "1", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[flag] = (kernel.launches, other.launches)
        res = np.load(os.path.join(out, "results.npy"), allow_pickle=True).item()
        reps = res["num_repetitions"]
        root_err = float(np.abs(res["hml"][..., keep] - root).max())
        print(f"  demo {flag} 1: whole CLI run {wall:.4f} s on {card}; {kernel.__name__} "
              f"launches {kernel.launches}, {other.__name__} {other.launches}; root_horizontal "
              f"channels max_abs {root_err:.6g} from the content", flush=True)
        check(set(res) == RESULT_KEYS and res["motion"].shape == (DEMO_SAMPLES, 20, 3, 76)
              and res["hml"].shape == (DEMO_SAMPLES, 76, 181)
              and bool(np.isfinite(res["motion"]).all() and np.isfinite(res["hml"]).all()),
              f"demo {flag} 1: results.npy has the JAX schema, motion (8, 20, 3, 76), finite")
        check(root_err <= 1e-5, f"demo {flag} 1: root_horizontal channels equal the content's "
                                "within 1e-5")
        per_rep = 2 * FINETUNE_LAYERS  # 2 denoiser calls x the finetuned model's layers
        check(launches[flag] == (per_rep * reps, 0),
              f"demo {flag} 1: {kernel.__name__} launched {per_rep} x {reps} repetition "
              f"(2 denoiser calls x {FINETUNE_LAYERS} layers), {other.__name__} never")
        hml[flag] = res["hml"]
    dev = float(np.abs(hml["--quant_int8"] - hml["--fused"]).mean()
                / np.abs(hml["--fused"]).mean())
    print(f"  demo: int8 hml against bf16 hml, mean relative deviation {dev:.6g}", flush=True)
    check(dev < 0.1, "demo: int8 hml within mean relative deviation 0.1 of the bf16 hml")
    return launches["--quant_int8"][0]


# ---------------------------------------------------------------------------
# kernel 4 (standalone attention) and kernel 3 (fused DDPM update)
# ---------------------------------------------------------------------------

PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (NVIDIA data sheet)
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 on the tensor cores
ATTN_REL_L2 = 1e-5  # kernel 4 vs its plain version: fp32 sums in another order
# (B, S, D, H) of kernel 4's checks: the serving shape, S = 197 and 600, head
# width 32 (D = 128) and 48 (D = 192, not a multiple of 32) and ragged S (1,
# 33, 513)
ATTN_SHAPES = ((B, S, D, H), (B, 197, D, H), (2, 600, D, H), (B, S, 128, 4), (B, S, 192, 4),
               (4, 1, D, H), (4, 33, D, H), (2, 513, D, H))
PALLAS_ATTN = "MOTIONSTYLE_PALLAS_ATTN"


@contextmanager
def env_var(name: str, value):
    """Set (or, with None, unset) an environment variable for a block."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def attention_bound(b: int, s: int, d: int, h: int, width: int) -> tuple:
    """(bound_ms, bound_by, flops, bytes) of kernel 4: 4 B H S^2 dh operations
    at the fp32 (width 4) or bf16 (width 2) peak against q, k, v and the
    output, 4 B S D x width bytes, at the card's memory rate."""
    flops = 4 * b * h * s * s * (d // h)
    nbytes = 4 * b * s * d * width
    peak = PEAK_FP32_FLOPS if width == 4 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def attention_bound_tensor_cores(b: int, s: int, d: int, h: int, width: int) -> float:
    """Kernel 4's bound (ms) on the route it takes: the split-precision
    tensor-core products (fp32 inputs: 3 TF32 products for q k^T and for
    p v; bf16: q k^T in bf16, p v in 2 TF32 products) against the same
    bytes as attention_bound."""
    flops = 4 * b * h * s * s * (d // h)
    if width == 4:
        t_ops = 3 * flops / PEAK_TF32_FLOPS
    else:
        t_ops = flops / 2 / PEAK_BF16_FLOPS + 2 * (flops / 2) / PEAK_TF32_FLOPS
    return max(t_ops, 4 * b * s * d * width / PEAK_BYTES) * 1e3


def attention_kernel_phase(device) -> dict:
    """Kernel 4 against attention_reference on the card at ATTN_SHAPES, fp32
    and bf16 inputs, q, k, v as column slices of one packed qkv (the
    denoiser's layout), a key padding mask on the last clip (its first key
    kept); gate rel L2 <= ATTN_REL_L2. Gradients through KernelAttention
    bit-equal to the plain version's autograd gradients. Times at the
    serving shape (fp32): the kernel, the plain version and
    scaled_dot_product_attention with the same additive mask; also at
    S = 600. Returns the kernel's record fields."""
    import torch
    import torch.nn.functional as Fn

    from motionstyle_torch.ops import attention as at
    from motionstyle_torch.ops.fused_encoder import additive_key_mask

    gen = torch.Generator().manual_seed(3)
    record = {"max_abs_err": 0.0}
    n0 = at.attention_kernel.launches
    for b, s, d, h in ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(b, s, 3 * d, generator=gen).to(device, dtype)
            q, k, v = qkv.split(d, -1)
            kpm = torch.ones(b, s, dtype=torch.bool)
            kpm[-1, s // 2 + 1:] = False
            mask = additive_key_mask(kpm, kpm.shape[0], kpm.shape[1], device)
            got = at.attention_kernel(q, k, v, h, mask)
            torch.cuda.synchronize()
            want = at.attention_reference(q, k, v, h, mask)
            err, rel = float((got - want).abs().max()), rel_l2(got, want)
            where = f"B={b} S={s} D={d} H={h} {str(dtype)[6:]} (masked)"
            print(f"  attention {where}: max_abs {err:.6g} rel_l2 {rel:.6g}", flush=True)
            check(got.dtype == torch.float32 and got.shape == (b, s, d) and rel <= ATTN_REL_L2,
                  f"attention {where} fp32 out within rel_l2 {ATTN_REL_L2}")
            record["max_abs_err"] = max(record["max_abs_err"], err)
    # the backward is the plain recompute: gradients bit-equal to autograd's
    for b, s, dtype in ((B, S, torch.float32), (2, 600, torch.float32), (B, S, torch.bfloat16)):
        base = torch.randn(b, s, 3 * D, generator=gen).to(device, dtype)
        w = torch.randn(b, s, D, generator=gen).to(device)
        kpm = torch.ones(b, s, dtype=torch.bool)
        kpm[-1, s // 3:] = False
        mask = additive_key_mask(kpm, kpm.shape[0], kpm.shape[1], device)
        grads = []
        for fn in (lambda *a: at.KernelAttention.apply(*a, H, mask),
                   lambda *a: at.attention_reference(*a, H, mask)):
            qkv = base.clone().requires_grad_(True)
            (fn(*qkv.split(D, -1)) * w).sum().backward()
            grads.append(qkv.grad)
        torch.cuda.synchronize()
        check(torch.equal(grads[0], grads[1]),
              f"attention gradients through the kernel's Function bit-equal to the plain "
              f"version's at B={b} S={s} {str(dtype)[6:]}")
    at.attention_kernel.launches = n0  # checks are not the main path's

    def timed(b, s, dtype):
        qkv = torch.randn(b, s, 3 * D, generator=gen).to(device, dtype)
        q, k, v = qkv.split(D, -1)
        kpm = torch.ones(b, s, dtype=torch.bool)
        kpm[-1, s // 2:] = False
        mask = additive_key_mask(kpm, kpm.shape[0], kpm.shape[1], device)
        heads = [t.reshape(b, s, H, D // H).transpose(1, 2) for t in (q, k, v)]
        def kern():
            return at.attention_kernel(q, k, v, H, mask)

        def library():
            return Fn.scaled_dot_product_attention(*heads,
                                                   attn_mask=mask[:, None, None, :].to(dtype))

        with torch.no_grad():
            ms = time_ms(kern)
            plain = time_ms(lambda: at.attention_reference(q, k, v, H, mask))
            lib = time_ms(library)
            dev_us, lib_us = device_us(kern), device_us(library)
        at.attention_kernel.launches = n0
        bound_ms, bound_by, flops, nbytes = attention_bound(b, s, D, H, qkv.element_size())
        tc_ms = attention_bound_tensor_cores(b, s, D, H, qkv.element_size())
        print(f"  attention B={b} S={s} D={D} H={H} {str(dtype)[6:]}: kernel_ms {ms:.6g} "
              f"reference_ms {plain:.6g} library_ms {lib:.6g} (scaled_dot_product_attention, "
              f"the same additive mask) bound_ms {bound_ms:.6g} ({bound_by}: {flops / 1e9:.4g} "
              f"GFLOP at the {'fp32' if dtype == torch.float32 else 'bf16'} peak, "
              f"{nbytes / 1e6:.4g} MB), on the split tensor-core route {tc_ms:.6g}; device "
              f"time (torch.profiler) kernel {dev_us}, scaled_dot_product_attention {lib_us}",
              flush=True)
        return ms, plain, lib, bound_ms, bound_by

    ms, plain, lib, bound_ms, bound_by = timed(B, S, torch.float32)
    record.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound_ms, bound_by=bound_by)
    timed(B, S, torch.bfloat16)
    timed(2, 600, torch.float32)
    return record


def golden_attention_phase(device) -> None:
    """Kernel 4 on the golden prior: the fp32 MDM under
    MOTIONSTYLE_PALLAS_ATTN=1 (8 launches, within GOLDEN_ATOL of the
    reference output); then the full-width fp32 MDM at 599 frames (S = 600),
    B = 2, without the variable: the default dispatch launches kernel 4 for
    S > 512 (8 launches) and the output is within GOLDEN_ATOL of the same
    weights' forward on the CPU (the plain version)."""
    import numpy as np
    import torch

    from motionstyle_torch.ops.attention import attention_kernel

    model, g, _ = golden_model(device)
    with env_var(PALLAS_ATTN, "1"), torch.no_grad():
        attention_kernel.launches = 0
        out = model(torch.as_tensor(g["x"], device=device), torch.as_tensor(g["t"], device=device),
                    torch.as_tensor(g["enc_text"], device=device))
        torch.cuda.synchronize()
        n = attention_kernel.launches
    err = float(np.abs(out.cpu().numpy() - g["out"]).max())
    print(f"  fp32 MDM with {PALLAS_ATTN}=1 vs reference out: max_abs {err:.6g}; "
          f"attention_kernel launches {n}", flush=True)
    check(n == 8 and err <= GOLDEN_ATOL,
          f"golden MDM through kernel 4 (8 launches) within atol {GOLDEN_ATOL}")

    rs = np.random.RandomState(5)
    x = torch.from_numpy((rs.randn(2, 181, 1, 599) * 0.5).astype(np.float32))
    t = torch.tensor([10, 700])
    enc = torch.from_numpy(rs.randn(2, g["enc_text"].shape[-1]).astype(np.float32))
    with env_var(PALLAS_ATTN, None), torch.no_grad():
        attention_kernel.launches = 0
        t0 = time.perf_counter()
        got = model(x.to(device), t.to(device), enc.to(device))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = attention_kernel.launches
        want = model.cpu()(x, t, enc)
    err = float((got.cpu() - want).abs().max())
    print(f"  fp32 MDM at S=600 (599 frames), B=2, default dispatch: attention_kernel launches "
          f"{n}; max_abs {err:.6g} from the CPU forward; card forward {secs:.4f} s (first call)",
          flush=True)
    check(n == 8 and bool(torch.isfinite(got).all()) and err <= GOLDEN_ATOL,
          f"S > 512 routes to kernel 4 by default (8 launches), within atol {GOLDEN_ATOL} of the "
          f"CPU forward")


UNFUSED_PRETRAIN_STEPS = 2


@contextmanager
def profiled_step(n: int, out: dict):
    """Run the n-th PriorTrainer.run_step call (1-based) of the block under
    torch.profiler: out gets its host seconds (up to the loss's host read and
    a synchronize) and its device time, every CUDA kernel summed and kernel
    4's launches apart (us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from motionstyle_torch.train.pretrain import PriorTrainer

    run_step, calls = PriorTrainer.run_step, [0]

    def wrapped(self, batch):
        calls[0] += 1
        if calls[0] != n:
            return run_step(self, batch)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loss = run_step(self, batch)
            float(loss)
            torch.cuda.synchronize()
            out["host_s"] = time.perf_counter() - t0
        rows = [(e.key, event_device_us(e)) for e in prof.key_averages()
                if e.device_type.name == "CUDA"]
        out["device_us"] = sum(us for _, us in rows)
        out["kernel4_us"] = sum(us for name, us in rows if "attention_kernel" in name)
        return loss

    PriorTrainer.run_step = wrapped
    try:
        yield
    finally:
        PriorTrainer.run_step = run_step


def pretrain_unfused_phase(card: str, data_dir: str, tmp_root: str) -> None:
    """The pretrain CLI with --fused_train 0 (the plain layers; full width,
    batch 64) for 2 steps, first without MOTIONSTYLE_PALLAS_ATTN, then with
    it =1 from the same seed: kernel 4 launched 8 times per forward with the
    variable and never without, finite losses, the first loss within rel
    1e-4 of the run without (the dropout masks come from the same
    generator); seconds per step of both, and the second step of each under
    torch.profiler: its device time against its host clock."""
    import csv

    import numpy as np
    import torch

    from motionstyle_torch.cli.pretrain_prior import main as pretrain_main
    from motionstyle_torch.ops.attention import attention_kernel

    layers, seed, batch = FINETUNE_LAYERS, 10, FINETUNE_BATCH
    runs = {}
    for label, value in (("without the variable", None), (f"{PALLAS_ATTN}=1", "1")):
        save_dir = os.path.join(tmp_root, f"prior_unfused_{len(runs)}")
        random.seed(seed)  # the loader's crops and captions
        step2 = {}
        with env_var(PALLAS_ATTN, value), profiled_step(2, step2):
            attention_kernel.launches = 0
            t0 = time.perf_counter()
            pretrain_main(["--dataset", "stylexia_posrot", "--data_dir", data_dir, "--save_dir",
                           save_dir, "--batch_size", str(batch), "--layers", str(layers),
                           "--num_steps", str(UNFUSED_PRETRAIN_STEPS), "--log_interval", "1",
                           "--seed", str(seed), "--fused_train", "0", "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = attention_kernel.launches
        with open(os.path.join(save_dir, "progress.csv")) as f:
            rows = list(csv.DictReader(f))
        losses = [float(r["prior_loss"]) for r in rows]
        secs = [float(r["step_seconds"]) for r in rows]
        print(f"  pretrain --fused_train 0 {label}: {UNFUSED_PRETRAIN_STEPS} steps in "
              f"{wall:.4f} s (whole CLI run on {card}); losses {losses}; step seconds {secs} "
              f"({batch / secs[-1]:.6g} clips/s at the last); attention_kernel launches {n}; "
              f"second step under torch.profiler: host {step2['host_s']:.6g} s, device "
              f"{step2['device_us']:.6g} us, of which kernel 4 {step2['kernel4_us']:.6g} us",
              flush=True)
        check(len(losses) == UNFUSED_PRETRAIN_STEPS and bool(np.isfinite(losses).all()),
              f"pretrain --fused_train 0 {label}: losses finite")
        want = layers * UNFUSED_PRETRAIN_STEPS if value else 0
        check(n == want, f"pretrain --fused_train 0 {label}: kernel 4 launched {want} times "
                         f"({layers} per forward)" if value else
                         f"pretrain --fused_train 0 {label}: kernel 4 never launched")
        runs[label] = losses
    plain, kern = runs.values()
    rel = abs(kern[0] - plain[0]) / abs(plain[0])
    print(f"  first loss with kernel 4 {kern[0]:.8g} against {plain[0]:.8g} (rel {rel:.3g})",
          flush=True)
    check(rel <= 1e-4, "pretrain through kernel 4: first loss within rel 1e-4 of the plain run")


SAMPLER_SHAPE = (64, 181, 1, 196)  # bench.py's throughput shape: Xia C=181, T=196
UPDATE_T = 500  # the chain step whose posterior coefficients the checks use


def update_bound(n: int, masked: bool) -> tuple:
    """(bound_ms, bytes) of kernel 3: x, model_out (and mask, motion) read
    and sample, x0 written once, fp32, at the card's memory rate."""
    nbytes = n * 4 * ((4 if masked else 2) + 2)
    return nbytes / PEAK_BYTES * 1e3, nbytes


def sampler_update_phase(device) -> dict:
    """Kernel 3 against its plain version at SAMPLER_SHAPE with a
    root_horizontal inpainting mask: x0 bit-equal; at sigma 0 the sample
    bit-equal to c1 x0b + c2 x; at sigma 1 within max abs 2e-6; kept
    channels noise-free; the free channels' standardised noise within the
    stated moments; the same seed the same output, seed + 1 another. Times:
    the kernel, the plain version and, for reference, the port's unfused
    update (torch.randn + the DDPM update of diffusion/sampling.py); no one
    PyTorch call computes the function. Returns the kernel's record."""
    import numpy as np
    import torch

    from motionstyle_torch.data.masks import get_inpainting_mask
    from motionstyle_torch.diffusion import ddpm, sampling
    from motionstyle_torch.diffusion.schedule import make_schedule
    from motionstyle_torch.ops.sampler_update import (
        fused_ddpm_update, fused_ddpm_update_reference)

    gen = torch.Generator().manual_seed(4)
    shape = SAMPLER_SHAPE
    x, out0, motion = (torch.randn(shape, generator=gen).to(device) for _ in range(3))
    mask = torch.as_tensor(np.asarray(get_inpainting_mask(
        "root_horizontal", shape, dataset="stylexia_posrot"), np.float32)).to(device).contiguous()
    sched = make_schedule("cosine", 1000, device=device)
    c1, c2 = sched.posterior_mean_coef1[UPDATE_T], sched.posterior_mean_coef2[UPDATE_T]
    one, zero = torch.ones((), device=device), torch.zeros((), device=device)
    n0 = fused_ddpm_update.launches

    got0, xs0 = fused_ddpm_update(x, out0, mask, motion, c1, c2, zero, one, 7)
    got1, xs1 = fused_ddpm_update(x, out0, mask, motion, c1, c2, one, one, 7)
    again, _ = fused_ddpm_update(x, out0, mask, motion, c1, c2, one, one, 7)
    other, _ = fused_ddpm_update(x, out0, mask, motion, c1, c2, one, one, 8)
    torch.cuda.synchronize()
    ref0, rxs0 = fused_ddpm_update_reference(x, out0, mask, motion, c1, c2, zero, one, 7)
    ref1, _ = fused_ddpm_update_reference(x, out0, mask, motion, c1, c2, one, one, 7)
    check(torch.equal(xs0, rxs0) and torch.equal(xs1, rxs0),
          "update: blended x0 bit-equal to the plain version")
    mean = c1 * xs0 + c2 * x
    check(torch.equal(got0, mean) and torch.equal(got0, ref0),
          "update at sigma 0: bit-equal to c1 x0b + c2 x and to the plain version")
    err = float((got1 - ref1).abs().max())
    print(f"  update at sigma 1: max_abs {err:.6g} from the plain version", flush=True)
    check(err <= 2e-6, "update at sigma 1 within max_abs 2e-6 of the plain version")
    kept = mask > 0
    noise = got1 - mean
    check(bool((noise[kept] == 0).all()), "update: kept channels carry exactly no noise")
    z = noise[~kept].double()
    zmean, zstd = float(z.mean()), float(z.std())
    tail = float((z.abs() > 2).double().mean())
    print(f"  update noise over {z.numel()} free elements: mean {zmean:.6g} std {zstd:.6g} "
          f"P(|z| > 2) {tail:.6g}", flush=True)
    check(abs(zmean) < 0.005 and abs(zstd - 1) < 0.005 and abs(tail - 0.0455) <= 0.003,
          "update noise: |mean| < 0.005, |std - 1| < 0.005, P(|z| > 2) within 0.003 of 0.0455")
    check(torch.equal(again, got1) and not torch.equal(other, got1),
          "update: the same seed gives the same output, seed + 1 another")

    t = torch.full((shape[0],), UPDATE_T, dtype=torch.int64, device=device)
    inp = ddpm.Inpainting(mask, motion)
    noise_gen = torch.Generator(device=device).manual_seed(0)

    def unfused():
        pmv = ddpm.p_mean_variance(sched, lambda *_: out0, x, t, {}, inpainting=inp)
        step_noise = torch.randn(shape, generator=noise_gen, device=device)
        return sampling._ddpm_update(pmv, x, t, step_noise, inp)

    def kern():
        return fused_ddpm_update(x, out0, mask, motion, c1, c2, one, one, 7)

    with torch.no_grad():
        ms = time_ms(kern)
        plain = time_ms(lambda: fused_ddpm_update_reference(x, out0, mask, motion, c1, c2, one,
                                                            one, 7), iters=20)
        unfused_ms = time_ms(unfused)
        dev_us, unfused_us = device_us(kern), device_us(unfused)
    fused_ddpm_update.launches = n0  # checks and timings are not the main path's
    bound_ms, nbytes = update_bound(x.numel(), masked=True)
    print(f"  update B={shape[0]} C={shape[1]} T={shape[3]} ({x.numel()} elements): kernel_ms "
          f"{ms:.6g} reference_ms {plain:.6g} unfused update (torch.randn + the DDPM update) "
          f"{unfused_ms:.6g} ms; bound_ms {bound_ms:.6g} (bytes: {nbytes / 1e6:.4g} MB); no one "
          f"PyTorch call computes the update; device time (torch.profiler) kernel call "
          f"{dev_us}, unfused update {unfused_us}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by="bytes",
                library_ms=None, unfused_ms=unfused_ms)


DDPM_SKIP = 950  # a 50-step tail of the 1000-step chain, down to t = 0


def ddpm_fused_phase(card: str, device) -> int:
    """The full-width denoiser with --fused 1 (kernel 1, bf16) on the golden
    prior runs sample_loop(method="ddpm", fused_update=True,
    dump_all_xstart=True) at SAMPLER_SHAPE: the last 50 steps of the
    1000-step chain from the content (skip_timesteps=950, init_image =
    content, root_horizontal inpainting), so t = 0 and its noise-free step
    run. Checks 50 launches of kernel 3, every dumped x0's kept channels
    bit-equal to the content and a finite result; then the same chain with
    fused_update=False and True in turns (fused, unfused, unfused, fused):
    seconds per step and clips/s; then the same tail with the prior under
    quant_int8 (kernel 2, 8 launches a step; the JAX package measures its
    int8 DDPM throughput, bench.py:714): seconds per step and clips/s, its
    kept channels and a finite result. Returns kernel 3's launches."""
    import numpy as np
    import torch

    from motionstyle_torch.data.masks import get_inpainting_mask
    from motionstyle_torch.diffusion import sampling
    from motionstyle_torch.diffusion.ddpm import Inpainting
    from motionstyle_torch.diffusion.schedule import make_schedule
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer, fused_encoder_layer_int8
    from motionstyle_torch.ops.sampler_update import fused_ddpm_update

    model, g, _ = golden_model(device, fused=True, dtype="bfloat16")
    shape = SAMPLER_SHAPE
    rs = np.random.RandomState(6)
    content = torch.from_numpy((rs.randn(*shape) * 0.5).astype(np.float32)).to(device)
    mask = torch.as_tensor(np.asarray(get_inpainting_mask(
        "root_horizontal", shape, dataset="stylexia_posrot"), np.float32)).to(device)
    enc = torch.from_numpy(rs.randn(shape[0], g["enc_text"].shape[-1]).astype(np.float32))
    cond = {"enc_text": enc.to(device)}
    sched = make_schedule("cosine", 1000, device=device)
    steps = sched.num_timesteps - DDPM_SKIP

    def model_fn(x, t, c):
        return model(x, t, c["enc_text"])

    def chain(fused: bool, dump: bool = False, fn=model_fn):
        return sampling.sample_loop(
            sched, fn, cond, torch.Generator(device=device).manual_seed(0), shape=shape,
            init_image=content, method="ddpm", skip_timesteps=DDPM_SKIP,
            inpainting=Inpainting(mask, content), dump_all_xstart=dump, fused_update=fused)

    # the main path: every count from here to the end of the run
    fused_ddpm_update.launches = fused_encoder_layer.launches = 0
    xs = chain(True, dump=True)
    torch.cuda.synchronize()
    launches, layer_launches = fused_ddpm_update.launches, fused_encoder_layer.launches
    keep = mask > 0
    kept_ok = all(torch.equal(x0[keep], content[keep]) for x0 in xs)
    print(f"  ddpm fused_update: {steps} steps, fused_ddpm_update launches {launches}, "
          f"fused_encoder_layer launches {layer_launches}; dumped x0 {tuple(xs.shape)}",
          flush=True)
    check(launches == steps, f"ddpm fused_update: kernel 3 launched once per step ({steps})")
    check(kept_ok, "ddpm fused_update: every dumped x0's kept channels bit-equal to the content")
    check(bool(torch.isfinite(xs).all()), "ddpm fused_update: finite result")

    secs = {True: [], False: []}
    for fused in (True, False, False, True):
        t0 = time.perf_counter()
        out = chain(fused)
        torch.cuda.synchronize()
        secs[fused].append(time.perf_counter() - t0)
        check(bool(torch.isfinite(out).all()), f"ddpm chain fused_update={fused}: finite")
    with torch.no_grad():
        x = torch.randn(shape, generator=torch.Generator().manual_seed(7)).to(device)
        t = torch.full((shape[0],), 10, dtype=torch.int64, device=device)
        rows = device_profile(lambda: model_fn(x, t, cond), iters=10)
    print(f"  ddpm step's denoiser (kernel 1, B={shape[0]} S={shape[3] + 1}): device time "
          f"(torch.profiler) {sum(us for _, us in rows):.6g} us per call; by kernel: " + "; ".join(
              f"{us:.6g} us {name[:60]}" for name, us in rows[:5]), flush=True)
    for fused in (True, False):
        per_step = [s_ / steps for s_ in secs[fused]]
        print(f"  ddpm chain fused_update={fused}, B={shape[0]} T={shape[3]}, {steps} steps "
              f"(kernel 1 denoiser): seconds per step {[round(p, 8) for p in per_step]}, "
              f"clips/s {[round(shape[0] / s_, 4) for s_ in secs[fused]]} over the chain, on "
              f"{card}", flush=True)

    model8, _, _ = golden_model(device, fused=True, quant_int8=True, dtype="bfloat16")

    def model8_fn(x, t, c):
        return model8(x, t, c["enc_text"])

    n8 = fused_encoder_layer_int8.launches
    xs8 = chain(True, dump=True, fn=model8_fn)
    torch.cuda.synchronize()
    launches8 = fused_encoder_layer_int8.launches - n8
    check(launches8 == 8 * steps, f"ddpm int8: kernel 2 launched 8 x {steps} steps")
    check(bool(torch.isfinite(xs8).all()) and all(torch.equal(x0[keep], content[keep])
                                                  for x0 in xs8),
          "ddpm int8: finite, every dumped x0's kept channels bit-equal to the content")
    t0 = time.perf_counter()
    out8 = chain(True, fn=model8_fn)
    torch.cuda.synchronize()
    secs8 = time.perf_counter() - t0
    check(bool(torch.isfinite(out8).all()), "ddpm int8 chain: finite")
    with torch.no_grad():
        rows8 = device_profile(lambda: model8_fn(x, t, cond), iters=10)
    print(f"  ddpm step's denoiser (kernel 2, B={shape[0]} S={shape[3] + 1}): device time "
          f"(torch.profiler) {sum(us for _, us in rows8):.6g} us per call; by kernel: " + "; ".join(
              f"{us:.6g} us {name[:60]}" for name, us in rows8[:5]), flush=True)
    print(f"  ddpm chain int8 (kernel 2 denoiser, fused_update=True), B={shape[0]} "
          f"T={shape[3]}, {steps} steps: seconds per step {secs8 / steps:.8f}, clips/s "
          f"{shape[0] / secs8:.4f} over the chain, on {card}; kernel 2 launches {launches8} in "
          f"the checked run; mean |int8 - bf16| / mean |bf16| of the result "
          f"{float((out8 - out).abs().mean() / out.abs().mean()):.6g}", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from motionstyle_torch import _build  # absent when the script stands alone
    from motionstyle_torch.ops.attention import attention_kernel
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer, fused_encoder_layer_int8

    device = torch.device("cuda")
    with phase("device"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        print(card, flush=True)
        print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
              f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with phase("build"):
        with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:  # one nvcc per source, together
            built = list(pool.map(_build.build, KERNEL_SOURCES))
        for name, (path, secs) in zip(KERNEL_SOURCES, built):
            _build.load(name)
            print(f"  {os.path.relpath(path, ROOT)}: nvcc {secs:.3f} s", flush=True)
        for name in ("fused_encoder", "fused_encoder_train", "fused_encoder_int8"):  # wgmma GEMMs
            print_gemm_registers(built[KERNEL_SOURCES.index(name)][0])
    with phase("kernel"):
        record = kernel_phase(device)
        record_int8 = int8_kernel_phase(device)
    with phase("attention_kernel"):
        record_attn = attention_kernel_phase(device)
    with phase("golden"):
        golden_sd = golden_phase(device)
        golden_attention_phase(device)
    with phase("serve"):
        launches = serve_phase(golden_sd, card, "--fused", waves=4)
    with phase("serve_int8"):
        launches_int8 = serve_phase(golden_sd, card, "--quant_int8", waves=1)
    with phase("serve_unfused"), env_var(PALLAS_ATTN, "1"):
        launches_attn = serve_phase(golden_sd, card, "--fused", waves=1, value=0,
                                    kernel=attention_kernel,
                                    others=(fused_encoder_layer, fused_encoder_layer_int8))
    with phase("sampler_update"):
        record_update = sampler_update_phase(device)
    with phase("ddpm_fused"):
        launches_update = ddpm_fused_phase(card, device)
    with phase("train_kernel"):
        train_records, ms_b1, _ = train_kernel_phase(device)
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "style_xia")
        write_xia_corpus(data_dir)
        with phase("pretrain"):
            prng_counts, prior_path = pretrain_phase(card, data_dir, tmp)
        with phase("pretrain_unfused"):
            pretrain_unfused_phase(card, data_dir, tmp)
        with phase("finetune"):
            launches_recompute, launches_store, launches_par, _, args_of, model_path = \
                finetune_phase(golden_sd, card, ms_b1,
                               {n: r["ms"] for n, r in train_records.items()}, tmp, data_dir,
                               prior_path)
            parallel_unroll_gate(golden_sd, device)
            profile_finetune(args_of)
        with phase("semantic"):
            launches_sem = semantic_phase(card, data_dir, tmp, prior_path, args_of)
        with phase("demo"):
            demo_phase(model_path, data_dir, tmp, card)
        with phase("quality"):
            launches_quality = quality_phase(card, tmp)
    # each kernel's launches on the paths that run it: kernels 5 and 7 on the
    # recompute finetune, kernels 8 and 9 and the shared kernel 6 on the
    # store-probs finetune; then the parallel finetunes, the semantic phase
    # and the quality phase, each counted from 0 around its own run
    recompute_only = ("fused_layer_train_forward", "fused_layer_train_bwd_attn")
    new_paths = (launches_par, launches_sem, launches_quality)
    train_launches = {n: (launches_recompute if n in recompute_only else launches_store)[n]
                      + sum(p[n] for p in new_paths) for n in TRAIN_NAMES}
    launches += sum(p["fused_encoder_layer"] for p in new_paths)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [dict(name="fused_encoder_layer", route="cuda",
                    source="motionstyle_torch/csrc/fused_encoder.cu",
                    replaces="motionstyle/ops/fused_encoder.py:96", launches=launches,
                    **{k: record[k] for k in keys}),
               dict(name="fused_encoder_layer_int8", route="cuda",
                    source="motionstyle_torch/csrc/fused_encoder_int8.cu",
                    replaces="motionstyle/ops/fused_encoder.py:136", launches=launches_int8,
                    **{k: record_int8[k] for k in keys})]
    for name, replaces in TRAIN_KERNELS.items():
        kernels.append(dict(name=name, route="cuda",
                            source="motionstyle_torch/csrc/fused_encoder_train.cu",
                            replaces=replaces, launches=train_launches[name],
                            **{k: train_records[name][k] for k in keys}))
    # kernel 10: its launches are those of kernels 5-9 in prng mode on the
    # prng pretrain run, its main path
    kernels.append(dict(name=PRNG_NAME, route="cuda",
                        source="motionstyle_torch/csrc/fused_encoder_train.cu",
                        replaces=PRNG_REPLACES,
                        launches=sum(prng_counts[n][1] for n in TRAIN_NAMES),
                        **{k: train_records[PRNG_NAME][k] for k in keys}))
    # kernel 3 on the fused DDPM chain, kernel 4 on the unfused server
    kernels.append(dict(name="fused_ddpm_update", route="cuda",
                        source="motionstyle_torch/csrc/sampler_update.cu",
                        replaces="motionstyle/ops/sampler_update.py:45", launches=launches_update,
                        **{k: record_update[k] for k in keys}))
    kernels.append(dict(name="attention_kernel", route="cuda",
                        source="motionstyle_torch/csrc/attention.cu",
                        replaces="motionstyle/ops/attention.py:52", launches=launches_attn,
                        **{k: record_attn[k] for k in keys}))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
