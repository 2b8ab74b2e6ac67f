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
     attention's register-resident and two-pass paths), at head width 48
     at the humanml demo's guided batch B=16, S=197 and at the humanml and
     bandai finetunes' neutral chain B=1, S=197 (both GEMM plans on the card
     equal to the wrapper's mirror, layer_plan); kernel 1 timed at
     B=8, S=77, B=16, S=197 and B=64, S=197 (device time per launch; each
     GEMM launch's tile, grid and cluster beside its bound) beside
     nn.TransformerEncoderLayer and scaled_dot_product_attention; then the int8 layer (kernel 2) against
     its twin with a key padding mask at the serving shape, B=64 S=197, the
     humanml demo's guided batch B=16 S=197 (--quant_int8 1), B=1, S=1 and
     197, D=128, D=384, D=64 with F=64 and D=1024 with F=2048: its
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
  6. arch: MDM's other architectures at full width (d=512, 8 layers,
     humanml's 263 features, T=196, B=8): trans_dec, trans_dec with
     emb_trans_dec and gru on the card against the same seeded weights on
     the CPU (fp32, TF32 off: rel L2 <= 1e-5); trans_dec again under
     MOTIONSTYLE_PALLAS_ATTN=1, kernel 4 launched 8 times a forward (its
     self-attention; the cross-attention has Sq != Sk and stays plain)
     within the golden phase's atol of the plain run; DiffuseTransfer from
     tests/goldens/diffuse_transfer.npz against its golden (atol 2e-4); SMPL
     LBS and rotation2xyz of random_smpl_model, card against CPU; each
     forward's seconds.
  7. serve: the serving CLI's engine (--fused 1, full width: d=512, 8
     layers) behind MotionServer on localhost answers /healthz and
     /v1/sample requests; results are checked and the kernel launches
     counted.
  8. serve_int8: the same with --quant_int8 1, one wave of 4 requests;
     kernel 2 launched 16 times per batch, kernel 1 never.
  9. serve_unfused: the same with --fused 0 (the fp32 plain layers) under
     MOTIONSTYLE_PALLAS_ATTN=1, one wave: kernel 4 launched 16 times per
     batch, kernels 1 and 2 never.
 10. sampler_update: the fused DDPM update (kernel 3) against its plain
     version at B=64, C=181, T=196 with a root_horizontal mask: x0 and the
     sigma-0 sample bit-equal, sigma 1 within 2e-6, kept channels
     noise-free, the noise's moments, seed behaviour; its time, the plain
     version's, an unfused update's and the bound.
 11. ddpm_fused: the 50-step tail of the 1000-step DDPM chain (the golden
     prior through kernel 1, B=64, T=196, root_horizontal inpainting) with
     sample_loop(fused_update=True): 50 launches of kernel 3, every dumped
     x0's kept channels equal to the content; then fused and unfused
     updates in turns, seconds per step and clips/s; then the same tail
     with the prior under quant_int8 (kernel 2), seconds per step and
     clips/s.
 12. train_kernel: the five training kernels (forward, FFN-half and
     attention-half backward, store-probs forward and stored attention-half
     backward) against their twins at the finetune's shapes (B=64 and B=1,
     S=77, full width, dropout masks at rate 0.1 and 0), past the old caps
     (S=197, D=384), at the edges of the forwards' wgmma GEMM tiles and
     clusters (D=64 with one head and F=64, D=1024 with 8 heads, B=3 S=1)
     at S=257 and 300 (the tensor-core attention's tiled route, which
     writes kernel 8's probs there) and at the humanml trainers' B=64,
     S=197 (the CUDA-core attention backward over 197 keys, 19.9 MB of
     stored probs a layer); the store forward's out, a1 and attn
     bit-equal to the forward's, its probs against probs_twin; their
     times, the twins', a library layer's and the card's bounds, and
     kernels 5-9 launch by launch (device time, tile, grid, cluster, the
     weight gradients' slices, bound) at B=64 and B=1 and in prng mode at
     B=64, none of them the WMMA gemm_kernel; two calls of kernels 6, 7
     and 9 on the same inputs bit-equal, and the backward's plan on the card
     equal to the wrapper's mirror at every shape; then the same in prng
     mode (kernel 10: the dropout bits
     regenerated inside the kernels from per-clip seeds, also at rate 0.5),
     with determinism and seed sensitivity, rate 1e-9 against the
     deterministic layer, the keep fraction at rate 0.5, a finite difference
     through the layer with store off and on, and the prng times beside the
     masks times, in turns; prng mode is also checked at the pretrain's
     microbatch (B=32).
 13. pretrain: the prior pretraining CLI at full width (batch 64) on a
     synthetic Xia corpus written from a seed: 4 steps with --fused_train 1,
     4 with --fused_train_prng 1 (like for like: the seconds per step of the
     two dropout modes), then 4 with --fused_train_prng 1 --grad_accum 2
     --ema_rate 0.999 --schedule_sampler loss_second_moment; losses, the
     written mdm.pt, model_pretrained.pt and mdm_ema.pt, seconds per step and
     every kernel's launches, with no mask arrays drawn in the prng runs.
 14. pretrain_unfused: the same CLI with --fused_train 0, 2 steps without
     MOTIONSTYLE_PALLAS_ATTN and 2 with it =1 from the same seed: kernel 4
     launched 8 times per forward with it, never without; the first losses
     within rel 1e-4; seconds per step of both; the second step of each
     under torch.profiler, its device time (kernel 4's apart) beside its host
     clock.
 15. finetune: the finetune CLI (--fused 1, batch 64, full width, the golden
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
     then 2 steps without --skip_render (the noised and clean neutral
     motions as BVH and video, the style example's reconstruction as video:
     the files, each BVH read back, both IK fits on the card against the
     same fits on the CPU, each stage's seconds) and 2 steps with
     --quant_int8 1 (kernel 2 in the gradient-free forwards, kernels 1 and
     5-9 never); then a short store run under torch.profiler.
 16. semantic: the semantic-discriminator CLI at full width (batch 64,
     --fused_train 1) from the pretrain phase's prior for a few steps:
     losses, seconds per step, the frozen prior and style encoder bit-equal,
     kernels 5, 6 and 7 launched 8 times a step; then 2 finetune steps with
     --semantic_guidance 1 from the new checkpoint.
 17. lora: the finetune CLI at full width (batch 64, --fused_train 1
     --lora_rank 8) for 3 steps, the same without LoRA, 2 steps resumed from
     the first run's adapter (in turns: LoRA, plain, LoRA) and one step with
     --fused_train_store 1: the style encoder bit-equal to its start, the
     factors moved, model*.pt (the merge), adapter*.pt and opt*.pt written,
     model*.pt bit-equal to the adapter merged on the card, kernels 5 / 6 /
     7 (8 / 6 / 9) launched 104 / 56 / 56 times a step as without LoRA;
     then the adapter as the demo's --model_path (bit-equal to the merged
     model*.pt's demo), as a serve --styles entry beside a full checkpoint
     and exported and served with --artifact (answers bit-equal, or within
     EXPORT_ATOL for the artifact, of a server of model*.pt; 16 launches of
     kernel 1 a device batch); seconds per step with and without LoRA,
     adapter MB against the encoder's, peak memory.
 18. distill: cli.distill_prior at full width (batch 64) from the pretrain
     phase's mdm.pt, --diffusion_steps 64 --stages 2, 3 steps a stage:
     plain, under MOTIONSTYLE_PALLAS_ATTN=1 (kernel 4 launched 24 times a
     step: 8 layers x 2 teacher forwards + 1 student forward; never
     without the variable) and with --distill_guidance 2 under it: finite
     losses, mdm_32step.pt and mdm_16step.pt loaded back through
     --mdm_path, only the prior moved; the 16-step student and the 64-step
     teacher sampled from the same noise (seconds a clip, rel L2).
 19. demo: the demo CLI on the store run's model*.pt and args.json, 8
     samples, --skip_render, with --fused 1 and with --quant_int8 1:
     results.npy, the kept root channels, the kernels' launches and the
     int8 result's deviation from the bf16 one; then --fused 1 with one
     repetition and without --skip_render: three IK-fitted BVH files (read
     back, finite, (frames, 20)), three renders (mp4, or gif without
     ffmpeg), the IK's tensors on the card and each fit within POST_IK_REL
     of the same fit on the CPU with its error no larger than the start's,
     kernel 1's 16 launches, and the seconds of each foot-skate pass, IK fit
     and render.
 20. styles: the serve CLI (--fused 1, --deterministic 1, full width) with
     the recompute and store finetunes' checkpoints as two named styles (a,
     b), 4 waves of 4 requests with the styles interleaved (p50, p95,
     clips/s), then a 300-frame clip on /v1/stream (5 windows: the seconds
     to the first chunk and to the whole) and /v1/sample: each style's
     answers bit-equal to a single-style server's, kernel 1 launched 16
     times per device batch (one style each), the drained stream equal to
     /v1/sample with the content's root channels at every frame, and
     --style_strength 0 answering with the base (the finetunes' seeded
     start) bit for bit.
 21. export: cli.export_model at full width for cuda with --fused 1, then
     --quant_int8 1, the second style stored beside the first (seconds, MB);
     serve --artifact: kernel 1 (2) as 16 custom-operator nodes of the
     loaded program and launched 16 times per batch, a live server and the
     artifact in turns over the same waves, answers within EXPORT_ATOL and
     both p50s.
 22. demo_long: the demo CLI with --long_frames 240 on a 260-frame clip the
     smoke writes (4 windows, 2 samples, the post chain at 240 frames), then
     --style_strength 0.5 and 1 (root-exact, different motions).
 23. humanml: the humanml data path at full width (batch 64, 196-frame
     clips: S=197, 263 features) on a synthetic HumanML3D-layout corpus
     that eval/quality_protocol.make_corpus writes from a seed:
     prepare_dataset on tests/goldens/prepare_xia.bvh against its golden;
     pretrain_prior --dataset humanml, 3 steps --fused_train 1, then 2
     --fused_train_prng 1; from that prior finetune_style_diffusion
     --dataset humanml, 2 steps --fused_train 1 and 1 --fused_train_store 1
     (the neutral content the prior's whole 1000-step chain at B=1: 8000
     kernel-1 launches, read from the counter); the humanml demo (8
     samples, the content generated by the prior's guided 1000-step chain
     at B=16): --fused 1, --quant_int8 1, --forecast_stride 4,
     --parallel_window 64 and --long_frames 240, each --skip_render, then
     one render run (no BVH, three renders); one serve wave of 4 humanml
     requests; a 1-step bandai-2 finetune and its demo. Each checks finite
     losses and outputs, the files, the kept root channels equal to the
     content's (the generated content's on humanml) and every kernel's
     launches, with seconds per step and stage and peak memory.
 24. eval: the T2M evaluation stack (item 9) on the humanml phase's corpus
     and first prior and the distill phase's student: train_evaluator
     --dataset humanml (196-frame clips, batch 32, 20 AE + 40 match steps:
     finite losses, s/step), its finest.tar in the port's wrapper on the
     card and on the CPU (co-embeddings at B=64, T=196 within rel L2 1e-5,
     TF32 switched on outside the wrapper's fp32 scope); eval_metrics on the
     prior (--split train, batch 32, 64 samples, guided: B=64, S=197) with
     the full 1000-step DDPM through kernel 1 (--fused 1), DDIM-50 through
     kernel 2 (--quant_int8 1), DDIM-10 through kernel 4 (--fused 0 under
     MOTIONSTYLE_PALLAS_ATTN=1), then --forecast_stride 4 with
     multimodality (32 samples x 3 repeats) over 2 replications: each dict
     finite with the JAX CLI's keys, the sampler called as the protocol
     asks (the batches for 64 samples, the multimodality batches 3 times,
     per replication), each call on 32 clips at a (B, S) where the kernel
     phases hold the run's kernel against its twin (kernel 1 at B=64 with
     S=197 and S=77, kernel 2 at B=64, S=197, kernel 4 at B=64, S=197),
     the kernel launched 8 x calls x steps (read from the counter, the
     steps from the run's grid) and no other kernel, seconds and clips/s;
     an evaluator trained on Xia, and with it the distill
     phase's 16-step student (ddim16 of 64) against its 64-step teacher;
     train_t2m_generator --dataset humanml at its default widths, 3 length
     and 3 CompV6 steps, --run_eval over 8 captions against the humanml
     evaluator: finite losses, t2m_generator.pkl, finite metrics, no kernel.
 25. item12: the host pieces (ROADMAP item 12) at full width: whether
     tensorboardX imports; the finetune CLI (batch 64, --fused_train_store 1,
     4 steps) at its default --train_platform_type (or NoPlatform, after
     checking that the default raises ImportError naming tensorboardX where
     it is missing) with --native_loader 1 --prefetch 2 --profile DIR: 104 /
     56 / 56 launches of kernels 8 / 6 / 9 a step, finite losses, the event
     file's Loss/loss, the trace's 10 largest device entries and its
     host-to-device and device-to-host copies; the numpy loader and native +
     prefetch in turns (numpy, native, native, numpy), the loop's seconds a
     step between step starts; the native batches of 64 against the numpy
     twin's (float32 rounding) and through PrefetchLoader (bit-equal, in
     order), each assembly's host ms and the g++ flags that took; the demo
     with --profile (a trace, 16 kernel-1 launches); Joints2SMPL at SMPL's
     size (6890 vertices, 24 joints, 10 betas) on a seeded 196-frame FK clip
     of 22 joints, 150 iterations, on the card and on the CPU (seconds, the
     joint error before and after, rel L2 of the joints, gated at
     POST_IK_REL, and of pose, betas and camera); fit_seq (--chunk 64
     --save_obj 1) and render_mesh --results at their CLI defaults; joints2bvh,
     motions2hik, plot_3d_array and render_mesh_frames.
 26. item11: scale-out (ROADMAP item 11) at full width on the one card.
     Which collectives gloo takes on CUDA tensors there (printed first). (a)
     torchrun --standalone --nproc_per_node 2 of the finetune CLI with
     --data_parallel 1 --fused 1 --fused_train 1 at a global batch of 64:
     two ranks share the card over gloo; each rank launches kernels 5 / 6 /
     7 104 / 56 / 56 times a step; the losses within rtol 1e-3 of a world-1
     run of the same command (tests/test_fsdp.py:281). (b) the finetune
     trainer with fsdp on a world-1 NCCL mesh and --fused_train's kernels,
     against the plain trainer: losses within rtol 1e-3; its DCP checkpoint
     restored into a plain trainer, parameters and Adam moments bit-equal.
     (c) the demo at --model_parallel 2 over two ranks on the card (plain
     layers split over 'model', gloo's CUDA all-reduce), within atol 1e-4 of
     the world-1 demo (tests/test_parallel.py:97); without a CUDA all-reduce
     in gloo it prints why and runs no such arm. Each arm's seconds. No
     scaling is measured: the ranks share one card.
 27. quality: the port's quality protocol (eval/quality_protocol.py) through
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

import glob
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
# D = 1024 with 8 heads and F = 2048 (the largest cluster), B=3, S=1
# (M = 3: one tile, nearly all rows TMA's zero fill); the humanml demo's
# guided batch, B=16, S=197 (8 samples, the cond and uncond halves of
# classifier-free guidance), and the humanml and bandai finetunes' neutral
# chain and final resample, B=1, S=197; the eval phase's guided batch on
# Xia (eval_metrics --batch_size 32: B = 2 x 32, S=77); the GEMM plans of
# these three held to the wrapper's mirror (ops/fused_encoder.py::layer_plan)
GUIDED_LAYER = (16, 197)
NEUTRAL_LAYER = (1, 197)
EVAL_XIA_LAYER = (64, S)
KERNEL_EXTRA_SHAPES = ((B, 197, D, H, F), (B, 300, D, H, F), (B, S, 128, 4, F),
                       (B, S, 384, 6, 1536), (B, S, 64, 1, 64), (B, S, 1024, 8, 2048),
                       (3, 1, D, H, F), (*GUIDED_LAYER, D, H, F), (*NEUTRAL_LAYER, D, H, F),
                       (*EVAL_XIA_LAYER, D, H, F))
# the inference layer at the DDPM chain's shape (bench.py's B=64, T=196: S=197),
# at the edges of its attention's two paths: S=1 and 256 (the score row in
# registers), 257 and 600 (two passes over the key tiles), and at head width
# 48, which no CLI asks for but the kernel takes (not a multiple of 32)
DDPM_LAYER = (64, 197)
KERNEL_ATTENTION_SHAPES = ((*DDPM_LAYER, D, H, F), (B, 1, D, H, F), (B, 256, D, H, F),
                           (B, 257, D, H, F), (B, 600, D, H, F), (B, S, 192, 4, F))
# the int8 layer (kernel 2) against its twin: the serving shape, the DDPM
# chain's B=64, S=197 (128-row tiles), the humanml demo's guided batch under
# --quant_int8 1 (B=16, S=197), serving bucket 1 (B=1), S=1 and 197,
# head width 32, D = 384 with 6 heads, and at the edges of its GEMMs: D = 64
# with F = 64 (K = 64 under a stage's 128 int8 values: TMA's zero fill) and
# D = 1024 with F = 2048 (a LayerNorm cluster of 8 at BN = 128); rel L2 on
# the fp32 output (the two differ by summation order, and a code flip where
# that moves a value across a rounding tie)
INT8_SHAPES = ((B, S, D, H, F), (*DDPM_LAYER, D, H, F), (*GUIDED_LAYER, D, H, F),
               (1, S, D, H, F), (B, 1, D, H, F),
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

    for b, s in (GUIDED_LAYER, NEUTRAL_LAYER, EVAL_XIA_LAYER):
        layer_plan_check(b, s, D, F)
    x = torch.randn(*GUIDED_LAYER, D, generator=gen).to(device, torch.bfloat16)
    with torch.no_grad():
        print(f"  B={GUIDED_LAYER[0]} S={GUIDED_LAYER[1]} (the humanml demo's guided batch): "
              f"kernel 1 device time {device_us(lambda: fused_encoder_layer(x, p, H))} a "
              "layer", flush=True)

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


def layer_plan_check(b: int, s: int, d: int, f: int) -> list:
    """Kernel 1's GEMM plan as its C launcher picks it on this card
    (fused_encoder_layer_plan), checked against the wrapper's plain mirror
    (ops.fused_encoder.layer_plan): tile, grid and cluster of each launch."""
    import torch

    from motionstyle_torch.ops.fused_encoder import layer_plan

    plans = gemm_plan(b, s, d, f)
    mirror = layer_plan(b, s, d, f, torch.cuda.get_device_properties(0).multi_processor_count)
    same = all((c["bm"], c["bn"], c["grid_x"], c["grid_y"], c["cluster"])
               == (py["bm"], py["bn"], py["gx"], py["gy"], py["cluster"])
               for c, py in zip(plans, mirror))
    print(f"  layer plan B={b} S={s}: " + "; ".join(
        f"{n} {c['bm']}x{c['bn']} grid {c['grid_x']}x{c['grid_y']} cluster {c['cluster']}"
        for n, c in zip(GEMM_LAUNCHES, plans)), flush=True)
    check(same, f"layer plan B={b} S={s} D={d} F={f}: the C launcher's equals the wrapper's "
                "mirror")
    return plans


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
# heads and F = 2048 (the largest cluster), B=3, S=1 (M = 3); S = 257
# and 300, where the tensor-core attention takes its two-pass tiled route
# and writes kernel 8's probs from there (and kernels 7 and 9's attention
# backward its tiled rows path); and the humanml trainers' B=64, S=197 (the
# attention backward's rows launch with 13 chunks of keys in registers,
# kernel 8's stored probs 64 x 4 x 197^2 x 2 B = 19.9 MB a layer)
HUMANML_TRAIN = (64, 197)
TRAIN_EXTRA_SHAPES = ((16, 197, D, H, F), (16, S, 384, 6, 1536), (8, S, 64, 1, 64),
                      (8, S, 1024, 8, 2048), (3, 1, D, H, F), (4, 257, D, H, F),
                      (4, 300, D, H, F), (*HUMANML_TRAIN, D, H, F))
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
        "attention_bwd_rows_tc", "attention_bwd_cols_tc", "dwqkv_gemm", "dwo_gemm",
        "dx_bwd_gemm", "reduce_rows_kernel"),
    "fused_layer_train_bwd_attn_stored": (
        "dropout_bwd_kernel", "dattn_bwd_gemm", "attention_bwd_rows_tc",
        "attention_bwd_cols_tc", "dwqkv_gemm", "dwo_gemm", "dx_bwd_gemm",
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
    train_bounds' of the three kernels: the tensor-core attention backward's
    rows launch (attention_bwd_rows_tc) counts the scores (kernel 7), dp and
    dq over q*scale (or the stored p), k, v and dattn, its cols launch
    (attention_bwd_cols_tc) dk and dv over q*scale, q, k, v and dattn (the
    function's operands of dk and dv). The launches form dp twice, which the
    bound does not count, and the bf16 p and ds that the rows launch hands
    the cols launch (two S x S planes a head) are the design's scratch, as
    the column sums are."""
    m, mk = b * s, (2 if masked else 0)
    core = 2 * b * s * s * d  # one S x S x D product over all heads
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
            (3 * core, m * d * 2 + m * d * 2 + 2 * m * d * 2 + m * d * 2),
            (2 * core, m * d * 2 + m * d * 2 + 2 * m * d * 2 + m * d * 2 + 2 * m * d * 2),
            *wgrads, dx, reduce_attn],
        "fused_layer_train_bwd_attn_stored": [
            dropout, dattn,
            (2 * core, probs + m * d * 2 + 2 * m * d * 2 + m * d * 2),
            (2 * core, probs + m * d * 2 + m * d * 2 + m * d * 2 + 2 * m * d * 2),
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


def sdpa_backward_us(b: int, s: int, d: int, h: int, device) -> dict:
    """The library yardstick of kernels 7 and 9's attention backward: device
    us of one backward through torch.nn.functional.scaled_dot_product_attention
    (torch.autograd.grad of its output, bf16 q, k, v (B, H, S, dh) and dO)
    with no mask, as the timed kernels run, and with an additive (B, 1, 1, S)
    mask (all zero, so the same function), which keeps SDPA off its
    mask-free backends; None where the profile records no device time."""
    import torch
    import torch.nn.functional as Fn

    gen = torch.Generator().manual_seed(s)
    q, k, v, dout = (torch.randn(b, h, s, d // h, generator=gen).to(device, torch.bfloat16)
                     for _ in range(4))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out = {}
    with torch.enable_grad():
        for label, mask in (("no mask", None),
                            ("additive mask", torch.zeros(b, 1, 1, s, device=device,
                                                          dtype=torch.bfloat16))):
            y = Fn.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            rows = device_profile(
                lambda: torch.autograd.grad(y, (q, k, v), dout, retain_graph=True), iters=10)
            out[label] = sum(us for _, us in rows) if rows else None
    return out


def print_attention_bwd(rows: dict, b: int, s: int, d: int, h: int, f: int, device) -> None:
    """Kernels 7 and 9's two attention launches (device us from
    torch.profiler rows of one call, by kernel) beside their bounds and SDPA's
    backward at the same (B, H, S, dh)."""
    lib = sdpa_backward_us(b, s, d, h, device)
    text = lambda us: "not measured" if us is None else f"{us:.6g} us"  # noqa: E731
    for name in ("fused_layer_train_bwd_attn", "fused_layer_train_bwd_attn_stored"):
        launches = TRAIN_BWD_LAUNCHES[name]
        bounds = dict(zip(launches, train_bwd_gemm_bounds(b, s, d, h, f, masked=True)[name]))
        parts = []
        total = 0.0
        for launch in ("attention_bwd_rows_tc", "attention_bwd_cols_tc"):
            us = sum(u for k, u in rows[name] if launch in k)
            flops, nbytes = bounds[launch]
            bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e6
            total += us
            parts.append(f"{launch} {text(us if rows[name] else None)} (bound {bound:.6g} us)")
        print(f"  {name} attention backward B={b} S={s}: " + ", ".join(parts)
              + f"; together {text(total if rows[name] else None)}; library SDPA backward "
              f"(bf16, H={h}, dh={d // h}): no mask {text(lib['no mask'])}, additive mask "
              f"{text(lib['additive mask'])}", flush=True)


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
    B=32); times at B=64, rate 0.1. Every backward half is called twice on
    the same inputs at every shape and must give the same bits. Kernels 6, 7
    and 9 are timed launch by launch beside their bounds at B=64 and B=1,
    S=77, and kernels 7 and 9 also at the humanml trainers' B=64, S=197, their
    two attention launches beside SDPA's backward at both B=64 shapes.
    Returns each kernel's record fields by name and the kernels' times at
    B=1."""
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
    humanml_inputs = {}
    for b, s, d, h, f in TRAIN_EXTRA_SHAPES:
        layer = random_layer(gen, d, f, device)
        for prng in (False, True):
            inputs = check_train_kernels(layer, b, s, d, h, f, 0.1, gen, device, records,
                                         prng=prng)
            if (b, s, d) == (*HUMANML_TRAIN, D):
                humanml_inputs[prng] = (layer, inputs)
    check_prng_limits(p, gen, device)
    prng_finite_difference(device)

    def runs_at(inputs, p=p):
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

    # the humanml trainers' shape: each kernel's device time, masks and prng
    # mode; kernels 7 and 9 launch by launch beside their bounds, and the
    # attention backward's two launches beside SDPA's backward
    with torch.no_grad():
        for prng, (layer, inputs) in sorted(humanml_inputs.items()):
            print(f"  B={HUMANML_TRAIN[0]} S={HUMANML_TRAIN[1]} "
                  f"({'prng' if prng else 'masks'}) device time: " + "; ".join(
                      f"{n} {device_us(kern)}"
                      for n, (kern, _) in runs_at(inputs, layer).items()), flush=True)
        layer, inputs = humanml_inputs[False]
        runs = runs_at(inputs, layer)
        attn_rows = {}
        for name in ("fused_layer_train_bwd_attn", "fused_layer_train_bwd_attn_stored"):
            attn_rows[name] = device_profile(runs[name][0], iters=10)
            print(f"  {name} (masks) B={HUMANML_TRAIN[0]} S={HUMANML_TRAIN[1]}:", flush=True)
            print_train_bwd_launches(name, attn_rows[name], *HUMANML_TRAIN, D, H, F, masked=True)
    print_attention_bwd(attn_rows, *HUMANML_TRAIN, D, H, F, device)

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
            attn_rows = {}
            for name in TRAIN_BWD_LAUNCHES:
                rows = attn_rows[name] = device_profile(runs[name][0], iters=10)
                print(f"  {name} ({mode}) B={bb} S={S}:", flush=True)
                print_train_bwd_launches(name, rows, bb, S, D, H, F, masked=mode == "masks")
            if (bb, mode) == (b, "masks"):
                print_attention_bwd(attn_rows, bb, S, D, H, F, device)
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
        engine, decode, handle, _ = serve.build_engine(args)
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
    from the pretrain phase's prior (prior_path); then 2 steps of
    --fused_train 1 without --skip_render (the post chain's files and stages,
    check_post_outputs) and 2 with --quant_int8 1 (kernel 2 at inference,
    the plain layers in training). Each run's counts are set to 0 just
    before it and read just after. Returns each masks path's
    training kernel launches, the launches of the parallel, rendering
    (without --skip_render) and int8 (--quant_int8 1) runs, the prng run's
    counts, the function that builds the CLI's arguments and the store run's
    last model*.pt."""
    import csv

    import numpy as np
    import torch

    from motionstyle_torch.cli import finetune_style_diffusion as finetune_cli
    from motionstyle_torch.cli.finetune_style_diffusion import main as finetune_main
    from motionstyle_torch.models.denoiser import MDMConfig, StyleDiffusion
    from motionstyle_torch.models.params import convert_encoder, seeded_init_
    from motionstyle_torch.ops import fused_encoder_train as ft
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer, fused_encoder_layer_int8

    steps, layers, seed = FINETUNE_STEPS, FINETUNE_LAYERS, 10
    counted = [getattr(ft, n) for n in TRAIN_NAMES] + [fused_encoder_layer,
                                                       fused_encoder_layer_int8]
    mdm_path = os.path.join(tmp_root, "mdm_golden.pt")
    torch.save({k: torch.as_tensor(v) for k, v in golden_sd.items()}, mdm_path)

    def finetune_args(data_dir: str, save_dir: str, num_steps: int, train_flag: str,
                      prior: str = mdm_path, extra=(), skip_render: bool = True) -> list:
        return ["--dataset", "stylexia_posrot", "--data_dir", data_dir, "--mdm_path", prior,
                "--save_dir", save_dir, "--fused", "1", train_flag, "1",
                "--batch_size", str(FINETUNE_BATCH), "--layers", str(layers),
                "--num_steps", str(num_steps), *(["--skip_render"] if skip_render else []),
                "--train_platform_type", "NoPlatform", "--seed", str(seed), "--device", "cuda",
                *extra]

    def run(train_flag: str, save_root: str, steps: int = steps, prior: str = mdm_path,
            extra=(), skip_render: bool = True) -> dict:
        label = " ".join([f"{train_flag} 1", *extra] + ([] if skip_render else ["(render)"]))
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
                                               extra, skip_render))
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
                    model_path=os.path.join(save_dir, ckpts[-1]), label=label,
                    save_dir=save_dir)

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

    # the post chain: 2 steps without --skip_render, IK on the card
    post_steps = 2
    with post_stage_watch(finetune_cli) as stages:
        rendered = run("--fused_train", os.path.join(tmp_root, "ft_render"), post_steps,
                       skip_render=False)
    files = sorted(os.listdir(rendered["save_dir"]))
    print(f"  {rendered['label']}: writes {files}", flush=True)
    style_frames = clip_length(data_dir, STYLE_EXAMPLE)
    check_post_outputs(rendered["save_dir"], FINETUNE_POST_FILES, stages,
                       {f: style_frames for f in FINETUNE_POST_FILES if f.endswith(".bvh")},
                       "finetune without --skip_render", fits=2, renders=3, passes=1)
    fwd_r, bwd_r = layers * (1 + 2 * unroll) * post_steps, layers * (1 + unroll) * post_steps
    want_r = dict.fromkeys(TRAIN_NAMES, 0)
    want_r.update(fused_layer_train_forward=fwd_r, fused_layer_train_bwd_ffn=bwd_r,
                  fused_layer_train_bwd_attn=bwd_r)
    check({n: rendered["launches"][n] for n in TRAIN_NAMES} == want_r
          and rendered["launches"]["fused_encoder_layer"] == layers * (100 + unroll),
          f"{rendered['label']}: training kernel launches == {want_r}, kernel 1 8 x 106")
    # fault E repaired: under --quant_int8 1 the gradient-free forwards run
    # kernel 2 and the training forwards the plain layers (no kernel 5-9)
    int8 = run("--fused_train", os.path.join(tmp_root, "ft_int8"), post_steps,
               extra=["--quant_int8", "1"])
    got8 = {n: int8["launches"][n] for n in TRAIN_NAMES + ("fused_encoder_layer_int8",
                                                          "fused_encoder_layer")}
    print(f"  {int8['label']}: launches {got8}; losses {int8['losses']}", flush=True)
    check(got8 == dict(dict.fromkeys(TRAIN_NAMES, 0), fused_encoder_layer=0,
                       fused_encoder_layer_int8=layers * (100 + unroll)),
          f"{int8['label']}: kernel 2 launched 8 x (100 neutral DDPM steps + 6 DDIM steps), "
          "kernels 1 and 5-9 never (the training forwards on the plain layers)")
    for k in counted:
        parallel[k.__name__] += rendered["launches"][k.__name__] + int8["launches"][k.__name__]
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


# ---------------------------------------------------------------------------
# LoRA style adapters and progressive distillation of the prior
# ---------------------------------------------------------------------------

LORA_RANK = 8
LORA_STEPS = 6  # a run's steps; its median after the first times the arm
DISTILL_STEPS = 3  # steps a stage; 2 stages: 64 -> 32 -> 16 DDIM steps
DISTILL_SAMPLES = 8
# kernel 4's distill run against the plain one: fp32 both, the same draws.
# Each step's loss within DISTILL_LOSS_REL; each student's movement from
# the prior within DISTILL_MOVE_REL (rel L2): Adam's first steps move each
# weight by about lr·sign(g), so the weights whose gradient is rounding
# noise (k's bias: softmax ignores it) take opposite signs in the two runs,
# while a wrong attention gradient turns every weight under the attention.
DISTILL_LOSS_REL, DISTILL_MOVE_REL = 1e-4, 0.1


@contextmanager
def lora_watch(out: dict):
    """Around each StyleFinetuneTrainer's life: when it is built, copies of
    its style encoder and its LoRA factors (out["start"]: the factors); when
    it saves, the encoder's parameters that are not bit-equal to the copy
    (out["base_changed"]) and the factors' largest movement
    (out["factor_moved"])."""
    import torch

    from motionstyle_torch.train import finetune

    trainer = finetune.StyleFinetuneTrainer
    init, save = trainer.__init__, trainer.save

    def watched_init(self, *a, **k):
        init(self, *a, **k)
        self._base_copy = {n: p.detach().clone()
                           for n, p in self.model.style_encoder.named_parameters()}
        out["start"] = self._factor_copy = {
            (site, n): p.detach().clone() for site, pair in (self.lora or {}).items()
            for n, p in pair.items()}

    def watched_save(self):
        params = dict(self.model.style_encoder.named_parameters())
        out["base_changed"] = [n for n, v in self._base_copy.items()
                               if not torch.equal(params[n].detach(), v)]
        out["factor_moved"] = max((float((self.lora[s][n].detach() - v).abs().max())
                                   for (s, n), v in self._factor_copy.items()), default=0.0)
        return save(self)

    trainer.__init__, trainer.save = watched_init, watched_save
    try:
        yield
    finally:
        trainer.__init__, trainer.save = init, save


def lora_phase(mdm_path: str, card: str, data_dir: str, tmp_root: str, finetune_args,
               style_path: str) -> dict:
    """LoRA style adapters at full width (d=512, 8 layers, batch 64): the
    finetune CLI with --fused_train 1 --lora_rank 8 for LORA_STEPS steps from
    the golden prior (mdm_path), the same without LoRA, then LORA_STEPS
    resumed from the first run's adapter, then the plain run again (the
    turns: LoRA, plain, LoRA, plain), then one step with --fused_train_store
    1 --lora_rank 8. Checks: the style
    encoder's own parameters bit-equal from the trainer's start to each save,
    the factors moved; model*.pt, adapter*.pt and opt*.pt written; model*.pt
    bit-equal to the adapter merged onto the run's seeded start on the card
    (model_util.style_encoder_state, the serving CLIs' path); kernels 5, 6
    and 7 (8, 6 and 9 with store) launched 104 / 56 / 56 times a step, as
    without LoRA; the resumed run started from the adapter's factors. Then
    the adapter as the demo's --model_path (8 samples, bit-equal to the demo
    of the merged model*.pt), as a --styles entry of the serve CLI beside
    the full checkpoint style_path, and exported (cli.export_model) and
    served with --artifact: answers bit-equal (merged on the card) or within
    EXPORT_ATOL (the artifact) of a server of the merged model*.pt, kernel 1
    launched 16 times a device batch. Prints seconds per step with and
    without LoRA, the adapter's size against the encoder's, and peak memory.
    Returns the launches of kernels 1, 2 and 5-9 on the phase's main
    paths."""
    import csv

    import numpy as np
    import torch

    from motionstyle_torch.cli import export_model, model_util
    from motionstyle_torch.cli.demo_style_transfer import main as demo_main
    from motionstyle_torch.cli.finetune_style_diffusion import main as finetune_main
    from motionstyle_torch.models import lora
    from motionstyle_torch.models.denoiser import MDMConfig
    from motionstyle_torch.models.params import convert_encoder
    from motionstyle_torch.ops import fused_encoder_train as ft
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer, fused_encoder_layer_int8
    from motionstyle_torch.serve.export import custom_ops_in

    layers, seed, unroll = FINETUNE_LAYERS, 10, 6
    counted = [getattr(ft, n) for n in TRAIN_NAMES] + [fused_encoder_layer,
                                                       fused_encoder_layer_int8]
    total = dict.fromkeys((k.__name__ for k in counted), 0)
    rank = ["--lora_rank", str(LORA_RANK)]

    def run(label, save_root, steps, train_flag="--fused_train", extra=()) -> dict:
        watch = {}
        torch.cuda.reset_peak_memory_stats()
        random.seed(seed)  # the loader's crops and captions
        # the main path: every count from here to the end of the run
        for k in counted:
            k.launches = 0
        _zero_counts(ft)
        t0 = time.perf_counter()
        with lora_watch(watch):
            save_dir = finetune_main(finetune_args(data_dir, save_root, steps, train_flag,
                                                   extra=extra))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in counted}
        for n in total:
            total[n] += launches[n]
        with open(os.path.join(save_dir, "progress.csv")) as f:
            rows = list(csv.DictReader(f))
        losses = [float(r["loss"]) for r in rows]
        secs = [float(r["step_seconds"]) for r in rows]
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"  {label}: {steps} steps in {wall:.4f} s (whole CLI run on {card}); losses "
              f"{losses}; step seconds {secs}; peak memory {peak:.4g} GB", flush=True)
        check(len(losses) == steps and bool(np.isfinite(losses).all()),
              f"{label}: losses finite")
        return dict(label=label, save_dir=save_dir, launches=launches, secs=secs, peak=peak,
                    watch=watch, losses=losses)

    def want(steps: int, store: bool = False) -> dict:
        fwd, bwd = layers * (1 + 2 * unroll) * steps, layers * (1 + unroll) * steps
        out = dict.fromkeys(TRAIN_NAMES, 0)
        f_name, attn_name = (TRAIN_NAMES[3], TRAIN_NAMES[4]) if store else (TRAIN_NAMES[0],
                                                                            TRAIN_NAMES[2])
        out.update({f_name: fwd, TRAIN_NAMES[1]: bwd, attn_name: bwd,
                    "fused_encoder_layer": layers * (100 + unroll),
                    "fused_encoder_layer_int8": 0})
        return out

    lora_run = run("--fused_train 1 --lora_rank 8", os.path.join(tmp_root, "ft_lora"),
                   LORA_STEPS, extra=rank)
    plain = run("--fused_train 1", os.path.join(tmp_root, "ft_plain"), LORA_STEPS)
    resumed = run("--fused_train 1 --lora_rank 8 (resumed)", os.path.join(tmp_root, "ft_lora2"),
                  LORA_STEPS, extra=[*rank, "--resume_checkpoint", lora_run["save_dir"]])
    plain2 = run("--fused_train 1 (again)", os.path.join(tmp_root, "ft_plain2"), LORA_STEPS)
    store = run("--fused_train_store 1 --lora_rank 8", os.path.join(tmp_root, "ft_lora_store"),
                1, "--fused_train_store", rank)

    # B = 0 at the start: the merge is the base, and the factors draw from a
    # generator of their own, so the first step is the plain run's
    first = [r["losses"][0] for r in (lora_run, plain, store)]
    print(f"  first losses (LoRA, plain, LoRA store): {first}", flush=True)
    check(first[0] == first[1] and abs(first[2] - first[0]) <= 1e-6 * abs(first[0]),
          "lora: the first loss equals the plain run's (a fresh adapter merges to the base); "
          "the store run's within rel 1e-6")
    save_dir = lora_run["save_dir"]
    step = f"{LORA_STEPS:09d}"
    adapter = os.path.join(save_dir, f"adapter{step}.pt")
    merged_path = os.path.join(save_dir, f"model{step}.pt")
    files = sorted(os.listdir(save_dir))
    check({f"model{step}.pt", f"adapter{step}.pt", f"opt{step}.pt"} <= set(files),
          f"lora: writes model{step}.pt, adapter{step}.pt and opt{step}.pt ({files})")
    for r in (lora_run, resumed, store):
        w = r["watch"]
        print(f"  {r['label']}: style encoder parameters changed {w.get('base_changed')}; "
              f"factors moved by max_abs {w.get('factor_moved', 0.0):.6g}", flush=True)
        check(w.get("base_changed") == [] and w.get("factor_moved", 0.0) > 0.0,
              f"{r['label']}: the style encoder bit-equal to its start, the factors moved")
    merged = convert_encoder(torch.load(merged_path, map_location="cpu"), "seqTransEncoder",
                             layers)
    cfg = MDMConfig(njoints=181, nfeats=1, latent_dim=merged["layers.0.norm1.weight"].numel(),
                    num_layers=layers)
    remerged = model_util.style_encoder_state(cfg, adapter, seed, "cuda")
    check(merged.keys() == remerged.keys()
          and all(torch.equal(merged[k], remerged[k]) for k in merged),
          "lora: model*.pt bit-equal to adapter*.pt merged onto the run's seeded start on the "
          "card")
    opt = torch.load(os.path.join(save_dir, f"opt{step}.pt"), weights_only=False)
    check(len(opt) == 1 + 2 * 2 * 4 * layers,
          f"lora: opt*.pt holds Adam's count, mu and nu of the {2 * 4 * layers} factors")
    factors, alpha = lora.import_lora(torch.load(adapter, map_location="cpu"))
    start = resumed["watch"]["start"]
    check(all(torch.equal(start[(s, n)].cpu(), factors[s][n]) for s in factors
              for n in ("a", "b")),
          "lora: the resumed run started from the adapter's factors, bit for bit")
    for r, w, store_path in ((lora_run, want(LORA_STEPS), False), (plain, want(LORA_STEPS), False),
                             (resumed, want(LORA_STEPS), False),
                             (plain2, want(LORA_STEPS), False), (store, want(1, True), True)):
        print(f"  {r['label']}: launches {r['launches']}", flush=True)
        check(r["launches"] == w, f"{r['label']}: launches == {w} (kernels "
                                  f"{'8, 6, 9' if store_path else '5, 6, 7'}: 104 / 56 / 56 a "
                                  "step; kernel 1 8 x (100 + 6))")
    n_factors = sum(p.numel() for pair in factors.values() for p in pair.values())
    size = os.path.getsize(adapter) / 1e6, os.path.getsize(merged_path) / 1e6
    print(f"  lora: rank {LORA_RANK}, alpha {alpha}: {n_factors} factors; adapter {size[0]:.4f} MB "
          f"against the style encoder's {size[1]:.4f} MB ({size[1] / size[0]:.4g}x)", flush=True)
    print(f"  lora in turns (LoRA, plain, LoRA resumed, plain), seconds per step after the "
          f"first, peak memory, on {card}:", flush=True)
    for r in (lora_run, plain, resumed, plain2, store):
        tail = r["secs"][1:] or r["secs"]
        print(f"    {r['label']}: {r['secs']} (median after the first "
              f"{float(np.median(tail)):.6g} s); {r['peak']:.4g} GB", flush=True)
    arms = {name: [x for r in runs for x in r["secs"][1:]]
            for name, runs in (("LoRA", (lora_run, resumed)), ("plain", (plain, plain2)))}
    med = {name: float(np.median(x)) for name, x in arms.items()}
    print(f"  lora s/step, median of {len(arms['LoRA'])} steps an arm in turns: LoRA "
          f"{med['LoRA']:.6g} (range {min(arms['LoRA']):.6g}-{max(arms['LoRA']):.6g}), plain "
          f"{med['plain']:.6g} (range {min(arms['plain']):.6g}-{max(arms['plain']):.6g}): "
          f"{100 * (med['LoRA'] / med['plain'] - 1):+.4g} % on {card}", flush=True)

    # the adapter as the demo's --model_path, against the merged model*.pt
    hml = {}
    for label, path in (("adapter", adapter), ("merged", merged_path)):
        fused_encoder_layer.launches = fused_encoder_layer_int8.launches = 0
        t0 = time.perf_counter()
        out = demo_main(["--model_path", path, "--input_content", DEMO_CONTENT, "--data_dir",
                         data_dir, "--skip_render", "--num_samples", str(DEMO_SAMPLES),
                         "--output_dir", os.path.join(tmp_root, f"demo_lora_{label}"),
                         "--fused", "1", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = np.load(os.path.join(out, "results.npy"), allow_pickle=True).item()
        got = (fused_encoder_layer.launches, fused_encoder_layer_int8.launches)
        if label == "adapter":
            total["fused_encoder_layer"] += got[0]
        print(f"  demo --model_path {os.path.basename(path)} --fused 1: whole CLI run "
              f"{wall:.4f} s on {card}; kernel launches (1, 2) {got}", flush=True)
        check(got == (2 * layers * res["num_repetitions"], 0)
              and res["motion"].shape == (DEMO_SAMPLES, 20, 3, 76)
              and bool(np.isfinite(res["hml"]).all()),
              f"demo with the {label}: (8, 20, 3, 76) finite, kernel 1 launched 16 times a "
              "repetition")
        hml[label] = res["hml"]
    check(np.array_equal(hml["adapter"], hml["merged"]),
          "demo: the adapter's samples bit-equal to the merged model*.pt's")

    # serving: the adapter as a --styles entry beside a full checkpoint, and
    # exported with the adapter as --model_path; a server of model*.pt the yardstick
    rng = np.random.RandomState(3)
    contents = [rng.randn(76, 181).astype(np.float32) * 0.5 for _ in range(4)]
    ref, dec_ref, _, _ = served(["--mdm_path", mdm_path, "--fused", "1", "--model_path",
                                 merged_path])
    try:
        want_motion = [ref.sample(dec_ref({"content": c, "seed": i}))
                       for i, c in enumerate(contents)]
    finally:
        ref.close()
    export_dir = os.path.join(tmp_root, "artifact_lora")
    t0 = time.perf_counter()
    export_model.main(["--model_path", adapter, "--mdm_path", mdm_path, "--fused", "1",
                       "--platforms", "cuda", "--output", export_dir, "--device", "cuda"])
    export_s = time.perf_counter() - t0
    for label, argv, style, atol in (
            ("--styles lora=adapter", ["--mdm_path", mdm_path, "--fused", "1", "--model_path",
                                       style_path, "--styles", f"lora={adapter}"], "lora", 0.0),
            ("--artifact of the adapter", ["--artifact", export_dir], None, EXPORT_ATOL)):
        engine, decode, _, _ = served(argv)
        try:
            # the main path: every count from here to the end of the requests
            fused_encoder_layer.launches = fused_encoder_layer_int8.launches = 0
            device_batches = count_device_batches(engine)
            t0 = time.perf_counter()
            got_motion = [engine.sample(decode({"content": c, "seed": i, "style": style}))
                          for i, c in enumerate(contents)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = (fused_encoder_layer.launches, fused_encoder_layer_int8.launches)
            nodes = custom_ops_in(engine.sampler.program) if style is None else None
        finally:
            engine.close()
        total["fused_encoder_layer"] += got[0]
        diff = max(float(np.abs(g - w).max()) for g, w in zip(got_motion, want_motion))
        print(f"  serve {label}: {len(contents)} requests in {wall:.4f} s on {card}; max_abs "
              f"{diff:.6g} from the merged model*.pt's server; kernel launches (1, 2) {got} "
              f"over {len(device_batches)} device batches", flush=True)
        check(diff <= atol, f"serve {label}: answers within {atol} of serving the merged "
                            "model*.pt" + (" (bit-equal: both merged on the card)" if not atol
                                           else ""))
        check(got == (2 * layers * len(device_batches), 0) and len(device_batches) == 4,
              f"serve {label}: kernel 1 launched {2 * layers} times a device batch")
        if nodes is not None:
            check(nodes == ["motionstyle.fused_encoder_layer.default"] * 2 * layers,
                  f"the adapter's artifact calls kernel 1's operator {2 * layers} times")
    size = sum(os.path.getsize(os.path.join(dp, f))
               for dp, _, fs in os.walk(export_dir) for f in fs)
    print(f"  export of the adapter (--fused 1, cuda): {export_s:.4f} s, {size / 1e6:.4f} MB on "
          f"{card}", flush=True)
    return total


@contextmanager
def distill_watch(out: dict):
    """Around each ProgressiveDistiller's life: a copy of the model's
    parameters when it is built; at each save the parameters outside the
    prior that are not bit-equal to the copy (out["changed"]) and the prior's
    largest movement (out["mdm_moved"])."""
    import torch

    from motionstyle_torch.diffusion import distillation

    cls = distillation.ProgressiveDistiller
    init, save = cls.__init__, cls.save

    def watched_init(self, *a, **k):
        init(self, *a, **k)
        self._copy = {n: p.detach().clone() for n, p in self.model.named_parameters()}

    def watched_save(self, n_steps):
        params = dict(self.model.named_parameters())
        out["changed"] = [n for n, v in self._copy.items() if not n.startswith("mdm.")
                          and not torch.equal(params[n].detach(), v)]
        out["mdm_moved"] = max(float((params[n].detach() - v).abs().max())
                               for n, v in self._copy.items() if n.startswith("mdm."))
        return save(self, n_steps)

    cls.__init__, cls.save = watched_init, watched_save
    try:
        yield
    finally:
        cls.__init__, cls.save = init, save


def distill_phase(card: str, data_dir: str, tmp_root: str, prior_path: str) -> int:
    """cli.distill_prior at full width (d=512, 8 layers, batch 64) from the
    pretrain phase's mdm.pt with --diffusion_steps 64 --stages 2 and
    DISTILL_STEPS steps a stage: once plain, once under
    MOTIONSTYLE_PALLAS_ATTN=1 and once with --distill_guidance 2 under it.
    Checks: finite losses; mdm_32step.pt and mdm_16step.pt written and loaded
    back through --mdm_path; only the prior's weights moved; kernel 4
    launched 8 layers x (2 teacher forwards + 1 student forward) = 24 times
    a step under the variable (the guided teacher's two halves in one
    forward of twice the batch), never without it. Then the stage-2 student
    sampled on its 16-step DDIM grid and the teacher on 64 from the same
    noise: seconds per clip of each and their rel L2. Kernel 4's run is held
    to the plain one (the same seeds, j and noise draws): each step's loss
    within DISTILL_LOSS_REL, each student's movement from the prior within
    DISTILL_MOVE_REL. Returns kernel 4's launches."""
    import csv

    import numpy as np
    import torch

    from motionstyle_torch.cli import model_util
    from motionstyle_torch.cli.distill_prior import main as distill_main, parse_args
    from motionstyle_torch.diffusion import sampling
    from motionstyle_torch.diffusion.schedule import make_schedule
    from motionstyle_torch.ops.attention import attention_kernel

    layers, seed = FINETUNE_LAYERS, 10
    total = 0

    def argv(save_dir, *extra):
        return ["--dataset", "stylexia_posrot", "--data_dir", data_dir, "--mdm_path",
                prior_path, "--save_dir", save_dir, "--batch_size", str(FINETUNE_BATCH),
                "--layers", str(layers), "--diffusion_steps", "64", "--stages", "2",
                "--steps_per_stage", str(DISTILL_STEPS), "--log_interval", "1", "--seed",
                str(seed), "--device", "cuda", *extra]

    runs = {}
    for label, variable, extra in (("plain", None, ()), (f"{PALLAS_ATTN}=1", "1", ()),
                                   (f"--distill_guidance 2, {PALLAS_ATTN}=1", "1",
                                    ("--distill_guidance", "2"))):
        save_dir = os.path.join(tmp_root, f"distill_{len(runs)}")
        watch = {}
        random.seed(seed)  # the loader's crops and captions
        with env_var(PALLAS_ATTN, variable), distill_watch(watch):
            # the main path: every count from here to the end of the run
            attention_kernel.launches = 0
            t0 = time.perf_counter()
            paths = distill_main(argv(save_dir, *extra))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = attention_kernel.launches
        total += launches
        with open(os.path.join(save_dir, "progress.csv")) as f:
            rows = list(csv.DictReader(f))
        losses = [float(r[k]) for r in rows for k in ("distill_64_loss", "distill_32_loss")
                  if r.get(k)]
        secs = [float(r["step_seconds"]) for r in rows]
        steps = 2 * DISTILL_STEPS
        print(f"  distill {label}: {steps} steps in {wall:.4f} s (whole CLI run on {card}); "
              f"losses {losses}; step seconds {secs}; kernel 4 launches {launches}; prior "
              f"moved by max_abs {watch.get('mdm_moved', 0.0):.6g}, other parameters changed "
              f"{watch.get('changed')}", flush=True)
        check(len(losses) == steps and bool(np.isfinite(losses).all()),
              f"distill {label}: losses finite")
        check([os.path.basename(p) for p in paths] == ["mdm_32step.pt", "mdm_16step.pt"],
              f"distill {label}: writes mdm_32step.pt and mdm_16step.pt")
        check(watch.get("changed") == [] and watch.get("mdm_moved", 0.0) > 0.0,
              f"distill {label}: only the prior's weights moved")
        per_step = layers * (2 + 1)
        check(launches == (per_step * steps if variable else 0),
              f"distill {label}: kernel 4 launched "
              + (f"{per_step} times a step ({layers} layers x (2 teacher forwards + 1 student "
                 "forward))" if variable else "never without the variable"))
        runs[label] = (paths, secs, losses)

    # kernel 4 forward and backward inside the training step, held to the plain run
    (plain_paths, _, plain_losses), (attn_paths, _, attn_losses) = (
        runs["plain"], runs[f"{PALLAS_ATTN}=1"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(attn_losses, plain_losses))
    print(f"  distill {PALLAS_ATTN}=1 against plain: losses max rel {loss_rel:.6g}",
          flush=True)
    check(loss_rel <= DISTILL_LOSS_REL,
          f"distill: kernel 4's losses within rel {DISTILL_LOSS_REL} of the plain run's")
    prior = torch.load(prior_path, map_location="cpu")
    for plain_path, attn_path in zip(plain_paths, attn_paths):
        want_sd, got_sd = (torch.load(q, map_location="cpu") for q in (plain_path, attn_path))
        keys = [k for k in prior if k in want_sd and prior[k].is_floating_point()]
        moved = rel_l2(torch.cat([(got_sd[k] - prior[k]).flatten() for k in keys]),
                       torch.cat([(want_sd[k] - prior[k]).flatten() for k in keys]))
        print(f"  distill {PALLAS_ATTN}=1 against plain: {os.path.basename(plain_path)}'s "
              f"movement from the prior rel L2 {moved:.6g}", flush=True)
        check(moved <= DISTILL_MOVE_REL,
              f"distill: kernel 4's {os.path.basename(plain_path)} moved within rel L2 "
              f"{DISTILL_MOVE_REL} of the plain run's")

    # the students load back through --mdm_path; the stage-2 student on its
    # 16-step grid against the teacher on 64, from the same noise
    paths = plain_paths
    models = {}
    for name, path in (("teacher", prior_path), ("student 32", paths[0]),
                       ("student 16", paths[1])):
        args = parse_args(argv(os.path.join(tmp_root, "distill_load"), "--mdm_path", path))
        args.semantic_discriminator_path = args.model_path = ""
        bundle = model_util.build_model(args, device="cuda")
        sd = torch.load(path, map_location="cpu")
        loaded = bundle.model.mdm.state_dict()
        check(all(torch.equal(loaded[k].cpu(), v) for k, v in sd.items()),
              f"distill: {os.path.basename(path)} loads back through --mdm_path")
        models[name] = bundle
    enc = torch.as_tensor(models["teacher"].encode_text(["a person walks"] * DISTILL_SAMPLES,
                                                         "stylexia_posrot"), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randn((DISTILL_SAMPLES, 181, 1, 76), generator=gen, device="cuda")
    out = {}
    for name, n in (("teacher", 64), ("student 16", 16)):
        model = models[name].model
        sched = make_schedule("cosine", 64, None if n == 64 else f"ddim{n}", device="cuda")
        fn = lambda x, t, c, m=model: m.denoise_prior(x, t, c["enc_text"])  # noqa: E731
        sampling.sample_loop(sched, fn, {"enc_text": enc}, gen, noise=noise, method="ddim",
                             shape=tuple(noise.shape))  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = sampling.sample_loop(sched, fn, {"enc_text": enc}, gen, noise=noise,
                                         method="ddim", shape=tuple(noise.shape))
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / DISTILL_SAMPLES
        print(f"  distill: {name} on its {n}-step DDIM grid: {secs:.6g} s a clip "
              f"({DISTILL_SAMPLES} clips, 76 frames, on {card})", flush=True)
        check(out[name].shape == noise.shape and bool(torch.isfinite(out[name]).all()),
              f"distill: the {name}'s samples finite")
    print(f"  distill: stage-2 student (16 steps) against the teacher (64 steps) from the same "
          f"noise: rel L2 {rel_l2(out['student 16'], out['teacher']):.6g}", flush=True)
    print("  distill seconds per step after the first: " + "; ".join(
        f"{label} {float(np.median(secs[1:])):.6g}" for label, (_, secs, _) in runs.items())
          + f" on {card}", flush=True)
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


# ---------------------------------------------------------------------------
# the post chain: foot-skate cleanup and renders on the host, IK on
# the card
# ---------------------------------------------------------------------------

STYLE_EXAMPLE = "350angry_jumping.npy"  # the finetune's default style example
FINETUNE_POST_FILES = ("generated_neutral_motion.bvh", "generated_neutral_motion00",
                       "generated_noised_neutral_motion.bvh",
                       "generated_noised_neutral_motion00", "style_example_rec00")
DEMO_POST_FILES = ("input_content_motion.bvh", "input_style_example.bvh",
                   "out_transferred_motion.bvh", "input_content_motion00",
                   "input_style_motion00", "output_transferred_motion00_rep00")
# the IK fit on the card against the same fit on the CPU: rel L2 of the
# fitted joints (fp32 FK in another order through 100 Adam steps, whose
# first steps divide by the gradient's own magnitude)
POST_IK_REL = 1e-3


def clip_length(data_dir: str, name: str) -> int:
    """The frames a CLI takes from a clip of the corpus (the 76-frame window)."""
    from motionstyle_torch.data.datasets import StyleMotionDataset, get_opt

    ds = StyleMotionDataset(get_opt("stylexia_posrot", data_dir), split="test")
    return int(ds.process_np_motion(os.path.join(ds.opt.motion_dir, name))[1])


@contextmanager
def post_stage_watch(module):
    """Wrap the post chain's three entry points where a CLI module calls them
    (remove_fs, fit_joints_bvh, plot_3d_motion): each call's seconds and each
    fit's inputs and result, {name: [record, ...]}; restored on exit."""
    import numpy as np

    stages = {"remove_fs": [], "fit_joints_bvh": [], "plot_3d_motion": []}
    saved = {n: getattr(module, n) for n in stages}

    def timed(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)  # a fit ends in a copy to the host: synchronised
            rec = {"s": time.perf_counter() - t0}
            if name == "fit_joints_bvh":  # (path, initial_data, skeleton, real_offsets, glb)
                rec.update(data=np.array(a[1]), skeleton=a[2], offsets=a[3],
                           target=np.array(a[4]), result=out)
            stages[name].append(rec)
            return out
        return call

    for n, fn in saved.items():
        setattr(module, n, timed(n, fn))
    try:
        yield stages
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def check_ik_fits(fits: list, label: str) -> None:
    """Each fit's tensors on the card, its joints within POST_IK_REL of the
    same fit on the CPU, and its error to the target no larger than the
    start's."""
    import torch

    from motionstyle_torch.core.features import recover_root_rot_pos
    from motionstyle_torch.post.ik import fit_hmlvec_ik

    for i, f in enumerate(fits):
        res, skel, offs = f["result"], f["skeleton"], f["offsets"]
        check(all(t.is_cuda for t in res), f"{label}: IK fit {i}'s tensors on the card")
        cpu = fit_hmlvec_ik(torch.as_tensor(f["data"]), skel, offs, torch.as_tensor(f["target"]),
                            iters=100)
        j, data = skel.njoints, torch.as_tensor(f["data"])
        q0, p0 = recover_root_rot_pos(data)
        start = skel.forward_kinematics_real_cont6d(
            data[..., 4 + (j - 1) * 3:].reshape(data.shape[:-1] + (j, 6)), p0, q0, offs)
        card = skel.forward_kinematics_real_cont6d(res.cont6d.cpu(), res.r_pos.cpu(),
                                                   res.r_rot_quat.cpu(), offs)
        host = skel.forward_kinematics_real_cont6d(cpu.cont6d, cpu.r_pos, cpu.r_rot_quat, offs)
        target = torch.as_tensor(f["target"])
        rel = rel_l2(card, host)
        before, after = (float((x - target).abs().mean()) for x in (start, card))
        print(f"  {label}: IK fit {i} ({len(data)} frames, 100 Adam steps) {f['s']:.4f} s on "
              f"{res.cont6d.device}; joints vs the CPU fit rel L2 {rel:.6g}; mean |error| "
              f"{before:.6g} -> {after:.6g}", flush=True)
        check(rel <= POST_IK_REL, f"{label}: IK fit {i} on the card within rel L2 "
                                  f"{POST_IK_REL} of the CPU fit")
        check(after <= before, f"{label}: IK fit {i}'s error after <= before")


def check_post_outputs(out_dir: str, names, stages: dict, bvh_frames: dict, label: str,
                       fits: int, renders: int, passes: int = 0) -> None:
    """The post chain's files in out_dir (a .bvh as named, a render as .mp4
    or .gif), each BVH read back as (frames, 20) and finite, the calls of each
    stage, the IK fits (check_ik_fits) and each stage's seconds."""
    import numpy as np

    from motionstyle_torch.post.bvh import read_bvh

    files = set(os.listdir(out_dir))
    for name in names:
        found = name in files if name.endswith(".bvh") else bool(
            {name + ".mp4", name + ".gif"} & files)
        check(found, f"{label}: writes {name}" + ("" if name.endswith(".bvh") else ".mp4/.gif"))
    for name, frames in bvh_frames.items():
        anim = read_bvh(os.path.join(out_dir, name))
        check(anim.shape == (frames, 20) and bool(np.isfinite(anim.quats).all()
                                                  and np.isfinite(anim.pos).all()),
              f"{label}: {name} reads back as ({frames}, 20), finite")
    got = {n: len(v) for n, v in stages.items()}
    want = {"remove_fs": passes, "fit_joints_bvh": fits, "plot_3d_motion": renders}
    check(got == want, f"{label}: post calls {want} (got {got})")
    check_ik_fits(stages["fit_joints_bvh"], label)
    print(f"  {label}: stage seconds: " + "; ".join(
        f"{n} {[round(r['s'], 4) for r in v]}" for n, v in stages.items()), flush=True)


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
    deviation). Then once more with --fused 1 and without --skip_render:
    the post chain's files and stages (check_post_outputs: three IK fits on
    the card against the CPU's, two foot-skate passes, three renders).
    Returns kernel 2's launches in its run."""
    import numpy as np
    import torch

    from motionstyle_torch.cli import demo_style_transfer as demo_cli
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

    # the post chain: --fused 1, one repetition, without --skip_render
    label = "demo --fused 1 (render)"
    fused_encoder_layer.launches = fused_encoder_layer_int8.launches = 0
    t0 = time.perf_counter()
    with post_stage_watch(demo_cli) as stages:
        out = demo_main(["--model_path", model_path, "--input_content", DEMO_CONTENT,
                         "--data_dir", data_dir, "--num_samples", str(DEMO_SAMPLES),
                         "--output_dir", os.path.join(out_root, "render"), "--fused", "1",
                         "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (fused_encoder_layer.launches, fused_encoder_layer_int8.launches)
    res = np.load(os.path.join(out, "results.npy"), allow_pickle=True).item()
    print(f"  {label}: whole CLI run {wall:.4f} s on {card}; writes {sorted(os.listdir(out))}; "
          f"kernel launches (1, 2) {got}", flush=True)
    check(got == (2 * FINETUNE_LAYERS * res["num_repetitions"], 0) and res["num_repetitions"] == 1,
          f"{label}: kernel 1 launched {2 * FINETUNE_LAYERS} times in its one repetition, "
          "kernel 2 never")
    check(set(res) == RESULT_KEYS and bool(np.isfinite(res["hml"]).all()),
          f"{label}: results.npy unchanged in schema, finite")
    content_frames = clip_length(data_dir, DEMO_CONTENT)
    check_post_outputs(out, DEMO_POST_FILES, stages, {
        "input_content_motion.bvh": content_frames, "out_transferred_motion.bvh": content_frames,
        "input_style_example.bvh": clip_length(data_dir, STYLE_EXAMPLE)}, label, fits=3,
        renders=3, passes=2)
    return launches["--quant_int8"][0]


# ---------------------------------------------------------------------------
# the rest of serving: named styles, /v1/stream, exported artifacts, and the
# demo's long-form and style-strength runs
# ---------------------------------------------------------------------------

STYLE_WAVES = 4  # waves of 4 concurrent requests, the named styles interleaved
STREAM_FRAMES = 300  # 5 windows of 76 at overlap 10
# an artifact's answers against live serving's, max abs on the served motion:
# the loaded program runs the eager ops and the same kernels on the same
# noise, so they are bit-equal where the export keeps the eager ops (0 on the
# CPU, tests/test_torch_export.py); the bound leaves room for a library op
# that the program runs in another algorithm
EXPORT_ATOL = 1e-5
DEMO_LONG_FRAMES = 240  # a long clip's frames the demo restyles: 4 windows


def served(argv: list, device: str = "cuda") -> tuple:
    """(engine, decode, handle, stream) of the serve CLI for argv on
    `device`, warmed up."""
    import numpy as np

    from motionstyle_torch.cli import serve

    engine, decode, handle, stream = serve.build_engine(serve.parse_args(
        ["--dataset", "stylexia_posrot", "--max_wait_ms", "20", "--port", "0",
         "--deterministic", "1", "--device", device, *argv]))
    engine.warmup(decode({"content": np.zeros((76, 181), np.float32)}), log=False)
    return engine, decode, handle, stream


def count_device_batches(engine) -> list:
    """Wrap engine._run so that each device batch appends its size to the
    returned list: the batcher's own counter counts coalesced groups, which
    the engine splits into one device batch per style."""
    sizes, run = [], engine._run

    def counted(items):
        sizes.append(len(items))
        return run(items)

    engine._run = counted
    return sizes


def http_waves(base: str, contents: list, waves: int, styles: tuple) -> tuple:
    """`waves` waves of 4 concurrent /v1/sample requests, request i of a wave
    asking for styles[i % len(styles)] (None: the served model's own).
    Returns ({(wave, i): motion}, {(wave, i): latency in ms}, wall seconds)."""
    import numpy as np

    results, latencies, lock = {}, {}, threading.Lock()

    def client(wave, i):
        payload = {"content": contents[i].tolist(), "text": "a person walks angrily",
                   "seed": 100 * wave + i}
        if styles[i % len(styles)] is not None:
            payload["style"] = styles[i % len(styles)]
        res, dt = _post(base, payload)
        with lock:
            results[(wave, i)] = np.asarray(res["motion"], np.float32)
            latencies[(wave, i)] = dt * 1e3

    t0 = time.perf_counter()
    for wave in range(waves):
        threads = [threading.Thread(target=client, args=(wave, i)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        check(not any(t.is_alive() for t in threads), f"wave {wave} answered")
    return results, latencies, time.perf_counter() - t0


def percentiles(latencies: dict) -> tuple:
    import numpy as np

    lat = np.asarray(list(latencies.values()))
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 95))


def stream_request(base: str, content, seed: int, style) -> tuple:
    """/v1/stream a long clip: ([(offset, (C, 1, t) chunk)], seconds to the
    first chunk, seconds to the done line)."""
    import numpy as np

    payload = {"content": content.tolist(), "text": "a person walks angrily", "seed": seed,
               "style": style}
    req = urllib.request.Request(base + "/v1/stream", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    chunks, first, t0 = [], None, time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        for raw in r:
            obj = json.loads(raw)
            if "error" in obj:
                check(False, f"/v1/stream answers without an error line ({obj['error']})")
            if obj.get("done"):
                check(obj["chunks"] == len(chunks), "/v1/stream's done line counts its chunks")
                break
            if first is None:
                first = time.perf_counter() - t0
            chunks.append((obj["offset"], np.asarray(obj["motion"], np.float32)))
    return chunks, first, time.perf_counter() - t0


def styles_phase(mdm_path: str, card: str, style_paths: tuple, tmp_root: str,
                 device: str = "cuda") -> int:
    """Named styles and long-form streaming through the serve CLI at full
    width (--fused 1, --deterministic 1): a server of the finetune phase's
    two checkpoints (--model_path a, --styles a=a,b=b) answers STYLE_WAVES
    waves of 4 requests with the styles interleaved, and a
    STREAM_FRAMES-frame clip on /v1/stream and /v1/sample. Checks: each
    style's answers bit-equal to a single-style server's for the same seeds;
    kernel 1 launched 16 times per batch; the drained stream equal to
    /v1/sample, its root channels the content's at every frame; under
    --style_strength 0 every style answers with the base (the finetune's
    seeded start, written as a checkpoint). Returns kernel 1's launches."""
    import numpy as np
    import torch

    from motionstyle_torch.data.masks import get_inpainting_mask
    from motionstyle_torch.models.denoiser import MDMConfig, StyleDiffusion
    from motionstyle_torch.models.params import export_style_encoder, seeded_init_
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer, fused_encoder_layer_int8
    from motionstyle_torch.serve.engine import Request
    from motionstyle_torch.serve.server import MotionServer

    a, b = style_paths
    common = ["--mdm_path", mdm_path, "--fused", "1", "--model_path", a]
    rng = np.random.RandomState(1)
    contents = [rng.randn(76, 181).astype(np.float32) * 0.5 for _ in range(4)]
    long_content = rng.randn(STREAM_FRAMES, 181).astype(np.float32) * 0.5
    mask = np.asarray(get_inpainting_mask("root_horizontal", (1, 181, 1, 76),
                                          dataset="stylexia_posrot"), np.float32)[0]
    keep = mask[:, 0, 0] > 0
    engine, decode, handle, stream = served(common + ["--styles", f"a={a},b={b}"], device)
    server = MotionServer(engine, port=0, decode=decode, handle=handle,
                          stream=stream).start_background()
    base = f"http://127.0.0.1:{server.port}"
    try:
        # the main path: every count from here to the end of the traffic
        fused_encoder_layer.launches = fused_encoder_layer_int8.launches = 0
        device_batches = count_device_batches(engine)
        results, latencies, wall = http_waves(base, contents, STYLE_WAVES, ("a", "b"))
        p50, p95 = percentiles(latencies)
        chunks, first_s, stream_s = stream_request(base, long_content, 5, "a")
        t0 = time.perf_counter()
        whole, _ = _post(base, {"content": long_content.tolist(),
                                "text": "a person walks angrily", "seed": 5, "style": "a"})
        sample_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        batches = len(device_batches)
        launches, stray = fused_encoder_layer.launches, fused_encoder_layer_int8.launches
    finally:
        server.close()
    print(f"  styles a, b interleaved: {len(results)} requests in {wall:.4f} s: p50 "
          f"{p50:.4f} ms, p95 {p95:.4f} ms, {len(results) / wall:.4f} clips/s on {card}",
          flush=True)
    print(f"  kernel 1 launches {launches} over {batches} device batches (one style each); "
          f"kernel 2 {stray}", flush=True)
    check(launches == 16 * batches and batches > 0 and stray == 0,
          "styles and stream: kernel 1 launched 16 x batches (every style, every window), "
          "kernel 2 never")

    # each style's answers against a server of that style alone
    for name, path in (("a", a), ("b", b)):
        alone, dec1, _, _ = served(["--mdm_path", mdm_path, "--fused", "1", "--model_path", path],
                                   device)
        try:
            diff = 0.0
            for (wave, i), motion in results.items():
                if ("a", "b")[i % 2] != name:
                    continue
                want = alone.sample(dec1({"content": contents[i], "seed": 100 * wave + i,
                                          "text": "a person walks angrily"}))
                diff = max(diff, float(np.abs(motion - want).max()))
        finally:
            alone.close()
        print(f"  style {name} served with another style against alone: max_abs {diff:.6g}",
              flush=True)
        check(diff == 0.0, f"style {name}: answers bit-equal to a single-style server's "
                           "(--deterministic 1)")
    for (wave, i), motion in results.items():
        if not (motion.shape == (181, 1, 76) and np.array_equal(
                motion[keep], contents[i].T[:, None, :][keep])):
            check(False, "styles: every answer (181, 1, 76) with the content's root channels")

    # /v1/stream against /v1/sample
    whole = np.asarray(whole["motion"], np.float32)
    drained = np.concatenate([c for _, c in chunks], axis=-1)
    offsets = [o for o, _ in chunks]
    print(f"  /v1/stream of {STREAM_FRAMES} frames: {len(chunks)} chunks at offsets {offsets}; "
          f"first chunk {first_s:.4f} s, whole stream {stream_s:.4f} s, /v1/sample of the same "
          f"clip {sample_s:.4f} s, on {card}", flush=True)
    check(len(chunks) == 5 and offsets == [0, 76, 142, 208, 274],
          "/v1/stream: 5 windows of 76 at overlap 10")
    check(drained.shape == whole.shape == (181, 1, STREAM_FRAMES)
          and np.array_equal(drained, whole), "/v1/stream drained equals /v1/sample")
    check(np.array_equal(whole[keep], long_content.T[:, None, :][keep]),
          f"long-form: root channels equal the content's at all {STREAM_FRAMES} frames")

    # --style_strength 0: every style answers with the base
    base_path = os.path.join(tmp_root, "style_base", "model000000000.pt")
    os.makedirs(os.path.dirname(base_path), exist_ok=True)
    width = torch.load(a, map_location="cpu")["seqTransEncoder.layers.0.norm1.weight"].numel()
    torch.save(export_style_encoder(seeded_init_(StyleDiffusion(MDMConfig(
        njoints=181, nfeats=1, latent_dim=width, num_layers=FINETUNE_LAYERS)), 10)), base_path)
    zero, dec0, _, _ = served(common + ["--styles", f"b={b}", "--style_strength", "0"], device)
    ref, decr, _, _ = served(["--mdm_path", mdm_path, "--fused", "1", "--model_path", base_path],
                             device)
    try:
        diff = 0.0
        for style in (None, "b"):
            for i, c in enumerate(contents[:2]):
                got = zero.sample(dec0({"content": c, "seed": i, "style": style}))
                want = ref.sample(decr({"content": c, "seed": i}))
                diff = max(diff, float(np.abs(got - want).max()))
    finally:
        zero.close()
        ref.close()
    print(f"  --style_strength 0 against the base checkpoint: max_abs {diff:.6g}", flush=True)
    check(diff == 0.0, "--style_strength 0: every style answers with the base, bit-equal")
    return launches


def export_phase(mdm_path: str, card: str, style_paths: tuple, tmp_root: str,
                 device: str = "cuda") -> tuple:
    """cli.export_model at full width for cuda, --fused 1 and then
    --quant_int8 1, with the second finetuned style stored beside the first;
    then serve --artifact. For each: the export's seconds and size; kernel 1
    (or 2) as 16 custom-operator nodes of the loaded program and launched
    16 times per served batch; a live server and the artifact's answer the
    same waves (styles interleaved; live first, then the artifact), the
    answers within EXPORT_ATOL and the two p50s. Returns kernel 1's and
    kernel 2's launches from the artifacts' traffic."""
    import numpy as np
    import torch

    from motionstyle_torch.cli import export_model
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer, fused_encoder_layer_int8
    from motionstyle_torch.serve.export import custom_ops_in
    from motionstyle_torch.serve.server import MotionServer

    a, b = style_paths
    rng = np.random.RandomState(2)
    contents = [rng.randn(76, 181).astype(np.float32) * 0.5 for _ in range(4)]
    out = {}
    for flag, kernel, other, op in (
            ("--fused", fused_encoder_layer, fused_encoder_layer_int8,
             "motionstyle.fused_encoder_layer.default"),
            ("--quant_int8", fused_encoder_layer_int8, fused_encoder_layer,
             "motionstyle.fused_encoder_layer_int8.default")):
        path = os.path.join(tmp_root, f"artifact_{flag[2:]}")
        t0 = time.perf_counter()
        export_model.main(["--model_path", a, "--mdm_path", mdm_path, flag, "1",
                           "--platforms", device, "--styles", f"b={b}", "--output", path,
                           "--device", device])
        export_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(dp, f))
                   for dp, _, fs in os.walk(path) for f in fs)
        print(f"  export {flag} 1: {export_s:.4f} s, {size / 1e6:.4f} MB "
              f"({sorted(os.listdir(os.path.join(path, 'plans')))}) on {card}", flush=True)
        runs = {}
        for label, argv in (("live", ["--mdm_path", mdm_path, flag, "1", "--model_path", a,
                                      "--styles", f"b={b}"]),
                            ("artifact", ["--artifact", path])):
            engine, decode, handle, _ = served(argv, device)
            server = MotionServer(engine, port=0, decode=decode, handle=handle).start_background()
            try:
                # the main path: every count from here to the end of the traffic
                kernel.launches = other.launches = 0
                device_batches = count_device_batches(engine)
                results, latencies, wall = http_waves(f"http://127.0.0.1:{server.port}",
                                                      contents, STYLE_WAVES, (None, "b"))
                torch.cuda.synchronize()
                runs[label] = dict(results=results, p50p95=percentiles(latencies), wall=wall,
                                   batches=len(device_batches),
                                   launches=(kernel.launches, other.launches))
                if label == "artifact":
                    nodes = custom_ops_in(engine.sampler.program)
            finally:
                server.close()
            p50, p95 = runs[label]["p50p95"]
            slowest = max(latencies, key=latencies.get)
            print(f"  {label} {flag} 1, default and b interleaved: {len(results)} requests: p50 "
                  f"{p50:.4f} ms, p95 {p95:.4f} ms, {len(results) / wall:.4f} clips/s; slowest "
                  f"{latencies[slowest]:.4f} ms (wave {slowest[0]}, request {slowest[1]}); "
                  f"launches (kernel, other) {runs[label]['launches']} over "
                  f"{runs[label]['batches']} batches on {card}", flush=True)
        art = runs["artifact"]
        per_batch = 2 * FINETUNE_LAYERS  # 2 denoiser calls x the finetuned model's layers
        check(nodes == [op] * per_batch,
              f"artifact {flag} 1: the loaded program calls {op} {per_batch} times (2 denoiser "
              f"calls x {FINETUNE_LAYERS} layers; got {len(nodes)})")
        check(art["launches"] == (per_batch * art["batches"], 0) and art["batches"] > 0,
              f"artifact {flag} 1: {kernel.__name__} launched {per_batch} x batches, "
              f"{other.__name__} never")
        diff = max(float(np.abs(art["results"][k] - runs["live"]["results"][k]).max())
                   for k in art["results"])
        print(f"  artifact {flag} 1 against live: max_abs {diff:.6g}", flush=True)
        check(diff <= EXPORT_ATOL, f"artifact {flag} 1: answers within {EXPORT_ATOL} of live "
                                   "serving's")
        out[flag] = art["launches"][0]
    return out["--fused"], out["--quant_int8"]


def demo_long_phase(model_path: str, data_dir: str, out_root: str, card: str,
                    device: str = "cuda") -> int:
    """The demo CLI with --long_frames DEMO_LONG_FRAMES on a clip the smoke
    writes (DEMO_LONG_FRAMES + 20 frames), --fused 1, 2 samples, without
    --skip_render: results.npy over all the frames, the root channels the
    content's at every frame, kernel 1 launched 16 times per window, the post
    chain's outputs at that length; then --style_strength 0.5 and 1 on the
    corpus's clip with --skip_render: both root-exact, different. Returns
    kernel 1's launches."""
    import numpy as np
    import torch

    from motionstyle_torch.cli import demo_style_transfer as demo_cli
    from motionstyle_torch.cli.demo_style_transfer import main as demo_main
    from motionstyle_torch.data.masks import get_inpainting_mask
    from motionstyle_torch.diffusion.longform import plan_windows
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer

    rs = np.random.RandomState(3)
    long_path = os.path.join(out_root, "long_content", "900neutral_walking.npy")
    os.makedirs(os.path.dirname(long_path), exist_ok=True)
    raw = (rs.randn(DEMO_LONG_FRAMES + 20, 181) * 0.5).astype(np.float32)
    np.save(long_path, raw)
    keep = np.asarray(get_inpainting_mask("root_horizontal", (1, 181, 1, 76),
                                          dataset="stylexia_posrot"))[0, :, 0, 0] > 0
    label = f"demo --long_frames {DEMO_LONG_FRAMES} (render)"
    # the main path: every count from here to the end of the run
    fused_encoder_layer.launches = 0
    t0 = time.perf_counter()
    with post_stage_watch(demo_cli) as stages:
        out = demo_main(["--model_path", model_path, "--input_content", long_path,
                         "--data_dir", data_dir, "--num_samples", "2", "--long_frames",
                         str(DEMO_LONG_FRAMES), "--output_dir", os.path.join(out_root, "long"),
                         "--fused", "1", "--device", device])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_encoder_layer.launches
    res = np.load(os.path.join(out, "results.npy"), allow_pickle=True).item()
    windows = plan_windows(DEMO_LONG_FRAMES, 76, 10)[0]
    root_err = float(np.abs(res["hml"][:, :, keep] - raw[:DEMO_LONG_FRAMES, keep]).max())
    print(f"  {label}: whole CLI run {wall:.4f} s on {card}; {windows} windows; kernel 1 "
          f"launches {launches}; root channels max_abs {root_err:.6g} from the content",
          flush=True)
    check(res["motion"].shape == (2, 20, 3, DEMO_LONG_FRAMES)
          and res["hml"].shape == (2, DEMO_LONG_FRAMES, 181)
          and (res["lengths"] == DEMO_LONG_FRAMES).all()
          and bool(np.isfinite(res["motion"]).all() and np.isfinite(res["hml"]).all()),
          f"{label}: results.npy over {DEMO_LONG_FRAMES} frames, finite")
    check(root_err <= 1e-5, f"{label}: root channels equal the content's at every frame")
    check(launches == 2 * FINETUNE_LAYERS * windows,
          f"{label}: kernel 1 launched 2 x {FINETUNE_LAYERS} x {windows} windows")
    check_post_outputs(out, DEMO_POST_FILES, stages, {
        "input_content_motion.bvh": DEMO_LONG_FRAMES,
        "out_transferred_motion.bvh": DEMO_LONG_FRAMES,
        "input_style_example.bvh": clip_length(data_dir, STYLE_EXAMPLE)}, label, fits=3,
        renders=3, passes=2)

    hml = {}
    for strength in ("0.5", "1"):
        fused_encoder_layer.launches = 0
        out = demo_main(["--model_path", model_path, "--input_content", DEMO_CONTENT,
                         "--data_dir", data_dir, "--skip_render", "--num_samples", "2",
                         "--style_strength", strength, "--output_dir",
                         os.path.join(out_root, f"strength_{strength}"), "--fused", "1",
                         "--device", device])
        torch.cuda.synchronize()
        launches += fused_encoder_layer.launches
        check(fused_encoder_layer.launches == 2 * FINETUNE_LAYERS,
              f"demo --style_strength {strength}: kernel 1 launched 2 x {FINETUNE_LAYERS}")
        hml[strength] = np.load(os.path.join(out, "results.npy"), allow_pickle=True).item()["hml"]
        check(bool(np.isfinite(hml[strength]).all()), f"demo --style_strength {strength}: finite")
    moved = float(np.abs(hml["0.5"] - hml["1"]).max())
    root = float(np.abs(hml["0.5"][..., keep] - hml["1"][..., keep]).max())
    print(f"  demo --style_strength 0.5 against 1: max_abs {moved:.6g} (root channels "
          f"{root:.6g})", flush=True)
    check(moved > 0 and root == 0.0, "demo --style_strength 0.5: another motion, the same root")
    return launches


# ---------------------------------------------------------------------------
# kernel 4 (standalone attention) and kernel 3 (fused DDPM update)
# ---------------------------------------------------------------------------

PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (NVIDIA data sheet)
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 on the tensor cores
ATTN_REL_L2 = 1e-5  # kernel 4 vs its plain version: fp32 sums in another order
# (B, S, D, H) of kernel 4's checks: the serving shape, S = 197 and 600, head
# width 32 (D = 128) and 48 (D = 192, not a multiple of 32) and ragged S (1,
# 33, 513)
# ---------------------------------------------------------------------------
# the other architectures and the body model (ROADMAP §1 item 8), and the
# humanml and bandai data path (item 10)
# ---------------------------------------------------------------------------

ARCH_BATCH, ARCH_FRAMES, HML_FEATS = 8, 196, 263  # humanml's clip: S = 197
ARCH_REL_L2 = 1e-5  # fp32 on the card (TF32 off) against the same weights on the CPU
DT_GOLDEN = os.path.join(ROOT, "tests", "goldens", "diffuse_transfer.npz")
DT_KW = dict(njoints=32, nfeats=1, latent_dim=64, ff_size=128, num_layers=2, num_heads=4,
             clip_dim=64, dropout=0.1)  # tests/test_models.py's DiffuseTransfer config


def _timed(fn):
    """(result, seconds) of fn() with the card synchronised around it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def arch_phase(card: str, device) -> int:
    """MDM's other architectures at full width (d=512, 8 layers, 4 heads,
    ff 1024, humanml's 263 features, T=196, B=8) on the card against the same
    seeded weights on the CPU in fp32: trans_dec, trans_dec with
    emb_trans_dec and gru (rel L2 <= ARCH_REL_L2); trans_dec again under
    MOTIONSTYLE_PALLAS_ATTN=1, its self-attention through kernel 4 (8
    launches a forward; the cross-attention has Sq != Sk and stays plain)
    within GOLDEN_ATOL of the plain run; DiffuseTransfer from
    diffuse_transfer.npz against its golden output (GOLDEN_ATOL); SMPL LBS
    and rotation2xyz of random_smpl_model over B x T frames, card against
    CPU. Each forward's seconds (the second call). Returns kernel 4's
    launches."""
    import copy

    import numpy as np
    import torch

    from motionstyle_torch.models import rotation2xyz, smpl
    from motionstyle_torch.models.denoiser import MDM, DiffuseTransfer, MDMConfig
    from motionstyle_torch.models.params import assemble_diffuse_transfer_params, seeded_init_
    from motionstyle_torch.ops.attention import attention_kernel

    rs = np.random.RandomState(7)
    x = torch.from_numpy((rs.randn(ARCH_BATCH, HML_FEATS, 1, ARCH_FRAMES) * 0.5)
                         .astype(np.float32))
    t = torch.from_numpy(rs.randint(0, 1000, ARCH_BATCH)).long()
    enc = torch.from_numpy((rs.randn(ARCH_BATCH, 512) * 0.1).astype(np.float32))
    xd, td, encd = x.to(device), t.to(device), enc.to(device)
    launches = 0
    for arch, emb in (("trans_dec", False), ("trans_dec", True), ("gru", False)):
        label = arch + (" emb_trans_dec" if emb else "")
        cpu = seeded_init_(MDM(MDMConfig(njoints=HML_FEATS, nfeats=1, arch=arch,
                                         emb_trans_dec=emb)), 3).eval()
        on_card = copy.deepcopy(cpu).to(device)
        with torch.no_grad(), env_var(PALLAS_ATTN, None):
            want, cpu_s = _timed(lambda: cpu(x, t, enc))
            attention_kernel.launches = 0
            on_card(xd, td, encd)
            got, secs = _timed(lambda: on_card(xd, td, encd))
            stray = attention_kernel.launches
        rel = rel_l2(got.cpu(), want)
        print(f"  MDM {label} (d=512, 8 layers, B={ARCH_BATCH}, T={ARCH_FRAMES}): card vs CPU "
              f"rel L2 {rel:.6g}; forward {secs:.6f} s on {card} (CPU {cpu_s:.4f} s)",
              flush=True)
        check(got.shape == (ARCH_BATCH, HML_FEATS, 1, ARCH_FRAMES)
              and bool(torch.isfinite(got).all()) and rel <= ARCH_REL_L2 and stray == 0,
              f"MDM {label} on the card within rel L2 {ARCH_REL_L2} of the CPU, no kernel-4 "
              "launch without the variable")
        if arch == "trans_dec" and not emb:
            with torch.no_grad(), env_var(PALLAS_ATTN, "1"):
                attention_kernel.launches = 0
                through, secs_k = _timed(lambda: on_card(xd, td, encd))
                n = attention_kernel.launches
            err = float((through - got).abs().max())
            print(f"  MDM trans_dec with {PALLAS_ATTN}=1: attention_kernel launches {n}; "
                  f"max_abs {err:.6g} from the plain run; forward {secs_k:.6f} s (first call)",
                  flush=True)
            check(n == 8 and err <= GOLDEN_ATOL,
                  f"trans_dec self-attention through kernel 4 (8 launches a forward) within "
                  f"atol {GOLDEN_ATOL} of the plain run")
            launches += n

    g = np.load(DT_GOLDEN)
    sd = {k[len("sd__"):]: g[k] for k in g.files if k.startswith("sd__")}
    model = DiffuseTransfer(MDMConfig(**DT_KW)).eval()
    model.load_state_dict(assemble_diffuse_transfer_params(model.cfg, sd))
    model = model.to(device)
    args = [torch.as_tensor(g[k], device=device) for k in ("x", "t", "mu", "style_code",
                                                           "content_code")]
    args[1] = args[1].long()
    with torch.no_grad():
        out, secs = _timed(lambda: model(*args))
    err = float(np.abs(out.cpu().numpy() - g["out"]).max())
    print(f"  DiffuseTransfer (golden, 2 layers, latent 64): max_abs {err:.6g} from the "
          f"reference output; forward {secs:.6f} s", flush=True)
    check(err <= GOLDEN_ATOL, f"DiffuseTransfer on the card within atol {GOLDEN_ATOL} of its "
                              "golden")

    body = smpl.random_smpl_model(np.random.RandomState(0))
    frames = ARCH_BATCH * ARCH_FRAMES
    q = rs.randn(frames, 24, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    from motionstyle_torch.core.rotations import quaternion_to_matrix

    mats = quaternion_to_matrix(torch.from_numpy(q))
    betas = torch.from_numpy((rs.randn(frames, 10) * 0.5).astype(np.float32))
    want_v, want_j = smpl.lbs(body, betas, mats)
    smpl.lbs(body, betas.to(device), mats.to(device))
    (got_v, got_j), secs = _timed(lambda: smpl.lbs(body, betas.to(device), mats.to(device)))
    rel_v, rel_j = rel_l2(got_v.cpu(), want_v), rel_l2(got_j.cpu(), want_j)
    x6 = torch.from_numpy(rs.randn(ARCH_BATCH, 25, 6, ARCH_FRAMES).astype(np.float32))
    r2x = rotation2xyz.Rotation2xyz(smpl.SMPL(body))
    want_x = r2x(x6, None, "rot6d", True, True, "vibe", True)
    got_x, secs_x = _timed(lambda: r2x(x6.to(device), None, "rot6d", True, True, "vibe", True))
    rel_x = rel_l2(got_x.cpu(), want_x)
    print(f"  SMPL LBS over {frames} frames: vertices rel L2 {rel_v:.6g}, joints {rel_j:.6g} "
          f"({secs:.6f} s on the card); rotation2xyz rot6d -> vibe joints "
          f"{tuple(got_x.shape)} rel L2 {rel_x:.6g} ({secs_x:.6f} s)", flush=True)
    check(max(rel_v, rel_j, rel_x) <= ARCH_REL_L2 and got_v.is_cuda and got_x.is_cuda,
          f"SMPL LBS and rotation2xyz on the card within rel L2 {ARCH_REL_L2} of the CPU")
    return launches


# the humanml phase: a synthetic HumanML3D-layout corpus (eval/quality_protocol
# make_corpus: 196-frame clips, texts/ and the split files), enough for
# batches of 64; its clip names are {content}_{style}_{idx:06d}.npy from 600
HML_CLIPS_PER_PAIR = 17  # 4 (style, content) pairs: 68 clips
HML_STYLE = f"jumping_angry_{600 + 3 * HML_CLIPS_PER_PAIR:06d}.npy"
HML_CONTENT = "walking_neutral_000600.npy"
HML_TEXT = "a person is walking angry"
HML_PRETRAIN_STEPS, HML_PRNG_STEPS = 3, 2
HML_FINETUNE_STEPS, HML_STORE_STEPS = 2, 1
HML_CHAIN = 1000  # the humanml content's DDPM steps (the prior's whole chain)
XIA_CHAIN = HML_CHAIN // 10  # the posrot neutral chain: stopped at 0.9 T
HML_TRANSFER = 6  # DDIM-20 skip 14: the transfer's and the final resample's steps
HML_LONG_FRAMES = 240  # 2 windows of 196 at overlap 10
BANDAI_CLIPS_PER_PAIR = 16


@contextmanager
def root_watch():
    """Wrap sampling.sample_loop (every module calls it by attribute): each
    call with an inpainting target appends (seconds, shape, steps, the kept
    channels' largest difference from the target over the output or each
    dumped x0); restored on exit."""
    import torch

    from motionstyle_torch.diffusion import sampling

    calls, orig = [], sampling.sample_loop

    def watched(sched, model_fn, cond, generator=None, **kw):
        t0 = time.perf_counter()
        out = orig(sched, model_fn, cond, generator, **kw)
        inp = kw.get("inpainting")
        if inp is not None:
            torch.cuda.synchronize()
            keep = inp.mask.expand(kw.get("shape") or tuple(out.shape[-4:])) > 0
            motion = inp.motion.expand(keep.shape)
            outs = out if kw.get("dump_all_xstart") else out[None]
            err = max(float((o[keep] - motion[keep]).abs().max()) for o in outs)
            calls.append(dict(s=time.perf_counter() - t0, shape=tuple(keep.shape),
                              steps=sched.num_timesteps - kw.get("skip_timesteps", 0)
                              - (kw.get("stop_timesteps") or 0), err=err))
        return out

    sampling.sample_loop = watched
    try:
        yield calls
    finally:
        sampling.sample_loop = orig


def _train_counts_want(layers: int, steps: int, prng: bool, store: bool,
                       pretrain: bool) -> dict:
    """The training kernels' expected (launches, prng launches): a pretrain
    step one forward and one backward a layer; a finetune step the semantic
    branch's forward and 6 unrolled forwards each recomputed under
    checkpoint, with 7 backwards. A pretrain run also counts its mask draws
    (one a layer and step in masks mode, none in prng mode)."""
    fwd = layers * steps if pretrain else layers * (1 + 2 * HML_TRANSFER) * steps
    bwd = layers * steps if pretrain else layers * (1 + HML_TRANSFER) * steps
    want = {n: (0, 0) for n in TRAIN_NAMES}
    fwd_name, ffn, attn, fwd_store, attn_stored = TRAIN_NAMES
    for n, k in (((fwd_store if store else fwd_name), fwd), (ffn, bwd),
                 ((attn_stored if store else attn), bwd)):
        want[n] = (k, k if prng else 0)
    if pretrain:
        want["make_dropout_masks"] = 0 if prng else fwd
    return want


def humanml_phase(card: str, tmp_root: str) -> dict:
    """The humanml data path at full width (d=512, 8 layers, batch 64,
    196-frame clips: S=197, 263 features) on a synthetic HumanML3D-layout
    corpus written from a seed: prepare_dataset on the golden
    prepare_xia.bvh; pretrain_prior --dataset humanml, 3 steps
    --fused_train 1 then 2 --fused_train_prng 1; from that prior
    finetune_style_diffusion --dataset humanml, 2 steps --fused_train 1 and
    1 --fused_train_store 1 (each neutral content the prior's whole
    1000-step chain at B=1); the humanml demo (8 samples, content from the
    prior's guided 1000-step chain at B=16: --fused 1, --quant_int8 1,
    --forecast_stride 4, --parallel_window 64, --long_frames 240, each
    --skip_render, then one render run); one serve wave of 4 humanml
    requests; then a 1-step bandai-2 finetune and its demo. Each run's
    counts are set to 0 just before it and read just after: finite losses
    and outputs, the files, the kept root channels equal to the content's,
    every kernel's launches, seconds per step and stage, peak memory.
    Returns each kernel's launches over the phase."""
    import csv
    import shutil

    import numpy as np
    import torch

    from motionstyle_torch.cli import demo_style_transfer as demo_cli
    from motionstyle_torch.cli import prepare_dataset
    from motionstyle_torch.cli import serve
    from motionstyle_torch.cli.demo_style_transfer import main as demo_main
    from motionstyle_torch.cli.finetune_style_diffusion import main as finetune_main
    from motionstyle_torch.cli.pretrain_prior import main as pretrain_main
    from motionstyle_torch.data.datasets import Text2MotionDataset, get_opt
    from motionstyle_torch.data.masks import get_inpainting_mask
    from motionstyle_torch.diffusion.forecast_sampling import forecast_plan
    from motionstyle_torch.diffusion.longform import plan_windows
    from motionstyle_torch.eval.quality_protocol import make_corpus
    from motionstyle_torch.ops import fused_encoder_train as ft
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer, fused_encoder_layer_int8
    from motionstyle_torch.serve.server import MotionServer

    layers, seed, batch = FINETUNE_LAYERS, 10, FINETUNE_BATCH
    totals = dict.fromkeys(("fused_encoder_layer", "fused_encoder_layer_int8", PRNG_NAME)
                           + TRAIN_NAMES, 0)
    k1, k2 = fused_encoder_layer, fused_encoder_layer_int8

    def zero():
        k1.launches = k2.launches = 0
        _zero_counts(ft)

    def tally(counts=None):
        totals["fused_encoder_layer"] += k1.launches
        totals["fused_encoder_layer_int8"] += k2.launches
        if counts is not None:
            for n in TRAIN_NAMES:
                totals[n] += counts[n][0]
                totals[PRNG_NAME] += counts[n][1]

    # prepare_dataset: the golden BVH through the CLI, against its golden
    t0 = time.perf_counter()
    raw = os.path.join(tmp_root, "raw_bvh")
    os.makedirs(raw)
    shutil.copy(os.path.join(ROOT, "tests", "goldens", "prepare_xia.bvh"),
                os.path.join(raw, "650angry_jumping.bvh"))
    written = prepare_dataset.main(["--dataset", "stylexia_posrot", "--bvh_dir", raw, "--out",
                                    os.path.join(tmp_root, "prepared")])
    golden = np.load(os.path.join(ROOT, "tests", "goldens", "prepare_xia.npz"))["data"]
    got = np.load(written[0])
    err = float(np.abs(got - golden).max())
    print(f"  prepare_dataset on prepare_xia.bvh: {got.shape}, max_abs {err:.6g} from the "
          f"golden; {time.perf_counter() - t0:.4f} s", flush=True)
    check(got.shape == golden.shape and err <= 2e-3,
          "prepare_dataset writes the golden features within atol 2e-3 "
          "(tests/test_prepare_dataset.py's bound)")

    hml_root = os.path.join(tmp_root, "humanml")
    t0 = time.perf_counter()
    make_corpus(hml_root, clips_per_pair=HML_CLIPS_PER_PAIR, seed=seed, dataset="humanml")
    n_train = len(Text2MotionDataset(get_opt("humanml", hml_root)))
    print(f"  humanml corpus: {n_train} clips of 196 frames x {HML_FEATS} "
          f"({time.perf_counter() - t0:.4f} s)", flush=True)
    check(n_train >= batch, f"humanml corpus holds a batch of {batch}")

    # pretrain
    priors = []
    for label, flags, steps, prng in (("--fused_train 1", ["--fused_train", "1"],
                                       HML_PRETRAIN_STEPS, False),
                                      ("--fused_train_prng 1", ["--fused_train_prng", "1"],
                                       HML_PRNG_STEPS, True)):
        save_dir = os.path.join(tmp_root, f"hml_prior_{len(priors)}")
        random.seed(seed)
        torch.cuda.reset_peak_memory_stats()
        zero()
        t0 = time.perf_counter()
        pretrain_main(["--dataset", "humanml", "--data_dir", hml_root, "--save_dir", save_dir,
                       "--batch_size", str(batch), "--layers", str(layers), "--num_steps",
                       str(steps), "--num_frames", "196", "--log_interval", "1", "--seed",
                       str(seed), *flags, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _prior_counts(ft)
        tally(counts)
        with open(os.path.join(save_dir, "progress.csv")) as f:
            rows = list(csv.DictReader(f))
        losses = [float(r["prior_loss"]) for r in rows]
        secs = [float(r["step_seconds"]) for r in rows]
        want = _train_counts_want(layers, steps, prng, False, True)
        print(f"  humanml pretrain {label}: {steps} steps in {wall:.4f} s on {card}; losses "
              f"{losses}; step seconds {secs}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.4g} GB; (launches, prng launches) "
              f"{counts}", flush=True)
        check(len(losses) == steps and bool(np.isfinite(losses).all())
              and os.path.exists(os.path.join(save_dir, "mdm.pt")),
              f"humanml pretrain {label}: losses finite, mdm.pt written")
        check(counts == want, f"humanml pretrain {label}: kernels 5, 6, 7 launched {layers} "
                              f"times a step at B={batch}, S=197"
                              + (", all in prng mode, no mask arrays" if prng else ""))
        priors.append(os.path.join(save_dir, "mdm.pt"))

    # finetune from the first prior
    model_paths = []
    for label, flag, steps, store in (("--fused_train 1", "--fused_train", HML_FINETUNE_STEPS,
                                       False),
                                      ("--fused_train_store 1", "--fused_train_store",
                                       HML_STORE_STEPS, True)):
        random.seed(seed)
        torch.cuda.reset_peak_memory_stats()
        zero()
        t0 = time.perf_counter()
        with root_watch() as chains:
            save_dir = finetune_main([
                "--dataset", "humanml", "--data_dir", hml_root, "--mdm_path", priors[0],
                "--save_dir", os.path.join(tmp_root, f"hml_ft_{len(model_paths)}"),
                "--style_example", HML_STYLE, "--fused", "1", flag, "1", "--batch_size",
                str(batch), "--layers", str(layers), "--num_steps", str(steps), "--skip_render",
                "--train_platform_type", "NoPlatform", "--seed", str(seed), "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _prior_counts(ft)
        launches_1 = k1.launches
        tally(counts)
        with open(os.path.join(save_dir, "progress.csv")) as f:
            rows = list(csv.DictReader(f))
        losses = [float(r["loss"]) for r in rows]
        secs = [float(r["step_seconds"]) for r in rows]
        neutral = [c for c in chains if c["steps"] == HML_CHAIN]
        want = _train_counts_want(layers, steps, False, store, False)
        print(f"  humanml finetune {label}: {steps} steps in {wall:.4f} s on {card}; losses "
              f"{losses}; step seconds {secs}; neutral chain ({HML_CHAIN} DDPM steps, B=1) "
              f"{[round(c['s'], 4) for c in neutral]} s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.4g} GB; kernel 1 launches "
              f"{launches_1}; (launches, prng launches) {counts}", flush=True)
        check(len(losses) == steps and bool(np.isfinite(losses).all())
              and os.path.exists(os.path.join(save_dir, f"model{steps:09d}.pt")),
              f"humanml finetune {label}: losses finite, model{steps:09d}.pt written")
        check(len(neutral) == 1 and all(c["err"] == 0.0 for c in chains),
              f"humanml finetune {label}: the neutral content is the whole {HML_CHAIN}-step "
              "chain and every sample keeps the inpainted root channels exactly")
        check(launches_1 == layers * (HML_CHAIN + HML_TRANSFER) and k2.launches == 0,
              f"humanml finetune {label}: kernel 1 launched {layers} x ({HML_CHAIN} neutral + "
              f"{HML_TRANSFER} resample) times (read from its counter), kernel 2 never")
        check({k: counts[k] for k in TRAIN_NAMES} == want,
              f"humanml finetune {label}: training kernel launches {want}")
        model_paths.append(os.path.join(save_dir, f"model{steps:09d}.pt"))

    # the demo on the store run's model: content from the prior
    ds = Text2MotionDataset(get_opt("humanml", hml_root))
    keep = np.asarray(get_inpainting_mask("root_horizontal", (1, HML_FEATS, 1, 196),
                                          dataset="humanml"))[0, :, 0, 0] > 0
    captured = []
    orig_prior = demo_cli.prior_content

    def capture(*a, **k):
        content, long_content = orig_prior(*a, **k)
        captured.append(long_content if long_content is not None
                        else content.float().cpu().numpy())
        return content, long_content

    demo_cli.prior_content = capture
    par_sweeps = []
    orig_par = demo_cli.parallel_sample_loop

    def counted_par(*a, **k):
        out, sweeps = orig_par(*a, **k)
        par_sweeps.append(int(sweeps))
        return out, sweeps

    demo_cli.parallel_sample_loop = counted_par
    evals = int(forecast_plan(HML_CHAIN, 4)[0].sum())
    windows = plan_windows(HML_LONG_FRAMES, 196, 10)[0]
    try:
        for label, flags, kernel in (
                ("--fused 1", ["--fused", "1"], k1), ("--quant_int8 1", ["--quant_int8", "1"], k2),
                ("--forecast_stride 4", ["--fused", "1", "--forecast_stride", "4"], k1),
                ("--parallel_window 64", ["--fused", "1", "--parallel_window", "64"], k1),
                (f"--long_frames {HML_LONG_FRAMES}",
                 ["--fused", "1", "--long_frames", str(HML_LONG_FRAMES)], k1)):
            captured.clear()
            par_sweeps.clear()
            zero()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = demo_main(["--model_path", model_paths[-1], "--input_content", HML_CONTENT,
                             "--style_example", HML_STYLE, "--input_text", HML_TEXT,
                             "--data_dir", hml_root, "--skip_render", "--num_samples",
                             str(DEMO_SAMPLES), "--output_dir",
                             os.path.join(tmp_root, "hml_demo", label.split()[0][2:]), *flags,
                             "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            other = k2 if kernel is k1 else k1
            n, stray = kernel.launches, other.launches
            tally()
            res = np.load(os.path.join(out, "results.npy"), allow_pickle=True).item()
            frames = HML_LONG_FRAMES if "--long_frames" in flags else 196
            content = ds.inv_transform(captured[0][:, :, 0, :].transpose(0, 2, 1))[:, :frames]
            root_err = float(np.abs(res["hml"][:, :frames][..., keep]
                                    - content[..., keep]).max())
            prior_calls = {"--forecast_stride 4": evals,
                           "--parallel_window 64": sum(par_sweeps)}.get(label, HML_CHAIN)
            reps = windows if "--long_frames" in flags else 1
            want = layers * reps * (prior_calls + HML_TRANSFER)
            print(f"  humanml demo {label}: whole CLI run {wall:.4f} s on {card}; "
                  f"{kernel.__name__} launches {n} (prior forwards {prior_calls} a window at "
                  f"B={2 * DEMO_SAMPLES}, guided; {reps} window(s)), {other.__name__} {stray}; "
                  f"root channels max_abs {root_err:.6g} from the generated content; peak "
                  f"memory {torch.cuda.max_memory_allocated() / 1e9:.4g} GB"
                  + (f"; Picard sweeps {par_sweeps}" if par_sweeps else ""), flush=True)
            check(set(res) == RESULT_KEYS and res["hml"].shape == (DEMO_SAMPLES, frames, HML_FEATS)
                  and res["motion"].shape == (DEMO_SAMPLES, 22, 3, frames)
                  and bool(np.isfinite(res["hml"]).all() and np.isfinite(res["motion"]).all()),
                  f"humanml demo {label}: results.npy ({DEMO_SAMPLES}, {frames}, {HML_FEATS}), "
                  "finite")
            check(root_err <= 1e-4, f"humanml demo {label}: the root_horizontal channels "
                                    "equal the generated content's")
            check(n == want and stray == 0,
                  f"humanml demo {label}: {kernel.__name__} launched {want} times (read from "
                  f"its counter), {other.__name__} never")
        # one render run: no BVH on humanml; three renders, three foot-skate passes
        zero()
        label = "humanml demo --fused 1 (render)"
        t0 = time.perf_counter()
        with post_stage_watch(demo_cli) as stages:
            out = demo_main(["--model_path", model_paths[-1], "--input_content", HML_CONTENT,
                             "--style_example", HML_STYLE, "--input_text", HML_TEXT,
                             "--data_dir", hml_root, "--num_samples", "1", "--output_dir",
                             os.path.join(tmp_root, "hml_demo", "render"), "--fused", "1",
                             "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tally()
        print(f"  {label}: whole CLI run {wall:.4f} s on {card}; writes "
              f"{sorted(os.listdir(out))}", flush=True)
        check(not [f for f in os.listdir(out) if f.endswith(".bvh")],
              f"{label}: no BVH on humanml")
        check_post_outputs(out, ("input_content_motion00", "input_style_motion00",
                                 "output_transferred_motion00_rep00"), stages, {}, label,
                           fits=0, renders=3, passes=3)
    finally:
        demo_cli.prior_content = orig_prior
        demo_cli.parallel_sample_loop = orig_par

    # one serve wave of 4 humanml requests
    zero()
    engine, decode, handle, _ = serve.build_engine(serve.parse_args([
        "--dataset", "humanml", "--mdm_path", priors[0], "--model_path", model_paths[-1],
        "--fused", "1", "--max_wait_ms", "20", "--port", "0", "--device", "cuda"]))
    engine.warmup(decode({"content": np.zeros((196, HML_FEATS), np.float32)}), log=False)
    sizes = count_device_batches(engine)
    server = MotionServer(engine, port=0, decode=decode, handle=handle).start_background()
    rng = np.random.RandomState(3)
    contents = [(rng.randn(196, HML_FEATS) * 0.5).astype(np.float32) for _ in range(4)]
    try:
        zero()
        results, latencies, wall = http_waves(f"http://127.0.0.1:{server.port}", contents, 1,
                                              (None,))
        torch.cuda.synchronize()
        n = k1.launches
    finally:
        server.close()
    tally()
    mask = np.asarray(get_inpainting_mask("root_horizontal", (1, HML_FEATS, 1, 196),
                                          dataset="humanml"))[0, :, 0, 0] > 0
    ok = all(m.shape == (HML_FEATS, 1, 196) and bool(np.isfinite(m).all())
             and np.array_equal(m[mask], contents[i].T[:, None, :][mask])
             for (_, i), m in results.items())
    print(f"  humanml serve: 4 requests in {wall:.4f} s on {card}, p50 "
          f"{percentiles(latencies)[0]:.4f} ms; device batches {sizes}; kernel 1 launches {n}",
          flush=True)
    check(len(results) == 4 and ok, "humanml serve: 4 answers (263, 1, 196), finite, the "
                                    "content's root channels exact")
    check(n == 16 * len(sizes) and sizes, "humanml serve: kernel 1 launched 16 times a device "
                                          "batch")

    # bandai-2: a 1-step finetune (a seeded prior) and its demo
    b_root = os.path.join(tmp_root, "bandai-2")
    make_corpus(b_root, clips_per_pair=BANDAI_CLIPS_PER_PAIR, seed=seed,
                dataset="bandai-2_posrot")
    style = f"dataset-2_jumping_angry_{600 + 3 * BANDAI_CLIPS_PER_PAIR:03d}.npy"
    random.seed(seed)
    zero()
    t0 = time.perf_counter()
    with root_watch() as chains:
        save_dir = finetune_main([
            "--dataset", "bandai-2_posrot", "--data_dir", b_root, "--save_dir",
            os.path.join(tmp_root, "bandai_ft"), "--style_example", style, "--fused", "1",
            "--fused_train", "1", "--batch_size", str(batch), "--layers", str(layers),
            "--num_steps", "1", "--skip_render", "--train_platform_type", "NoPlatform",
            "--seed", str(seed), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _prior_counts(ft)
    n = k1.launches
    tally(counts)
    with open(os.path.join(save_dir, "progress.csv")) as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    print(f"  bandai-2 finetune --fused_train 1: 1 step in {wall:.4f} s on {card}; losses "
          f"{losses}; kernel 1 launches {n}; (launches, prng launches) {counts}", flush=True)
    check(len(losses) == 1 and bool(np.isfinite(losses).all())
          and all(c["err"] == 0.0 for c in chains) and n == layers * (XIA_CHAIN + HML_TRANSFER)
          and {k: counts[k] for k in TRAIN_NAMES} == _train_counts_want(layers, 1, False, False,
                                                                     False),
          f"bandai-2 finetune: loss finite, root channels kept, kernel 1 launched {layers} x "
          f"({XIA_CHAIN} + {HML_TRANSFER}) times, kernels 5, 6, 7 as a finetune step")
    zero()
    content = "dataset-2_walking_neutral_600.npy"
    out = demo_main(["--model_path", os.path.join(save_dir, "model000000001.pt"),
                     "--input_content", content, "--style_example", style, "--data_dir",
                     b_root, "--skip_render", "--num_samples", str(DEMO_SAMPLES),
                     "--output_dir", os.path.join(tmp_root, "bandai_demo"), "--fused", "1",
                     "--device", "cuda"])
    torch.cuda.synchronize()
    n = k1.launches
    tally()
    res = np.load(os.path.join(out, "results.npy"), allow_pickle=True).item()
    from motionstyle_torch.data.datasets import StyleMotionDataset

    bds = StyleMotionDataset(get_opt("bandai-2_posrot", b_root), split="test")
    clip, length = bds.process_np_motion(os.path.join(bds.opt.motion_dir, content))
    bkeep = np.asarray(get_inpainting_mask("root_horizontal", (1, 190, 1, 196),
                                           dataset="bandai-2_posrot"))[0, :, 0, 0] > 0
    root_err = float(np.abs(res["hml"][..., bkeep] - bds.inv_transform(clip)[:, bkeep]).max())
    print(f"  bandai-2 demo --fused 1: caption {res['text'][0]!r}; kernel 1 launches {n}; root "
          f"channels max_abs {root_err:.6g} from the content", flush=True)
    check(res["hml"].shape == (DEMO_SAMPLES, 196, 190) and bool(np.isfinite(res["hml"]).all())
          and root_err <= 1e-5 and n == 2 * layers,
          "bandai-2 demo: (8, 196, 190) finite, the content's root channels, kernel 1 "
          f"launched {2 * layers} times")
    return totals


# ---------------------------------------------------------------------------
# the T2M evaluation stack (ROADMAP §1 item 9)
# ---------------------------------------------------------------------------

# the JAX CLI's metric keys in its order (motionstyle/eval/motion_loaders.py:
# 275-293), then multimodality with --mm_num_samples, and with
# --replication_times > 1 each key's _conf
EVAL_KEYS = ("matching_score_gt", "matching_score", "R_precision_top_1_gt", "R_precision_top_1",
             "R_precision_top_2_gt", "R_precision_top_2", "R_precision_top_3_gt",
             "R_precision_top_3", "FID", "diversity_gt", "diversity")
EVAL_BATCH, EVAL_SAMPLES = 32, 64  # the guided forward: B = 2 x 32, S = 197
EVAL_AE_STEPS, EVAL_MATCH_STEPS = 20, 40
EVAL_EMB_REL = 1e-5  # the evaluator's embeddings, card against CPU
EVAL_INT8_GRID, EVAL_ATTN_GRID = 50, 10  # DDIM grids of the kernel-2 and kernel-4 runs
EVAL_STUDENT_STEPS = 16  # the distill phase's stage-2 student: ddim16 of 64
T2M_STEPS, T2M_EVAL_SAMPLES = 3, 8


@contextmanager
def eval_watch():
    """Record every evaluator-trainer update (seconds, logs), every CompV6
    and length-estimator step, and every sampler call of eval_metrics
    (seconds to a synchronised end, kind, steps); restored on exit."""
    import torch

    from motionstyle_torch.diffusion import forecast_sampling, sampling
    from motionstyle_torch.eval import t2m_generator, trainers

    rec = {"ae": [], "match": [], "gen": [], "len": [], "sample": []}
    saved = []

    def wrap(owner, name, key, sampler=False):
        orig = getattr(owner, name)

        def watched(*a, **k):
            t0 = time.perf_counter()
            out = orig(*a, **k)
            if sampler:
                torch.cuda.synchronize()
                sched = a[0]
                steps = sched.num_timesteps
                if key == "forecast":
                    from motionstyle_torch.diffusion.forecast_sampling import forecast_plan

                    steps = int(forecast_plan(steps, k["stride"])[0].sum())
                rec["sample"].append(dict(kind=key, s=time.perf_counter() - t0, steps=steps,
                                          clips=k["shape"][0], frames=k["shape"][-1]))
            else:
                rec[key].append(dict(s=time.perf_counter() - t0, **out))
            return out

        saved.append((owner, name, orig))
        setattr(owner, name, watched)

    wrap(trainers.MovementAETrainer, "update", "ae")
    wrap(trainers.TextMotionMatchTrainer, "update", "match")
    wrap(t2m_generator.CompV6Generator, "train_step", "gen")
    wrap(t2m_generator.LengthEstTrainer, "update", "len")
    wrap(sampling, "sample_loop", "ddpm_or_ddim", sampler=True)
    wrap(forecast_sampling, "forecast_sample_loop", "forecast", sampler=True)
    try:
        yield rec
    finally:
        for owner, name, orig in saved:
            setattr(owner, name, orig)


def eval_kernel_counts() -> dict:
    """Every kernel's launch counter, read."""
    from motionstyle_torch.ops import fused_encoder_train as ft
    from motionstyle_torch.ops.attention import attention_kernel
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer, fused_encoder_layer_int8
    from motionstyle_torch.ops.sampler_update import fused_ddpm_update

    out = {f.__name__: f.launches for f in (fused_encoder_layer, fused_encoder_layer_int8,
                                            attention_kernel, fused_ddpm_update)}
    out.update({n: sum(c) for n, c in _prior_counts(ft).items() if n in TRAIN_NAMES})
    return out


def eval_zero_counts() -> None:
    from motionstyle_torch.ops import fused_encoder_train as ft
    from motionstyle_torch.ops.attention import attention_kernel
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer, fused_encoder_layer_int8
    from motionstyle_torch.ops.sampler_update import fused_ddpm_update

    for f in (fused_encoder_layer, fused_encoder_layer_int8, attention_kernel, fused_ddpm_update):
        f.launches = 0
    _zero_counts(ft)


def check_launches(label: str, counts: dict, want: dict) -> None:
    """Each kernel's launches equal `want` (every kernel not named: 0)."""
    full = {n: want.get(n, 0) for n in counts}
    check(counts == full, f"{label}: launches {want or 'none'} (read from the counters), no "
                          "other kernel launched")


def eval_embeddings_check(path: str, card: str) -> None:
    """finest.tar in the port's wrapper on the card and on the CPU: the
    motion and text embeddings at B=64, T=196 within EVAL_EMB_REL, with
    TF32 switched on for the process around it (the wrapper's true_fp32
    scope must hold the card to the CPU's yardstick)."""
    import numpy as np
    import torch

    from motionstyle_torch.eval.evaluators import EvaluatorWrapper, WordVectorizer
    from motionstyle_torch.eval.motion_loaders import embed_texts

    rs = np.random.RandomState(5)
    motions = (rs.randn(64, 196, HML_FEATS) * 0.5).astype(np.float32)
    m_lens = rs.randint(40, 197, size=64)
    words = ("walk", "run", "jump", "slowly", "angry", "left", "person", "kick", "turn")
    tokens = [[f"{words[j]}/OTHER" for j in rs.randint(0, len(words), size=rs.randint(0, 18))]
              for _ in range(64)]
    we, po, cl = embed_texts(WordVectorizer(), tokens)
    out = {}
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for dev in ("cuda", "cpu"):
            w = EvaluatorWrapper("humanml", checkpoint_path=path, device=dev)
            t0 = time.perf_counter()
            out[dev] = [torch.from_numpy(e) for e in w.get_co_embeddings(we, po, cl, motions,
                                                                         m_lens)]
            print(f"  evaluator on {dev}: co-embeddings of 64 clips x 196 frames in "
                  f"{time.perf_counter() - t0:.4f} s", flush=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    rels = [rel_l2(a, b) for a, b in zip(out["cuda"], out["cpu"])]
    print(f"  evaluator card against CPU (TF32 on outside its scope): text rel L2 "
          f"{rels[0]:.6g}, motion rel L2 {rels[1]:.6g} on {card}", flush=True)
    check(max(rels) <= EVAL_EMB_REL and all(bool(torch.isfinite(e).all()) for e in out["cuda"]),
          f"evaluator: finest.tar's embeddings on the card within rel L2 {EVAL_EMB_REL} of the "
          "CPU's, finite")


def eval_expected_calls(n_loader: int, mm: tuple = (0, 0), reps: int = 1, seed: int = 10) -> int:
    """The sampler calls of one eval_metrics run by the T2M protocol
    (--num_samples EVAL_SAMPLES, --batch_size EVAL_BATCH, --seed `seed`, a
    loader of `n_loader` batches): each replication samples the
    ceil(EVAL_SAMPLES / EVAL_BATCH) batches it needs, and mm[1] times each
    of them that is among the min(mm[0] // EVAL_BATCH + 1, nbatch)
    multimodality batches drawn with RandomState(seed + replication)."""
    import numpy as np

    nbatch = min(n_loader, EVAL_SAMPLES // EVAL_BATCH + 1)
    visited = min(nbatch, -(-EVAL_SAMPLES // EVAL_BATCH))
    calls = 0
    for rep in range(reps):
        chosen = set()
        if mm[0] > 0 and mm[1] > 0:
            chosen = set(np.random.RandomState(seed + rep).choice(
                nbatch, min(mm[0] // EVAL_BATCH + 1, nbatch), replace=False).tolist())
        calls += sum(mm[1] if i in chosen else 1 for i in range(visited))
    return calls


def eval_held_shapes(kernel: str) -> set:
    """The (B, S) at which the kernel phases hold `kernel` against its twin
    at the denoiser's D, H, F."""
    if kernel == "attention_kernel":
        return {(b, s) for b, s, d, h in ATTN_SHAPES if (d, h) == (D, H)}
    shapes = INT8_SHAPES if kernel == "fused_encoder_layer_int8" else (
        KERNEL_EXTRA_SHAPES + KERNEL_ATTENTION_SHAPES)
    return {(b, s) for b, s, d, h, f in shapes if (d, h, f) == (D, H, F)}


def eval_metrics_run(label: str, card: str, argv: list, layers: int, want_kernel: str,
                     steps: int, n_loader: int, mm: tuple = (0, 0), reps: int = 1,
                     env=None) -> tuple:
    """One eval_metrics run on the card: the counters zeroed just before and
    read just after; the dict finite with the JAX CLI's keys; the sampler
    called eval_expected_calls times, each call on EVAL_BATCH clips for
    `steps` guided forwards (B = 2 x EVAL_BATCH) at a (B, S) where the kernel
    phases hold `want_kernel` against its twin; `want_kernel` launched
    layers x calls x steps times, no other kernel. Returns (metrics,
    launches of want_kernel)."""
    import numpy as np
    import torch

    from motionstyle_torch.cli.eval_metrics import main as eval_main

    random.seed(10)
    with env_var(PALLAS_ATTN, env), eval_watch() as rec:
        eval_zero_counts()
        t0 = time.perf_counter()
        out = eval_main(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = eval_kernel_counts()
    calls = rec["sample"]
    forwards = sum(c["steps"] for c in calls)
    clips = sum(c["clips"] for c in calls)
    sample_s = sum(c["s"] for c in calls)
    keys = list(EVAL_KEYS) + (["multimodality"] if mm[0] else [])
    keys += [f"{k}_conf" for k in keys] if reps > 1 else []
    print(f"  eval_metrics {label}: whole CLI run {wall:.4f} s on {card}; {len(calls)} sampler "
          f"calls ({sorted({c['kind'] for c in calls})}, {forwards} guided forwards of B="
          f"{2 * calls[0]['clips'] if calls else 0}), sampling {sample_s:.4f} s, "
          f"{clips / max(sample_s, 1e-9):.6g} clips/s; launches {counts}; metrics "
          f"{json.dumps(out)}", flush=True)
    check(list(out) == keys and all(np.isfinite(v) for v in out.values()),
          f"eval_metrics {label}: the metric dict is finite with the JAX CLI's keys")
    n_calls = eval_expected_calls(n_loader, mm, reps)
    shapes = {(2 * c["clips"], c["frames"] + 1) for c in calls}
    check(len(calls) == n_calls and all(c["clips"] == EVAL_BATCH and c["steps"] == steps
                                        for c in calls),
          f"eval_metrics {label}: {n_calls} sampler calls by the protocol, each on "
          f"{EVAL_BATCH} clips for {steps} forwards")
    check(shapes <= eval_held_shapes(want_kernel),
          f"eval_metrics {label}: {want_kernel} ran at {sorted(shapes)}, each held against its "
          "twin by the kernel phases")
    check_launches(f"eval_metrics {label}", counts, {want_kernel: layers * n_calls * steps})
    return out, counts[want_kernel]


def eval_phase(card: str, tmp_root: str, xia_dir: str, teacher: str) -> dict:
    """The T2M evaluation stack on the card (ROADMAP §1 item 9), on the
    humanml phase's corpus and prior and the distill phase's student:
    train_evaluator (humanml, 196-frame clips, batch 32, EVAL_AE_STEPS and
    EVAL_MATCH_STEPS; its finest.tar on the card against the CPU);
    eval_metrics with the prior's full 1000-step guided DDPM through kernel
    1 (--fused 1, B=2x32, S=197), a DDIM-50 grid through kernel 2
    (--quant_int8 1), a DDIM-10 grid through kernel 4 (--fused 0 under
    MOTIONSTYLE_PALLAS_ATTN=1), the forecast sampler with multimodality over
    two replications; the stage-2 student (16 DDIM steps) against its
    64-step teacher on Xia with an evaluator trained there; and
    train_t2m_generator with --run_eval against the humanml evaluator.
    Returns each kernel's launches over the phase."""
    import contextlib
    import io
    import pickle

    import numpy as np
    import torch

    from motionstyle_torch.cli import train_t2m_generator
    from motionstyle_torch.cli.train_evaluator import main as train_evaluator_main
    from motionstyle_torch.data.collate import get_dataset_loader

    layers = FINETUNE_LAYERS
    hml_root = os.path.join(tmp_root, "humanml")
    prior = os.path.join(tmp_root, "hml_prior_0", "mdm.pt")
    totals = dict.fromkeys(("fused_encoder_layer", "fused_encoder_layer_int8",
                            "attention_kernel"), 0)

    def train_evaluator(name, dataset, root, frames):
        np.random.seed(10)
        with eval_watch() as rec:
            eval_zero_counts()
            t0 = time.perf_counter()
            path = train_evaluator_main([
                "--dataset", dataset, "--data_dir", root, "--save_dir",
                os.path.join(tmp_root, name), "--batch_size", str(EVAL_BATCH), "--num_frames",
                str(frames), "--ae_steps", str(EVAL_AE_STEPS), "--match_steps",
                str(EVAL_MATCH_STEPS), "--log_interval", "10", "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = eval_kernel_counts()
        losses = [r["loss"] for r in rec["ae"] + rec["match"]]
        ae_s = float(np.median([r["s"] for r in rec["ae"][1:]]))
        match_s = float(np.median([r["s"] for r in rec["match"][1:]]))
        print(f"  train_evaluator {dataset}: {len(rec['ae'])} AE + {len(rec['match'])} match "
              f"steps at batch {EVAL_BATCH} in {wall:.4f} s on {card}; s/step after the first "
              f"(median): AE {ae_s:.6g}, match {match_s:.6g}; AE losses "
              f"{[round(r['loss'], 5) for r in rec['ae'][::5]]}, match losses "
              f"{[round(r['loss'], 5) for r in rec['match'][::10]]}", flush=True)
        check(len(rec["ae"]) == EVAL_AE_STEPS and len(rec["match"]) == EVAL_MATCH_STEPS
              and bool(np.isfinite(losses).all()) and os.path.exists(path),
              f"train_evaluator {dataset}: losses finite, finest.tar written")
        check_launches(f"train_evaluator {dataset}", counts, {})
        return path

    # 1. an evaluator for humanml, checked card against CPU
    finest = train_evaluator("eval_ev_hml", "humanml", hml_root, 196)
    eval_embeddings_check(finest, card)

    base = ["--dataset", "humanml", "--data_dir", hml_root, "--split", "train", "--mdm_path",
            prior, "--evaluator_checkpoint", finest, "--layers", str(layers), "--batch_size",
            str(EVAL_BATCH), "--num_samples", str(EVAL_SAMPLES), "--seed", "10"]
    hml_batches = len(get_dataset_loader("humanml", EVAL_BATCH, 196, split="train",
                                         data_root=hml_root))
    # 2-4. the prior through kernels 1, 2 and 4, each in its own run
    _, n = eval_metrics_run("--fused 1 (1000-step DDPM)", card, base + ["--fused", "1"],
                            layers, "fused_encoder_layer", 1000, hml_batches)
    totals["fused_encoder_layer"] += n
    _, n = eval_metrics_run(f"--quant_int8 1 (DDIM-{EVAL_INT8_GRID})", card, base + [
        "--quant_int8", "1", "--use_ddim", "1", "--timestep_respacing",
        f"ddim{EVAL_INT8_GRID}"], layers, "fused_encoder_layer_int8", EVAL_INT8_GRID,
        hml_batches)
    totals["fused_encoder_layer_int8"] += n
    _, n = eval_metrics_run(f"--fused 0, {PALLAS_ATTN}=1 (DDIM-{EVAL_ATTN_GRID})", card, base + [
        "--fused", "0", "--use_ddim", "1", "--timestep_respacing", f"ddim{EVAL_ATTN_GRID}"],
        layers, "attention_kernel", EVAL_ATTN_GRID, hml_batches, env="1")
    totals["attention_kernel"] += n
    # 5. multimodality and replications, on the forecast sampler: 1000 steps
    # with a forward on every 4th and on the last
    forecast_forwards = len(range(0, 1000, 4)) + (999 % 4 != 0)
    _, n = eval_metrics_run("--forecast_stride 4, multimodality, 2 replications", card, base + [
        "--fused", "1", "--forecast_stride", "4", "--mm_num_samples", "32", "--mm_num_repeats",
        "3", "--replication_times", "2"], layers, "fused_encoder_layer", forecast_forwards,
        hml_batches, mm=(32, 3), reps=2)
    totals["fused_encoder_layer"] += n

    # 6. the distilled student against its teacher on Xia, an evaluator of Xia's
    xia_finest = train_evaluator("eval_ev_xia", "stylexia_posrot", xia_dir, 76)
    xia_batches = len(get_dataset_loader("stylexia_posrot", EVAL_BATCH, 76, split="train",
                                         data_root=xia_dir))
    student = os.path.join(tmp_root, "distill_0", f"mdm_{EVAL_STUDENT_STEPS}step.pt")
    scored = {}
    for name, path, grid in (("student", student, EVAL_STUDENT_STEPS),
                             ("teacher", teacher, 64)):
        scored[name], n = eval_metrics_run(
            f"Xia {name} (DDIM-{grid} of 64)", card,
            ["--dataset", "stylexia_posrot", "--data_dir", xia_dir, "--split", "train",
             "--mdm_path", path, "--evaluator_checkpoint", xia_finest, "--layers", str(layers),
             "--diffusion_steps",
             "64", "--timestep_respacing", f"ddim{grid}", "--use_ddim", "1", "--fused", "1",
             "--batch_size", str(EVAL_BATCH), "--num_samples", str(EVAL_SAMPLES), "--seed",
             "10"], layers, "fused_encoder_layer", grid, xia_batches)
        totals["fused_encoder_layer"] += n
    print("  distilled student against its teacher (Xia, the same evaluator, loader and "
          "seed): " + "; ".join(f"{k} {scored['student'][k]} vs {scored['teacher'][k]}"
                                 for k in ("FID", "R_precision_top_1", "matching_score",
                                           "diversity")), flush=True)

    # 7. the T2M generator, scored against the humanml evaluator
    printed = io.StringIO()
    np.random.seed(10)
    with eval_watch() as rec, contextlib.redirect_stdout(printed):
        eval_zero_counts()
        t0 = time.perf_counter()
        path = train_t2m_generator.main([
            "--dataset", "humanml", "--data_dir", hml_root, "--save_dir",
            os.path.join(tmp_root, "eval_t2m"), "--gen_steps", str(T2M_STEPS), "--len_steps",
            str(T2M_STEPS), "--log_interval", "1", "--run_eval", "--num_eval_samples",
            str(T2M_EVAL_SAMPLES), "--evaluator_checkpoint", finest, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = eval_kernel_counts()
    metrics = json.loads(printed.getvalue().strip().splitlines()[-1])
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    losses = [r["loss"] for r in rec["gen"] + rec["len"]]
    print(f"  train_t2m_generator: {T2M_STEPS} length + {T2M_STEPS} CompV6 steps (hidden "
          f"1024, text_hidden 512, dim_z 128, batch 16, 64 frames) and --run_eval over "
          f"{T2M_EVAL_SAMPLES} captions in {wall:.4f} s on {card}; CompV6 s/step "
          f"{[round(r['s'], 4) for r in rec['gen']]}; losses {[round(v, 4) for v in losses]}; "
          f"metrics {json.dumps(metrics)}", flush=True)
    check(len(rec["gen"]) == len(rec["len"]) == T2M_STEPS and bool(np.isfinite(losses).all())
          and set(ckpt) >= {"generator", "length_estimator", "dim_pose"}
          and ckpt["dim_pose"] == HML_FEATS,
          "train_t2m_generator: losses finite, t2m_generator.pkl written in the JAX layout")
    check(list(metrics) == list(EVAL_KEYS) and all(np.isfinite(v) for v in metrics.values()),
          "train_t2m_generator --run_eval: the metric dict is finite with the JAX CLI's keys")
    check_launches("train_t2m_generator", counts, {})
    return totals


# kernel 4 against its twin: the serving shape, S=197, the eval phase's
# guided humanml batch under --fused 0 (DDPM_LAYER: B = 2 x 32, S=197),
# S=600, head widths 32 and 48, and the edges of its key tiles
ATTN_SHAPES = ((B, S, D, H), (B, 197, D, H), (*DDPM_LAYER, D, H), (2, 600, D, H),
               (B, S, 128, 4), (B, S, 192, 4), (4, 1, D, H), (4, 33, D, H), (2, 513, D, H))
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


# ---------------------------------------------------------------------------
# the remaining host pieces (ROADMAP item 12): the trainer platforms,
# --profile, the native loader with --prefetch, and the SMPLify chain
# ---------------------------------------------------------------------------

ITEM12_STEPS = 4  # finetune steps a run: 3 intervals between step starts
SMPL_FRAMES, SMPL_ITERS, SMPL_VERTS = 196, 150, 6890  # a humanml clip; SMPL's mesh
# the card's mean joint error against the CPU fit's: two fp32 Adam runs of
# 170 steps drift apart by rounding (pose rel L2 7e-3 on the card, as the
# port's and the JAX fit drift on the CPU), not in what they reach
SMPL_ERROR_REL = 1e-2


def read_event_scalars(log_dir: str) -> list:
    """(tag, step, value) of every scalar in a directory's TensorBoard event
    files (TFRecord framing: length, its crc, an Event proto, its crc)."""
    import struct

    from tensorboardX.proto import event_pb2

    out = []
    for name in sorted(os.listdir(log_dir)):
        if "tfevents" in name:
            with open(os.path.join(log_dir, name), "rb") as f:
                data = f.read()
            pos = 0
            while pos < len(data):
                (n,) = struct.unpack("<Q", data[pos:pos + 8])
                event = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
                pos += 12 + n + 4
                out += [(v.tag, event.step, v.simple_value) for v in event.summary.value]
    return out


def trace_summary(path: str, top: int = 10) -> tuple:
    """A Chrome trace's device entries (kernels, copies, memsets): the `top`
    largest by summed duration as (name, count, ms), the count and ms of the
    host-to-device and device-to-host copies, the number of events, the
    device entries' summed ms and the trace's span in ms."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            n, us = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (n + 1, us + float(e.get("dur", 0.0)))
    rows = sorted(((k, n, us / 1e3) for k, (n, us) in by_name.items()), key=lambda r: -r[2])
    copies = {d: (sum(n for k, n, _ in rows if d in k), sum(ms for k, _, ms in rows if d in k))
              for d in ("HtoD", "DtoH")}
    timed = [e for e in events if e.get("ph") == "X" and "ts" in e]
    span_ms = (max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in timed)
               - min(float(e["ts"]) for e in timed)) / 1e3 if timed else 0.0
    return rows[:top], copies, len(events), sum(ms for _, _, ms in rows), span_ms


@contextmanager
def step_starts(trainer_cls):
    """The host clock at the entry of every trainer step: the intervals
    between them are whole loop iterations (the next batch's assembly, its
    text features and the step)."""
    starts: list = []
    run_step = trainer_cls.run_step

    def timed(self, batch):
        starts.append(time.perf_counter())
        return run_step(self, batch)

    trainer_cls.run_step = timed
    try:
        yield starts
    finally:
        trainer_cls.run_step = run_step


@contextmanager
def native_collate_calls():
    """Count the native loader's calls of the C++ batch assembly."""
    from motionstyle_torch.native import loader as native_loader

    calls = {"n": 0}
    collate = native_loader.window_normalize_collate

    def counted(*a, **k):
        calls["n"] += 1
        return collate(*a, **k)

    native_loader.window_normalize_collate = counted
    try:
        yield calls
    finally:
        native_loader.window_normalize_collate = collate


def item12_finetune(label: str, argv: list, card: str) -> dict:
    """One finetune CLI run (store path: kernels 8, 6, 9) with its counts set
    to 0 just before it and read just after: 104 / 56 / 56 launches of
    kernels 8 / 6 / 9 a step and no other training kernel, finite losses.
    Returns the launches, losses, loop intervals and the save dir."""
    import csv

    import numpy as np
    import torch

    from motionstyle_torch.cli.finetune_style_diffusion import main as finetune_main
    from motionstyle_torch.ops import fused_encoder_train as ft
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer
    from motionstyle_torch.train.finetune import StyleFinetuneTrainer

    random.seed(10)  # the loader's crops and captions
    # the main path: every count from here to the end of the run
    _zero_counts(ft)
    fused_encoder_layer.launches = 0
    with step_starts(StyleFinetuneTrainer) as starts, native_collate_calls() as native:
        t0 = time.perf_counter()
        save_dir = finetune_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _prior_counts(ft)
    with open(os.path.join(save_dir, "progress.csv")) as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    loops = [float(x) for x in np.diff(starts)]
    steps = ITEM12_STEPS
    fwd, ffn, attn = ("fused_layer_train_forward_store", "fused_layer_train_bwd_ffn",
                      "fused_layer_train_bwd_attn_stored")
    want = {n: (0, 0) for n in TRAIN_NAMES}
    want.update({fwd: (104 * steps, 0), ffn: (56 * steps, 0), attn: (56 * steps, 0)})
    got = {n: counts[n] for n in TRAIN_NAMES}
    print(f"  {label}: {steps} steps, whole CLI run {wall:.4f} s on {card}; losses {losses}; "
          f"loop seconds between step starts {[round(x, 6) for x in loops]}; native batch "
          f"assemblies {native['n']}; kernel 1 launches {fused_encoder_layer.launches}; "
          f"(launches, prng launches) {got}", flush=True)
    check(len(losses) == steps and bool(np.isfinite(losses).all()), f"{label}: losses finite")
    check(got == want, f"{label}: kernels 8 / 6 / 9 launched 104 / 56 / 56 times a step, "
                       "kernels 5 and 7 never")
    check(fused_encoder_layer.launches > 0, f"{label}: kernel 1 launched (neutral content, "
                                            "final resample)")
    return dict(launches={n: c[0] for n, c in got.items()}, k1=fused_encoder_layer.launches,
                losses=losses, loops=loops, native=native["n"], save_dir=save_dir)


def native_batches_check(data_dir: str, card: str) -> None:
    """The native loader's batch of FINETUNE_BATCH clips against the numpy
    twin's (DataLoader + t2m_style_collate) on one seed: the motion equal to
    float32 rounding (rtol 1e-5, atol 1e-6), masks, lengths, captions and
    styles equal; PrefetchLoader's batches bit-equal to the native loader's,
    in order; each assembly's host milliseconds (median of 20)."""
    import numpy as np

    from motionstyle_torch.data.collate import DataLoader, t2m_style_collate
    from motionstyle_torch.data.datasets import StyleMotionDataset, get_opt
    from motionstyle_torch.native.loader import NativeStyleLoader, PrefetchLoader

    ds = StyleMotionDataset(get_opt("stylexia_posrot", data_dir), split="train")
    batches = {}
    for name, make in (("native", lambda: NativeStyleLoader(ds, FINETUNE_BATCH, seed=5)),
                       ("numpy", lambda: DataLoader(ds, FINETUNE_BATCH, t2m_style_collate,
                                                    seed=5)),
                       ("prefetch", lambda: PrefetchLoader(
                           NativeStyleLoader(ds, FINETUNE_BATCH, seed=5), depth=2))):
        random.seed(3)
        batches[name] = list(make()) + list(make())  # two epochs
    nat, ref, pre = batches["native"], batches["numpy"], batches["prefetch"]
    err = max(float(np.abs(m - r).max()) for (m, _), (r, _) in zip(nat, ref))
    same = all(np.allclose(m, r, rtol=1e-5, atol=1e-6)
               and all(np.array_equal(c["y"][k], rc["y"][k]) for k in ("mask", "lengths"))
               and c["y"]["text"] == rc["y"]["text"] and c["y"]["style"] == rc["y"]["style"]
               for (m, c), (r, rc) in zip(nat, ref))
    check(len(nat) == len(ref) == len(pre) > 0 and same,
          f"native batches of {FINETUNE_BATCH} equal the numpy twin's to float32 rounding "
          f"(max_abs {err:.3g})")
    check(all(np.array_equal(m, p) and c["y"]["text"] == pc["y"]["text"]
              for (m, c), (p, pc) in zip(nat, pre)),
          "PrefetchLoader's batches bit-equal to the native loader's, in order")
    idx = np.arange(FINETUNE_BATCH)
    loader = NativeStyleLoader(ds, FINETUNE_BATCH)
    ms = {}
    for name, fn in (("native", lambda: loader._assemble(idx)),
                     ("numpy", lambda: t2m_style_collate([ds[int(i)] for i in idx]))):
        secs = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            secs.append(time.perf_counter() - t0)
        ms[name] = 1e3 * float(np.median(secs))
    print(f"  batch assembly of {FINETUNE_BATCH} clips (76 x 181), host ms (median of 20): "
          f"native {ms['native']:.4f}, numpy twin {ms['numpy']:.4f}; on {card}'s host",
          flush=True)


def seeded_fk_clip(smpl, frames: int):
    """A (frames, 22, 3) joint clip from a seeded smooth pose track through
    the body model's own forward kinematics, lifted 0.9 above the origin."""
    import numpy as np
    import torch

    from motionstyle_torch.core import rotations as rot
    from motionstyle_torch.models.smpl import lbs

    r = np.random.RandomState(0)
    t = np.arange(frames)[:, None] / 20.0
    pose = (r.rand(1, 72) * 0.3 * np.sin((r.rand(1, 72) * 2 + 0.5) * t
                                         + r.rand(1, 72) * 6.28)).astype(np.float32)
    with torch.no_grad():
        _, joints = lbs(smpl.model, torch.zeros(frames, 10),
                        rot.axis_angle_to_matrix(torch.from_numpy(pose).reshape(frames, 24, 3)),
                        skin=False)
    return joints[:, :22].numpy() + np.array([0.0, 0.9, 0.0], np.float32)


def smplify_check(smpl, clip, card: str) -> tuple:
    """Joints2SMPL on the card at SMPL_ITERS and the same fit on the CPU:
    seconds a fit, the mean joint error before (the rest pose at the torso
    camera) and after, pose / betas / camera rel L2 card against CPU, gated
    as check_ik_fits gates the IK: the fitted joints within POST_IK_REL of
    the CPU's and the error no larger than the start's; and the card's error
    within SMPL_ERROR_REL of the CPU's (the same fit quality). Returns the
    card's
    (pose tensor, fitted pose / betas / camera, fitter)."""
    import numpy as np
    import torch

    from motionstyle_torch.core import rotations as rot
    from motionstyle_torch.models.smpl import lbs
    from motionstyle_torch.post.smplify import Joints2SMPL

    def joints_of(fit):
        T = len(clip)
        with torch.no_grad():
            _, j = lbs(smpl.model, torch.as_tensor(fit["betas"]),
                       rot.axis_angle_to_matrix(torch.as_tensor(fit["pose"]).reshape(T, 24, 3)),
                       skin=False)
        return j[:, :22].numpy() + fit["cam"][:, None]

    fits, secs = {}, {}  # "card" / "cpu" -> (pose tensor, warm start, fitter), seconds
    for name, dev in (("card", "cuda"), ("cpu", "cpu")):
        j2s = Joints2SMPL(smpl, num_smplify_iters=SMPL_ITERS, device=dev)
        t0 = time.perf_counter()
        out, fit = j2s.joint2smpl(clip)  # ends in a copy to the host: synchronised
        secs[name] = time.perf_counter() - t0
        fits[name] = (out, fit, j2s)
    rest = joints_of({"pose": np.zeros((len(clip), 72), np.float32),
                      "betas": np.zeros((len(clip), 10), np.float32),
                      "cam": np.zeros((len(clip), 3), np.float32)})
    torso = [2, 1, 17, 16]
    rest += (clip[:, torso] - rest[:, torso]).mean(axis=1, keepdims=True)
    before = float(np.abs(rest - clip).mean())
    after = {d: float(np.abs(joints_of(f[1]) - clip).mean()) for d, f in fits.items()}
    rel = {k: rel_l2(torch.as_tensor(fits["card"][1][k]), torch.as_tensor(fits["cpu"][1][k]))
           for k in ("pose", "betas", "cam")}
    host, dev = joints_of(fits["cpu"][1]), joints_of(fits["card"][1])
    jrel = rel_l2(torch.as_tensor(dev), torch.as_tensor(host))
    # about their mean too: the synthetic body's joints sit within
    # millimetres of each other, far from the origin, so this one shows the
    # fp32 drift of two Adam runs through an ill-conditioned fit
    mean = host.mean(axis=(0, 1))
    crel = rel_l2(torch.as_tensor(dev - mean), torch.as_tensor(host - mean))
    print(f"  SMPLify ({len(clip)} frames, 22 joints, {SMPL_VERTS} vertices, 20 + {SMPL_ITERS} "
          f"Adam steps): {secs['card']:.4f} s a fit on {card}, {secs['cpu']:.4f} s on the CPU; "
          f"mean |joint error| {before:.6g} -> {after['card']:.6g} (CPU {after['cpu']:.6g}); "
          f"card against CPU rel L2: joints {jrel:.6g} (about their mean {crel:.6g}), pose "
          f"{rel['pose']:.6g}, betas "
          f"{rel['betas']:.6g}, cam {rel['cam']:.6g}", flush=True)
    check(jrel <= POST_IK_REL, f"SMPLify: the fitted joints on the card within rel L2 "
                               f"{POST_IK_REL} of the CPU fit's")
    check(after["card"] <= before, "SMPLify: the joint error after <= before")
    check(abs(after["card"] - after["cpu"]) <= SMPL_ERROR_REL * after["cpu"],
          f"SMPLify: the card's joint error within {SMPL_ERROR_REL:g} of the CPU's")
    out, fit, j2s = fits["card"]
    check(out.shape == (1, 25, 6, len(clip)) and bool(np.isfinite(out).all()),
          "SMPLify: a finite (1, 25, 6, T) pose tensor")
    return out, fit, j2s


def item12_phase(card: str, data_dir: str, tmp_root: str, mdm_path: str) -> dict:
    """ROADMAP item 12 at full width: probe tensorboardX; the finetune CLI at
    its default platform (or NoPlatform, after checking that the default
    raises ImportError naming tensorboardX where it is missing) with
    --native_loader 1 --prefetch 2 --profile DIR --fused_train_store 1: the
    trace's largest device entries and its copies; then the numpy loader and
    native + prefetch in turns (numpy, native, native, numpy) for the loop's
    seconds a step; the native batches against the numpy twin's; a traced
    demo; SMPLify at SMPL's size on a seeded FK clip, card against CPU, then
    fit_seq and render_mesh at their CLI defaults and joints2bvh,
    motions2hik, plot_3d_array and render_mesh_frames. Returns the launches
    of kernels 1, 8, 6 and 9 in its runs."""
    import numpy as np
    import torch

    from motionstyle_torch.cli.demo_style_transfer import main as demo_main
    from motionstyle_torch.cli.fit_seq import main as fit_seq_main
    from motionstyle_torch.cli.render_mesh import main as render_mesh_main
    from motionstyle_torch.core import params, rotations as rot
    from motionstyle_torch.models.smpl import SMPL, lbs, random_smpl_model
    from motionstyle_torch.native import build as native_build
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer
    from motionstyle_torch.post.bvh import read_bvh
    from motionstyle_torch.post.motions2hik import motions2hik
    from motionstyle_torch.post.render import plot_3d_array, render_mesh_frames
    from motionstyle_torch.post.vis_utils import joints2bvh
    from motionstyle_torch.train.platforms import get_platform
    from motionstyle_torch.utils import TRACE_FILE

    root = os.path.join(tmp_root, "item12")
    try:
        import tensorboardX

        tbx = tensorboardX.__version__
    except ImportError as ex:
        tbx = None
        print(f"  tensorboardX on this machine: missing ({ex})", flush=True)
    if tbx is None:
        try:
            get_platform("TensorboardPlatform", os.path.join(root, "tb_probe"))
            raised = ""
        except ImportError as ex:
            raised = str(ex)
        check("tensorboardX" in raised, "the default platform raises ImportError naming "
                                        "tensorboardX")
        platform = ["--train_platform_type", "NoPlatform"]
        print("  the finetune below runs with --train_platform_type NoPlatform: no "
              "tensorboardX", flush=True)
    else:
        platform = []
        print(f"  tensorboardX on this machine: {tbx}; the finetune below runs at the "
              "default --train_platform_type (TensorboardPlatform)", flush=True)

    def argv(save_dir: str, *extra) -> list:
        return ["--dataset", "stylexia_posrot", "--data_dir", data_dir, "--mdm_path", mdm_path,
                "--save_dir", os.path.join(root, save_dir), "--fused", "1", "--fused_train", "1",
                "--fused_train_store", "1", "--batch_size", str(FINETUNE_BATCH), "--layers",
                str(FINETUNE_LAYERS), "--num_steps", str(ITEM12_STEPS), "--skip_render",
                "--seed", "10", "--device", "cuda", *extra]

    native = ["--native_loader", "1", "--prefetch", "2"]
    trace_dir = os.path.join(root, "trace_finetune")
    runs = [item12_finetune("finetune (default platform, native + prefetch, traced)",
                            argv("traced", *platform, *native, "--profile", trace_dir), card)]
    check(runs[0]["native"] > 0, "the traced finetune assembled its batches natively")
    if tbx is not None:
        events = read_event_scalars(runs[0]["save_dir"])
        check(sorted(s for t, s, _ in events if t == "Loss/loss") == list(range(ITEM12_STEPS)),
              f"TensorboardPlatform wrote Loss/loss at steps 0-{ITEM12_STEPS - 1} "
              f"({len(events)} scalars)")
    path = os.path.join(trace_dir, TRACE_FILE)
    top, copies, n_events, device_ms, span_ms = trace_summary(path)
    print(f"  finetune trace {path}: {os.path.getsize(path) / 1e6:.4g} MB, {n_events} events; "
          f"device entries {device_ms:.4f} ms over the trace's {span_ms:.4f} ms "
          f"({100 * device_ms / max(span_ms, 1e-9):.4g} % busy, overlaps counted twice); "
          f"host-to-device copies {copies['HtoD'][0]} ({copies['HtoD'][1]:.4f} ms), "
          f"device-to-host {copies['DtoH'][0]} ({copies['DtoH'][1]:.4f} ms); the "
          f"{len(top)} largest device entries:" if top else
          f"  finetune trace {path}: {n_events} events, no device entry recorded (device "
          "time not measured)", flush=True)
    for name, n, ms in top:
        print(f"    {ms:10.4f} ms {n:7d} x  {name[:90]}", flush=True)
    check(n_events > 0, "the finetune's trace parses and holds events")

    # the loop's seconds a step, numpy loader and native + prefetch in turns
    loops = {"numpy": [], "native": []}
    for label in ("numpy", "native", "native", "numpy"):
        extra = native if label == "native" else []
        runs.append(item12_finetune(f"finetune ({label} loader, NoPlatform)",
                                    argv(f"{label}_{len(runs)}", "--train_platform_type",
                                         "NoPlatform", *extra), card))
        loops[label] += runs[-1]["loops"][1:]  # the first interval holds the warm-up
        check((runs[-1]["native"] > 0) == (label == "native"),
              f"the {label} loader's run assembled its batches "
              f"{'natively' if extra else 'in numpy'}")
    print("  finetune loop seconds a step (median of the intervals between step starts after "
          f"each run's first, runs in turns numpy, native, native, numpy): numpy loader {np.median(loops['numpy']):.6g}"
          f" {[round(x, 6) for x in loops['numpy']]}, native + prefetch "
          f"{np.median(loops['native']):.6g} {[round(x, 6) for x in loops['native']]} on "
          f"{card}; the runs' first losses {[r['losses'][0] for r in runs]}", flush=True)
    native_batches_check(data_dir, card)
    print(f"  native ingest library: {native_build.last_build['path']}, g++ flags "
          f"{' '.join(native_build.last_build['flags'])}; the host's CPUs: {os.cpu_count()} "
          f"({len(os.sched_getaffinity(0))} usable; the C++ pass starts up to that many "
          "threads a batch)", flush=True)

    # a traced demo on the traced finetune's checkpoint
    model = sorted(glob.glob(os.path.join(runs[0]["save_dir"], "model*.pt")))[-1]
    fused_encoder_layer.launches = 0
    demo_trace = os.path.join(root, "trace_demo")
    demo_main(["--model_path", model, "--input_content", DEMO_CONTENT, "--data_dir", data_dir,
               "--skip_render", "--num_samples", str(DEMO_SAMPLES), "--output_dir",
               os.path.join(root, "demo"), "--fused", "1", "--device", "cuda",
               "--profile", demo_trace])
    torch.cuda.synchronize()
    demo_k1 = fused_encoder_layer.launches
    top, _, n_events, _, _ = trace_summary(os.path.join(demo_trace, TRACE_FILE), top=3)
    print(f"  demo --profile: kernel 1 launches {demo_k1}; trace {n_events} events; largest "
          f"device entries {[(name[:40], n, round(ms, 4)) for name, n, ms in top]}", flush=True)
    check(n_events > 0 and demo_k1 == 2 * FINETUNE_LAYERS,
          f"demo --profile: a trace that parses; kernel 1 launched {2 * FINETUNE_LAYERS} times")

    # SMPLify at SMPL's size, then the CLIs and the other exports
    smpl = SMPL(random_smpl_model(np.random.RandomState(0), n_verts=SMPL_VERTS))
    clip = seeded_fk_clip(smpl, SMPL_FRAMES)
    out, fit, j2s = smplify_check(smpl, clip, card)
    clips = os.path.join(root, "clips")
    os.makedirs(clips)
    np.save(os.path.join(clips, "clip.npy"), clip)
    t0 = time.perf_counter()
    params_path, = fit_seq_main(["--data_folder", clips, "--files", "clip.npy", "--save_folder",
                                 os.path.join(root, "fit"), "--chunk", "64", "--save_obj", "1"])
    fit_s = time.perf_counter() - t0
    d = np.load(params_path, allow_pickle=True).item()
    objs = os.listdir(os.path.join(root, "fit", "clip_obj"))
    print(f"  fit_seq --chunk 64 --save_obj 1: {fit_s:.4f} s; pose {d['pose'].shape}, motion "
          f"{d['motion'].shape}; {len(objs)} OBJ files", flush=True)
    check(d["pose"].shape == (SMPL_FRAMES, 72) and d["motion"].shape == (1, 25, 6, SMPL_FRAMES)
          and bool(np.isfinite(d["pose"]).all()) and len(objs) == SMPL_FRAMES,
          f"fit_seq: smpl_params.npy of {SMPL_FRAMES} frames and an OBJ a frame")
    results = os.path.join(root, "mesh", "results.npy")
    os.makedirs(os.path.dirname(results))
    np.save(results, {"motion": clip.transpose(1, 2, 0)[None], "text": ["a person moves"],
                      "lengths": np.asarray([SMPL_FRAMES]), "num_samples": 1,
                      "num_repetitions": 1})
    t0 = time.perf_counter()
    obj_dir = render_mesh_main(["--results", results])
    mesh_s = time.perf_counter() - t0
    objs = os.listdir(obj_dir)
    mp = np.load(os.path.join(root, "mesh", "sample00_rep00_smpl_params.npy"),
                 allow_pickle=True).item()
    print(f"  render_mesh --results: {mesh_s:.4f} s; {len(objs)} OBJ files; vertices "
          f"{mp['vertices'].shape}", flush=True)
    check(len(objs) == SMPL_FRAMES and mp["length"] == SMPL_FRAMES
          and bool(np.isfinite(mp["vertices"]).all()),
          f"render_mesh: {SMPL_FRAMES} OBJ files and finite vertices")
    bvh = os.path.join(root, "fit.bvh")
    t0 = time.perf_counter()
    joints2bvh(bvh, clip, params.smpl_real_offsets, params.t2m_kinematic_chain, j2s)
    bvh_s = time.perf_counter() - t0
    anim = read_bvh(bvh)
    hik = motions2hik(out)
    t0 = time.perf_counter()
    frames = plot_3d_array((clip, "smplify", params.t2m_kinematic_chain))
    T = 20  # the card fit's first frames as a point-cloud video
    with torch.no_grad():
        verts, _ = lbs(smpl.model, torch.as_tensor(fit["betas"][:T]), rot.axis_angle_to_matrix(
            torch.as_tensor(fit["pose"][:T]).reshape(T, 24, 3)))
    gif = render_mesh_frames(verts.numpy().transpose(1, 2, 0),
                             save_path=os.path.join(root, "mesh.mp4"))
    from PIL import Image

    with Image.open(gif) as im:
        gif_frames = im.n_frames
    print(f"  joints2bvh {bvh_s:.4f} s ({anim.shape}); motions2hik thetas "
          f"{np.asarray(hik['thetas']).shape}; plot_3d_array {frames.shape}; render_mesh_frames "
          f"{gif_frames} frames of {verts.shape[1]} vertices; renders {time.perf_counter() - t0:.4f}"
          " s", flush=True)
    check(anim.shape == (SMPL_FRAMES, 22) and np.asarray(hik["thetas"]).shape == (
        1, SMPL_FRAMES, 24, 3) and frames.shape == (SMPL_FRAMES, 300, 300, 3)
          and gif_frames == T, "joints2bvh, motions2hik, plot_3d_array and render_mesh_frames "
                               "give every frame")
    launches = {"fused_encoder_layer": sum(r["k1"] for r in runs) + demo_k1}
    for n in TRAIN_NAMES:
        launches[n] = sum(r["launches"][n] for r in runs)
    return launches


ITEM11_STEPS = 3
ITEM11_FT_WANT = (104, 56, 56)  # kernels 5 / 6 / 7 a step of the 8-layer recompute finetune
ITEM11_TIMEOUT = 420  # seconds one torchrun may take
ITEM11_DEMO_ATOL = 1e-4  # tests/test_parallel.py:97
ITEM11_FT_NAMES = ("fused_layer_train_forward", "fused_layer_train_bwd_ffn",
                   "fused_layer_train_bwd_attn")


def cuda_collectives() -> dict:
    """{collective: True or the error} for a CUDA tensor in the default
    group's backend (gloo where ranks share the card)."""
    import torch
    import torch.distributed as dist

    out = {}
    for name, call in (("all_reduce", lambda t: dist.all_reduce(t)),
                       ("broadcast", lambda t: dist.broadcast(t, 0)),
                       ("all_gather", lambda t: dist.all_gather(
                           [torch.empty_like(t) for _ in range(dist.get_world_size())], t))):
        try:
            call(torch.ones(4, device="cuda"))
            torch.cuda.synchronize()
            out[name] = True
        except Exception as ex:  # noqa: BLE001 — what the backend refuses is the answer
            out[name] = (str(ex).splitlines() or [type(ex).__name__])[0][:160]
    return out


def item11_rank(spec_path: str) -> int:
    """One torchrun rank of the item11 phase: each of the spec's runs (the
    finetune CLI, the demo) in this process, in turn, its kernel counts set
    to 0 just before it and read just after; the infos with each run's
    seconds go to <out>.rank<r>.json. The demo's run is left out, with the
    reason, where gloo takes no all-reduce of CUDA tensors."""
    import torch

    sys.path.insert(0, ROOT)
    from motionstyle_torch.cli.demo_style_transfer import main as demo_main
    from motionstyle_torch.cli.finetune_style_diffusion import main as finetune_main
    from motionstyle_torch.ops import fused_encoder_train as ft
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer
    from motionstyle_torch.parallel import mesh as mesh_lib

    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    info = {"rank": rank, "runs": []}
    torch.backends.cuda.matmul.allow_tf32 = False
    with mesh_lib.distributed("cuda"):
        import torch.distributed as dist

        info["backend"] = dist.get_backend()
        info["collectives"] = cuda_collectives()
        for run in spec["runs"]:
            if run["kind"] == "demo" and info["collectives"]["all_reduce"] is not True:
                info["runs"].append({"kind": "demo", "skipped": "gloo takes no all_reduce on "
                                     "CUDA tensors here"})
                continue
            random.seed(10)  # the loader's crops and captions, as the world-1 run's
            _zero_counts(ft)
            fused_encoder_layer.launches = 0
            t0 = time.perf_counter()
            out = (finetune_main if run["kind"] == "finetune" else demo_main)(run["argv"])
            torch.cuda.synchronize()
            info["runs"].append({
                "kind": run["kind"], "out": out, "seconds": time.perf_counter() - t0,
                "counts": {n: c[0] for n, c in _prior_counts(ft).items() if n in TRAIN_NAMES},
                "k1": fused_encoder_layer.launches})
    with open(f"{spec['out']}.rank{rank}.json", "w") as f:
        json.dump(info, f)
    return 0


def torchrun(spec: dict, nproc: int = 2) -> tuple:
    """Run item11_rank on nproc ranks under torchrun (its own process group,
    killed whole on a timeout); returns (each rank's info, seconds)."""
    with open(spec["out"] + ".spec.json", "w") as f:
        json.dump(spec, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), os.path.abspath(__file__), "--item11-rank", spec["out"] + ".spec.json"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, start_new_session=True)
    try:
        rc = proc.wait(timeout=ITEM11_TIMEOUT)
    except subprocess.TimeoutExpired:
        import signal

        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = "timeout"
    secs = time.perf_counter() - t0
    check(rc == 0, f"torchrun of {[r['kind'] for r in spec['runs']]} on {nproc} ranks exited 0 "
                   f"(got {rc})")
    infos = []
    for r in range(nproc):
        with open(f"{spec['out']}.rank{r}.json") as f:
            infos.append(json.load(f))
    return infos, secs


def csv_losses(save_dir: str) -> list:
    import csv

    with open(os.path.join(save_dir, "progress.csv")) as f:
        return [float(r["loss"]) for r in csv.DictReader(f)]


def fsdp_arm(card: str, tmp_root: str) -> dict:
    """(b): the finetune trainer at full width with fsdp on a world-1 NCCL
    mesh and the training kernels, 3 steps against the plain trainer's
    (rtol 1e-3); its DCP checkpoint restored into a plain trainer,
    parameters and Adam moments bit-equal. Returns kernels 5-7's launches
    in the FSDP run."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from motionstyle_torch.diffusion.schedule import make_schedule
    from motionstyle_torch.models.denoiser import MDMConfig, StyleDiffusion
    from motionstyle_torch.ops import fused_encoder_train as ft
    from motionstyle_torch.parallel import mesh as mesh_lib
    from motionstyle_torch.train.finetune import FinetuneConfig, StyleFinetuneTrainer

    rs = np.random.RandomState(11)
    B, C, T = FINETUNE_BATCH, 181, 76
    inp = np.zeros((1, C, 1, T), np.float32)
    inp[:, :3] = 1.0
    batches = [{"x_start": rs.randn(B, C, 1, T).astype(np.float32),
                "content": rs.randn(1, C, 1, T).astype(np.float32),
                "style_target": rs.randn(1, C, 1, T).astype(np.float32),
                "mask": np.ones((1, 1, 1, T), np.float32), "inp_mask": inp,
                "enc_text_style": rs.randn(1, 512).astype(np.float32),
                "enc_text_t2m": rs.randn(B, 512).astype(np.float32),
                "inp_mask_t2m": np.repeat(inp, B, 0),
                "frame_mask_t2m": np.ones((B, T), bool),
                "text_features": rs.randn(1, 512).astype(np.float32)}
               for _ in range(ITEM11_STEPS)]
    sched = make_schedule("cosine", 1000, "ddim20", device="cuda")

    def trainer(name, mesh=None, fsdp=False):
        torch.manual_seed(0)
        model = StyleDiffusion(MDMConfig(fused_train=True)).cuda()
        cfg = FinetuneConfig(save_dir=os.path.join(tmp_root, "item11", name), seed=10,
                             save_interval=10 ** 9, lr=1e-4)
        return StyleFinetuneTrainer(cfg, model, sched, mesh=mesh, fsdp=fsdp)

    dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp_root, "item11_pg"),
                            rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_mesh(1, device="cuda")
        t0 = time.perf_counter()
        fs = trainer("fsdp", mesh, fsdp=True)
        sharded = [type(p).__name__ for p, _ in fs.params[:1]]
        _zero_counts(ft)
        got = [fs.run_step(dict(b))["loss"] for b in batches]
        torch.cuda.synchronize()
        counts = {n: c[0] for n, c in _prior_counts(ft).items() if n in TRAIN_NAMES}
        fs_secs = time.perf_counter() - t0
        plain = trainer("plain")
        want = [plain.run_step(dict(b))["loss"] for b in batches]
        print(f"  (b) fsdp trainer on a world-1 {dist.get_backend()} mesh, parameters "
              f"{sharded[0]}: losses {got}; plain trainer {want}; kernels 5-7 launches "
              f"{counts}; {fs_secs:.4f} s on {card}", flush=True)
        check(np.allclose(got, want, rtol=1e-3), "(b) fsdp losses within rtol 1e-3 of the "
                                                 "plain trainer's")
        check(all(counts[n] == w * ITEM11_STEPS for n, w in zip(ITEM11_FT_NAMES, ITEM11_FT_WANT)),
              "(b) kernels 5 / 6 / 7 launched 104 / 56 / 56 times a step under fsdp")
        path = fs.save_dcp(ITEM11_STEPS)
        other = trainer("restored")
        check(other.load_sharded(path) == ITEM11_STEPS, "(b) the DCP step restored")
        a, b = fs.optimizer_leaves(), other.optimizer_leaves()
        same = len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
        pa = {k: mesh_lib.full_tensor(v).cpu() for k, v in
              fs.model.style_encoder.state_dict().items()}
        pb = {k: v.cpu() for k, v in other.model.style_encoder.state_dict().items()}
        same_p = pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k]) for k in pa)
        print(f"  (b) {path}: {len(a)} optimizer leaves, {len(pa)} parameters restored into a "
              "plain trainer", flush=True)
        check(same and same_p, "(b) the DCP checkpoint restores parameters and Adam moments "
                               "bit-equal")
    finally:
        dist.destroy_process_group()
    return counts


def item11_phase(card: str, data_dir: str, tmp_root: str, mdm_path: str,
                 model_path: str) -> dict:
    """ROADMAP item 11 at full width on the one card (see the module
    docstring's phase 26). Returns the launches of kernels 1 and 5-7."""
    import numpy as np
    import torch

    from motionstyle_torch.cli.demo_style_transfer import main as demo_main
    from motionstyle_torch.cli.finetune_style_diffusion import main as finetune_main
    from motionstyle_torch.ops import fused_encoder_train as ft
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer

    root = os.path.join(tmp_root, "item11")
    os.makedirs(root, exist_ok=True)

    def ft_argv(save_dir: str, *extra) -> list:
        return ["--dataset", "stylexia_posrot", "--data_dir", data_dir, "--mdm_path", mdm_path,
                "--save_dir", os.path.join(root, save_dir), "--fused", "1", "--fused_train", "1",
                "--batch_size", str(FINETUNE_BATCH), "--layers", str(FINETUNE_LAYERS),
                "--num_steps", str(ITEM11_STEPS), "--skip_render", "--seed", "10",
                "--train_platform_type", "NoPlatform", "--device", "cuda", *extra]

    # (a) and (c): one torchrun of two ranks sharing the card, the data-
    # parallel finetune, then the demo's tensor parallelism
    demo = ["--model_path", model_path, "--input_content", DEMO_CONTENT, "--data_dir", data_dir,
            "--skip_render", "--num_samples", str(DEMO_SAMPLES), "--seed", "10",
            "--device", "cuda"]
    infos, secs = torchrun({"out": os.path.join(root, "ranks"), "runs": [
        {"kind": "finetune", "argv": ft_argv("dp", "--data_parallel", "1")},
        {"kind": "demo", "argv": demo + ["--output_dir", os.path.join(root, "demo_tp"),
                                         "--model_parallel", "2"]}]})
    print(f"  torch.distributed backend with 2 ranks on the card: {infos[0]['backend']}; "
          f"collectives on CUDA tensors: {infos[0]['collectives']}; torchrun {secs:.4f} s",
          flush=True)
    ranks_ft = [i["runs"][0] for i in infos]
    losses2 = csv_losses(ranks_ft[0]["out"])
    random.seed(10)
    _zero_counts(ft)
    fused_encoder_layer.launches = 0
    t0 = time.perf_counter()
    one = finetune_main(ft_argv("one"))
    torch.cuda.synchronize()
    one_secs = time.perf_counter() - t0
    one_counts = {n: c[0] for n, c in _prior_counts(ft).items() if n in TRAIN_NAMES}
    k1_one = fused_encoder_layer.launches
    losses1 = csv_losses(one)
    print(f"  (a) finetune --data_parallel 1 on 2 ranks (global batch {FINETUNE_BATCH}): "
          f"in-rank CLI {[round(r['seconds'], 4) for r in ranks_ft]} s; losses {losses2}; "
          f"world-1 run {one_secs:.4f} s, losses {losses1}; per-rank kernels 5-7 launches "
          f"{[r['counts'] for r in ranks_ft]}, kernel 1 {[r['k1'] for r in ranks_ft]}; on "
          f"{card}", flush=True)
    check(len(losses2) == len(losses1) == ITEM11_STEPS and
          np.allclose(losses2, losses1, rtol=1e-3),
          "(a) the 2-rank losses within rtol 1e-3 of the world-1 run's")
    for r, run in enumerate(ranks_ft):
        check(all(run["counts"][n] == w * ITEM11_STEPS
                  for n, w in zip(ITEM11_FT_NAMES, ITEM11_FT_WANT)),
              f"(a) rank {r} launched kernels 5 / 6 / 7 104 / 56 / 56 times a step")
    launches = {n: sum(r["counts"][n] for r in ranks_ft) + one_counts[n] for n in TRAIN_NAMES}
    launches["fused_encoder_layer"] = sum(r["k1"] for r in ranks_ft) + k1_one

    # (b) fsdp on a world-1 NCCL mesh
    t0 = time.perf_counter()
    for n, c in fsdp_arm(card, tmp_root).items():
        launches[n] += c
    print(f"  (b) arm {time.perf_counter() - t0:.4f} s on {card}", flush=True)

    # (c) the demo's tensor parallelism over the two ranks
    ranks_demo = [i["runs"][1] for i in infos]
    if "skipped" in ranks_demo[0]:
        print(f"  (c) not run: {ranks_demo[0]['skipped']} "
              f"({infos[0]['collectives']['all_reduce']})", flush=True)
        return launches
    t0 = time.perf_counter()
    want = np.load(os.path.join(demo_main(demo + ["--output_dir", os.path.join(root, "demo1")]),
                                "results.npy"), allow_pickle=True).item()["hml"]
    one_secs = time.perf_counter() - t0
    got = np.load(os.path.join(ranks_demo[0]["out"], "results.npy"),
                  allow_pickle=True).item()["hml"]
    err = float(np.abs(got - want).max())
    print(f"  (c) demo --model_parallel 2 on 2 ranks: in-rank CLI "
          f"{[round(r['seconds'], 4) for r in ranks_demo]} s; world-1 demo {one_secs:.4f} s; "
          f"hml {got.shape} max_abs {err:.6g} on {card}", flush=True)
    check(got.shape == want.shape and err <= ITEM11_DEMO_ATOL,
          f"(c) the tensor-parallel demo within atol {ITEM11_DEMO_ATOL} of the world-1 demo")
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
    with phase("arch"):
        launches_arch = arch_phase(card, device)
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
        # two styles finetuned from the golden prior: the recompute and the
        # store runs of the finetune phase
        style_paths = tuple(sorted(glob.glob(os.path.join(tmp, run, "*", "model*.pt")))[-1]
                            for run in ("ft", "ft_store"))
        mdm_path = os.path.join(tmp, "mdm_golden.pt")
        with phase("lora"):
            launches_lora = lora_phase(mdm_path, card, data_dir, tmp, args_of, style_paths[0])
        with phase("distill"):
            launches_distill = distill_phase(card, data_dir, tmp, prior_path)
        with phase("demo"):
            demo_phase(model_path, data_dir, tmp, card)
        with phase("styles"):
            launches_styles = styles_phase(mdm_path, card, style_paths, tmp)
        with phase("export"):
            launches_art, launches_art8 = export_phase(mdm_path, card, style_paths, tmp)
        with phase("demo_long"):
            launches_demo_long = demo_long_phase(model_path, data_dir, tmp, card)
        with phase("humanml"):
            launches_hml = humanml_phase(card, tmp)
        with phase("eval"):
            launches_eval = eval_phase(card, tmp, data_dir, prior_path)
        with phase("item12"):
            launches_item12 = item12_phase(card, data_dir, tmp, mdm_path)
        with phase("item11"):
            launches_item11 = item11_phase(card, data_dir, tmp, mdm_path, model_path)
        with phase("quality"):
            launches_quality = quality_phase(card, tmp)
    # each kernel's launches on the paths that run it: kernels 5 and 7 on the
    # recompute finetune, kernels 8 and 9 and the shared kernel 6 on the
    # store-probs finetune; then the parallel, rendering and int8 finetunes,
    # the semantic, LoRA and quality phases, each counted from 0 around its
    # own run
    recompute_only = ("fused_layer_train_forward", "fused_layer_train_bwd_attn")
    new_paths = (launches_par, launches_sem, launches_lora, launches_quality)
    train_launches = {n: (launches_recompute if n in recompute_only else launches_store)[n]
                      + sum(p[n] for p in new_paths) for n in TRAIN_NAMES}
    launches += sum(p["fused_encoder_layer"] for p in new_paths)
    launches_int8 += launches_par["fused_encoder_layer_int8"]
    # the rest of serving: named styles and /v1/stream, the artifacts, the
    # demo's long-form and style-strength runs
    launches += launches_styles + launches_art + launches_demo_long
    launches_int8 += launches_art8 + launches_lora["fused_encoder_layer_int8"]
    # the humanml and bandai data path: kernels 1, 2 and 5-10 on its CLIs
    launches += launches_hml["fused_encoder_layer"]
    launches_int8 += launches_hml["fused_encoder_layer_int8"]
    for n in TRAIN_NAMES:
        train_launches[n] += launches_hml[n]
    # the T2M evaluation stack: kernels 1, 2 and 4 in eval_metrics's sampling
    launches += launches_eval["fused_encoder_layer"]
    launches_int8 += launches_eval["fused_encoder_layer_int8"]
    # the host pieces: kernels 8, 6, 9 and 1 in the item12 finetunes, 1 in its
    # traced demo
    launches += launches_item12["fused_encoder_layer"]
    for n in TRAIN_NAMES:
        train_launches[n] += launches_item12[n]
    # scale-out: kernels 5-7 on every rank of the data-parallel finetune, its
    # world-1 twin and the fsdp trainer; kernel 1 in the finetunes' sampling
    launches += launches_item11["fused_encoder_layer"]
    for n in TRAIN_NAMES:
        train_launches[n] += launches_item11[n]

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
                        launches=sum(prng_counts[n][1] for n in TRAIN_NAMES)
                        + launches_hml[PRNG_NAME],
                        **{k: train_records[PRNG_NAME][k] for k in keys}))
    # kernel 3 on the fused DDPM chain, kernel 4 on the unfused server and
    # the distiller under the variable
    kernels.append(dict(name="fused_ddpm_update", route="cuda",
                        source="motionstyle_torch/csrc/sampler_update.cu",
                        replaces="motionstyle/ops/sampler_update.py:45", launches=launches_update,
                        **{k: record_update[k] for k in keys}))
    kernels.append(dict(name="attention_kernel", route="cuda",
                        source="motionstyle_torch/csrc/attention.cu",
                        replaces="motionstyle/ops/attention.py:52",
                        launches=launches_attn + launches_distill + launches_arch
                        + launches_eval["attention_kernel"],
                        **{k: record_attn[k] for k in keys}))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--item11-rank":
        sys.exit(item11_rank(sys.argv[2]))
    sys.exit(main())
