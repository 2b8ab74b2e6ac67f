#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (motionstyle_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line with its seconds:
  1. device: the card's name and power limit (nvidia-smi); TF32 off.
  2. build: nvcc builds every kernel of the serving path from csrc/.
  3. kernel: each kernel against its plain PyTorch twin on the card at the
     serving shapes, with its time, the twin's, a library call's and the
     card's bound.
  4. golden: the port's fp32 MDM with the full-width reference weights of
     tests/goldens/mdm_model.npz against the reference output.
  5. serve: the serving CLI's engine (--fused 1, full width: d=512, 8
     layers) behind MotionServer on localhost answers /healthz and
     /v1/sample requests; results are checked and the kernel launches
     counted.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before it. Without
a CUDA device, or without the rest of the repository beside it, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "mdm_model.npz")

# the serving shape: a bucket of 8 clips of 76 frames + the condition token
B, S, D, H, F = 8, 77, 512, 4, 1024
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# kernel vs twin gates (bf16 output: one bf16 ulp at |y| in [2, 4) is 1.6e-2)
LAYER_MAX_ABS, LAYER_REL_L2, STACK_REL_L2 = 3e-2, 1e-2, 2e-2
GOLDEN_ATOL = 2e-4  # tests/test_models.py:35


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


def random_layer(gen, d: int, f: int, device):
    import torch

    from motionstyle_torch.ops.fused_encoder import WEIGHT_KEYS

    def r(*shape, std=1.0):
        return torch.randn(*shape, generator=gen) * std

    p = {"in_proj_weight": r(3 * d, d, std=d ** -0.5), "in_proj_bias": r(3 * d, std=0.1),
         "out_proj_weight": r(d, d, std=d ** -0.5), "out_proj_bias": r(d, std=0.1),
         "linear1_weight": r(f, d, std=d ** -0.5), "linear1_bias": r(f, std=0.1),
         "linear2_weight": r(d, f, std=f ** -0.5), "linear2_bias": r(d, std=0.1),
         "norm1_weight": 1 + r(d, std=0.1), "norm1_bias": r(d, std=0.1),
         "norm2_weight": 1 + r(d, std=0.1), "norm2_bias": r(d, std=0.1)}
    return {k: v.to(device=device, dtype=torch.bfloat16 if k in WEIGHT_KEYS
                    else torch.float32).contiguous() for k, v in p.items()}


def kernel_phase(device) -> dict:
    """Kernel vs twin on the card; returns the kernel's record fields."""
    from functools import partial

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
    bound_ms, bound_by, flops, nbytes = layer_bound(B, S, D, H, F)
    record.update(bound_ms=bound_ms, bound_by=bound_by)
    print(f"  B={B} S={S}: kernel_ms {record['ms']:.6g} reference_ms "
          f"{record['plain_ms']:.6g} library_ms {record['library_ms']:.6g} "
          f"bound_ms {bound_ms:.6g} ({bound_by}: {flops / 1e9:.4g} GFLOP, "
          f"{nbytes / 1e6:.4g} MB)", flush=True)
    return record


def golden_phase(device):
    import numpy as np
    import torch

    from motionstyle_torch.models.denoiser import MDM, MDMConfig
    from motionstyle_torch.models.params import from_torch_state_dict

    g = np.load(GOLDEN)
    sd = {k[len("sd__"):]: g[k] for k in g.files if k.startswith("sd__")}
    cfg = MDMConfig(njoints=181, nfeats=1)
    state = {k[len("mdm."):]: v for k, v in from_torch_state_dict(sd, cfg).items()}
    model = MDM(cfg)
    model.load_state_dict(state)
    model.to(device).eval()
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


def serve_phase(golden_sd, card: str) -> int:
    """Serve through the CLI's engine behind MotionServer; returns the
    kernel launches counted during the served traffic."""
    import numpy as np
    import torch

    from motionstyle_torch.cli import serve
    from motionstyle_torch.data.masks import get_inpainting_mask
    from motionstyle_torch.ops.fused_encoder import fused_encoder_layer
    from motionstyle_torch.serve.engine import Request
    from motionstyle_torch.serve.server import MotionServer

    njoints, nframes = serve.DATASET_DIMS["stylexia_posrot"]
    mask_full = np.asarray(get_inpainting_mask(
        "root_horizontal", (1, njoints, 1, nframes), dataset="stylexia_posrot"),
        np.float32)[0]
    mask = mask_full[:, 0, 0].astype(bool)  # the kept (root) channels
    with tempfile.TemporaryDirectory() as tmp:
        mdm_path = os.path.join(tmp, "mdm_golden.pt")
        torch.save({k: torch.as_tensor(v) for k, v in golden_sd.items()}, mdm_path)
        args = serve.parse_args([
            "--fused", "1", "--dataset", "stylexia_posrot", "--mdm_path", mdm_path,
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
        fused_encoder_layer.launches = 0
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
        for wave in range(4):
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
        launches = fused_encoder_layer.launches
    finally:
        server.close()

    check(len(results) == 16, "16 concurrent /v1/sample requests answered")
    for i, motion in results:
        if motion.shape != (njoints, 1, nframes) or not np.isfinite(motion).all():
            check(False, f"result shape {motion.shape} finite {np.isfinite(motion).all()}")
        if not np.array_equal(motion[mask], contents[i].T[:, None, :][mask]):
            check(False, "root_horizontal channels equal the content")
    check(True, "every result finite, (181, 1, 76), root_horizontal channels exact")
    lat = np.sort(np.asarray(latencies) * 1e3)
    p50, p95 = float(np.percentile(lat, 50)), float(np.percentile(lat, 95))
    print(f"  HTTP: {len(results)} requests in {wall:.4f} s: p50 {p50:.4f} ms, "
          f"p95 {p95:.4f} ms, {len(results) / wall:.4f} clips/s on {card}", flush=True)
    print(f"  engine: batch p50 {stats['batch_p50_ms']} ms (2 denoiser calls + noise), "
          f"submit-to-result p50 {stats['latency_p50_ms']} ms, mean batch "
          f"{stats['mean_batch_size']:.4g}", flush=True)
    print(f"  launches {launches} over {batches} batches "
          f"(8 layers x 2 denoiser calls each)", flush=True)
    check(launches == 16 * batches and batches > 0,
          "kernel launch counter == 16 x batches served")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from motionstyle_torch import _build  # absent when the script stands alone

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
        path, secs = _build.build("fused_encoder")
        _build.load("fused_encoder")
        print(f"  {os.path.relpath(path, ROOT)}: nvcc {secs:.3f} s", flush=True)
    with phase("kernel"):
        record = kernel_phase(device)
    with phase("golden"):
        golden_sd = golden_phase(device)
    with phase("serve"):
        launches = serve_phase(golden_sd, card)

    kernel = {"name": "fused_encoder_layer", "route": "cuda",
              "source": "motionstyle_torch/csrc/fused_encoder.cu",
              "replaces": "motionstyle/ops/fused_encoder.py:96",
              "launches": launches, "max_abs_err": record["max_abs_err"],
              "ms": record["ms"], "plain_ms": record["plain_ms"],
              "bound_ms": record["bound_ms"], "bound_by": record["bound_by"],
              "library_ms": record["library_ms"]}
    print(card, flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
