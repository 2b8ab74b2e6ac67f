#!/usr/bin/env python3
"""Where the time of kernels 7 and 9's attention backward goes, on one NVIDIA
GPU: the two launches of motionstyle_torch/csrc/fused_encoder_train.cu's
tensor-core attention backward (attention_bwd_rows_tc, attention_bwd_cols_tc)
built alone, once as they are and once per variant, and timed at the
finetune's and the humanml trainers' shapes (B=64, D=512, 4 heads, S=77 and
197), with the probabilities recomputed (kernel 7) and stored (kernel 9).

A variant is a set of text patches of the source's attention-backward block
(from `using attention::pv_chunk;` to `// LN1 statistics of a1`):
  * knock-outs take one part of the work away (a product, the exponentials,
    the rows launch's hand-over of p and ds): what the launch saves without
    it bounds what that part costs; their outputs are wrong by design;
  * tunings change a constant (warps of a cols block, BWD_CQ, the chunks of
    the rows launch's pass C): they must give the base's bits, which the
    script checks.
Each library is built with nvcc and motionstyle_torch._build.NVCC_FLAGS (all
in parallel) and called through a small C entry on random bf16 q, k, v and
dattn; every call is timed with CUDA events (50 calls) and split by launch
with torch.profiler (10 calls).

    python3 profile_attention_bwd.py [VARIANT ...]   # default: all

Prints the card's name and power limit first, then each variant's registers
and spills from the build log, and a line per shape with every variant's
microseconds (events) and its two launches' (profiler).
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "motionstyle_torch", "csrc")
SHAPES = ((64, 77, 512, 4, False), (64, 77, 512, 4, True), (64, 197, 512, 4, False),
          (64, 197, 512, 4, True))
TUNINGS = {
    "cols_warps_8": [("constexpr int COLS_WARPS = 4;", "constexpr int COLS_WARPS = 8;")],
    "cols_cq_64": [("constexpr int BWD_CQ = 32;", "constexpr int BWD_CQ = 64;")],
    "pass_c_2": [("constexpr int PASS_C_CHUNKS = 4;", "constexpr int PASS_C_CHUNKS = 2;")],
}
KNOCKOUTS = {
    "rows_no_scores": [("mma::qk_step(pr[2 * gc], pr[2 * gc + 1], qa[kc],", "if (0) mma::qk_step(pr[2 * gc], pr[2 * gc + 1], qa[kc],")],
    "rows_no_dq": [("pv_chunk(dq, dsa,", "if (0) pv_chunk(dq, dsa,")],
    "rows_no_exp": [("pr[n][0] = expf(", "pr[n][0] = ("), ("pr[n][1] = expf(", "pr[n][1] = ("),
                    ("pr[n][2] = expf(", "pr[n][2] = ("), ("pr[n][3] = expf(", "pr[n][3] = (")],
    "rows_no_hand_over": [("    a.pds[((plane * gridDim.x", "    if (0) a.pds[((plane * gridDim.x")],
    "cols_no_dv": [("pv_chunk(dv, pa,", "if (0) pv_chunk(dv, pa,")],
    "cols_no_dk": [("pv_chunk(dk, dsa,", "if (0) pv_chunk(dk, dsa,")],
}
HEAD = ('#include <cuda_bf16.h>\n#include <cuda_runtime.h>\n#include "attention_fwd.cuh"\n'
        'typedef __nv_bfloat16 bf16;\ntypedef __nv_bfloat162 bf162;\nnamespace {\n')
TAIL = '''}
extern "C" int attn_bwd(const void* q_s, const void* qkv, const void* dattn, const void* probs,
                        void* pds, void* dqkv, void* partial, int B, int S, int D, int H,
                        void* stream) {
  AttnBwdArgs a = {};
  a.q_s = (const bf16*)q_s;
  a.q = (const bf16*)qkv;
  a.k = a.q + D;
  a.v = a.q + 2 * D;
  a.ldqkv = 3 * D;
  a.dattn = (const bf16*)dattn;
  a.probs = (const bf16*)probs;
  a.pds = (uint4*)pds;
  a.nb = (S + 15) / 16;
  a.dqkv = (bf16*)dqkv;
  a.partial = (float*)partial;
  a.S = S;
  a.D = D;
  a.H = H;
  a.dh = D / H;
  a.scale = 1.f / sqrtf((float)(D / H));
  return (int)launch_attention_bwd(a, B, probs != nullptr, (cudaStream_t)stream);
}
'''


def source(patches) -> str:
    text = open(os.path.join(CSRC, "fused_encoder_train.cu")).read()
    block = text[text.index("using attention::pv_chunk;"):text.index("// LN1 statistics of a1")]
    for old, new in patches:
        if old not in block:
            raise ValueError(f"patch target not in the source: {old!r}")
        block = block.replace(old, new)
    return HEAD + block + TAIL


def build(name: str, patches, out_dir: str) -> tuple:
    from motionstyle_torch import _build

    cu, so = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
    with open(cu, "w") as f:
        f.write(source(patches))
    p = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", CSRC, "-o", so, cu],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{p.stderr[-3000:]}")
    log = p.stdout + p.stderr
    return so, re.findall(r"Used (\d+) registers", log), re.findall(r"(\d+) bytes spill stores", log)


def inputs(b: int, s: int, d: int, h: int, stored: bool, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(s)
    m = b * s
    qkv = torch.randn(m, 3 * d, device=dev, generator=g).to(torch.bfloat16)
    q_s = (qkv[:, :d].float() / (d // h) ** 0.5).to(torch.bfloat16).contiguous()
    dattn = torch.randn(m, d, device=dev, generator=g).to(torch.bfloat16)
    probs = None
    if stored:
        heads = lambda t: t.float().reshape(b, s, h, -1).transpose(1, 2)  # noqa: E731
        probs = torch.softmax(heads(q_s) @ heads(qkv[:, d:2 * d]).transpose(-1, -2), -1)
        probs = probs.to(torch.bfloat16).contiguous()
    nb = (s + 15) // 16
    pds = torch.empty(2 * b * h * nb * nb * 256, device=dev, dtype=torch.bfloat16)
    dqkv = torch.empty(m, 3 * d, device=dev, dtype=torch.bfloat16)
    partial = torch.empty(b * ((s + 63) // 64) * 3 * d, device=dev)
    return q_s, qkv, dattn, probs, pds, dqkv, partial


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, HERE)
    names = sys.argv[1:] or ["base", *TUNINGS, *KNOCKOUTS]
    variants = {"base": [], **TUNINGS, **KNOCKOUTS}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(names)) as pool:
            built = dict(zip(names, pool.map(lambda n: build(n, variants[n], tmp), names)))
        print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
        libs = {}
        for name, (so, regs, spills) in built.items():
            print(f"  {name}: registers {regs}, spill stores {spills}", flush=True)
            lib = ctypes.CDLL(so)
            lib.attn_bwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            libs[name] = lib
        dev = torch.device("cuda")
        stream = torch.cuda.current_stream().cuda_stream
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

        def device_us(e):
            return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

        for b, s, d, h, stored in SHAPES:
            args = inputs(b, s, d, h, stored, dev)
            dqkv, partial = args[5], args[6]
            res, want = [], None
            for name, lib in libs.items():
                def call():
                    rc = lib.attn_bwd(*(ptr(t) for t in args), b, s, d, h, stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: launch returned {rc}")
                call()
                torch.cuda.synchronize()
                if name == "base":
                    want = (dqkv.clone(), partial.clone())
                same = ""
                if name in TUNINGS:
                    same = (" bits as base" if torch.equal(dqkv, want[0])
                            and torch.equal(partial, want[1]) else " BITS DIFFER")
                for _ in range(3):
                    call()
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(50):
                    call()
                e1.record()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        call()
                    torch.cuda.synchronize()
                split = {("rows" if "rows" in e.key else "cols"): round(device_us(e) / 10, 1)
                         for e in prof.key_averages() if e.device_type.name == "CUDA"}
                res.append(f"{name} {e0.elapsed_time(e1) / 50 * 1e3:.1f} us {split}{same}")
                if name in TUNINGS and same != " bits as base":
                    print(f"  {name}: a tuning variant changed the output", flush=True)
            print(f"B={b} S={s} D={d} H={h} {'stored' if stored else 'recompute'}: "
                  + "; ".join(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
