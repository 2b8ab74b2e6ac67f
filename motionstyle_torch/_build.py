"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under csrc/ compiles on its own into a plain shared library with
a C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The output goes to motionstyle_torch/_build/ (listed in .gitignore), named by
a hash of the source, the shared headers (csrc/*.cuh) and the flags, so an
edited source rebuilds and an unchanged one loads from the file. Building happens at first use, never at
import: machines without nvcc import every module and use the plain PyTorch
twins on CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_DROP = [_VP, ctypes.c_uint, ctypes.c_float]  # prng dropout: seeds, keep threshold, 1/keep
# C signature of each library's entry points: name -> [(symbol, argtypes)]
SIGNATURES = {
    "fused_encoder": [
        ("fused_encoder_layer_forward", [_VP] * 23 + [_INT] * 5 + [_VP]),
        ("fused_encoder_layer_plan", [_INT] * 4 + [_VP]),
    ],
    "fused_encoder_int8": [
        ("fused_encoder_layer_int8_forward", [_VP] * 30 + [_INT] * 5 + [_VP]),
        ("fused_encoder_layer_int8_plan", [_INT] * 4 + [_VP]),
    ],
    "attention": [
        ("attention_forward", [_VP, _INT] * 3 + [_VP] * 2 + [_INT] * 5 + [ctypes.c_float, _VP]),
    ],
    "sampler_update": [
        ("sampler_update_forward", [_VP] * 5 + [_INT] + [_VP] * 2 + [ctypes.c_longlong, _VP]),
    ],
    "fused_encoder_train": [
        ("fused_layer_train_forward", [_VP] * 5 + _DROP + [_VP] * 22 + [_INT] * 5 + [_VP]),
        ("fused_layer_train_bwd_ffn", [_VP] * 4 + _DROP + [_VP] * 25 + [_INT] * 4 + [_VP]),
        ("fused_layer_train_bwd_attn", [_VP] * 5 + _DROP + [_VP] * 17 + [_INT] * 4 + [_VP]),
        ("fused_layer_train_forward_store",
         [_VP] * 5 + _DROP + [_VP] * 22 + [_INT] * 5 + [_VP]),
        ("fused_layer_train_bwd_attn_stored",
         [_VP] * 4 + _DROP + [_VP] * 16 + [_INT] * 4 + [_VP]),
        ("fused_layer_train_forward_plan", [_INT] * 4 + [_VP]),
        ("fused_layer_train_backward_plan", [_INT] * 4 + [_VP]),
    ],
}

_lock = threading.Lock()
_loaded: dict = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    """The library's path, named by a hash of the source, the headers under
    csrc/ (any of them may be included) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> tuple:
    """Compile csrc/<name>.cu if its library is missing. Returns (path,
    seconds spent compiling; 0.0 when the library was already built)."""
    out = library_path(name)
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
             os.path.join(CSRC_DIR, f"{name}.cu")],
            capture_output=True, text=True)
        with open(out[:-3] + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu with argtypes set (built on first
    use, then cached for the process)."""
    with _lock:
        if name not in _loaded:
            path, _ = build(name)
            lib = ctypes.CDLL(path)
            for symbol, argtypes in SIGNATURES[name]:
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]
