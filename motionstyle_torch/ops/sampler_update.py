"""The fused DDPM sampler update: a CUDA kernel for Hopper and its plain
PyTorch twin.

Replaces the Pallas TPU kernel motionstyle/ops/sampler_update.py::
_update_kernel (pallas_call at :105; kernel 3). One DDPM step in one pass:

  x0b    = model_out * (1 - mask) + motion * mask
  sample = c1 * x0b + c2 * x + (nonzero * sigma) * z * (1 - mask)

with the inpainting blend, the posterior mean and the masked Gaussian noise
fused, in the Pallas body's order of fp32 operations. z is Box-Muller
(`box_muller`, the JAX package's fp32 order) over 32-bit words of
counter-based Philox4x32-10: element e of the flat (B, C, 1, T) tensor takes
words 2(e & 1), 2(e & 1) + 1 of the Philox at counter (e >> 1, 0, 0) and key
(uint32(seed), UPDATE_KEY), so the draws depend only on the seed and the
element's index (`normal_draws`). The TPU kernel draws hardware bits per
block, so the two packages' noise streams differ (as the JAX package's own
fused stream differs from jax.random).

On the card (csrc/sampler_update.cu) the update is bound by its bytes: four
fp32 reads and two fp32 writes per element. `fused_ddpm_update` launches the
kernel for CUDA tensors (or raises) and runs the twin
`fused_ddpm_update_reference` only for CPU tensors;
`fused_ddpm_update.launches` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from motionstyle_torch.ops.fused_encoder_train import philox4x32_10

_M32 = 0xFFFFFFFF
_TWO_PI = 6.283185307179586
UPDATE_KEY = 0x44445055  # the Philox key's second word, as csrc/sampler_update.cu


def box_muller(bits1: torch.Tensor, bits2: torch.Tensor) -> torch.Tensor:
    """int32 random words x2 -> standard normal draws, each step rounded in
    fp32 in the JAX package's order (motionstyle/ops/sampler_update.py:34-43):
    u1 in (0, 1] (log-safe; it may round to exactly 1, giving 0), u2 in
    [0, 1]."""
    u1 = (bits1.to(torch.int32).float() + 2147483648.0 + 1.0) / 4294967296.0
    u2 = (bits2.to(torch.int32).float() + 2147483648.0) / 4294967296.0
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def _signed32(v):
    """The signed 32-bit value with v's low 32 bits (an int, or int64 tensor
    of uint32 words)."""
    return ((v + 2 ** 31) & _M32) - 2 ** 31


def normal_draws(seed: int, n: int, device=None) -> torch.Tensor:
    """The kernel's n standard normal draws for `seed`, (n,) fp32: element e
    from words 2(e & 1), 2(e & 1) + 1 of Philox4x32-10 at counter (e >> 1
    split into two 32-bit words, 0, 0) and key (uint32(seed), UPDATE_KEY)."""
    pairs = torch.arange((n + 1) // 2, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32_10((pairs & _M32, pairs >> 32, zero, zero),
                          (torch.tensor(int(seed) & _M32, device=device),
                           torch.tensor(UPDATE_KEY, device=device)))
    flat = torch.stack(torch.broadcast_tensors(*words), -1).reshape(-1)
    return box_muller(_signed32(flat[0::2][:n]), _signed32(flat[1::2][:n]))


def _scalar(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())


def fused_ddpm_update_reference(x: torch.Tensor, model_out: torch.Tensor,
                                mask: Optional[torch.Tensor], motion: Optional[torch.Tensor],
                                coef1, coef2, sigma, nonzero, seed: int) -> tuple:
    """Plain PyTorch twin of the kernel, on any device: (sample,
    pred_xstart) with the kernel's draws (normal_draws) and order of fp32
    operations. mask None is a zero mask."""
    dev = x.device
    c1, c2, sig, nz = (_scalar(v, dev) for v in (coef1, coef2, sigma, nonzero))
    if mask is None:
        mask = motion = torch.zeros_like(x, dtype=torch.float32)
    mask, motion = mask.float(), motion.float()
    keep = 1.0 - mask
    x0b = model_out.float() * keep + motion * mask
    z = normal_draws(seed, x.numel(), dev).reshape(x.shape)
    out = c1 * x0b + c2 * x.float() + (nz * sig) * z * keep
    return out, x0b


def _check_cuda_inputs(x, model_out, mask, motion) -> list:
    """Refuse what the kernel does not take: contiguous fp32 tensors of one
    shape on one card; mask and motion both given or both None."""
    if (mask is None) != (motion is None):
        raise ValueError("pass mask and motion together, or neither")
    tensors = [t for t in (x, model_out, mask, motion) if t is not None]
    for t in tensors:
        if t.shape != x.shape or t.dtype != torch.float32 or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"the update kernel takes contiguous float32 tensors of shape "
                             f"{tuple(x.shape)} on {x.device}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if x.numel() < 1:
        raise ValueError("the update kernel needs at least one element")
    return tensors


def fused_ddpm_update(x: torch.Tensor, model_out: torch.Tensor, mask: Optional[torch.Tensor],
                      motion: Optional[torch.Tensor], coef1, coef2, sigma, nonzero,
                      seed: int) -> tuple:
    """One DDPM step update. x, model_out (B, C, 1, T) fp32; mask and motion
    the inpainting condition or None; coef1, coef2, sigma and nonzero scalars
    shared by the batch (Python floats or 0-d tensors, e.g. one row of the
    sampler's per-step table; no host read is made of them); seed the step's
    int32 seed. Returns (sample, pred_xstart), pred_xstart the blended x0.
    CUDA tensors launch the kernel; CPU tensors run the twin."""
    if x.device.type == "cpu":
        return fused_ddpm_update_reference(x, model_out, mask, motion, coef1, coef2, sigma,
                                           nonzero, seed)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ddpm_update runs on cuda or cpu, not {x.device}")
    from motionstyle_torch import _build

    _check_cuda_inputs(x, model_out, mask, motion)
    lib = _build.load("sampler_update")
    scal = torch.stack([_scalar(v, x.device) for v in (coef1, coef2, sigma, nonzero)])
    out, xstart = torch.empty_like(x), torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.sampler_update_forward(
        ptr(x), ptr(model_out), ptr(mask), ptr(motion), ptr(scal), _signed32(int(seed)),
        ptr(out), ptr(xstart), x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_ddpm_update kernel failed: CUDA error {rc}")
    fused_ddpm_update.launches += 1
    return out, xstart


fused_ddpm_update.launches = 0
