"""Long-form generation beyond the training horizon: windowed outpainting.

Counterpart of motionstyle/diffusion/longform.py. The denoiser is trained at
a fixed clip length W (76 frames on Xia). This module chains windows of that
one shape: window k > 0 is sampled with its first `overlap` frames inpainted
to the previous window's tail (the Inpainting blend of the style pipeline,
here masking the time axis for all channels), so each window continues the
last one exactly. A full-length `content` + `content_mask` may also be
given: each window then preserves its slice of the content as well (the
root_horizontal channels of a long content clip), which carries the
style-transfer contract past the training horizon.

The windows stitch without a seam because generation runs in normalised
hml_vec feature space, where the root moves by per-frame velocities that are
summed into positions only once, over the whole concatenated sequence
(core/features.py::recover_root_rot_pos).

Every window has the same (B, C, 1, W) shape, so the sampler sees one batch
shape for any target length; the loop runs on the host in numpy. Where the
JAX package folds its key per window (fold_in(rng, k)), this one hands
run_window a torch.Generator seeded with window_seed(seed, k).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from motionstyle_torch.diffusion.ddpm import Inpainting


def window_seed(seed: int, k: int) -> int:
    """Window k's seed from a base seed: the JAX serve CLI's per-window
    request seed (motionstyle/cli/serve.py:209)."""
    return (int(seed) + 7919 * (k + 1)) & 0x7FFFFFFF


def plan_windows(n_frames: int, window: int, overlap: int):
    """(number of windows, per-window fresh-frame stride)."""
    if n_frames <= window:
        return 1, n_frames
    stride = window - overlap
    assert stride > 0, "overlap must be < window"
    extra = -(-(n_frames - window) // stride)  # ceil
    return 1 + extra, stride


def longform_stream(
    run_window: Callable,
    n_frames: int,
    window: int,
    overlap: int = 10,
    seed: int = 0,
    content: Optional[np.ndarray] = None,
    content_mask: Optional[np.ndarray] = None,
    device=None,
):
    """Generator form of longform_sample: yields (frame_offset, chunk) with
    chunk (B, C, 1, t) as each window completes, so a server can deliver a
    long job progressively (serve/server.py /v1/stream). Draining it equals
    longform_sample bit for bit (longform_sample is this generator,
    drained). run_window(init (B, C, 1, W) | None, inpainting | None,
    generator) gets a torch.Generator on `device` (the CPU when None) seeded
    with window_seed(seed, k)."""
    n_windows, stride = plan_windows(n_frames, window, overlap)
    if content is not None:
        content = np.asarray(content, np.float32)
        # the default mask is built BEFORE padding: pad frames are mask=0
        # (generated) as on the explicit-mask path, not frozen zeros
        content_mask = (np.ones_like(content) if content_mask is None
                        else np.asarray(content_mask, np.float32))
        need = window + (n_windows - 1) * stride
        if content.shape[-1] < need:
            pad = np.zeros(content.shape[:-1] + (need - content.shape[-1],), np.float32)
            content = np.concatenate([content, pad], axis=-1)
            content_mask = np.concatenate([content_mask, np.zeros_like(pad)], axis=-1)

    def window_inputs(k: int, prev_tail):
        off = k * stride
        if content is not None:
            init = content[..., off:off + window].copy()
            mask = content_mask[..., off:off + window].copy()
        else:
            init = mask = None
        if prev_tail is not None:
            if init is None:
                init = np.zeros(prev_tail.shape[:-1] + (window,), np.float32)
                mask = np.zeros_like(init)
            init[..., :overlap] = prev_tail
            mask[..., :overlap] = 1.0
        if init is None:
            return None, None
        return init, Inpainting(mask=mask, motion=init)

    emitted = 0
    tail = None
    for k in range(n_windows):
        init, inp = window_inputs(k, tail)
        gen = torch.Generator(device=device or "cpu").manual_seed(window_seed(seed, k))
        out = run_window(init, inp, gen)
        if torch.is_tensor(out):
            out = out.float().cpu().numpy()
        out = np.asarray(out, np.float32)
        # the inpainting blend guarantees out[..., :overlap] == tail exactly
        chunk = out if k == 0 else out[..., overlap:]
        # overlap=0 (independent windows): out[..., -0:] would be the whole
        # window and break the next init's empty slice assignment
        tail = out[..., -overlap:] if overlap else None
        chunk = chunk[..., :n_frames - emitted]  # clip the final window
        if chunk.shape[-1]:
            yield emitted, chunk
            emitted += chunk.shape[-1]


def longform_sample(
    run_window: Callable,
    n_frames: int,
    window: int,
    overlap: int = 10,
    seed: int = 0,
    content: Optional[np.ndarray] = None,
    content_mask: Optional[np.ndarray] = None,
    device=None,
) -> np.ndarray:
    """Chain windows to (B, C, 1, n_frames) of normalised features.

    run_window(init_image (B, C, 1, W) | None, inpainting | None, generator)
    -> (B, C, 1, W), called with the same shapes every window.
    content/content_mask (B, C, 1, >= n_frames): per-window slices are
    inpainted wherever content_mask is 1 (the long style-transfer use:
    preserve the content's root channels at every frame); the window-overlap
    continuity mask is OR-ed on top."""
    chunks = [c for _, c in longform_stream(
        run_window, n_frames, window, overlap=overlap, seed=seed,
        content=content, content_mask=content_mask, device=device)]
    return np.concatenate(chunks, axis=-1)
