"""Quantitative style-transfer quality metrics, numpy only.

The port's own copy of motionstyle/eval/style_metrics.py (the port imports
nothing of the JAX package), with the same functions and numbers:

  1. style_descriptor: per-channel high-frequency (frame-difference) energy
     of the pose channels; style in motion data is dominated by dynamics.
  2. content_similarity: correlation of the low-pass pose channels, the
     smooth component that defines what is being done.
  3. root-trajectory preservation: the inpainting contract, the masked
     channels of the output equal the content's.

Used by the finetune CLI's --auto_stop and by eval/quality_protocol.py.
"""
from __future__ import annotations

import numpy as np


def style_descriptor(hml: np.ndarray, pose_start: int = 4) -> np.ndarray:
    """Per-channel high-frequency energy of a denormalized hml_vec clip.

    hml (T, D) -> descriptor (D - pose_start,): std over time of the
    first-order frame differences of each pose channel (root channels
    excluded — they are pinned by the inpainting mask, not styled).
    """
    v = np.diff(np.asarray(hml, dtype=np.float64)[:, pose_start:], axis=0)
    return v.std(axis=0)


def style_distance(a: np.ndarray, b: np.ndarray, pose_start: int = 4) -> float:
    """L2 distance between the style descriptors of two clips."""
    da, db = style_descriptor(a, pose_start), style_descriptor(b, pose_start)
    return float(np.linalg.norm(da - db))


def lowpass(x: np.ndarray, window: int = 9) -> np.ndarray:
    """Zero-lag moving average along axis 0 (edge-padded)."""
    x = np.asarray(x, dtype=np.float64)
    half = window // 2
    padded = np.pad(x, [(half, half)] + [(0, 0)] * (x.ndim - 1), mode="edge")
    kernel = np.ones(window) / window
    return np.apply_along_axis(lambda c: np.convolve(c, kernel, mode="valid"),
                               0, padded)


def content_similarity(a: np.ndarray, b: np.ndarray, pose_start: int = 4,
                       window: int = 9) -> float:
    """Pearson correlation of the low-pass pose channels of two clips.

    High when the clips perform the same underlying motion regardless of
    styling; the smooth component carries the content identity.
    """
    T = min(a.shape[0], b.shape[0])
    la = lowpass(a[:T, pose_start:], window).ravel()
    lb = lowpass(b[:T, pose_start:], window).ravel()
    la = la - la.mean()
    lb = lb - lb.mean()
    denom = np.linalg.norm(la) * np.linalg.norm(lb)
    if denom == 0:
        return 0.0
    return float(np.dot(la, lb) / denom)


def transfer_report(output: np.ndarray, content: np.ndarray,
                    style_example: np.ndarray, pose_start: int = 4) -> dict:
    """Full quality report for one transfer: output/content/style_example are
    denormalized hml_vec clips (T, D), truncated to their valid lengths."""
    d_style = style_distance(output, style_example, pose_start)
    d_content_style = style_distance(content, style_example, pose_start)
    root = np.abs(output[:, :3] - content[: output.shape[0], :3]).max()
    return {
        "style_dist_to_example": d_style,
        "style_dist_content_to_example": d_content_style,
        # <1 means the output moved toward the style example's dynamics
        "style_dist_ratio": d_style / max(d_content_style, 1e-12),
        "content_similarity": content_similarity(output, content, pose_start),
        "root_horizontal_max_abs_err": float(root),
    }
