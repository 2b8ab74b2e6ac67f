"""Stick-figure motion rendering to mp4 or gif: the port's counterpart of
motionstyle/post/render.py's plot_3d_motion.

Parity: data_loaders/humanml/utils/plot_script.py (plot_3d_motion :30): the
same framing (the root's xz trajectory subtracted, the floor snapped to the
lowest joint, a grey floor patch under the clip's extent, limits of `radius`
around the root), the same view (matplotlib's elev 120, azim -90: x to the
right, 0.866 y - 0.5 z up), the chain colours of each visualisation mode
(the inpainting highlight, gt frames in blue) and line widths (4 pt for the
first five chains, 2 after), at figsize x 100 pixels.

The frames are drawn with Pillow, not matplotlib: the machines the port runs
on may lack matplotlib, and Pillow is the JAX renderer's own fallback
writer. With an ffmpeg binary a .mp4 path is encoded by ffmpeg from raw
frames; otherwise a gif is written beside it, at min(fps, 20) frames a
second, as the JAX renderer does. Host-side: joints come in as numpy.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional

import numpy as np

DPI = 100
BACKGROUND = (255, 255, 255)
FLOOR = (191, 191, 191)  # (0.5, 0.5, 0.5) at alpha 0.5 over white
VIEW = np.array([[1.0, 0.0, 0.0],  # screen x
                 [0.0, np.sin(np.radians(120.0)), np.cos(np.radians(120.0))]])  # screen y


def _colors_for_mode(vis_mode: str, painting_features: Optional[List[str]]):
    blue = ["#4D84AA", "#5B9965", "#61CEB9", "#34C1E2", "#80B79A"]
    orange = ["#DD5A37", "#D69E00", "#B75A39", "#FF6D00", "#DDB50E"]
    if vis_mode == "gt":
        return blue
    if vis_mode == "upper_body":
        return orange[:2] + blue[2:]
    return orange  # any inpainting mode highlights the whole figure


def _frames(kinematic_tree, data, title, size, radius, colors, gt_frames, trajec, mins, maxs):
    """One RGB image per frame of data (T, J, 3), already framed."""
    from PIL import Image, ImageDraw, ImageFont

    w, h = size
    lo = VIEW @ np.array([-radius / 2, 0.0, radius * 2 / 3.0])
    hi = VIEW @ np.array([radius / 2, radius, -radius / 3.0])
    scale = min(w / (hi[0] - lo[0]), h / (hi[1] - lo[1]))

    def to_px(p):  # (..., 3) world -> (..., 2) pixels, y down
        s = p @ VIEW.T
        return np.stack([(s[..., 0] - (lo[0] + hi[0]) / 2) * scale + w / 2,
                         h / 2 - (s[..., 1] - (lo[1] + hi[1]) / 2) * scale], axis=-1)

    font = ImageFont.load_default(size=10)
    widths = [max(1, round(pt * DPI / 72)) for pt in (4.0, 2.0)]
    out = []
    for index in range(len(data)):
        img = Image.new("RGB", (w, h), BACKGROUND)
        draw = ImageDraw.Draw(img)
        x0, x1 = mins[0] - trajec[index, 0], maxs[0] - trajec[index, 0]
        z0, z1 = mins[2] - trajec[index, 1], maxs[2] - trajec[index, 1]
        floor = to_px(np.array([[x0, 0.0, z0], [x0, 0.0, z1], [x1, 0.0, z1], [x1, 0.0, z0]]))
        draw.polygon([tuple(p) for p in floor], fill=FLOOR)
        used = _colors_for_mode("gt", None) if index in gt_frames else colors
        for i, (chain, color) in enumerate(zip(kinematic_tree, used)):
            pts = to_px(data[index, list(chain)])
            draw.line([tuple(p) for p in pts], fill=color, width=widths[0 if i < 5 else 1],
                      joint="curve")
        if title:
            draw.text((w / 2, 2), title, fill=(0, 0, 0), font=font, anchor="ma")
        out.append(img)
    return out


def plot_3d_motion(save_path: str, kinematic_tree, joints: np.ndarray, title: str = "",
                   dataset: str = "stylexia_posrot", figsize=(3, 3), fps: float = 20,
                   radius: float = 3, vis_mode: str = "default", gt_frames=(),
                   painting_features: Optional[List[str]] = None):
    """joints: (T, J, 3) global positions -> an animated mp4 (or the gif
    fallback). Returns save_path, as the JAX renderer does."""
    data = joints.copy().reshape(len(joints), -1, 3)
    if dataset == "kit":
        data *= 0.003
    elif dataset in ("humanml",):
        data *= 1.3
    mins, maxs = data.min(axis=0).min(axis=0), data.max(axis=0).max(axis=0)
    colors = _colors_for_mode(vis_mode, painting_features)
    data[:, :, 1] -= mins[1]
    trajec = data[:, 0, [0, 2]]
    data[..., 0] -= data[:, 0:1, 0]
    data[..., 2] -= data[:, 0:1, 2]

    size = (int(figsize[0] * DPI), int(figsize[1] * DPI))
    frames = _frames(kinematic_tree, data, title, size, radius, colors, set(gt_frames),
                     trajec, mins, maxs)
    os.makedirs(os.path.dirname(os.path.abspath(save_path)) or ".", exist_ok=True)
    if shutil.which("ffmpeg") and save_path.endswith(".mp4"):
        raw = b"".join(f.tobytes() for f in frames)
        subprocess.run(["ffmpeg", "-y", "-loglevel", "error", "-f", "rawvideo",
                        "-pix_fmt", "rgb24", "-s", f"{size[0]}x{size[1]}", "-r", str(fps),
                        "-i", "-", "-pix_fmt", "yuv420p", save_path], input=raw, check=True)
    else:
        alt = save_path if save_path.endswith(".gif") else save_path.rsplit(".", 1)[0] + ".gif"
        frames[0].save(alt, save_all=True, append_images=frames[1:], loop=0,
                       duration=1000 / min(fps, 20))
    return save_path
