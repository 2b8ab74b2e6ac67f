"""Motion and mesh rendering to mp4, gif or frame arrays: the port's
counterpart of motionstyle/post/render.py (plot_3d_motion, plot_3d_array,
explicit_plot_3d_motion, render_mesh_frames).

Parity: data_loaders/humanml/utils/plot_script.py (plot_3d_motion :30): the
same framing (the root's xz trajectory subtracted, the floor snapped to the
lowest joint, a grey floor patch under the clip's extent, limits of `radius`
around the root), the same view (matplotlib's elev 120, azim -90: x to the
right, 0.866 y - 0.5 z up), the chain colours of each visualisation mode
(the inpainting highlight, gt frames in blue) and line widths (4 pt for the
first five chains, 2 after), at figsize x 100 pixels. plot_3d_array
(plot_script.py:314) returns a clip's frames as a (T, H, W, 3) array, and
render_mesh_frames draws SMPL meshes: through pyrender where pyrender and
trimesh import (the reference's visualize/render_final.py scene), else as a
point cloud.

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


def _fit_view(points: np.ndarray, view: np.ndarray, size: tuple, margin: float = 0.05):
    """world (..., 3) -> pixels (..., 2), y down: the projection `view` (2, 3)
    scaled so that every point fits the image (matplotlib's autoscaling)."""
    s = points.reshape(-1, 3) @ view.T
    lo, hi = s.min(axis=0), s.max(axis=0)
    w, h = size
    scale = (1 - 2 * margin) * min(w / max(hi[0] - lo[0], 1e-9), h / max(hi[1] - lo[1], 1e-9))
    mid = (lo + hi) / 2

    def to_px(p):
        q = p @ view.T
        return np.stack([(q[..., 0] - mid[0]) * scale + w / 2,
                         h / 2 - (q[..., 1] - mid[1]) * scale], axis=-1)
    return to_px


def plot_3d_array(args) -> np.ndarray:
    """A motion's frames as a (T, H, W, 3) uint8 array (the training loop's
    logging GIFs); parity: plot_script.py:314 (plot_3d_array). args =
    (joints (T, J, 3), title or None, kinematic_tree, ...), the reference's
    tuple: the floor snapped to the lowest joint, elev 120 / azim -90, the gt
    colours, no axes, 300 x 300 pixels (a 3 x 3 inch figure at 100 dpi)."""
    from PIL import Image, ImageDraw, ImageFont

    joints, title, kinematic_tree = args[0], args[1], args[2]
    data = np.asarray(joints).reshape(len(joints), -1, 3).copy()
    data[:, :, 1] -= data[..., 1].min()
    size = (3 * DPI, 3 * DPI)
    to_px = _fit_view(data, VIEW, size)
    font = ImageFont.load_default(size=8)
    width = max(1, round(1.5 * DPI / 72))  # matplotlib's default line width
    frames = []
    for t in range(len(data)):
        img = Image.new("RGB", size, BACKGROUND)
        draw = ImageDraw.Draw(img)
        for chain, color in zip(kinematic_tree, _colors_for_mode("gt", None)):
            draw.line([tuple(p) for p in to_px(data[t, list(chain)])], fill=color,
                      width=width, joint="curve")
        if title:
            draw.text((size[0] / 2, 2), str(title), fill=(0, 0, 0), font=font, anchor="ma")
        frames.append(np.asarray(img))
    return np.stack(frames)


def explicit_plot_3d_motion(save_path, kinematic_tree, joints, title="",
                            dataset="stylexia_posrot", figsize=(3, 3), fps=20,
                            radius=3, vis_mode="default", gt_frames=()):
    """plot_3d_motion with explicit figure control; parity: plot_script.py:168."""
    return plot_3d_motion(save_path, kinematic_tree, joints, title=title, dataset=dataset,
                          figsize=figsize, fps=fps, radius=radius, vis_mode=vis_mode,
                          gt_frames=gt_frames)


def _save_gif(frames: list, save_path: str, fps: float) -> str:
    alt = save_path if save_path.endswith(".gif") else save_path.rsplit(".", 1)[0] + ".gif"
    os.makedirs(os.path.dirname(os.path.abspath(alt)) or ".", exist_ok=True)
    frames[0].save(alt, save_all=True, append_images=frames[1:],
                   duration=int(1000 / min(fps, 20)), loop=0)
    return alt


def _render_mesh_frames_pyrender(verts: np.ndarray, faces, save_path: str, fps: float) -> str:
    """A raytraced mesh video through pyrender, the scene of the reference's
    visualize/render_final.py:169-258 (as motionstyle/post/render.py:164-219
    builds it): a warm colour ramp frame by frame, a MetallicRoughness BLEND
    material, three directional lights, a perspective camera pitched -pi/6
    looking down the +z setback, 960 x 960 RGBA at fps 20, one
    OffscreenRenderer for every frame."""
    import pyrender
    import trimesh
    from PIL import Image
    from pyrender.constants import RenderFlags

    T = verts.shape[-1]
    mins = verts.min(axis=(0, 2))
    maxs = verts.max(axis=(0, 2))
    minx, maxx = mins[0] - 0.5, maxs[0] + 0.5
    minz = mins[2] - 0.5
    c = -np.pi / 6
    cam_pose = np.array([
        [1, 0, 0, (minx + maxx) / 2],
        [0, np.cos(c), -np.sin(c), 1.5],
        [0, np.sin(c), np.cos(c), max(4.0, minz + (1.5 - mins[1]) * 2, maxx - minx)],
        [0, 0, 0, 1],
    ])
    renderer = pyrender.OffscreenRenderer(960, 960)
    frames = []
    try:
        for i in range(T):
            tri = trimesh.Trimesh(vertices=verts[:, :, i], faces=faces)
            material = pyrender.MetallicRoughnessMaterial(
                metallicFactor=0.5, alphaMode="BLEND",
                baseColorFactor=[1.0, (145 + i * 0.8) / 255.0, (33 + i * 0.5) / 255.0, 0.9])
            scene = pyrender.Scene(bg_color=[1, 1, 1, 0.8], ambient_light=(0.4, 0.4, 0.4))
            scene.add(pyrender.Mesh.from_trimesh(tri, material=material))
            light = pyrender.DirectionalLight(color=[1, 1, 1], intensity=300)
            for lx in ([0, -1, 1], [0, 1, 1], [1, 1, 2]):
                pose = np.eye(4)
                pose[:3, 3] = lx
                scene.add(light, pose=pose)
            scene.add(pyrender.PerspectiveCamera(yfov=np.pi / 3.0), pose=cam_pose)
            rgba, _ = renderer.render(scene, flags=RenderFlags.RGBA)
            frames.append(Image.fromarray(np.asarray(rgba)))
    finally:
        renderer.delete()
    return _save_gif(frames, save_path, fps)


def render_mesh_frames(vertices: np.ndarray, faces=None, save_path: str = "mesh.mp4",
                       fps: float = 20) -> str:
    """An SMPL mesh video from vertices (V, 3, T): through pyrender where
    pyrender and trimesh import and faces are given (parity:
    visualize/render_final.py), otherwise a point cloud (elev 110, azim -90)
    drawn with Pillow, so the export always produces output. Returns the gif's
    path."""
    try:
        import pyrender  # noqa: F401
        import trimesh  # noqa: F401

        have_pyrender = True
    except ImportError:
        have_pyrender = False
    verts = np.asarray(vertices)
    # a mesh needs faces: a faces-less call is a point cloud even with pyrender
    if have_pyrender and faces is not None:
        return _render_mesh_frames_pyrender(verts, faces, save_path, fps)
    from PIL import Image, ImageDraw

    view = np.array([[1.0, 0.0, 0.0],
                     [0.0, np.sin(np.radians(110.0)), np.cos(np.radians(110.0))]])
    size = (3 * DPI, 3 * DPI)
    to_px = _fit_view(verts.transpose(2, 0, 1), view, size)
    frames = []
    for i in range(verts.shape[-1]):
        img = Image.new("RGB", size, BACKGROUND)
        ImageDraw.Draw(img).point([tuple(p) for p in to_px(verts[:, :, i])],
                                  fill=_colors_for_mode("gt", None)[0])
        frames.append(img)
    return _save_gif(frames, save_path, fps)
