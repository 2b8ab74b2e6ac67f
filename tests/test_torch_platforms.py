"""The port's trainer platforms (motionstyle_torch/train/platforms.py), its
profile_trace (utils.py) and the renders beside plot_3d_motion
(post/render.py) against the JAX package's, on the CPU.

TensorboardPlatform: the same scalars through both packages' classes give
event files with the same tags, steps and values (tensorboardX is on this
machine); without tensorboardX both raise ImportError. ClearmlPlatform:
without clearml both warn and report nothing. profile_trace: a Chrome trace
that parses. plot_3d_array: the JAX renderer's frame shape; render_mesh_frames
and explicit_plot_3d_motion: a gif of every frame, and the pyrender arm
through a stub of the pyrender and trimesh API (tests/test_post.py's).
"""
import json
import os
import struct
import sys
import types

import numpy as np
import pytest

from motionstyle.post import render as jrender
from motionstyle.train import platforms as jplatforms
from motionstyle_torch.core import params
from motionstyle_torch.post import render
from motionstyle_torch.train import platforms
from motionstyle_torch.utils import TRACE_FILE, profile_trace

SCALARS = [("loss", 1.5, 0), ("rot_mse", 0.25, 0), ("loss", 1.25, 1), ("rot_mse", 0.125, 1)]


def read_events(log_dir: str) -> list:
    """(tag, step, value) of every scalar in a directory's event files (the
    TFRecord framing: length, its crc, the Event proto, its crc)."""
    from tensorboardX.proto import event_pb2

    out = []
    for name in sorted(os.listdir(log_dir)):
        if "tfevents" not in name:
            continue
        with open(os.path.join(log_dir, name), "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            (n,) = struct.unpack("<Q", data[pos:pos + 8])
            event = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
            pos += 12 + n + 4
            for v in event.summary.value:
                out.append((v.tag, event.step, v.simple_value))
    return out


def test_tensorboard_platform_writes_the_jax_classes_events(tmp_path):
    got = {}
    for name, module in (("jax", jplatforms), ("port", platforms)):
        p = module.TensorboardPlatform(str(tmp_path / name))
        p.report_args({"lr": 1e-4}, name="Args")
        for tag, value, step in SCALARS:
            p.report_scalar(name=tag, value=value, iteration=step, group_name="Loss")
        p.close()
        got[name] = read_events(str(tmp_path / name))
    assert got["port"] == got["jax"] == [(f"Loss/{t}", s, v) for t, v, s in SCALARS]


def test_tensorboard_platform_raises_without_tensorboardx(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    for module in (jplatforms, platforms):
        with pytest.raises(ImportError):
            module.TensorboardPlatform(str(tmp_path))
    with pytest.raises(ImportError):
        platforms.get_platform("TensorboardPlatform", str(tmp_path))


def test_clearml_platform_warns_and_reports_nothing(tmp_path, capsys):
    """Without clearml (this machine has none) both classes print the same
    warning and every call is a no-op."""
    outs = []
    for module in (jplatforms, platforms):
        p = module.ClearmlPlatform(str(tmp_path / "run"))
        p.report_args({"lr": 1e-4}, name="Args")
        p.report_scalar("loss", 1.0, 0, group_name="Loss")
        p.close()
        assert p.task is None and p.logger is None
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "falling back to NoPlatform behavior" in outs[1]
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("name", ["NoPlatform", "TrainPlatform", "TensorboardPlatform",
                                  "ClearmlPlatform"])
def test_get_platform_builds_each_name(name, tmp_path):
    p = platforms.get_platform(name, str(tmp_path))
    assert type(p).__name__ == name and type(p) is platforms.PLATFORMS[name]
    assert type(getattr(jplatforms, name)(str(tmp_path / "jax"))).__name__ == name
    p.report_scalar("loss", 1.0, 0, group_name="Loss")
    p.close()
    with pytest.raises(ValueError, match="unknown train platform"):
        platforms.get_platform("WandbPlatform", str(tmp_path))


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None and any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "trace" / TRACE_FILE) as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    with profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not os.path.exists(tmp_path / "off")


def _frames(path: str) -> int:
    from PIL import Image

    with Image.open(path) as im:
        return im.n_frames


def test_plot_3d_array_has_the_jax_frames_shape():
    joints = np.random.RandomState(0).randn(3, 20, 3)
    args = (joints, "a title", params.xia_kinematic_chain)
    got = render.plot_3d_array(args)
    want = jrender.plot_3d_array(args)
    assert got.shape == want.shape == (3, 300, 300, 3) and got.dtype == want.dtype == np.uint8
    assert (got != 255).any(axis=(1, 2, 3)).all()  # every frame draws something


def test_explicit_plot_3d_motion_writes_every_frame(tmp_path):
    joints = np.random.RandomState(1).randn(4, 20, 3)
    out = render.explicit_plot_3d_motion(str(tmp_path / "clip.mp4"), params.xia_kinematic_chain,
                                         joints, title="t", fps=20)
    assert out == str(tmp_path / "clip.mp4")
    files = os.listdir(tmp_path)
    assert files in (["clip.gif"], ["clip.mp4"])  # an mp4 where ffmpeg exists
    if files == ["clip.gif"]:
        assert _frames(str(tmp_path / "clip.gif")) == 4


@pytest.mark.parametrize("faces", [None, "faces_without_pyrender"])
def test_render_mesh_frames_draws_a_point_cloud(faces, tmp_path):
    """Without pyrender (neither machine has it), with or without faces: a
    point-cloud gif of every frame, as the JAX renderer's fallback returns."""
    verts = np.random.RandomState(2).randn(50, 3, 5).astype(np.float32)
    kw = {} if faces is None else {"faces": np.zeros((2, 3), int)}
    got = render.render_mesh_frames(verts, save_path=str(tmp_path / "port" / "mesh.mp4"), **kw)
    want = jrender.render_mesh_frames(verts, save_path=str(tmp_path / "jax_mesh.mp4"), **kw)
    assert got == str(tmp_path / "port" / "mesh.gif") and want.endswith("jax_mesh.gif")
    assert _frames(got) == _frames(want) == 5


def test_pyrender_arm_with_a_stub(tmp_path, monkeypatch):
    """The opt-in pyrender renderer against a minimal stub of the pyrender
    and trimesh API (tests/test_post.py:243's): one render a frame, one
    OffscreenRenderer deleted once, a gif of every frame."""
    calls = {"render": 0, "deleted": 0}

    class _Obj:
        def __init__(self, *a, **k):
            pass

    class _Scene(_Obj):
        def add(self, obj, pose=None):
            pass

    class _Mesh(_Obj):
        @staticmethod
        def from_trimesh(tri, material=None, smooth=True):
            return _Obj()

    class _Renderer:
        def __init__(self, w, h):
            self.w, self.h = w, h

        def render(self, scene, flags=0):
            calls["render"] += 1  # frames that differ: a gif merges equal frames
            return (np.full((self.h, self.w, 4), 40 * calls["render"], np.uint8), None)

        def delete(self):
            calls["deleted"] += 1

    pyrender = types.ModuleType("pyrender")
    pyrender.OffscreenRenderer = _Renderer
    pyrender.MetallicRoughnessMaterial = _Obj
    pyrender.Scene = _Scene
    pyrender.Mesh = _Mesh
    pyrender.DirectionalLight = _Obj
    pyrender.PerspectiveCamera = _Obj
    constants = types.ModuleType("pyrender.constants")
    constants.RenderFlags = types.SimpleNamespace(RGBA=2048)
    pyrender.constants = constants
    trimesh_mod = types.ModuleType("trimesh")
    trimesh_mod.Trimesh = _Obj
    monkeypatch.setitem(sys.modules, "pyrender", pyrender)
    monkeypatch.setitem(sys.modules, "pyrender.constants", constants)
    monkeypatch.setitem(sys.modules, "trimesh", trimesh_mod)

    verts = np.random.RandomState(0).randn(50, 3, 4).astype(np.float32)
    out = render.render_mesh_frames(verts, faces=np.zeros((2, 3), int),
                                    save_path=str(tmp_path / "mesh.mp4"))
    assert calls == {"render": 4, "deleted": 1}
    assert out == str(tmp_path / "mesh.gif") and _frames(out) == 4
    # without faces the stub is never called: the point cloud
    render.render_mesh_frames(verts, save_path=str(tmp_path / "cloud.mp4"))
    assert calls == {"render": 4, "deleted": 1}
