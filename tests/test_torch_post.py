"""The port's post chain (motionstyle_torch/post/{footskate,bvh,ik,render}.py)
against the JAX package's and the reference goldens at the JAX tests' own
tolerances (tests/test_post.py, tests/test_prepare_dataset.py):

- footskate: the Butterworth filter at atol 1e-10, remove_fs at 1e-8 with
  velocities at 1e-10 and contacts exact (tests/goldens/postprocess.npz); the
  port's copy is the same numpy, so against JAX every output is bit-equal;
- BVH: the reference-written tests/goldens/prepare_xia.bvh read at 1e-4
  against prepare_xia.npz; save_bvh's bytes equal to JAX's for the same Anim
  when both convert the same Euler angles (each package converts in
  float32, and XLA's atan2, asin and fused products round differently from
  torch's, so unpatched the angles agree to 1e-4 degrees and the hierarchy
  byte for byte);
- IK: fit_hmlvec_ik and fit_quats_ik after 10 Adam steps from the same start
  against JAX's at atol 1e-4 (measured ~2e-6: float32 FK in another order,
  and Adam's first steps divide by the gradient's own magnitude);
- plot_3d_motion on 5 frames.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.core import params as jparams, rotations as jrot
from motionstyle.core.skeleton import Skeleton as JSkeleton
from motionstyle.post import bvh as jbvh, footskate as jfootskate, ik as jik
from motionstyle_torch.core import params, rotations as rot
from motionstyle_torch.core.features import recover_root_rot_pos
from motionstyle_torch.core.skeleton import Skeleton
from motionstyle_torch.data.masks import XIA_BVH_JOINT_NAMES
from motionstyle_torch.post import bvh, footskate, ik
from motionstyle_torch.post.render import plot_3d_motion
from tests.test_torch_models import one_torch_thread  # noqa: F401

XIA = Skeleton(params.xia_raw_offsets, params.xia_kinematic_chain)
JXIA = JSkeleton(jparams.xia_raw_offsets, jparams.xia_kinematic_chain)
EE = ["rtoes", "ltoes", "lfoot", "rfoot"]
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
IK_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _anim(module, T=6, seed=0):
    r = np.random.RandomState(seed)
    q = r.randn(T, 20, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[q[..., 0] < 0] *= -1
    offsets = params.xia_real_offsets.copy()
    pos = np.tile(offsets[None], (T, 1, 1)).astype(np.float32)
    pos[:, 0] = r.randn(T, 3)
    return module.Anim(q, pos, offsets, np.asarray(XIA.parents), list(XIA_BVH_JOINT_NAMES))


# ---- footskate ----

def test_butterworth_golden(goldens):
    g = goldens["postprocess"]
    out = footskate.butterworth(g["sig"].copy(), 1 / 20, 3)
    np.testing.assert_allclose(out, g["bw"], atol=1e-10)


@pytest.mark.parametrize("kw, out_key, contacts_key", [
    (dict(force_on_floor=True, use_vel3=True, vel3_thr=0.05, after_butterworth=True),
     "fs_out", "fs_contacts"),
    (dict(force_on_floor=False, use_window=False), "fs2_out", "fs2_contacts")])
def test_remove_fs_golden(goldens, kw, out_key, contacts_key):
    g = goldens["postprocess"]
    out, vels, contacts, _ = footskate.remove_fs(g["walk"].copy(), g["walk"].copy(),
                                                 XIA_BVH_JOINT_NAMES, EE, **kw)
    np.testing.assert_array_equal(contacts, g[contacts_key])
    np.testing.assert_allclose(out, g[out_key], atol=1e-8)
    if out_key == "fs_out":
        np.testing.assert_allclose(vels, g["fs_vels"], atol=1e-10)


@pytest.mark.parametrize("kw", [
    dict(force_on_floor=True, use_vel3=True, vel3_thr=0.05, after_butterworth=True),
    dict(force_on_floor=False, interp_length=3, use_vel3=True, vel3_thr=0.03,
         after_butterworth=True),
    dict(use_window=True, use_butterworth=True)])
def test_footskate_equals_jax(goldens, kw):
    """The demo's and the finetune's passes and the windowed detector, on the
    golden walk against a shifted reference: every output bit-equal."""
    g = goldens["postprocess"]
    ref = g["walk"] + np.random.RandomState(1).randn(*g["walk"].shape) * 1e-3
    got = footskate.remove_fs(g["walk"].copy(), ref, XIA_BVH_JOINT_NAMES, EE, **kw)
    want = jfootskate.remove_fs(g["walk"].copy(), ref, XIA_BVH_JOINT_NAMES, EE, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    fid = footskate.get_ee_id_by_names(XIA_BVH_JOINT_NAMES, EE)
    np.testing.assert_array_equal(footskate.get_foot_contact(ref, fid),
                                  jfootskate.get_foot_contact(ref, fid))
    np.testing.assert_array_equal(footskate.butterworth_motion(ref),
                                  jfootskate.butterworth_motion(ref))


# ---- BVH ----

def test_reads_the_reference_written_bvh(goldens):
    g = np.load(os.path.join(GOLDEN_DIR, "prepare_xia.npz"))
    path = os.path.join(GOLDEN_DIR, "prepare_xia.bvh")
    anim = bvh.read_bvh(path)
    np.testing.assert_allclose(np.abs(anim.quats), np.abs(g["quats"]), atol=1e-4)
    np.testing.assert_allclose(anim.pos, g["pos"], atol=1e-4)
    want = jbvh.read_bvh(path)
    assert anim.bones == want.bones and anim.frametime == want.frametime
    np.testing.assert_array_equal(anim.parents, want.parents)
    np.testing.assert_array_equal(anim.offsets, want.offsets)
    np.testing.assert_array_equal(anim.pos, want.pos)
    np.testing.assert_allclose(anim.quats, want.quats, atol=1e-6)
    for a, b in zip(bvh.extract_chains(anim), jbvh.extract_chains(want)):
        np.testing.assert_array_equal(np.asarray(a, dtype=object), np.asarray(b, dtype=object))


_QUATERNION_TO_EULER = rot.quaternion_to_euler


def _euler_f64(q, order="zyx", epsilon=0.0):
    """One Euler conversion for both packages' writers: float64, rounded to
    float32 as each package's own conversion returns."""
    q64 = torch.from_numpy(np.asarray(q, np.float64))
    return _QUATERNION_TO_EULER(q64, order, epsilon).float()


@pytest.mark.parametrize("orders", ["zyx", "xyz", "mixed"])
def test_save_bvh_bytes_equal_jaxs(orders, tmp_path, monkeypatch):
    anim, janim = _anim(bvh, seed=2), _anim(jbvh, seed=2)
    anim.end_offsets = janim.end_offsets = {6: np.array([0.1, -0.02, 0.0])}
    order = orders if orders != "mixed" else [("zyx", "xyz", "zxy", "xzy", "yxz", "yzx")[j % 6]
                                               for j in range(20)]
    # unpatched: the hierarchy byte for byte, the angles within 1e-4 degrees
    bvh.save_bvh(str(tmp_path / "port0.bvh"), anim, order=order)
    jbvh.save_bvh(str(tmp_path / "jax0.bvh"), janim, order=order)
    got, want = (open(tmp_path / f).read() for f in ("port0.bvh", "jax0.bvh"))
    head = got.index("Frame Time")
    assert got[:head] == want[:head]
    rows = [np.array([r.split() for r in s[head:].splitlines()[1:]], np.float64)
            for s in (got, want)]
    np.testing.assert_allclose(rows[0], rows[1], atol=1e-4)
    # the same angles: the same bytes
    monkeypatch.setattr(rot, "quaternion_to_euler", _euler_f64)
    monkeypatch.setattr(jrot, "quaternion_to_euler", _euler_f64)
    bvh.save_bvh(str(tmp_path / "port.bvh"), anim, order=order, positions=orders == "xyz")
    jbvh.save_bvh(str(tmp_path / "jax.bvh"), janim, order=order, positions=orders == "xyz")
    assert (tmp_path / "port.bvh").read_bytes() == (tmp_path / "jax.bvh").read_bytes()


def test_round_trip_and_jax_reads_the_ports_file(tmp_path):
    anim = _anim(bvh)
    path = str(tmp_path / "t.bvh")
    bvh.save_bvh(path, anim, 1 / 20)
    for back in (bvh.read_bvh(path), jbvh.read_bvh(path)):
        perm = [back.bones.index(n) for n in anim.bones]
        np.testing.assert_allclose(back.offsets[perm], anim.offsets, atol=1e-5)
        np.testing.assert_allclose(back.pos[:, 0], anim.pos[:, 0], atol=1e-5)
        d = np.abs(np.sum(back.quats[:, perm] * anim.quats, axis=-1))
        np.testing.assert_allclose(d, 1.0, atol=1e-4)
        _, gp1 = rot.quat_fk(_t(anim.quats), _t(anim.pos), anim.parents)
        _, gp2 = rot.quat_fk(_t(back.quats), _t(back.pos), back.parents)
        np.testing.assert_allclose(gp1.numpy(), gp2.numpy()[:, perm], atol=1e-4)


def _motion_rows(path):
    lines = open(path).read().splitlines()
    return lines, next(i for i, l in enumerate(lines) if l.startswith("Frame Time")) + 1


def test_parser_variants(tmp_path):
    """A corrupt row raises; a frame wrapped over two lines, 'End Site {' on
    one line, %e offsets, 'Frames:' without a space, the file's frame time
    and the order override read as the canonical file, as in JAX."""
    import re

    anim = _anim(bvh)
    anim.frametime = 1 / 60
    path = str(tmp_path / "ok.bvh")
    bvh.save_bvh(path, anim, order="xyz")
    lines, first = _motion_rows(path)
    open(tmp_path / "bad.bvh", "w").write(
        "\n".join(lines[:first + 2] + ["corrupted @@@ line"] + lines[first + 2:]) + "\n")
    for module in (bvh, jbvh):
        with pytest.raises(ValueError):
            module.read_bvh(str(tmp_path / "bad.bvh"))
    row = lines[first].split()
    open(tmp_path / "wrapped.bvh", "w").write("\n".join(
        lines[:first] + [" ".join(row[:len(row) // 2]), " ".join(row[len(row) // 2:])]
        + lines[first + 1:]) + "\n")
    text = re.sub(r"End Site\s*\n\s*\{", "End Site {", open(path).read())
    text = re.sub(r"OFFSET ([-\d.e]+) ([-\d.e]+) ([-\d.e]+)",
                  lambda m: "OFFSET " + " ".join(f"{float(v):e}" for v in m.groups()), text)
    open(tmp_path / "variant.bvh", "w").write(text.replace("Frames: ", "Frames:"))
    a = bvh.read_bvh(path)
    assert abs(a.frametime - 1 / 60) < 1e-6
    np.testing.assert_allclose(bvh.read_bvh(path, order="xyz").quats, a.quats, atol=1e-6)
    for name in ("wrapped.bvh", "variant.bvh"):
        b = bvh.read_bvh(str(tmp_path / name))
        assert a.bones == b.bones
        np.testing.assert_allclose(b.quats, a.quats, atol=1e-5)
        np.testing.assert_allclose(b.pos, a.pos, atol=1e-5)
        np.testing.assert_allclose(b.offsets, a.offsets, atol=1e-5)
        np.testing.assert_allclose(jbvh.read_bvh(str(tmp_path / name)).quats, b.quats,
                                   atol=1e-5)


def test_resample_and_clip_match_jax():
    anim, janim = _anim(bvh, T=9, seed=3), _anim(jbvh, T=9, seed=3)
    got, want = bvh.resample_anim(anim, 1.5), jbvh.resample_anim(janim, 1.5)
    assert got.quats.shape == want.quats.shape and got.frametime == want.frametime
    np.testing.assert_allclose(got.quats, want.quats, atol=1e-5)
    np.testing.assert_allclose(got.pos, want.pos, atol=1e-6)
    anim.clip(slice(2, 5))
    assert anim.shape == (3, 20)


# ---- IK ----

def _ik_inputs(goldens, frames=76):
    g = goldens["features"]
    return g["feats"][0][:frames].astype(np.float32), g["rec_real"][0][:frames] + 0.02


def test_fit_hmlvec_ik_matches_jax_after_10_steps(goldens):
    data, target = _ik_inputs(goldens)
    res = ik.fit_hmlvec_ik(_t(data), XIA, params.xia_real_offsets, _t(target), iters=10)
    want = jik.fit_hmlvec_ik(jnp.asarray(data), JXIA, jnp.asarray(jparams.xia_real_offsets),
                             jnp.asarray(target), iters=10)
    for got, w in zip(res[:3], want[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=IK_ATOL)
    assert abs(float(res.loss) - float(want.loss)) <= 1e-4 * abs(float(want.loss))
    # the fit moved towards the target
    r_rot_quat, r_pos = recover_root_rot_pos(_t(data))
    before = XIA.forward_kinematics_real_cont6d(_t(data[:, 61:]).reshape(-1, 20, 6), r_pos,
                                                r_rot_quat, params.xia_real_offsets)
    after = XIA.forward_kinematics_real_cont6d(res.cont6d, res.r_pos, res.r_rot_quat,
                                               params.xia_real_offsets)
    tgt = _t(target)
    assert float((after - tgt).abs().mean()) < float((before - tgt).abs().mean())
    np.testing.assert_allclose(ik.gmof(_t(data), 0.5).numpy(),
                               np.asarray(jik.gmof(jnp.asarray(data), 0.5)), rtol=1e-6)


def test_fit_quats_ik_matches_jax_after_10_steps():
    r = np.random.RandomState(0)
    q = r.randn(4, 8, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pos = r.randn(4, 8, 3).astype(np.float32)
    parents = [-1, 0, 1, 2, 1, 4, 1, 6]
    _, target = jrot.quat_fk(jnp.asarray(q), jnp.asarray(pos), parents)
    q2 = q + r.randn(*q.shape).astype(np.float32) * 0.1
    got = ik.fit_quats_ik(_t(q2), _t(pos), parents, _t(target), iters=10, lr=1e-2)
    want = jik.fit_quats_ik(jnp.asarray(q2), jnp.asarray(pos), parents, target, iters=10,
                            lr=1e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=IK_ATOL)
    _, init = rot.quat_fk(_t(q2), _t(pos), parents)
    _, fit = rot.quat_fk(rot.cont6d_to_quaternion(got), _t(pos), parents)
    tgt = _t(target)
    assert float((fit - tgt).abs().mean()) < float((init - tgt).abs().mean())


def test_fit_joints_bvh_writes_the_jax_file(goldens, tmp_path):
    data, target = _ik_inputs(goldens, frames=10)
    ik.fit_joints_bvh(str(tmp_path / "port.bvh"), data, XIA, params.xia_real_offsets, target,
                      names=XIA_BVH_JOINT_NAMES, iter_num=10, device=torch.device("cpu"))
    jik.fit_joints_bvh(str(tmp_path / "jax.bvh"), data, JXIA, jparams.xia_real_offsets, target,
                       names=XIA_BVH_JOINT_NAMES, iter_num=10)
    got, want = bvh.read_bvh(str(tmp_path / "port.bvh")), jbvh.read_bvh(str(tmp_path / "jax.bvh"))
    assert got.shape == (10, 20) and got.bones == want.bones
    np.testing.assert_allclose(got.pos, want.pos, atol=1e-5)
    np.testing.assert_allclose(np.abs(np.sum(got.quats * want.quats, axis=-1)), 1.0, atol=1e-4)


# ---- render ----

@pytest.mark.parametrize("vis_mode", ["gt", "root_horizontal", "upper_body"])
def test_plot_3d_motion_on_5_frames(goldens, tmp_path, vis_mode):
    """An mp4 with ffmpeg, else a gif beside it (tests/test_post.py:300-308):
    5 frames of figsize x 100 pixels with the figure drawn (more than the
    background and the floor's colour), the gt frames in the gt colours."""
    from PIL import Image

    joints = goldens["features"]["rec_ric"][0][:5]
    out = plot_3d_motion(str(tmp_path / "clip.mp4"), params.xia_kinematic_chain, joints,
                         title="t", fps=20, vis_mode=vis_mode, gt_frames=(1,))
    assert out == str(tmp_path / "clip.mp4")
    files = os.listdir(tmp_path)
    assert files in (["clip.mp4"], ["clip.gif"]), files
    if files == ["clip.gif"]:
        im = Image.open(tmp_path / "clip.gif")
        assert im.n_frames == 5 and im.size == (300, 300)
        colours = []
        for i in range(5):
            im.seek(i)
            colours.append({c for _, c in im.convert("RGB").getcolors(1 << 16)})
        assert all(len(c) > 2 for c in colours)
        assert (255, 255, 255) in colours[0] and (191, 191, 191) in colours[0]
        gt = (0x4D, 0x84, 0xAA)
        assert gt in colours[1] and (gt in colours[0]) == (vis_mode == "gt")
