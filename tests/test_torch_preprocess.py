"""The port's preprocessing and prepare_dataset CLI against the JAX package's
on the CPU: downsample_quats and downsample_joints, smpl_params_to_pose (one
batched LBS call on the shared synthetic SMPL model), load_hybrik's three
payloads, pos2hmlrep's stages (the uniform-skeleton retarget, then
process_file) and pos2hmlrep end to end at atol 1e-5; prepare_dataset against
the golden prepare_xia.npz (atol 2e-3, tests/test_prepare_dataset.py's bound)
and against the JAX CLI on the same BVH corpus for all four profiles (the
files it writes, features at 5e-5: the bound the port's
process_file_with_rotation is held to in tests/test_torch_skeleton.py). Both
run on the CPU because the tests ask for it; without a device they ask for
the card.
"""
import os
import pickle
from os.path import join as pjoin

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from motionstyle.cli import prepare_dataset as jprep
from motionstyle.core import features as jfeatures
from motionstyle.core import rotations as jrot
from motionstyle.data import preprocess as jpre
from motionstyle.models import smpl as jsmpl
from motionstyle_torch.cli import prepare_dataset as prep
from motionstyle_torch.core import features
from motionstyle_torch.data import preprocess as pre
from motionstyle_torch.models import smpl
from tests.test_prepare_dataset import _write_corpus
from tests.test_torch_models import one_torch_thread  # noqa: F401

ATOL = 1e-5
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _quats(seed: int, T: int = 14, J: int = 24, smooth: bool = False) -> np.ndarray:
    r = np.random.RandomState(seed)
    if smooth:
        aa = 0.3 * np.sin(np.linspace(0, 2 * np.pi, T)[:, None, None]
                          * r.uniform(0.5, 2, (1, J, 1)) + r.uniform(0, 6, (1, J, 3)))
        return np.asarray(jrot.axis_angle_to_quaternion(jnp.asarray(aa, jnp.float32)))
    q = r.randn(T, J, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("rate", [25 / 20, 0.5])
def test_downsample_matches_jax(rate):
    q = _quats(0)
    p = np.random.RandomState(1).randn(len(q), 3).astype(np.float32)
    (gq, gp), (wq, wp) = pre.downsample_quats(q, p, rate), jpre.downsample_quats(q, p, rate)
    assert gq.shape == wq.shape and gp.shape == wp.shape
    np.testing.assert_allclose(gq, wq, atol=ATOL)
    np.testing.assert_allclose(gp, wp, atol=ATOL)
    j = np.random.RandomState(2).randn(len(q), 22, 3)
    np.testing.assert_allclose(pre.downsample_joints(j, rate), jpre.downsample_joints(j, rate),
                               atol=ATOL)


def test_smpl_params_to_pose_matches_jax():
    with_trans = True
    q = _quats(3, smooth=True)
    tl = np.random.RandomState(4).randn(len(q), 3).astype(np.float32)
    betas = (0.3 * np.random.RandomState(5).randn(10)).astype(np.float32)
    want = jpre.smpl_params_to_pose(q, tl, betas,
                                    jsmpl.SMPL(jsmpl.random_smpl_model(np.random.RandomState(0))),
                                    with_trans=with_trans)
    got = pre.smpl_params_to_pose(q, tl, betas,
                                  smpl.SMPL(smpl.random_smpl_model(np.random.RandomState(0))),
                                  with_trans=with_trans, device="cpu")
    assert got.shape == want.shape == (11, 22, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _walk(seed: int) -> np.ndarray:
    """A smooth walk of the synthetic SMPL body: (T, 22, 3) joints."""
    q = _quats(seed, T=25, smooth=True)
    T = len(q)
    tl = np.stack([np.linspace(0, 2, T), np.zeros(T), 0.1 * np.sin(np.linspace(0, 6, T))],
                  -1).astype(np.float32)
    model = smpl.SMPL(smpl.random_smpl_model(np.random.RandomState(0)))
    return pre.smpl_params_to_pose(q, tl, np.zeros(10, np.float32), model, with_trans=True,
                                   device="cpu")


def test_pos2hmlrep_matches_jax():
    joints = _walk(0)
    uni = features.uniform_skeleton(joints.copy(), pre._T2M_SKELETON,
                                    pre.skel_params.smpl_real_offsets, (5, 8),
                                    pre._T2M_FACE_JOINTS)
    want_uni = np.asarray(jfeatures.uniform_skeleton(
        joints.copy(), jpre._T2M_SKELETON, jpre.skel_params.smpl_real_offsets, (5, 8),
        jpre._T2M_FACE_JOINTS))
    np.testing.assert_allclose(uni, want_uni, atol=ATOL)
    got = features.process_file(want_uni.astype(np.float64), 0.002, pre._T2M_SKELETON,
                                pre._T2M_FACE_JOINTS, [7, 10], [8, 11])[0]
    want = jfeatures.process_file(want_uni.astype(np.float64), 0.002, jpre._T2M_SKELETON,
                                  jpre._T2M_FACE_JOINTS, [7, 10], [8, 11])[0]
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the JAX pos2hmlrep is these two stages: its output is `want`. Measured
    # on this walk: the retarget differs by 8.9e-7 and process_file on one
    # input by 2.4e-7, but process_file's IK turns the retarget's 8.9e-7 into
    # 7.9e-6 (JAX's process_file on the two retargets), and end to end the
    # port is 7.9e-6 from JAX (channel 183, a local rotation)
    hml, want_hml = pre.pos2hmlrep(joints.copy()), want.astype(np.float32)
    assert hml.shape == want_hml.shape == (len(joints) - 1, 263) and hml.dtype == np.float32
    np.testing.assert_allclose(hml, want_hml, atol=ATOL)


@pytest.mark.parametrize("entry", ["smpl_params_to_pose", "prepare_dataset"])
def test_the_card_is_the_default_device(entry, tmp_path):
    """Without a device both entry points ask for the card, and raise where
    there is none; they never fall back to the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "smpl_params_to_pose":
            pre.smpl_params_to_pose(_quats(3), np.zeros((14, 3), np.float32),
                                    np.zeros(10, np.float32),
                                    smpl.SMPL(smpl.random_smpl_model(np.random.RandomState(0))))
        else:
            bvh_dir = str(tmp_path / "raw")
            _profile_corpus("stylexia_posrot", bvh_dir)
            prep.main(["--dataset", "stylexia_posrot", "--bvh_dir", bvh_dir, "--out",
                       str(tmp_path / "out")])


@pytest.mark.parametrize("suffix", ["pt", "pk", "pkl"])
def test_load_hybrik_matches_jax(suffix, tmp_path):
    r = np.random.RandomState(6)
    T = 5
    q = _quats(7, T=T)
    mats = np.array(jrot.quaternion_to_matrix(jnp.asarray(q)))
    path = str(tmp_path / f"clip.{suffix}")
    if suffix == "pt":
        torch.save([{"pred_theta_mats": torch.from_numpy(mats.reshape(T, -1)),
                     "pred_shape": torch.from_numpy(r.randn(T, 10).astype(np.float32)),
                     "pred_xyz_jts_24_struct": torch.from_numpy(
                         r.randn(T, 72).astype(np.float32)),
                     "transl": torch.from_numpy(r.randn(T, 3).astype(np.float32))}], path)
    elif suffix == "pk":
        with open(path, "wb") as f:
            pickle.dump({"pred_thetas": mats, "pred_betas": r.randn(T, 10),
                         "pred_xyz_24_struct": r.randn(T, 24, 3), "transl": r.randn(T, 3)}, f)
    else:
        with open(path, "wb") as f:
            pickle.dump([{"smpl_pose_quat_wroot": q, "smpl_beta": r.randn(T, 10),
                          "root_trans": r.randn(T, 3)}], f)
    got, want = pre.load_hybrik(path), jpre.load_hybrik(path)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_allclose(a, np.asarray(b), atol=ATOL)


def test_prepare_matches_the_golden_pipeline():
    g = np.load(pjoin(GOLDEN_DIR, "prepare_xia.npz"))
    data = prep.process_bvh_file(pjoin(GOLDEN_DIR, "prepare_xia.bvh"), "stylexia_posrot",
                                 device="cpu")
    assert data.shape == g["data"].shape and data.dtype == np.float32
    np.testing.assert_allclose(data, g["data"], atol=2e-3)


def _profile_corpus(dataset: str, bvh_dir: str, n: int = 1) -> list:
    """BVH files of a profile's skeleton (the JAX writer), named by its
    scheme: a swaying pose over a forward-moving root."""
    from motionstyle.core import params as skel_params
    from motionstyle.core.skeleton import Skeleton
    from motionstyle.data.masks import BVH_JOINT_NAMES
    from motionstyle.post.bvh import Anim, save_bvh

    profile = jprep.PROFILES[dataset]
    skel = Skeleton(getattr(skel_params, f"{profile['offsets']}_raw_offsets"),
                    getattr(skel_params, f"{profile['chains']}_kinematic_chain"))
    offsets = np.asarray(getattr(skel_params, f"{profile['offsets']}_real_offsets"), np.float64)
    names = BVH_JOINT_NAMES["bandai-2_posrot" if dataset == "bandai-1_posrot" else dataset]
    os.makedirs(bvh_dir, exist_ok=True)
    files = []
    for k in range(n):
        r = np.random.RandomState(10 + k)
        T, J = 30, len(offsets)
        t = np.arange(T) / 20.0
        axes = r.randn(J, 3)
        axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
        half = 0.5 * r.uniform(0.05, 0.3, J)[None] * np.sin(
            2 * np.pi * r.uniform(0.5, 2.0, J)[None] * t[:, None])
        quats = np.concatenate([np.cos(half)[..., None], np.sin(half)[..., None] * axes[None]],
                               -1)
        pos = np.broadcast_to(offsets[None], (T, J, 3)).copy()
        pos[:, 0, 1] = 0.9
        pos[:, 0, 2] = 0.03 * np.arange(T)
        stem = {"stylexia_posrot": f"65{k}angry_jumping",
                "humanml_posrot": f"M00000{k}"}.get(
            dataset, f"dataset-{dataset[7]}_walk_angry_{k:03d}")
        save_bvh(pjoin(bvh_dir, stem + ".bvh"),
                 Anim(quats, pos, offsets, np.asarray(skel.parents), list(names)))
        files.append(stem)
    return files


@pytest.mark.parametrize("dataset", ["stylexia_posrot", "bandai-2_posrot", "bandai-1_posrot",
                                     "humanml_posrot"])
def test_prepare_matches_the_jax_cli(dataset, tmp_path):
    """The CLI on one BVH corpus in both packages: the same files, features
    within 5e-5, Mean/Std alike, the same profiles (bandai-1's is bandai-2's
    under another name scheme)."""
    bvh_dir = str(tmp_path / "raw")
    stems = _profile_corpus(dataset, bvh_dir)
    got = prep.main(["--dataset", dataset, "--bvh_dir", bvh_dir, "--out",
                     str(tmp_path / "port"), "--downsample", "2", "--device", "cpu"])
    want = jprep.main(["--dataset", dataset, "--bvh_dir", bvh_dir, "--out",
                       str(tmp_path / "jax"), "--downsample", "2"])
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == \
        [s + ".npy" for s in stems]
    for a, b in zip(got, want):
        x, y = np.load(a), np.load(b)
        assert x.shape == y.shape and x.shape[1] == prep.PROFILES[dataset]["dim"]
        np.testing.assert_allclose(x, y, atol=5e-5)
    for f in ("Mean.npy", "Std.npy"):
        np.testing.assert_allclose(np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f),
                                   atol=5e-5)
    assert {k: {n: v for n, v in p.items() if n != "name_hint"}
            for k, p in prep.PROFILES.items()} == \
        {k: {n: v for n, v in p.items() if n != "name_hint"} for k, p in jprep.PROFILES.items()}


def test_prepare_refuses_and_skips_as_the_jax_cli(tmp_path, capsys):
    """A wrong skeleton is skipped with its reason (then no clip survives),
    --any_skeleton takes it positionally, a non-conforming name warns, an
    empty directory raises."""
    from motionstyle.post.bvh import Anim, read_bvh, save_bvh

    with pytest.raises(FileNotFoundError, match="no .bvh"):
        os.makedirs(tmp_path / "none")
        prep.prepare(str(tmp_path / "none"), str(tmp_path / "o0"), "stylexia_posrot", device="cpu")
    bvh_dir = str(tmp_path / "raw")
    _write_corpus(bvh_dir, [("oddname.bvh", 5)])
    assert len(prep.prepare(bvh_dir, str(tmp_path / "o1"), "stylexia_posrot", device="cpu")) == 1
    assert "naming convention" in capsys.readouterr().out
    a = read_bvh(pjoin(bvh_dir, "oddname.bvh"))
    bad_dir = str(tmp_path / "bad")
    os.makedirs(bad_dir)
    save_bvh(pjoin(bad_dir, "650angry_jumping.bvh"),
             Anim(a.quats, a.pos, a.offsets, a.parents, [f"bone{i}" for i in range(20)]))
    with pytest.raises(RuntimeError, match="no clips survived"):
        prep.prepare(bad_dir, str(tmp_path / "o2"), "stylexia_posrot", device="cpu")
    assert "lacks joints" in capsys.readouterr().out
    assert len(prep.prepare(bad_dir, str(tmp_path / "o3"), "stylexia_posrot",
                            any_skeleton=True, device="cpu")) == 1
