"""The port's SMPL body model and rotation2xyz against the JAX package on the
CPU, on the shared synthetic model (random_smpl_model draws the same numbers
from the same RandomState in both packages): LBS, the joint maps and every
pose representation at atol 1e-5 (tests/test_smpl.py's bound), the
closed-form identities of tests/test_smpl.py, and the asset loader (no SMPL
asset ships with the repository: a missing file raises, a written one loads
as the JAX loader loads it).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from motionstyle.core import rotations as jrot
from motionstyle.models import rotation2xyz as jr2x
from motionstyle.models import smpl as jsmpl
from motionstyle_torch.core import rotations as rot
from motionstyle_torch.models import rotation2xyz as r2x
from motionstyle_torch.models import smpl
from tests.test_torch_models import one_torch_thread  # noqa: F401

ATOL = 1e-5
FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "parents",
          "j_regressor_extra")


@pytest.fixture(scope="module")
def models():
    return (smpl.random_smpl_model(np.random.RandomState(0)),
            jsmpl.random_smpl_model(np.random.RandomState(0)))


def _pose(seed: int, B: int = 3):
    r = np.random.RandomState(seed)
    q = r.randn(B, 24, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    mats = np.array(jrot.quaternion_to_matrix(jnp.asarray(q)))
    return mats, (0.5 * r.randn(B, 10)).astype(np.float32), r.randn(B, 3).astype(np.float32)


def test_random_model_draws_the_jax_models_numbers(models):
    port, jax_model = models
    for f in FIELDS:
        assert np.array_equal(getattr(port, f), getattr(jax_model, f)), f
        assert getattr(port, f).dtype == getattr(jax_model, f).dtype, f


@pytest.mark.parametrize("with_transl", [False, True])
def test_lbs_matches_jax(models, with_transl):
    mats, betas, transl = _pose(1)
    tl = transl if with_transl else None
    want_v, want_j = jsmpl.lbs(models[1], jnp.asarray(betas), jnp.asarray(mats),
                               None if tl is None else jnp.asarray(tl))
    got_v, got_j = smpl.lbs(models[0], torch.from_numpy(betas), torch.from_numpy(mats),
                            None if tl is None else torch.from_numpy(tl))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=ATOL)
    np.testing.assert_allclose(got_j.numpy(), np.asarray(want_j), atol=ATOL)


def test_joint_maps_match_jax(models):
    mats, betas, _ = _pose(2)
    want = jsmpl.SMPL(models[1])(jnp.asarray(mats[:, 1:]), jnp.asarray(mats[:, 0]),
                                 jnp.asarray(betas))
    got = smpl.SMPL(models[0])(torch.from_numpy(mats[:, 1:]), torch.from_numpy(mats[:, 0]),
                               torch.from_numpy(betas))
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, err_msg=k)


def test_identity_pose_and_betas_are_the_closed_forms(models):
    model = models[0]
    pose = torch.eye(3).expand(2, 24, 3, 3)
    verts, joints = smpl.lbs(model, torch.zeros(2, 10), pose)
    np.testing.assert_allclose(verts.numpy(), np.tile(model.v_template[None], (2, 1, 1)),
                               atol=ATOL)
    np.testing.assert_allclose(joints.numpy()[0], model.j_regressor @ model.v_template,
                               atol=ATOL)
    betas = torch.zeros(1, 10)
    betas[0, 0] = 2.0
    verts, _ = smpl.lbs(model, betas, pose[:1])
    np.testing.assert_allclose(verts[0].numpy(), model.v_template + 2.0 * model.shapedirs[..., 0],
                               atol=ATOL)


@pytest.mark.parametrize("pose_rep, width", [("rot6d", 6), ("rotquat", 4), ("rotvec", 3),
                                             ("rotmat", 9)])
def test_rotation2xyz_matches_jax(models, pose_rep, width):
    """Every pose representation (and every joint set on rot6d), with
    translation, masked frames and beta, against the JAX module on the same
    model."""
    r = np.random.RandomState(3)
    B, T = 2, 5
    x = r.randn(B, 25, width, T).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[5], [3]])).astype(np.float32)
    port = r2x.Rotation2xyz(smpl.SMPL(models[0]))
    ref = jr2x.Rotation2xyz(jsmpl.SMPL(models[1]))
    # every joint set on one representation, the SMPL joints and vertices on the others
    for jointstype in r2x.JOINTSTYPES if pose_rep == "rot6d" else ("smpl", "vertices"):
        want = ref(jnp.asarray(x), jnp.asarray(mask), pose_rep, True, True, jointstype, True,
                   beta=0.3)
        got = port(torch.from_numpy(x), torch.from_numpy(mask), pose_rep, True, True,
                   jointstype, True, beta=0.3)
        assert tuple(got.shape) == want.shape, jointstype
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=jointstype)


def test_rotation2xyz_global_rotation_and_refusals(models):
    """glob=False takes --glob_rot as the global orientation (and needs it);
    xyz passes through; an unknown joint set raises, as in the JAX module."""
    r = np.random.RandomState(4)
    x = r.randn(2, 23, 3, 4).astype(np.float32)
    glob_rot = [3.14159, 0.0, 0.0]
    want = jr2x.Rotation2xyz(jsmpl.SMPL(models[1]))(
        jnp.asarray(x), None, "rotvec", False, False, "smpl", False, glob_rot=glob_rot)
    port = r2x.Rotation2xyz(smpl.SMPL(models[0]))
    got = port(torch.from_numpy(x), None, "rotvec", False, False, "smpl", False,
               glob_rot=glob_rot)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with pytest.raises(TypeError, match="global rotation"):
        port(torch.from_numpy(x), None, "rotvec", False, False, "smpl", False)
    xyz = torch.ones(1, 5, 3, 4)
    assert port(xyz, None, "xyz", True, True, "smpl", True) is xyz
    with pytest.raises(NotImplementedError):
        port(torch.zeros(1, 25, 6, 2), None, "rot6d", True, True, "nope", True)


def test_rotation2xyz_on_the_port_rotations_round_trip(models):
    """rot6d made by the port's own rotation library (matrix_to_rotation_6d)
    decodes to the pose the matrices give: the smpl joints equal LBS's."""
    mats, _, _ = _pose(5, B=4)
    d6 = rot.matrix_to_rotation_6d(torch.from_numpy(mats))  # (T=4, 24, 6)
    x = d6.permute(1, 2, 0)[None]  # (1, 24, 6, 4)
    out = r2x.Rotation2xyz(smpl.SMPL(models[0]))(x, None, "rot6d", False, True, "smpl", False)
    _, joints = smpl.lbs(models[0], torch.zeros(4, 10), torch.from_numpy(mats))
    want = (joints - joints[:, :1]).permute(1, 2, 0)[None]
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=ATOL)


def test_loader_raises_without_the_asset_and_reads_a_written_one(models, tmp_path):
    with pytest.raises(FileNotFoundError):
        smpl.load_smpl_model(str(tmp_path / "SMPL_NEUTRAL.pkl"))
    with pytest.raises(FileNotFoundError):
        smpl.SMPL(model_path=str(tmp_path / "absent.pkl"))
    m = models[0]
    path = str(tmp_path / "model.npz")
    kintree = np.stack([np.where(m.parents < 0, 4294967295, m.parents), np.arange(24)])
    np.savez(path, v_template=m.v_template, shapedirs=m.shapedirs,
             posedirs=m.posedirs.T.reshape(-1, 3, 207), J_regressor=m.j_regressor,
             weights=m.lbs_weights, kintree_table=kintree)
    extra = str(tmp_path / "extra.npy")
    np.save(extra, m.j_regressor_extra)
    got = smpl.load_smpl_model(path, extra)
    want = jsmpl.load_smpl_model(path, extra)
    for f in FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    no_extra = smpl.load_smpl_model(path, str(tmp_path / "absent.npy"))
    assert no_extra.j_regressor_extra is None
    pose = torch.eye(3).expand(1, 24, 3, 3)
    with pytest.raises(IndexError, match="J_regressor_extra"):
        smpl.SMPL(no_extra)(pose[:, 1:], pose[:, 0])
