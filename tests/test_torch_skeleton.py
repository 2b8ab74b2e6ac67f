"""The port's skeleton tables, FK/IK and the rest of the feature codec
(motionstyle_torch/core/{params,skeleton,features}.py, the BVH joint names
of data/masks.py) against the JAX package's and the reference goldens
(tests/goldens/skeleton_xia.npz, features.npz, process_posrot.npz) at the JAX
tests' tolerances (tests/test_skeleton_features.py: FK 2e-4, IK 1e-3 up to
sign, decoders 1e-4 and 1e-3, the posrot encoder 1e-4 on positions and
2e-3 on features). Seeded comparisons with JAX: atol 1e-5 on FK of
unit-scale offsets, 5e-5 on the host encoders, whose float32 quaternion
products XLA and torch round differently (one ulp, then amplified through
the feature's cumulative parts), and exact on the numpy tables."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.core import features as jfeatures, params as jparams
from motionstyle.core.skeleton import Skeleton as JSkeleton
from motionstyle.data import masks as jmasks
from motionstyle_torch.core import features, params
from motionstyle_torch.core.skeleton import Skeleton
from motionstyle_torch.data import masks
from tests.test_torch_models import one_torch_thread  # noqa: F401

XIA = Skeleton(params.xia_raw_offsets, params.xia_kinematic_chain)
JXIA = JSkeleton(jparams.xia_raw_offsets, jparams.xia_kinematic_chain)
T2M = Skeleton(params.smpl_raw_offsets, params.t2m_kinematic_chain)
JT2M = JSkeleton(jparams.smpl_raw_offsets, jparams.t2m_kinematic_chain)
XIA_FACE = [12, 16, 3, 7]  # rfemur, lfemur, rclavicle, lclavicle
TABLES = [n for n in dir(jparams) if n.endswith(("_offsets", "_chain", "_skel_id"))]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("name", TABLES)
def test_tables_equal_the_jax_packages(name):
    got, want = getattr(params, name), getattr(jparams, name)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_parents_and_bvh_names():
    assert len(TABLES) == 14  # 4 chains, 8 offset tables, 2 skeleton ids
    for chain, n in ((params.xia_kinematic_chain, 20), (params.t2m_kinematic_chain, 22),
                     (params.bandai_kinematic_chain, 21), (params.kit_kinematic_chain, 21)):
        assert params.chains_to_parents(chain, n) == jparams.chains_to_parents(chain, n)
    assert XIA.parents == JXIA.parents and XIA.kinematic_chain == JXIA.kinematic_chain
    assert masks.BVH_JOINT_NAMES == jmasks.BVH_JOINT_NAMES
    for name in ("XIA_BVH_JOINT_NAMES", "BANDAI_BVH_JOINT_NAMES", "SMPL_BVH_JOINT_NAMES"):
        assert getattr(masks, name) == getattr(jmasks, name)
    for name, layout in jfeatures.LAYOUTS.items():
        assert masks.LAYOUTS[name].ric_slice == layout.ric_slice
        assert masks.LAYOUTS[name].rot_slice == layout.rot_slice


def test_fk_goldens(goldens):
    g = goldens["skeleton_xia"]
    out = XIA.forward_kinematics_real_cont6d(_t(g["cont6d"]), _t(g["root_pos"]), _t(g["r_rot"]),
                                             params.xia_real_offsets)
    np.testing.assert_allclose(out.numpy(), g["real_fk"], atol=2e-4)
    out = XIA.forward_kinematics_cont6d(_t(g["cont6d"].reshape(-1, 20, 6)),
                                        _t(g["root_pos"].reshape(-1, 3)), params.xia_real_offsets)
    np.testing.assert_allclose(out.numpy(), g["chain_fk"], atol=2e-4)


def test_inverse_kinematics_golden_and_jax(goldens):
    """Against the reference's quaternions up to sign where they are finite
    (its zero-length pelvis bone gives NaN, the port identity, as JAX), and
    against the JAX package's own IK, with and without the smoothed forward."""
    g = goldens["skeleton_xia"]
    ours = XIA.inverse_kinematics_np(g["joints_for_ik"], XIA_FACE)
    assert ours.dtype == np.float64 and np.isfinite(ours).all()
    ref = g["ik_quats"]
    ok = np.isfinite(ref).all(axis=-1)
    np.testing.assert_allclose(np.abs(np.sum(ours * ref, axis=-1))[ok], 1.0, atol=1e-3)
    for smooth in (False, True):
        np.testing.assert_allclose(
            XIA.inverse_kinematics_np(g["joints_for_ik"], XIA_FACE, smooth),
            JXIA.inverse_kinematics_np(g["joints_for_ik"], XIA_FACE, smooth), atol=1e-5)


def test_ik_fk_round_trip():
    r = np.random.RandomState(3)
    quats = r.randn(5, 20, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    root_pos = _t(r.randn(5, 3))
    joints = XIA.forward_kinematics_quat(_t(quats), root_pos, params.xia_real_offsets).numpy()
    ik = XIA.inverse_kinematics_np(joints.astype(np.float64), XIA_FACE)
    joints2 = XIA.forward_kinematics_quat(_t(ik), root_pos, params.xia_real_offsets).numpy()
    np.testing.assert_allclose(joints2, joints, atol=5e-3)


@pytest.mark.parametrize("do_root_r", [True, False])
def test_fk_matches_jax_on_seeded_input(do_root_r):
    r = np.random.RandomState(4)
    quats = r.randn(3, 6, 20, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    c6 = r.randn(3, 6, 20, 6).astype(np.float32)
    root = r.randn(3, 6, 3).astype(np.float32)
    yaw = r.randn(3, 6, 4).astype(np.float32)
    offs = params.xia_real_offsets
    pairs = [
        (XIA.forward_kinematics_quat(_t(quats), _t(root), offs, do_root_r),
         JXIA.forward_kinematics_quat(jnp.asarray(quats), jnp.asarray(root), jnp.asarray(offs),
                                      do_root_r)),
        (XIA.forward_kinematics_cont6d(_t(c6), _t(root), offs, do_root_r),
         JXIA.forward_kinematics_cont6d(jnp.asarray(c6), jnp.asarray(root), jnp.asarray(offs),
                                        do_root_r)),
        (XIA.forward_kinematics_real_cont6d(_t(c6), _t(root), _t(yaw), offs),
         JXIA.forward_kinematics_real_cont6d(jnp.asarray(c6), jnp.asarray(root),
                                             jnp.asarray(yaw), jnp.asarray(offs))),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    joints = r.randn(20, 3)
    np.testing.assert_allclose(XIA.offsets_from_joints(joints), JXIA.offsets_from_joints(joints),
                               atol=1e-6)


def test_decoders_goldens_and_jax(goldens):
    g = goldens["features"]
    out = features.recover_from_real_rot(_t(g["feats"]), XIA, params.xia_real_offsets)
    np.testing.assert_allclose(out.numpy(), g["rec_real"], atol=1e-3)
    want = jfeatures.recover_from_real_rot(jnp.asarray(g["feats"]), JXIA,
                                           jnp.asarray(jparams.xia_real_offsets))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4)
    offs = params.smpl_real_offsets
    out = features.recover_from_rot(_t(g["feats_hml"]), T2M, offs)
    want = jfeatures.recover_from_rot(jnp.asarray(g["feats_hml"]), JT2M, jnp.asarray(offs))
    assert out.shape == (2, 60, 22, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4)
    for name, data in (("humanml", g["feats_hml"]), ("stylexia_posrot", g["feats"])):
        got = features.split_hmlvec(data, masks.LAYOUTS[name])
        want = jfeatures.split_hmlvec(data, jfeatures.LAYOUTS[name])
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def _posrot(g, module, skel):
    return module.process_file_with_rotation(g["pos_syn"].copy(), g["rots_syn"].copy(), skel,
                                             XIA_FACE, fid_l=[18, 19], fid_r=[14, 15],
                                             feet_thre=0.002)


def test_process_file_with_rotation_golden_and_jax(goldens):
    g = goldens["process_posrot"]
    data, glob, loc, lvel = _posrot(g, features, XIA)
    np.testing.assert_allclose(glob, g["glob"], atol=1e-4)
    np.testing.assert_allclose(data, g["data"], atol=2e-3)
    want = _posrot(g, jfeatures, JXIA)
    for got, w in zip((data, glob, loc, lvel), want):
        assert got.dtype == w.dtype and got.shape == w.shape
        np.testing.assert_allclose(got, w, atol=5e-5)
    # decoding the encoded clip gives the canonical positions back
    rec = features.recover_from_ric(_t(data), 20).numpy()
    np.testing.assert_allclose(rec, glob[:-1], atol=5e-3)


def test_process_file_and_uniform_skeleton_match_jax(goldens):
    pos = goldens["process_posrot"]["pos_syn"]
    got = features.process_file(pos.copy(), 0.002, XIA, XIA_FACE, [18, 19], [14, 15])
    want = jfeatures.process_file(pos.copy(), 0.002, JXIA, XIA_FACE, [18, 19], [14, 15])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=5e-5)
    got = features.uniform_skeleton(pos.copy(), XIA, params.xia_real_offsets, (13, 17), XIA_FACE)
    want = jfeatures.uniform_skeleton(pos.copy(), JXIA, jparams.xia_real_offsets, (13, 17),
                                      XIA_FACE)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-5)
