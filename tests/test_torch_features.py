"""The port's feature decoders and quaternion math against the reference
goldens (tests/goldens/features.npz, quaternion.npz) at the tolerances the
JAX package holds itself to there (tests/test_skeleton_features.py:69-80,
tests/test_rotations.py), and against the JAX functions on seeded input at
atol 1e-5. The decoders integrate velocities with fp32 cumulative sums, which
XLA's CPU lowering adds in a tree order and the port in sequence: one ulp
per partial sum. The seeded clips have the synthetic Xia corpus's scale
(randn * 0.5, tests/test_cli.py) over the Xia window of 76 frames, where the
decoded joints reach |10| and that ulp stays below 1e-5; at std-1 velocities
the joints reach |25| and it grows to ~3e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.core import features as jfeatures
from motionstyle.core import rotations as jrot
from motionstyle_torch.core import features, rotations as rot
from tests.test_torch_models import one_torch_thread  # noqa: F401

ORDERS = ("xyz", "yzx", "zxy", "xzy", "yxz", "zyx")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_recover_root_rot_pos_golden(goldens):
    g = goldens["features"]
    q, p = features.recover_root_rot_pos(_t(g["feats"]))
    np.testing.assert_allclose(q.numpy(), g["rec_root_quat"], atol=1e-4)
    np.testing.assert_allclose(p.numpy(), g["rec_root_pos"], atol=1e-4)


@pytest.mark.parametrize("feats, joints, want", [("feats", 20, "rec_ric"),
                                                 ("feats_hml", 22, "rec_ric_hml")])
def test_recover_from_ric_golden(goldens, feats, joints, want):
    g = goldens["features"]
    out = features.recover_from_ric(_t(g[feats]), joints)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), g[want], atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_decoders_match_jax_on_seeded_input(seed):
    """(2, 3, 76, 181) clips with leading batch dimensions; the yaw wraps
    several times over a clip."""
    x = (np.random.RandomState(seed).randn(2, 3, 76, 181) * 0.5).astype(np.float32)
    jq, jp = jfeatures.recover_root_rot_pos(jnp.asarray(x))
    q, p = features.recover_root_rot_pos(_t(x))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-5)
    want = np.asarray(jfeatures.recover_from_ric(jnp.asarray(x), 20))
    np.testing.assert_allclose(features.recover_from_ric(_t(x), 20).numpy(), want, atol=1e-5)


@pytest.mark.parametrize("name, fn, args, atol", [
    ("qmul", rot.qmul, ("q1", "q2"), 1e-5),
    ("qrot", rot.qrot, ("q1", "v"), 1e-4),
    ("qbetween", rot.qbetween, ("v0", "v1"), 1e-5),
    ("q2mat", rot.quaternion_to_matrix, ("q1",), 1e-5),
    ("q2cont6d", rot.quaternion_to_cont6d, ("q1",), 1e-5),
    ("cont6d2mat", rot.cont6d_to_matrix, ("c6",), 1e-5),
])
def test_rotations_golden(goldens, name, fn, args, atol):
    g = goldens["quaternion"]
    out = fn(*(_t(g[a]) for a in args))
    np.testing.assert_allclose(out.numpy(), g[name], atol=atol)


def test_qeuler_all_orders_golden(goldens):
    """The reference's qeuler in degrees stacked (x, y, z); the port, as the
    JAX package, returns radians stacked in the order string's sequence."""
    g = goldens["quaternion"]
    for order in ORDERS:
        ours = np.degrees(rot.quaternion_to_euler(_t(g["q1"]), order).numpy())
        ours_xyz = ours[..., [order.index(c) for c in "xyz"]]
        np.testing.assert_allclose(ours_xyz, g[f"qeuler_{order}"], atol=2e-3, err_msg=order)


def test_rotations_match_jax_on_seeded_input():
    rs = np.random.RandomState(1)
    q = rs.randn(5, 7, 4).astype(np.float32)
    r = rs.randn(7, 4).astype(np.float32)  # broadcast against q
    v = rs.randn(5, 7, 3).astype(np.float32)
    c6 = rs.randn(5, 7, 6).astype(np.float32)
    pairs = [
        (rot.qnormalize(_t(q)), jrot.qnormalize(jnp.asarray(q))),
        (rot.qinv(rot.qnormalize(_t(q))), jrot.qinv(jrot.qnormalize(jnp.asarray(q)))),
        (rot.qmul(_t(q), _t(r)), jrot.qmul(jnp.asarray(q), jnp.asarray(r))),
        (rot.qrot(rot.qnormalize(_t(q)), _t(v)),
         jrot.qrot(jrot.qnormalize(jnp.asarray(q)), jnp.asarray(v))),
        (rot.qbetween(_t(v), _t(v[::-1].copy())),
         jrot.qbetween(jnp.asarray(v), jnp.asarray(v[::-1].copy()))),
        (rot.quaternion_to_cont6d(_t(q)), jrot.quaternion_to_cont6d(jnp.asarray(q))),
        (rot.cont6d_to_matrix(_t(c6)), jrot.cont6d_to_matrix(jnp.asarray(c6))),
    ] + [(rot.quaternion_to_euler(rot.qnormalize(_t(q)), o),
          jrot.quaternion_to_euler(jrot.qnormalize(jnp.asarray(q)), o)) for o in ORDERS]
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(NotImplementedError):
        rot.quaternion_to_euler(_t(q), "xxy")
