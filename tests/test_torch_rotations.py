"""The port's rotation library (motionstyle_torch/core/rotations.py) against
the JAX package's on seeded input and against the reference goldens
(tests/goldens/rotation_lib.npz, quaternion.npz) at the JAX tests' own
tolerances (tests/test_rotations.py: atol 1e-5 to 1e-4, 2e-3 degrees for
Euler against the reference's qeuler). Seeded comparisons with JAX: atol
1e-5 on unit-scale float32 results (XLA and torch round a few operations
differently), 1e-4 where angles pass through atan2 or arccos near their
edges. fit_quats_ik's loss is differentiated through matrix_to_quaternion,
so its gradient is held to jax.grad's, NaN where JAX's is NaN: at a matrix
whose diagonal terms tie at zero (the identity, a quarter turn), jnp.maximum
splits the gradient and sqrt's is infinite, and torch.maximum does the same."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.core import rotations as jrot
from motionstyle_torch.core import rotations as rot
from tests.test_torch_models import one_torch_thread  # noqa: F401

ORDERS = ("xyz", "yzx", "zxy", "xzy", "yxz", "zyx")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _unit_quats(n, seed):
    q = np.random.RandomState(seed).randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _same(got, want, atol=1e-5):
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


def test_cont6d_to_quaternion_golden(goldens):
    """The reference goes 6D -> matrix -> axis-angle -> quaternion, the port
    (as JAX) matrix -> quaternion directly: equal up to sign."""
    out = rot.cont6d_to_quaternion(_t(goldens["quaternion"]["c6"])).numpy()
    d = np.abs(np.sum(out * goldens["rotation_lib"]["cont6d2q"], axis=-1))
    np.testing.assert_allclose(d, 1.0, atol=1e-4)


def test_quat_fk_golden(goldens):
    g = goldens["rotation_lib"]
    gr, gp = rot.quat_fk(_t(g["lrot"]), _t(g["lpos"]), list(g["parents"]))
    np.testing.assert_allclose(gr.numpy(), g["quat_fk_gr"], atol=1e-4)
    np.testing.assert_allclose(gp.numpy(), g["quat_fk_gp"], atol=1e-4)


def test_remove_quat_discontinuities_golden(goldens):
    g = goldens["rotation_lib"]
    out = rot.remove_quat_discontinuities(_t(g["qseq"]))
    np.testing.assert_allclose(out.numpy(), g["rm_disc"], atol=1e-6)
    np.testing.assert_array_equal(rot.qfix_np(g["qseq"]), g["rm_disc"])


def test_round_trips():
    """tests/test_rotations.py's identities: matrix, cont6d, row-6D,
    axis-angle and Euler round trips."""
    q = _t(_unit_quats(64, 3))
    m = rot.quaternion_to_matrix(q)
    d = (rot.matrix_to_quaternion(m) * q).sum(-1).abs()
    np.testing.assert_allclose(d.numpy(), 1.0, atol=1e-5)
    _same(rot.cont6d_to_matrix(rot.matrix_to_cont6d(m)), m.numpy())
    _same(rot.rotation_6d_to_matrix(rot.matrix_to_rotation_6d(m)), m.numpy())
    aa = _t(np.random.RandomState(6).randn(64, 3))
    aa2 = rot.quaternion_to_axis_angle(rot.axis_angle_to_quaternion(aa))
    _same(rot.axis_angle_to_matrix(aa2), rot.axis_angle_to_matrix(aa).numpy())
    for order in ORDERS:
        e = _t((np.random.RandomState(7).rand(32, 3) - 0.5) * 2.0)
        q1 = rot.euler_to_quaternion(e, order)
        q2 = rot.euler_to_quaternion(rot.quaternion_to_euler(q1, order), order)
        np.testing.assert_allclose((q1 * q2).sum(-1).abs().numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_match_jax_on_seeded_input(seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(5, 7, 4).astype(np.float32)
    qu = q / np.linalg.norm(q, axis=-1, keepdims=True)
    c6 = rs.randn(5, 7, 6).astype(np.float32)
    aa = rs.randn(5, 7, 3).astype(np.float32)
    aa[0, 0] = 0.0  # the small-angle branch
    e = ((rs.rand(5, 7, 3) - 0.5) * 3.0).astype(np.float32)
    m = np.asarray(jrot.quaternion_to_matrix(jnp.asarray(qu)))
    pairs = [
        (rot.matrix_to_quaternion(_t(m)), jrot.matrix_to_quaternion(jnp.asarray(m))),
        (rot.matrix_to_cont6d(_t(m)), jrot.matrix_to_cont6d(jnp.asarray(m))),
        (rot.cont6d_to_quaternion(_t(c6)), jrot.cont6d_to_quaternion(jnp.asarray(c6))),
        (rot.rotation_6d_to_matrix(_t(c6)), jrot.rotation_6d_to_matrix(jnp.asarray(c6))),
        (rot.matrix_to_rotation_6d(_t(m)), jrot.matrix_to_rotation_6d(jnp.asarray(m))),
        (rot.axis_angle_to_quaternion(_t(aa)), jrot.axis_angle_to_quaternion(jnp.asarray(aa))),
        (rot.quaternion_to_axis_angle(_t(q)), jrot.quaternion_to_axis_angle(jnp.asarray(q))),
        (rot.axis_angle_to_matrix(_t(aa)), jrot.axis_angle_to_matrix(jnp.asarray(aa))),
        (rot.expmap_to_quaternion(_t(aa)), jrot.expmap_to_quaternion(jnp.asarray(aa))),
        (rot.lerp(_t(aa), _t(e), 0.3), jrot.lerp(jnp.asarray(aa), jnp.asarray(e), 0.3)),
        (rot.dct_matrix(9), jrot.dct_matrix(9)),
    ] + [(rot.euler_to_quaternion(_t(e), o), jrot.euler_to_quaternion(jnp.asarray(e), o))
         for o in ORDERS]
    for got, want in pairs:
        _same(got, want)
    t = rs.rand(5, 1).astype(np.float32)
    _same(rot.qpow(_t(qu), _t(t)), jrot.qpow(jnp.asarray(qu), jnp.asarray(t)), atol=1e-4)
    _same(rot.qslerp(_t(qu), _t(qu[::-1].copy()), _t(t)),
          jrot.qslerp(jnp.asarray(qu), jnp.asarray(qu[::-1].copy()), jnp.asarray(t)), atol=1e-4)
    np.testing.assert_array_equal(rot.qinv_np(q), jrot.qinv_np(q))
    seq = rs.randn(9, 3, 4).astype(np.float32)
    np.testing.assert_array_equal(rot.remove_quat_discontinuities(_t(seq)).numpy(),
                                  np.asarray(jrot.remove_quat_discontinuities(jnp.asarray(seq))))
    np.testing.assert_array_equal(rot.qfix_np(seq), jrot.qfix_np(seq))


def test_fk_match_jax():
    rs = np.random.RandomState(2)
    parents = [-1, 0, 1, 2, 1, 4, 1, 6]
    lrot = rs.randn(3, 8, 4).astype(np.float32)
    lpos = rs.randn(3, 8, 3).astype(np.float32)
    gr, gp = rot.quat_fk(_t(lrot), _t(lpos), parents)
    jgr, jgp = jrot.quat_fk(jnp.asarray(lrot), jnp.asarray(lpos), parents)
    _same(gr, jgr)
    _same(gp, jgp)
    mats = np.asarray(jrot.quaternion_to_matrix(jrot.qnormalize(jnp.asarray(lrot))))
    gr, gp = rot.rotm_fk(_t(mats), _t(lpos), parents)
    jgr, jgp = jrot.rotm_fk(jnp.asarray(mats), jnp.asarray(lpos), parents)
    _same(gr, jgr)
    _same(gp, jgp)


def _fk_loss_jax(c6, pos, target, parents):
    _, glb = jrot.quat_fk(jrot.cont6d_to_quaternion(c6), pos, parents)
    return jnp.mean((glb - target) ** 2)


def test_quats_ik_loss_gradient_matches_jax_grad():
    """The gradient of fit_quats_ik's loss (cont6d -> matrix -> quaternion ->
    FK -> MSE) against jax.grad, on random cont6d, on cont6d of the identity
    and of a quarter turn about z (diagonal terms that tie at zero: NaN in
    both), and on a turn whose matrix has m00 = m11 = 0 and every branch's
    argument positive (finite in both)."""
    rs = np.random.RandomState(3)
    parents = [-1, 0, 1, 2, 1]
    c6 = rs.randn(2, 5, 6).astype(np.float32)
    c6[1, 1] = [1, 0, 0, 0, 1, 0]  # identity
    c6[1, 2] = [0, 1, 0, -1, 0, 0]  # a quarter turn about z
    c6[1, 3] = [0, 0.6, 0.8, 1, 0, 0]  # m00 = m11 = 0, m22 = -0.6
    pos = rs.randn(2, 5, 3).astype(np.float32)
    target = rs.randn(2, 5, 3).astype(np.float32)
    want = np.asarray(jax.grad(_fk_loss_jax)(jnp.asarray(c6), jnp.asarray(pos),
                                             jnp.asarray(target), parents))
    x = _t(c6).requires_grad_(True)
    _, glb = rot.quat_fk(rot.cont6d_to_quaternion(x), _t(pos), parents)
    ((glb - _t(target)) ** 2).mean().backward()
    got = x.grad.numpy()
    assert np.isnan(want).any() and np.isfinite(want[0]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the matrix_to_quaternion gradient alone, at a tie of the largest branch
    m = np.eye(3, dtype=np.float32)[None].repeat(2, 0)
    m[1] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    jg = np.asarray(jax.grad(lambda a: jrot.matrix_to_quaternion(a).sum())(jnp.asarray(m)))
    xm = _t(m).requires_grad_(True)
    rot.matrix_to_quaternion(xm).sum().backward()
    np.testing.assert_array_equal(np.isnan(xm.grad.numpy()), np.isnan(jg))
    np.testing.assert_allclose(xm.grad.numpy(), jg, atol=1e-5)
