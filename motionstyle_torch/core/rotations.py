"""Quaternion, rotation-matrix, 6D and axis-angle math in PyTorch: the port's
own copy of motionstyle/core/rotations.py.

Conventions, as in the JAX package:
  - quaternions are (w, x, y, z), scalar first;
  - cont6d is the first two *columns* of the rotation matrix, concatenated:
    [m[..., :, 0], m[..., :, 1]]; the SMPL path's 6D (rotation_6d_to_matrix)
    is the first two *rows*, another convention;
  - every function broadcasts over leading dimensions and runs on the
    device of its inputs; float32 throughout (the feature codec is
    precision-sensitive, never bf16);
  - the gradients follow JAX's where its rules differ from torch's defaults:
    matrix_to_quaternion takes sqrt(maximum(x, 0)) with torch.maximum, which
    splits the gradient at a tie as jnp.maximum does (torch.clamp would not),
    so post/ik.py::fit_quats_ik differentiates as the JAX fit does.

qinv_np and qfix_np are the host-side numpy helpers of the encoders.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-8


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) scaled to unit length."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(_EPS)


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion (its inverse)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q * r, both (..., 4) scalar first."""
    w1, v1 = q[..., :1], q[..., 1:]
    w2, v2 = r[..., :1], r[..., 1:]
    w = w1 * w2 - (v1 * v2).sum(-1, keepdim=True)
    v = w1 * v2 + w2 * v1 + _cross(v1, v2)
    return torch.cat([w, v], dim=-1)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Vector(s) v (..., 3) rotated by quaternion(s) q (..., 4):
    v + 2 (s (u x v) + u x (u x v)), exact for unit quaternions."""
    s, u = q[..., :1], q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (s * uv + _cross(u, uv))


def qbetween(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """The quaternion that rotates v0 onto v1 (inputs need not be unit)."""
    a = _cross(v0, v1)
    w = torch.sqrt((v0 ** 2).sum(-1) * (v1 ** 2).sum(-1)) + (v0 * v1).sum(-1)
    return qnormalize(torch.cat([w[..., None], a], dim=-1))


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    q = qnormalize(q)
    r, i, j, k = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    m = torch.stack([
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quaternion_to_cont6d(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> cont6d: the first two matrix columns, concatenated."""
    m = quaternion_to_matrix(q)
    return torch.cat([m[..., :, 0], m[..., :, 1]], dim=-1)


def cont6d_to_matrix(c: torch.Tensor) -> torch.Tensor:
    """cont6d -> rotation matrix by Gram-Schmidt: x = normalize(c[:3]),
    z = normalize(x x c[3:]), y = z x x; the result's columns are (x, y, z)."""
    x = c[..., 0:3]
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(_EPS)
    z = _cross(x, c[..., 3:6])
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(_EPS)
    y = _cross(z, x)
    return torch.stack([x, y, z], dim=-1)


def quaternion_to_euler(q: torch.Tensor, order: str = "zyx", epsilon: float = 0.0
                        ) -> torch.Tensor:
    """Quaternion -> intrinsic Euler angles in radians, the reference's qeuler
    closed forms for all six orders, stacked in the order string's sequence
    (the JAX package's layout; the reference stacks degrees as x, y, z).
    epsilon shrinks the asin clamp to (-1 + eps, 1 - eps)."""
    w, x, y, z = q.unbind(-1)

    def asin(v):
        return torch.asin(torch.clamp(2.0 * v, -1.0 + epsilon, 1.0 - epsilon))

    def at(a, b):
        return torch.atan2(2.0 * a, 1.0 - 2.0 * b)

    forms = {
        "xyz": lambda: {"x": at(w * x - y * z, x * x + y * y), "y": asin(x * z + w * y),
                        "z": at(w * z - x * y, y * y + z * z)},
        "yzx": lambda: {"x": at(w * x - y * z, x * x + z * z),
                        "y": at(w * y - x * z, y * y + z * z), "z": asin(x * y + w * z)},
        "zxy": lambda: {"x": asin(w * x + y * z), "y": at(w * y - x * z, x * x + y * y),
                        "z": at(w * z - x * y, x * x + z * z)},
        "xzy": lambda: {"x": at(w * x + y * z, x * x + z * z),
                        "y": at(w * y + x * z, y * y + z * z), "z": asin(w * z - x * y)},
        "yxz": lambda: {"x": asin(w * x - y * z), "y": at(x * z + w * y, x * x + y * y),
                        "z": at(x * y + w * z, x * x + z * z)},
        "zyx": lambda: {"x": at(w * x + y * z, x * x + y * y), "y": asin(w * y - x * z),
                        "z": at(w * z + x * y, y * y + z * z)},
    }
    if order not in forms:
        raise NotImplementedError(f"euler order {order!r}")
    e = forms[order]()
    return torch.stack([e[c] for c in order], dim=-1)


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) by the
    four-branch construction picked by the largest diagonal combination
    (the first on a tie, as jnp.argmax), without data-dependent control flow."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    zero = m.new_zeros(())

    def _sqrt(x):
        return torch.sqrt(torch.maximum(x, zero))

    q_abs = torch.stack([
        _sqrt(1.0 + m00 + m11 + m22), _sqrt(1.0 + m00 - m11 - m22),
        _sqrt(1.0 - m00 + m11 - m22), _sqrt(1.0 - m00 - m11 + m22)], dim=-1)
    quat_by_w = torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1)
    quat_by_x = torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1)
    quat_by_y = torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1)
    quat_by_z = torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1)
    candidates = torch.stack([quat_by_w, quat_by_x, quat_by_y, quat_by_z], -2)
    candidates = candidates / (2.0 * q_abs[..., None].clamp_min(0.1))
    best = torch.argmax(q_abs, dim=-1)
    index = best[..., None, None].expand(best.shape + (1, 4))
    return qnormalize(torch.gather(candidates, -2, index)[..., 0, :])


def matrix_to_cont6d(m: torch.Tensor) -> torch.Tensor:
    return torch.cat([m[..., :, 0], m[..., :, 1]], dim=-1)


def cont6d_to_quaternion(c: torch.Tensor) -> torch.Tensor:
    return matrix_to_quaternion(cont6d_to_matrix(c))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """PyTorch3D-style 6D (rows) -> matrix whose rows are (b1, b2, b3)
    (utils/rotation_conversions.py:513; the SMPL path's convention)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True).clamp_min(_EPS)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.vector_norm(b2, dim=-1, keepdim=True).clamp_min(_EPS)
    b3 = _cross(b1, b2)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(m: torch.Tensor) -> torch.Tensor:
    """The first two rows, flattened (utils/rotation_conversions.py:555)."""
    return m[..., :2, :].reshape(m.shape[:-2] + (6,))


def axis_angle_to_quaternion(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> quaternion, with a small-angle Taylor branch:
    the gradient is finite at aa = 0 (IK fits start at the rest pose)."""
    angle = torch.sqrt(torch.maximum((aa * aa).sum(-1, keepdim=True), aa.new_tensor(1e-24)))
    half = angle * 0.5
    small = angle < 1e-6
    sin_half_over_angle = torch.where(
        small, 0.5 - angle * angle / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(angle), angle))
    return torch.cat([torch.cos(half), aa * sin_half_over_angle], dim=-1)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    q = qnormalize(q)
    norm = torch.linalg.vector_norm(q[..., 1:], dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(norm, q[..., :1])
    small = norm < 1e-6
    scale = torch.where(small, torch.full_like(norm, 2.0),
                        angle / torch.where(small, torch.ones_like(norm), norm))
    return q[..., 1:] * scale


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(aa))


_AXES = {"x": (1.0, 0.0, 0.0), "y": (0.0, 1.0, 0.0), "z": (0.0, 0.0, 1.0)}


def euler_to_quaternion(e: torch.Tensor, order: str = "zyx") -> torch.Tensor:
    """Intrinsic Euler angles (radians) -> quaternion: q = q_0 q_1 q_2 for the
    axes of the order string, e[..., i] the angle about order[i]
    (data_loaders/humanml/common/quaternion.py:195)."""
    q = None
    for i, ax in enumerate(order):
        half = e[..., i:i + 1] * 0.5
        qi = torch.cat([torch.cos(half), torch.sin(half) * e.new_tensor(_AXES[ax])], dim=-1)
        q = qi if q is None else qmul(q, qi)
    return q


def remove_quat_discontinuities(rotations: torch.Tensor) -> torch.Tensor:
    """Flip quaternion signs along time (axis 0 of (T, ..., 4)) so that each
    frame's dot product with the *corrected* previous frame is >= 0
    (utils/rotation.py:666): a loop over T, since each flip depends on the
    one before."""
    out = [rotations[0]]
    for cur in rotations[1:]:
        flip = (out[-1] * cur).sum(-1, keepdim=True) < 0
        out.append(torch.where(flip, -cur, cur))
    return torch.stack(out, dim=0)


def quat_fk(lrot: torch.Tensor, lpos: torch.Tensor, parents) -> tuple:
    """Forward kinematics over a parent array (parents[0] == -1, topologically
    sorted): local quaternions (..., J, 4) and offsets (..., J, 3) -> (global
    quaternions, global positions) (utils/rotation.py:646)."""
    lrot = qnormalize(lrot)
    gr, gp = [lrot[..., :1, :]], [lpos[..., :1, :]]
    for i in range(1, len(parents)):
        p = int(parents[i])
        gp.append(qrot(gr[p], lpos[..., i:i + 1, :]) + gp[p])
        gr.append(qmul(gr[p], lrot[..., i:i + 1, :]))
    return torch.cat(gr, dim=-2), torch.cat(gp, dim=-2)


def rotm_fk(lrot: torch.Tensor, lpos: torch.Tensor, parents) -> tuple:
    """Matrix-form FK: (..., J, 3, 3) and (..., J, 3) -> (global rotations,
    global positions) (utils/rotation.py:631)."""
    gr, gp = [lrot[..., :1, :, :]], [lpos[..., :1, :]]
    for i in range(1, len(parents)):
        p = int(parents[i])
        gp.append((gr[p][..., 0, :, :] @ lpos[..., i, :, None])[..., 0][..., None, :] + gp[p])
        gr.append(gr[p] @ lrot[..., i:i + 1, :, :])
    return torch.cat(gr, dim=-3), torch.cat(gp, dim=-2)


def dct_matrix(n: int) -> torch.Tensor:
    """Orthonormal DCT-II basis (n, n), float32 (utils/rotation.py:715)."""
    k = torch.arange(n)
    m = math.sqrt(2.0 / n) * torch.cos(math.pi * (2 * k[None] + 1) * k[:, None] / (2 * n))
    m[0] = math.sqrt(1.0 / n)
    return m


def expmap_to_quaternion(e: torch.Tensor) -> torch.Tensor:
    """Exponential map (..., 3) -> quaternion (..., 4) through the normalised
    sinc (data_loaders/humanml/common/quaternion.py:240)."""
    theta = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    return torch.cat([torch.cos(0.5 * theta), 0.5 * torch.sinc(0.5 * theta / math.pi) * e],
                     dim=-1)


def qpow(q0: torch.Tensor, t) -> torch.Tensor:
    """Quaternion power q0 ** t, t a scalar or broadcastable to q0[..., 0]."""
    q0 = qnormalize(q0)
    theta0 = torch.arccos(torch.clamp(q0[..., 0], -1.0, 1.0))
    theta0 = torch.where(theta0.abs() <= 1e-9, torch.full_like(theta0, 1e-9), theta0)
    v0 = q0[..., 1:] / torch.sin(theta0)[..., None]
    theta = torch.as_tensor(t, dtype=q0.dtype, device=q0.device) * theta0
    return torch.cat([torch.cos(theta)[..., None], v0 * torch.sin(theta)[..., None]], dim=-1)


def qslerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation from q0 to q1 at fraction(s) t, q1 first moved
    onto q0's hemisphere (the shortest path)."""
    q0, q1 = qnormalize(q0), qnormalize(q1)
    q1 = torch.where((q0 * q1).sum(-1, keepdim=True) < 0, -q1, q1)
    return qmul(qpow(qmul(q1, qinv(q0)), t), q0)


def lerp(p0: torch.Tensor, p1: torch.Tensor, t) -> torch.Tensor:
    return p0 + torch.as_tensor(t, dtype=p0.dtype, device=p0.device) * (p1 - p0)


def qinv_np(q) -> np.ndarray:
    """Host-side unit-quaternion inverse (the conjugate), (w, x, y, z)."""
    out = np.array(q, copy=True)
    out[..., 1:] = -out[..., 1:]
    return out


def qfix_np(q) -> np.ndarray:
    """Host-side quaternion continuity fix over axis 0."""
    q = np.array(q, copy=True)
    for i in range(1, q.shape[0]):
        d = np.sum(q[i] * q[i - 1], axis=-1)
        q[i][d < 0] = -q[i][d < 0]
    return q
