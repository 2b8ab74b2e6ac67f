"""Quaternion, rotation-matrix and cont6d math in PyTorch (the port's own
copy of motionstyle/core/rotations.py:26-250 for what the feature decoder
and the goldens of tests/goldens/quaternion.npz need).

Conventions, as in the JAX package:
  - quaternions are (w, x, y, z), scalar first;
  - cont6d is the first two *columns* of the rotation matrix, concatenated:
    [m[..., :, 0], m[..., :, 1]] (the SMPL path's 6D rows are another
    convention, not ported here);
  - every function broadcasts over leading dimensions; float32 throughout
    (the feature codec is precision-sensitive, never bf16).

Not on this slice (ROADMAP §1 item 1): matrix_to_quaternion and the
axis-angle, slerp and FK helpers, which the post chain needs.
"""
from __future__ import annotations

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
