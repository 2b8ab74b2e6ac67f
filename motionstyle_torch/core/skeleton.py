"""Skeleton forward and inverse kinematics in PyTorch (the port's own copy of
motionstyle/core/skeleton.py).

Forward kinematics run on the device of their inputs:
  - forward_kinematics_quat / forward_kinematics_cont6d: the chain convention,
    in which a joint's offset is rotated by the joint's *own* global rotation
    (data_loaders/humanml/common/skeleton.py:108-198);
  - forward_kinematics_real_cont6d: the parent-array convention of the posrot
    ("real rotation") layouts and of the IK fit, in which the offset is
    rotated by the *parent's* global rotation and the root's 6D rotation is
    pre-multiplied by the yaw quaternion (skeleton.py:200-244).

inverse_kinematics_np is host numpy (dataset preprocessing), with the JAX
package's dtypes: the quaternion products in float32, the joints and the
result in float64 (skeleton.py:55-105, with the revised hip order and the
root's qbetween(target, forward)). A zero-length bone (Xia's pelvis) gets
the identity rotation where the reference gives NaN.
"""
from __future__ import annotations

import numpy as np
import torch

from motionstyle_torch.core import rotations as rot
from motionstyle_torch.core.params import chains_to_parents


def on_host(fn, *arrays) -> np.ndarray:
    """fn of the rotation library on numpy arrays, computed in float32 on the
    CPU as the JAX package computes its jnp calls on host arrays."""
    return fn(*(torch.from_numpy(np.array(a, dtype=np.float32)) for a in arrays)).numpy()


class Skeleton:
    """Unit bone directions (J, 3), kinematic chains and the parent array
    derived from them (or given)."""

    def __init__(self, raw_offsets, kinematic_chain, parents=None):
        self.raw_offsets = np.asarray(raw_offsets)
        self.kinematic_chain = tuple(map(tuple, kinematic_chain))
        self.parents = tuple(parents if parents is not None
                             else chains_to_parents(self.kinematic_chain, len(self.raw_offsets)))

    @property
    def njoints(self) -> int:
        return len(self.raw_offsets)

    def offsets_from_joints(self, joints: np.ndarray) -> np.ndarray:
        """Unit offsets scaled by the bone lengths of one pose (J, 3)
        (skeleton.py:43-51, get_offsets_joints)."""
        offsets = np.array(self.raw_offsets, dtype=np.float32, copy=True)
        for i in range(1, self.njoints):
            offsets[i] = np.linalg.norm(joints[i] - joints[self.parents[i]]) * offsets[i]
        return offsets

    @staticmethod
    def _like(offsets, ref: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(offsets, dtype=ref.dtype, device=ref.device)

    def forward_kinematics_quat(self, quat_params: torch.Tensor, root_pos: torch.Tensor,
                                offsets, do_root_r: bool = True) -> torch.Tensor:
        """quat_params (..., J, 4), root_pos (..., 3), offsets (J, 3) -> (..., J, 3)."""
        offsets = self._like(offsets, quat_params)
        gjoints = [None] * self.njoints
        gjoints[0] = root_pos
        root_q = quat_params[..., 0, :]
        if not do_root_r:
            root_q = torch.zeros_like(root_q)
            root_q[..., 0] = 1.0
        for chain in self.kinematic_chain:
            r = root_q
            for k in range(1, len(chain)):
                j = chain[k]
                r = rot.qmul(r, quat_params[..., j, :])
                gjoints[j] = rot.qrot(r, offsets[j]) + gjoints[chain[k - 1]]
        return torch.stack(gjoints, dim=-2)

    def forward_kinematics_cont6d(self, cont6d: torch.Tensor, root_pos: torch.Tensor,
                                  offsets, do_root_r: bool = True) -> torch.Tensor:
        """cont6d (..., J, 6), root_pos (..., 3), offsets (J, 3) -> (..., J, 3):
        a joint's position takes its own accumulated rotation (skeleton.py:177-198)."""
        offsets = self._like(offsets, cont6d)
        mats = rot.cont6d_to_matrix(cont6d)
        gjoints = [None] * self.njoints
        gjoints[0] = root_pos
        root_m = mats[..., 0, :, :]
        if not do_root_r:
            root_m = torch.eye(3, dtype=cont6d.dtype, device=cont6d.device).expand(root_m.shape)
        for chain in self.kinematic_chain:
            m = root_m
            for k in range(1, len(chain)):
                j = chain[k]
                m = m @ mats[..., j, :, :]
                gjoints[j] = (m @ offsets[j][..., None])[..., 0] + gjoints[chain[k - 1]]
        return torch.stack(gjoints, dim=-2)

    def forward_kinematics_real_cont6d(self, cont6d: torch.Tensor, root_pos: torch.Tensor,
                                       r_rot_quat: torch.Tensor, tgt_offsets) -> torch.Tensor:
        """FK of the posrot layouts: cont6d (..., J, 6) local rotations (the
        root's relative to the yaw frame), root_pos (..., 3), r_rot_quat
        (..., 4) the root's yaw, tgt_offsets (J, 3) metric offsets ->
        (..., J, 3) global joints (skeleton.py:200-222)."""
        offsets = self._like(tgt_offsets, cont6d)
        mats = rot.cont6d_to_matrix(cont6d)
        gr = [None] * self.njoints
        gp = [None] * self.njoints
        gr[0] = rot.quaternion_to_matrix(r_rot_quat) @ mats[..., 0, :, :]
        gp[0] = root_pos
        for i in range(1, self.njoints):
            p = self.parents[i]
            gp[i] = (gr[p] @ offsets[i, :, None])[..., 0] + gp[p]
            gr[i] = gr[p] @ mats[..., i, :, :]
        return torch.stack(gp, dim=-2)

    def inverse_kinematics_np(self, joints: np.ndarray, face_joint_idx,
                              smooth_forward: bool = False) -> np.ndarray:
        """Global joints (T, J, 3) -> local quaternions (T, J, 4), float64.

        face_joint_idx = (r_hip, l_hip, sdr_r, sdr_l). The root takes the
        yaw-only rotation of Z+ onto the body's forward direction; each chain
        joint the rotation of its raw offset onto the observed bone."""
        r_hip, l_hip, sdr_r, sdr_l = face_joint_idx
        across = (joints[:, r_hip] - joints[:, l_hip]) + (joints[:, sdr_r] - joints[:, sdr_l])
        across = across / np.sqrt((across ** 2).sum(-1))[:, None]
        forward = np.cross(np.array([[0.0, 1.0, 0.0]]), across, axis=-1)
        if smooth_forward:
            import scipy.ndimage

            forward = scipy.ndimage.gaussian_filter1d(forward, 20, axis=0, mode="nearest")
        forward = forward / np.sqrt((forward ** 2).sum(-1))[..., None]

        target = np.tile(np.array([[0.0, 0.0, 1.0]]), (len(forward), 1))
        root_quat = on_host(rot.qbetween, target, forward)
        root_quat[0] = np.array([1.0, 0.0, 0.0, 0.0])

        ident = np.array([1.0, 0.0, 0.0, 0.0])
        quat_params = np.zeros(joints.shape[:-1] + (4,), dtype=np.float64)
        quat_params[:, 0] = root_quat
        for chain in self.kinematic_chain:
            R = root_quat
            for j in range(len(chain) - 1):
                u = np.tile(self.raw_offsets[chain[j + 1]][None],
                            (len(joints), 1)).astype(np.float64)
                v = joints[:, chain[j + 1]] - joints[:, chain[j]]
                vlen = np.sqrt((v ** 2).sum(-1))[:, None]
                degenerate = (vlen < 1e-8) | (np.abs(u).sum(-1, keepdims=True) < 1e-8)
                v = v / np.maximum(vlen, 1e-8)
                rot_u_v = on_host(rot.qbetween, u, v)
                rot_u_v = np.where(degenerate,
                                   on_host(rot.qmul, R, np.broadcast_to(ident, rot_u_v.shape)),
                                   rot_u_v)
                r_loc = on_host(rot.qmul, rot.qinv_np(R), rot_u_v)
                quat_params[:, chain[j + 1]] = r_loc
                R = on_host(rot.qmul, R, r_loc)
        return quat_params
