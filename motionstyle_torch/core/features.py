"""The hml_vec feature codec in PyTorch (the port's own copy of
motionstyle/core/features.py).

Decoders run on the device of their input: integrate the root's yaw and xz
velocities into a global root pose, then place the root-relative joint
positions (ric) around it, or run FK over the joint rotations
(recover_from_rot for the humanml layout, recover_from_real_rot for the
posrot ones). fp32 throughout, never bf16: the shift-by-one cumulative sums
integrate velocities over the whole clip. The rotation direction is the
reference's "revised by HL" one (motion_process.py:389-461): the velocity at
frame t and the local positions are rotated *by* that frame's yaw
quaternion, not its inverse.

Encoders (process_file, process_file_with_rotation, uniform_skeleton) are
host numpy in and out, with the JAX package's dtypes: its jnp calls on host
arrays compute in float32 (core/skeleton.py::on_host), the numpy arithmetic
around them stays float64.
"""
from __future__ import annotations

import numpy as np
import torch

from motionstyle_torch.core import rotations as rot
from motionstyle_torch.core.skeleton import Skeleton, on_host
from motionstyle_torch.data.masks import FeatureLayout


def recover_root_rot_pos(data: torch.Tensor) -> tuple:
    """hml_vec (..., T, D) -> (root yaw quaternion (..., T, 4), root position
    (..., T, 3)): angle[t] and xz[t] sum the velocities of frames < t."""
    data = data.float()
    rot_vel = data[..., 0]
    r_rot_ang = torch.cumsum(
        torch.cat([torch.zeros_like(rot_vel[..., :1]), rot_vel[..., :-1]], dim=-1), dim=-1)
    zeros = torch.zeros_like(r_rot_ang)
    r_rot_quat = torch.stack([torch.cos(r_rot_ang), zeros, torch.sin(r_rot_ang), zeros], dim=-1)

    vel_xz = data[..., 1:3]
    vel_xz = torch.cat([torch.zeros_like(vel_xz[..., :1, :]), vel_xz[..., :-1, :]], dim=-2)
    r_pos = torch.stack([vel_xz[..., 0], torch.zeros_like(vel_xz[..., 0]), vel_xz[..., 1]],
                        dim=-1)
    r_pos = torch.cumsum(rot.qrot(r_rot_quat, r_pos), dim=-2)
    r_pos = torch.cat([r_pos[..., :1], data[..., 3:4], r_pos[..., 2:]], dim=-1)
    return r_rot_quat, r_pos


def recover_from_ric(data: torch.Tensor, joints_num: int) -> torch.Tensor:
    """hml_vec (..., T, D) -> global joint positions (..., T, J, 3)."""
    data = data.float()
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    positions = data[..., 4:(joints_num - 1) * 3 + 4]
    positions = positions.reshape(positions.shape[:-1] + (joints_num - 1, 3))
    positions = rot.qrot(r_rot_quat[..., None, :], positions)
    offset = torch.stack([r_pos[..., 0], torch.zeros_like(r_pos[..., 0]), r_pos[..., 2]],
                         dim=-1)
    positions = positions + offset[..., None, :]
    return torch.cat([r_pos[..., None, :], positions], dim=-2)


def recover_from_rot(data: torch.Tensor, skeleton: Skeleton, offsets) -> torch.Tensor:
    """Decode the humanml layout (rotations without the root) through the
    joint rotations and chain FK (motion_process.py:413-427):
    (..., T, D) -> (..., T, J, 3); offsets (J, 3)."""
    data = data.float()
    joints_num = skeleton.njoints
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    start = 4 + (joints_num - 1) * 3
    cont6d = torch.cat([rot.quaternion_to_cont6d(r_rot_quat),
                        data[..., start:start + (joints_num - 1) * 6]], dim=-1)
    cont6d = cont6d.reshape(cont6d.shape[:-1] + (joints_num, 6))
    return skeleton.forward_kinematics_cont6d(cont6d, r_pos, offsets)


def recover_from_real_rot(data: torch.Tensor, skeleton: Skeleton, offsets) -> torch.Tensor:
    """Decode a posrot layout through its real rotations and the
    parent-array FK (bvh_utils.py:1337-1345)."""
    data = data.float()
    joints_num = skeleton.njoints
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    cont6d = data[..., 4 + (joints_num - 1) * 3:]
    cont6d = cont6d.reshape(cont6d.shape[:-1] + (joints_num, 6))
    return skeleton.forward_kinematics_real_cont6d(cont6d, r_pos, r_rot_quat, offsets)


def split_hmlvec(data, layout: FeatureLayout) -> dict:
    """An hml_vec's named channel groups."""
    out = {"root": data[..., :4], "ric": data[..., layout.ric_slice],
           "rot6d": data[..., layout.rot_slice]}
    if layout.has_vel_fc:
        start = layout.rot_slice.stop
        out["local_vel"] = data[..., start:start + 3 * layout.njoints]
        out["foot_contact"] = data[..., start + 3 * layout.njoints:]
    return out


def _foot_detect(positions: np.ndarray, fid_l, fid_r, thres: float):
    """Squared-velocity foot contacts (motion_process.py:256-272)."""
    velfactor = np.array([thres, thres])

    def _feet(fid):
        d = positions[1:, fid] - positions[:-1, fid]
        return ((d ** 2).sum(-1) < velfactor).astype(np.float32)

    return _feet(fid_l), _feet(fid_r)


def _canonicalize(positions: np.ndarray, face_joint_idx):
    """Floor snap, origin shift and the turn that faces Z+: returns
    (positions, root_quat_init), the latter rotating the first frame's
    forward direction onto Z+ (motion_process.py:204-241,
    bvh_utils.py:1100-1139)."""
    positions = np.array(positions, copy=True)
    floor_height = positions.min(axis=0).min(axis=0)[1]
    positions[:, :, 1] -= floor_height
    root_pos_init = positions[0]
    positions = positions - root_pos_init[0] * np.array([1.0, 0.0, 1.0])

    r_hip, l_hip, sdr_r, sdr_l = face_joint_idx
    across = (root_pos_init[r_hip] - root_pos_init[l_hip]) + (
        root_pos_init[sdr_r] - root_pos_init[sdr_l])
    across = across / np.sqrt((across ** 2).sum())
    forward = np.cross(np.array([0.0, 1.0, 0.0]), across)
    forward = forward / np.sqrt((forward ** 2).sum())
    target = np.array([0.0, 0.0, 1.0])
    root_quat_init = on_host(rot.qbetween, forward[None], target[None])[0]
    q = np.broadcast_to(root_quat_init, positions.shape[:-1] + (4,))
    return on_host(rot.qrot, q, positions), root_quat_init


def _local_positions(positions: np.ndarray, r_rot: np.ndarray) -> np.ndarray:
    """RIFKE: positions relative to the root's xz, turned by the inverse yaw."""
    local_pos = positions.copy()
    local_pos[..., 0] -= local_pos[:, 0:1, 0]
    local_pos[..., 2] -= local_pos[:, 0:1, 2]
    inv = np.repeat(rot.qinv_np(r_rot)[:, None], local_pos.shape[1], axis=1)
    return on_host(rot.qrot, inv, local_pos)


def process_file(positions: np.ndarray, feet_thre: float, skeleton: Skeleton,
                 face_joint_idx, fid_l, fid_r) -> tuple:
    """positions (T, J, 3) -> humanml-style features (T-1, dim), and the
    canonical global positions, the local positions and the root's xz
    velocity: canonicalize, detect contacts, IK to cont6d, RIFKE
    (motion_process.py:196-378, without the uniform_skeleton retarget)."""
    positions, _ = _canonicalize(positions, face_joint_idx)
    global_positions = positions.copy()
    feet_l, feet_r = _foot_detect(positions, fid_l, fid_r, feet_thre)

    quat_params = skeleton.inverse_kinematics_np(positions, face_joint_idx, smooth_forward=True)
    cont6d_params = on_host(rot.quaternion_to_cont6d, quat_params)
    r_rot = quat_params[:, 0].copy()
    velocity = on_host(rot.qrot, r_rot[1:], positions[1:, 0] - positions[:-1, 0])
    r_velocity = on_host(rot.qmul, r_rot[1:], rot.qinv_np(r_rot[:-1]))
    local_pos = _local_positions(positions, r_rot)

    root_y = local_pos[:, 0, 1:2]
    r_velocity_y = np.arcsin(r_velocity[:, 2:3])
    l_velocity = velocity[:, [0, 2]]
    root_data = np.concatenate([r_velocity_y, l_velocity, root_y[:-1]], axis=-1)
    rot_data = cont6d_params[:, 1:].reshape(len(cont6d_params), -1)
    ric_data = local_pos[:, 1:].reshape(len(local_pos), -1)
    inv = np.repeat(rot.qinv_np(r_rot)[:-1, None], global_positions.shape[1], axis=1)
    local_vel = on_host(rot.qrot, inv, global_positions[1:] - global_positions[:-1]
                        ).reshape(len(positions) - 1, -1)

    data = np.concatenate(
        [root_data, ric_data[:-1], rot_data[:-1], local_vel, feet_l, feet_r], axis=-1)
    return data, global_positions, local_pos, l_velocity


def process_file_with_rotation(positions: np.ndarray, rotations: np.ndarray,
                               skeleton: Skeleton, face_joint_idx, fid_l, fid_r,
                               feet_thre: float) -> tuple:
    """positions (T, J, 3) and real local rotations (T, J, 4) -> posrot
    features (T-1, dim): the rot6d block holds the given rotations, the
    root's turned into the yaw frame (bvh_utils.py:1091-1287)."""
    rotations = np.array(rotations, copy=True)
    positions, root_quat_init = _canonicalize(positions, face_joint_idx)
    q0 = np.broadcast_to(root_quat_init, rotations[:, 0].shape)
    rotations[:, 0] = on_host(rot.qmul, q0, rotations[:, 0])

    global_positions = positions.copy()
    feet_l, feet_r = _foot_detect(positions, fid_l, fid_r, feet_thre)

    quat_params = skeleton.inverse_kinematics_np(positions, face_joint_idx, smooth_forward=True)
    quat_params = quat_params.astype(np.float32)
    r_rot = quat_params[:, 0].copy()
    velocity = on_host(rot.qrot, rot.qinv_np(r_rot[1:]), positions[1:, 0] - positions[:-1, 0])
    r_velocity = on_host(rot.qmul, r_rot[1:], rot.qinv_np(r_rot[:-1]))
    local_pos = _local_positions(positions, r_rot)
    rotations[:, 0, :] = on_host(rot.qmul, rot.qinv_np(r_rot), rotations[:, 0, :])

    root_y = local_pos[:, 0, 1:2]
    r_velocity_y = np.arcsin(r_velocity[:, 2:3])
    l_velocity = velocity[:, [0, 2]]
    root_data = np.concatenate([r_velocity_y, l_velocity, root_y[:-1]], axis=-1)
    rot_data = on_host(rot.quaternion_to_cont6d, rotations).reshape(len(rotations), -1)
    ric_data = local_pos[:, 1:].reshape(len(local_pos), -1)

    data = np.concatenate([root_data, ric_data[:-1], rot_data[:-1]], axis=-1)
    return data, global_positions, local_pos, l_velocity


def uniform_skeleton(positions: np.ndarray, skeleton: Skeleton, target_offsets: np.ndarray,
                     l_idx: tuple, face_joint_idx) -> np.ndarray:
    """Retarget a motion onto the canonical skeleton: scale by leg length,
    then an IK/FK round trip (motion_process.py:38-61); float32 out."""
    src_offsets = skeleton.offsets_from_joints(positions[0])
    src_leg_len = np.abs(src_offsets[l_idx[0]]).max() + np.abs(src_offsets[l_idx[1]]).max()
    tgt_leg_len = np.abs(target_offsets[l_idx[0]]).max() + np.abs(target_offsets[l_idx[1]]).max()
    tgt_root_pos = positions[:, 0] * (tgt_leg_len / src_leg_len)
    quat_params = skeleton.inverse_kinematics_np(positions, face_joint_idx)
    return on_host(skeleton.forward_kinematics_quat, quat_params, tgt_root_pos, target_offsets)
