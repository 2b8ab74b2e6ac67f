"""The hml_vec decoders of the demo path in PyTorch (the port's own copy of
motionstyle/core/features.py:81-120): integrate the root's yaw and xz
velocities into a global root pose, and place the root-relative joint
positions (ric) around it.

fp32 throughout, never bf16: the shift-by-one cumulative sums integrate
velocities over the whole clip. The rotation direction is the reference's
"revised by HL" one (motion_process.py:389-461): the velocity at frame t and
the local positions are rotated *by* that frame's yaw quaternion, not its
inverse.

Not on this slice: recover_from_rot and recover_from_real_rot (FK through
core/skeleton.py, ROADMAP §1 item 1) and the process_file encoders (item 10).
"""
from __future__ import annotations

import torch

from motionstyle_torch.core import rotations as rot


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
