"""Pose representation -> SMPL joints or vertices.

Counterpart of motionstyle/models/rotation2xyz.py (parity:
model/rotation2xyz.py Rotation2xyz.__call__ :17-92): rot6d, quaternion,
axis-angle or matrix pose tensors (B, J (+ a translation row), F, T) become
SMPL joints or vertices with the reference's translation handling, every
frame of the batch in one LBS call on the pose's device.
"""
from __future__ import annotations

from typing import Optional

import torch

from motionstyle_torch.core import rotations as rot
from motionstyle_torch.models.smpl import JOINTSTYPE_ROOT, SMPL

JOINTSTYPES = ["a2m", "a2mpl", "smpl", "vibe", "vertices"]


class Rotation2xyz:
    def __init__(self, smpl_model: Optional[SMPL] = None, dataset: str = "amass"):
        self.dataset = dataset
        self.smpl_model = smpl_model if smpl_model is not None else SMPL()

    def __call__(self, x: torch.Tensor, mask: Optional[torch.Tensor], pose_rep: str,
                 translation: bool, glob: bool, jointstype: str, vertstrans: bool,
                 betas: Optional[torch.Tensor] = None, beta: float = 0.0, glob_rot=None,
                 **kwargs) -> torch.Tensor:
        """x (B, J (+1 translation row), F, T) -> (B, J_out, 3, T)."""
        if pose_rep == "xyz":
            return x
        if jointstype not in JOINTSTYPES:
            raise NotImplementedError("This jointstype is not implemented.")
        if not glob and glob_rot is None:
            raise TypeError("You must specify global rotation if glob is False")

        if translation:
            x_translations = x[:, -1, :3]  # (B, 3, T)
            x_rotations = x[:, :-1]
        else:
            x_rotations = x
        x_rotations = x_rotations.permute(0, 3, 1, 2)  # (B, T, J, F)
        B, T, J, Fe = x_rotations.shape
        flat = x_rotations.reshape(B * T, J, Fe)

        if pose_rep == "rotvec":
            rotations = rot.axis_angle_to_matrix(flat)
        elif pose_rep == "rotmat":
            rotations = flat.reshape(B * T, J, 3, 3)
        elif pose_rep == "rotquat":
            rotations = rot.quaternion_to_matrix(flat)
        elif pose_rep == "rot6d":
            rotations = rot.rotation_6d_to_matrix(flat)
        else:
            raise NotImplementedError("No geometry for this one.")

        if not glob:
            global_orient = rot.axis_angle_to_matrix(
                torch.as_tensor(glob_rot, dtype=x.dtype, device=x.device))
            global_orient = global_orient.expand(B * T, 3, 3)
        else:
            global_orient = rotations[:, 0]
            rotations = rotations[:, 1:]

        if betas is None:
            betas = rotations.new_zeros((rotations.shape[0], self.smpl_model.num_betas))
            betas[:, 1] = beta
        out = self.smpl_model(body_pose=rotations, global_orient=global_orient, betas=betas)
        joints = out[jointstype]  # (B*T, J_out, 3)
        x_xyz = joints.reshape(B, T, -1, 3).permute(0, 2, 3, 1)  # (B, J_out, 3, T)

        if jointstype != "vertices":
            root = JOINTSTYPE_ROOT[jointstype]
            x_xyz = x_xyz - x_xyz[:, root: root + 1]
        if translation and vertstrans:
            x_translations = x_translations - x_translations[:, :, 0:1]
            x_xyz = x_xyz + x_translations[:, None]
        if mask is not None:
            x_xyz = x_xyz * mask[:, None, None, :].to(x_xyz.dtype)
        return x_xyz
