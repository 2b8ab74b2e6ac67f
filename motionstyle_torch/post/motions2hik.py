"""Model output -> HumanIK JSON for Maya rigs (joint Euler angles);
the port's counterpart of motionstyle/post/motions2hik.py.

Parity: visualize/motions2hik.py: the SMPL joint index -> HIK name map,
SMPLify per repetition when the payload is xyz joints (on the fitter's
device), 6D -> intrinsic-XYZ Euler degrees (on the host, in float32).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from motionstyle_torch.core import rotations as rot
from motionstyle_torch.post.smplify import Joints2SMPL

HIK_JOINT_MAP = [
    "Hips", "LeftUpLeg", "RightUpLeg", "Spine", "LeftLeg", "RightLeg", "Spine1",
    "LeftFoot", "RightFoot", "Spine2", "LeftToeBase", "RightToeBase", "Neck",
    "LeftShoulder", "RightShoulder", "Head", "LeftArm", "RightArm",
    "LeftForeArm", "RightForeArm", "LeftHand", "RightHand",
]


def rotation_6d_to_euler_deg(d6: np.ndarray) -> np.ndarray:
    """Row-convention 6D -> intrinsic XYZ Euler angles in degrees."""
    m = rot.rotation_6d_to_matrix(torch.as_tensor(np.asarray(d6), dtype=torch.float32))
    eul = rot.quaternion_to_euler(rot.matrix_to_quaternion(m), "xyz")
    return np.degrees(eul.numpy())


def motions2hik(motions: np.ndarray, j2s: Optional[Joints2SMPL] = None) -> dict:
    """motions (num_reps, num_joints, 3 | 6, num_frames) -> the HIK JSON dict."""
    nreps, _, nfeats, nframes = motions.shape
    thetas, root_translation = [], []
    for rep_idx in range(nreps):
        rep = motions[rep_idx].transpose(2, 0, 1)  # (T, J, F)
        if nfeats == 3:
            if j2s is None:
                raise ValueError("xyz payload needs a Joints2SMPL fitter")
            motion, _ = j2s.joint2smpl(rep)  # (1, 25, 6, T)
        else:
            motion = rep.transpose(1, 2, 0)[None]
        thetas_6d = motion[0, :-1, :, :nframes].transpose(2, 0, 1)  # (T, J, 6)
        thetas.append([rotation_6d_to_euler_deg(thetas_6d)])
        root_translation.append([motion[0, -1, :3, :nframes].T])
    return {
        "joint_map": HIK_JOINT_MAP,
        "thetas": np.concatenate(thetas, axis=0).tolist(),
        "root_translation": np.concatenate(root_translation, axis=0).tolist(),
    }
