"""BVH and OBJ export on top of SMPLify (the port's counterpart of
motionstyle/post/vis_utils.py).

Parity: visualize/vis_utils.py: joints2rotation :70 (the SMPLify fit),
joints2bvh :82 (Butterworth-smoothed neck and head channels, quaternions
from the fitted 6D pose, real offsets, a BVH file), npy2obj :10 (a
results.npy -> per-frame OBJ meshes from rotation2xyz's vertices).

As in the JAX package the row-convention 6D pose is converted with the row
convention throughout (the reference's cont6d2q at vis_utils.py:100
transposes its rotations). The fit and the vertices run on the device of the
Joints2SMPL fitter (or `device`); the filter and the files on the host.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from motionstyle_torch.core import rotations as rot
from motionstyle_torch.core.params import chains_to_parents
from motionstyle_torch.post.bvh import Anim, save_bvh
from motionstyle_torch.post.footskate import butterworth
from motionstyle_torch.post.smplify import Joints2SMPL


def joints2rotation(joints: np.ndarray, j2s: Joints2SMPL,
                    num_smplify_iters: int = 150) -> np.ndarray:
    """joints (T, J, 3), lifted to the floor -> the fitted (1, 25, 6, T)
    rot6d pose tensor."""
    joints = np.array(joints, copy=True)
    joints[:, :, 1] -= joints.min(axis=0).min(axis=0)[1]
    motion_tensor, _ = j2s.joint2smpl(joints, num_iters=num_smplify_iters)
    return motion_tensor


def joints2bvh(path: str, joints: np.ndarray, real_offset: np.ndarray, kinematic_chain,
               j2s: Joints2SMPL, names=None, num_smplify_iters: int = 150,
               butterworth_all: bool = False) -> None:
    """SMPLify-fit the joints, then write a BVH; parity vis_utils.py:82-116."""
    motion = joints2rotation(joints, j2s, num_smplify_iters)
    motion = np.array(motion[0].transpose(2, 0, 1))  # (T, 25, 6), writable

    joint_indices = range(motion.shape[1]) if butterworth_all else [12, 15]  # neck, head
    for joint in joint_indices:
        for j in range(motion.shape[-1]):
            motion[:, joint, j] = butterworth(motion[:, joint, j], 1 / 20, 1.8)

    n_joints = real_offset.shape[0]
    quats = rot.matrix_to_quaternion(rot.rotation_6d_to_matrix(
        torch.as_tensor(motion[:, :n_joints], dtype=torch.float32))).numpy()
    parents = np.asarray(chains_to_parents(kinematic_chain, n_joints))

    real_offset = real_offset.copy()
    real_offset[0] = 0.0
    pos = np.tile(real_offset[None], (quats.shape[0], 1, 1)).astype(np.float32)
    pos[:, 0, :] = motion[:, -1, :3]
    anim = Anim(quats, pos, real_offset, parents, list(names) if names else None)
    save_bvh(path, anim, 1 / 20)


class Npy2Obj:
    """A results.npy -> SMPL meshes, with per-frame OBJ export.

    Parity: vis_utils.py npy2obj :10-68 (SMPLify when the payload is xyz
    joints, the rot6d pose directly otherwise; vertices from rotation2xyz
    plus the root offset). The vertices are computed on j2s's device, or on
    `device` without a fitter ('cuda' unless asked)."""

    def __init__(self, npy_path: str, sample_idx: int, rep_idx: int, rot2xyz,
                 j2s: Optional[Joints2SMPL] = None, device="cuda"):
        self.motions = np.load(npy_path, allow_pickle=True)
        if npy_path.endswith(".npz"):
            self.motions = self.motions["arr_0"]
        self.motions = self.motions[None][0]
        self.rot2xyz = rot2xyz
        dev = j2s.device if j2s is not None else torch.device(device)
        _, _, nfeats, _ = self.motions["motion"].shape
        self.absl_idx = rep_idx * int(self.motions["num_samples"]) + sample_idx
        if nfeats == 3:
            if j2s is None:
                raise ValueError("xyz payload needs a Joints2SMPL fitter")
            motion_tensor, _ = j2s.joint2smpl(
                self.motions["motion"][self.absl_idx].transpose(2, 0, 1))
            self.motions["motion"] = motion_tensor
        else:
            self.motions["motion"] = self.motions["motion"][[self.absl_idx]]
        self.real_num_frames = int(np.asarray(self.motions["lengths"])[self.absl_idx])
        with torch.no_grad():
            self.vertices = rot2xyz(
                torch.as_tensor(self.motions["motion"], dtype=torch.float32, device=dev),
                mask=None, pose_rep="rot6d", translation=True, glob=True,
                jointstype="vertices", vertstrans=True).cpu().numpy()
        root_loc = self.motions["motion"][:, -1, :3, :].reshape(1, 1, 3, -1)
        self.vertices = self.vertices + root_loc

    def get_vertices(self, sample_i: int, frame_i: int) -> np.ndarray:
        return self.vertices[sample_i, :, :, frame_i]

    def save_obj(self, save_path: str, frame_i: int, faces: Optional[np.ndarray] = None) -> str:
        verts = self.get_vertices(0, frame_i)
        with open(save_path, "w") as fw:
            for v in verts:
                fw.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            if faces is not None:
                for f in faces:
                    fw.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")
        return save_path

    def save_npy(self, save_path: str) -> None:
        n = self.real_num_frames
        np.save(save_path, {
            "motion": self.motions["motion"][0, :, :, :n],
            "thetas": self.motions["motion"][0, :-1, :, :n],
            "root_translation": self.motions["motion"][0, -1, :3, :n],
            "vertices": self.vertices[0, :, :, :n],
            "text": self.motions["text"][0],
            "length": n,
        })
