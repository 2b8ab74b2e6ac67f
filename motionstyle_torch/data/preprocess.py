"""AMASS / HybrIK preprocessing: SMPL parameter sequences -> XYZ joints ->
hml_vec features.

Counterpart of motionstyle/data/preprocess.py (parity:
utils/process_smpl_from_hybrik.py): fractional-rate pose downsampling by
slerp/lerp over an LCM upsample grid (downsample :56, joints_downsample :74),
amass_to_pose :89 (HybrIK .pt/.pk/.pkl payloads -> SMPL FK -> the axis flip
into the Y-up Z-forward frame, the first 22 joints), pos2hmlrep :183 (the
uniform skeleton retarget + process_file into the 263-d layout).

The reference's per-frame body-model loop is one batched SMPL LBS call
(models/smpl.py) on the run's device: the card unless the caller asks for
the CPU, as the JAX package runs its jnp calls on its default backend. The
slerp of the downsampling and the payload conversions stay small float32
work on the CPU.
"""
from __future__ import annotations

from fractions import Fraction
from math import lcm
from typing import Optional

import numpy as np
import torch

from motionstyle_torch.cli.model_util import resolve_device
from motionstyle_torch.core import params as skel_params
from motionstyle_torch.core import rotations as rot
from motionstyle_torch.core.features import process_file, uniform_skeleton
from motionstyle_torch.core.skeleton import Skeleton, on_host
from motionstyle_torch.models.smpl import SMPL

# AMASS -> canonical axis permutation (x<->z swap), the active matrix of the
# reference (process_smpl_from_hybrik.py:48-50)
TRANS_MATRIX = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])


def _resample_grid(downsample_rate: float):
    frac = Fraction(downsample_rate).limit_denominator(1000)
    up = lcm(frac.numerator, frac.denominator) // frac.numerator
    down = lcm(frac.numerator, frac.denominator) // frac.denominator
    t = np.linspace(0, 1, up + 1)[:-1]
    return t, down


def downsample_quats(rotations: np.ndarray, positions: np.ndarray, rate: float):
    """(T, J, 4) quaternions + (T, 3) translations resampled by a fractional
    rate: slerp and lerp on the upsampled grid, then every `down`-th frame."""
    t, down = _resample_grid(rate)
    q0, q1 = rotations[:-1], rotations[1:]
    new_q = np.stack([on_host(lambda a, b: rot.qslerp(a, b, float(ti)), q0, q1) for ti in t])
    new_q = new_q.transpose(1, 0, 2, 3).reshape((-1,) + rotations.shape[1:])
    new_p = np.stack([positions[:-1] * (1 - ti) + positions[1:] * ti for ti in t])
    new_p = new_p.transpose(1, 0, 2).reshape((-1,) + positions.shape[1:])
    return new_q[::down], new_p[::down]


def downsample_joints(joints: np.ndarray, rate: float) -> np.ndarray:
    t, down = _resample_grid(rate)
    new_j = np.stack([joints[:-1] * (1 - ti) + joints[1:] * ti for ti in t])
    new_j = new_j.transpose(1, 0, 2, 3).reshape((-1,) + joints.shape[1:])
    return new_j[::down]


def smpl_params_to_pose(theta_quats: np.ndarray, transl: np.ndarray, betas: np.ndarray,
                        smpl: SMPL, fps: float = 25, ex_fps: float = 20,
                        with_trans: bool = False, device="cuda") -> np.ndarray:
    """SMPL pose quaternions (T, 24, 4) + translations (T, 3) -> joints
    (T, 22, 3) in the canonical Y-up frame at ex_fps (amass_to_pose :89-180),
    every frame in one LBS call on `device` (the card unless 'cpu' is asked
    for; raises without a card)."""
    device = resolve_device(device)
    theta_quats, transl = downsample_quats(theta_quats, transl, fps / ex_fps)
    mats = rot.quaternion_to_matrix(
        torch.as_tensor(theta_quats, dtype=torch.float32, device=device))
    b = torch.as_tensor(np.asarray(betas, np.float32).reshape(1, -1)[:, :smpl.num_betas],
                        device=device).expand(mats.shape[0], smpl.num_betas)
    out = smpl(body_pose=mats[:, 1:], global_orient=mats[:, 0], betas=b)
    joints = out["smpl"].cpu().numpy()  # (T, 24, 3)
    if with_trans:
        joints = joints + transl[:, None]
    joints = joints @ TRANS_MATRIX
    joints[..., 1] *= -1
    return joints[:, :22]


def load_hybrik(src_path: str):
    """A HybrIK result payload -> (theta_quats (T, 24, 4), betas, transl,
    joints or None)."""
    import pickle

    if src_path.endswith("pt"):
        bdata = torch.load(src_path, map_location="cpu", weights_only=False)[0]
        mats = bdata["pred_theta_mats"].reshape(-1, 24, 3, 3).numpy()
        betas = bdata["pred_shape"].mean(0).numpy()
        joints = bdata["pred_xyz_jts_24_struct"].reshape(-1, 24, 3).numpy()
        transl = bdata["transl"].numpy()
        quats = on_host(rot.matrix_to_quaternion, mats)
    elif src_path.endswith("pk"):
        with open(src_path, "rb") as f:
            bdata = pickle.load(f)
        mats = bdata["pred_thetas"].reshape(-1, 24, 3, 3)
        betas = bdata["pred_betas"].mean(0)
        joints = bdata["pred_xyz_24_struct"].reshape(-1, 24, 3)
        transl = bdata["transl"]
        quats = on_host(rot.matrix_to_quaternion, mats)
    else:  # .pkl (quaternion payload)
        with open(src_path, "rb") as f:
            bdata = pickle.load(f)[0]
        quats = bdata["smpl_pose_quat_wroot"]
        betas = bdata["smpl_beta"].mean(0)
        transl = bdata["root_trans"]
        joints = None
    return quats, betas, transl, joints


_T2M_SKELETON = Skeleton(skel_params.t2m_raw_offsets, skel_params.t2m_kinematic_chain)
_T2M_FACE_JOINTS = [2, 1, 17, 16]  # r_hip, l_hip, sdr_r, sdr_l


def pos2hmlrep(joints: np.ndarray, tgt_offsets: Optional[np.ndarray] = None) -> np.ndarray:
    """joints (T, 22, 3) -> humanml 263-d features; parity :183-192."""
    if tgt_offsets is None:
        tgt_offsets = skel_params.smpl_real_offsets
    joints = uniform_skeleton(joints, _T2M_SKELETON, tgt_offsets, l_idx=(5, 8),
                              face_joint_idx=_T2M_FACE_JOINTS)
    data, _, _, _ = process_file(joints.astype(np.float64), 0.002, _T2M_SKELETON,
                                 _T2M_FACE_JOINTS, fid_l=[7, 10], fid_r=[8, 11])
    return data.astype(np.float32)
