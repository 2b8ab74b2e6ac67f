"""Optimizer-based inverse kinematics on the device (the port's own copy of
motionstyle/post/ik.py).

The reference fits its BVH output by Adam over (cont6d, root position, root
yaw quaternion) against target joints with a Geman-McClure loss
(data_loaders/humanml/common/Kinematics.py:30-91, used by fit_joints_bvh,
bvh_utils.py:1811). Here the leaves live on the device of the data and
torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8) takes a fixed number of
steps over the differentiable FK: the update of optax.adam, which the JAX
package runs in one jitted fori_loop. Each step is a chain of 3x3 products
per joint, forward and backward, so on the card the fit is bound by
launches. The products stay in fp32: nothing here enables TF32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from motionstyle_torch.core import rotations as rot
from motionstyle_torch.core.features import recover_root_rot_pos
from motionstyle_torch.core.skeleton import Skeleton
from motionstyle_torch.post.bvh import Anim, save_bvh


def gmof(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Geman-McClure robust error (Kinematics.py:57-63)."""
    x2 = x ** 2
    s2 = sigma ** 2
    return (s2 * x2) / (s2 + x2)


class IKResult(NamedTuple):
    cont6d: torch.Tensor  # (..., J, 6)
    r_pos: torch.Tensor  # (..., 3)
    r_rot_quat: torch.Tensor  # (..., 4)
    loss: torch.Tensor


def _adam(leaves: list, loss_fn, iters: int, lr: float) -> None:
    """iters Adam steps on the leaves (updated in place), optax.adam's update."""
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(iters):
        opt.zero_grad(set_to_none=True)
        loss_fn().backward()
        opt.step()


def fit_hmlvec_ik(data: torch.Tensor, skeleton: Skeleton, real_offsets,
                  target_joints: torch.Tensor, iters: int = 100, lr: float = 1e-3,
                  sigma: float = 100.0) -> IKResult:
    """Fit (cont6d, r_pos, r_rot_quat), started from an hml_vec (T, D) of a
    posrot layout, to target global joints (T, J, 3): Adam at lr with
    betas (0.9, 0.999) on gmof(FK - target, sigma).sum()
    (InverseKinematics_hmlvec) for `iters` steps, on data's device."""
    joints_num = skeleton.njoints
    data = data.float()
    offsets = torch.as_tensor(real_offsets, dtype=torch.float32, device=data.device)
    target = torch.as_tensor(target_joints, dtype=torch.float32, device=data.device)
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    cont6d = data[..., 4 + (joints_num - 1) * 3:].reshape(data.shape[:-1] + (joints_num, 6))
    leaves = [t.detach().clone().requires_grad_(True) for t in (cont6d, r_pos, r_rot_quat)]

    def loss_fn():
        glb = skeleton.forward_kinematics_real_cont6d(leaves[0], leaves[1], leaves[2], offsets)
        return gmof(glb - target, sigma).sum()

    _adam(leaves, loss_fn, iters, lr)
    with torch.no_grad():
        loss = loss_fn()
    return IKResult(*(t.detach() for t in leaves), loss)


def fit_quats_ik(quats: torch.Tensor, pos: torch.Tensor, parents,
                 target_joints: torch.Tensor, iters: int = 50, lr: float = 1e-3
                 ) -> torch.Tensor:
    """Optimize the cont6d of an animation's quaternions against target
    joints with Adam on the FK's mean squared error (InverseKinematics_quats,
    Kinematics.py:94-130). Returns the cont6d."""
    c6 = rot.quaternion_to_cont6d(quats).detach().clone().requires_grad_(True)

    def loss_fn():
        _, glb = rot.quat_fk(rot.cont6d_to_quaternion(c6), pos, parents)
        return ((glb - target_joints) ** 2).mean()

    _adam([c6], loss_fn, iters, lr)
    return c6.detach()


def fit_joints_bvh(path: str, initial_data: np.ndarray, skeleton: Skeleton,
                   real_offsets: np.ndarray, glb: np.ndarray, names=None,
                   iter_num: int = 100, frametime: float = 1 / 20,
                   device="cuda") -> IKResult:
    """IK-fit an hml_vec to (possibly foot-skate-cleaned) global joints on
    `device` and write the result as BVH (bvh_utils.py:1811-1846)."""
    res = fit_hmlvec_ik(torch.as_tensor(np.asarray(initial_data), dtype=torch.float32,
                                        device=device),
                        skeleton, real_offsets,
                        torch.as_tensor(np.asarray(glb), dtype=torch.float32, device=device),
                        iters=iter_num)
    r_rot_quat = rot.qnormalize(res.r_rot_quat)
    joint_quats = rot.cont6d_to_quaternion(res.cont6d)
    joint_quats[..., 0, :] = rot.qmul(r_rot_quat, joint_quats[..., 0, :])
    joint_quats = joint_quats.cpu().numpy()

    offsets = np.array(real_offsets, dtype=np.float32, copy=True)
    offsets[0] = 0.0
    pos = np.tile(offsets[None], (joint_quats.shape[0], 1, 1))
    pos[:, 0, :] = res.r_pos.cpu().numpy()
    anim = Anim(joint_quats, pos, offsets, np.asarray(skeleton.parents),
                list(names) if names else None)
    save_bvh(path, anim, frametime)
    return res
