"""SMPLify-3D: optimizer-based fitting of SMPL pose and shape to 3D joints,
on the device of the joints (the port's counterpart of
motionstyle/post/smplify.py).

Parity: visualize/joints2smpl/src/{smplify,customloss,prior}.py and the
joints2smpl wrapper (visualize/simplify_loc2rot.py:63-114):
  - MaxMixturePrior (GMM-08 over the 69-d body pose; the min-component
    weighted NLL, prior.py:101-215), loaded from the reference's gmm_08.pkl
    asset or built synthetically;
  - the angle prior on knees and elbows (customloss.py:15-21), the shape
    prior, the Geman-McClure joint error and the pose-preserve term
    (body_fitting_loss_3d :128-192);
  - the two-stage fit: camera translation + global orientation for 20
    steps, then the full body for num_iters (smplify.py:155-230), each stage
    torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8), optax.adam's update,
    which the JAX package runs in a jitted fori_loop. Every frame of a clip
    is one row of the batch; the betas are fitted on the first clip of a
    sequence only (seq_ind == 0).

The losses read only the SMPL joints, so the Adam steps run the joints-only
LBS (models/smpl.py::lbs(skin=False)); the vertices are skinned once, after
the fit. The collision term (mesh_intersection BVH) is not ported: it needs
a CUDA BVH library and the reference disables it by default
(use_collision=False). Keep TF32 off on a card: the transform chain
multiplies 4x4 matrices 23 deep.
"""
from __future__ import annotations

import os
import pickle
from typing import NamedTuple, Optional

import numpy as np
import torch

from motionstyle_torch.core import rotations as rot
from motionstyle_torch.models.smpl import SMPL, lbs
from motionstyle_torch.post.ik import _adam, gmof

# joints2smpl/src/config.py
JOINT_MAP = {
    "MidHip": 0, "LHip": 1, "LKnee": 4, "LAnkle": 7, "LFoot": 10, "RHip": 2,
    "RKnee": 5, "RAnkle": 8, "RFoot": 11, "LShoulder": 16, "LElbow": 18,
    "LWrist": 20, "LHand": 22, "RShoulder": 17, "RElbow": 19, "RWrist": 21,
    "RHand": 23, "spine1": 3, "spine2": 6, "spine3": 9, "Neck": 12, "Head": 15,
    "LCollar": 13, "Rcollar": 14,
}
AMASS_IDX = list(range(22))
GMM_MODEL_DIR = os.environ.get("GMM_MODEL_DIR", "./visualize/joints2smpl/smpl_models/")
CAMERA_ITERS = 20  # stage 1's Adam steps (smplify.py:155-180)


def angle_prior(body_pose: torch.Tensor) -> torch.Tensor:
    """Penalise unnatural knee and elbow bending; parity customloss.py:15-21.
    body_pose: (B, 69) axis-angle without the global orientation."""
    sel = body_pose[:, [55 - 3, 58 - 3, 12 - 3, 15 - 3]]
    sign = body_pose.new_tensor([1.0, -1.0, -1.0, -1.0])
    return torch.exp(sel * sign) ** 2


class MaxMixturePrior:
    """GMM max-mixture pose prior (the min over components of the weighted
    NLL). The arrays are numpy; each device gets its copy once."""

    def __init__(self, means: np.ndarray, precisions: np.ndarray, nll_weights: np.ndarray):
        self.means = means  # (K, 69)
        self.precisions = precisions  # (K, 69, 69)
        self.nll_weights = nll_weights  # (K,)
        self._on_device: dict = {}

    @classmethod
    def load(cls, prior_folder: str = GMM_MODEL_DIR, num_gaussians: int = 8
             ) -> "MaxMixturePrior":
        path = os.path.join(prior_folder, f"gmm_{num_gaussians:02d}.pkl")
        with open(path, "rb") as f:
            gmm = pickle.load(f, encoding="latin1")
        return cls.from_arrays(gmm["means"].astype(np.float32),
                               gmm["covars"].astype(np.float32),
                               gmm["weights"].astype(np.float32))

    @classmethod
    def from_arrays(cls, means, covs, weights) -> "MaxMixturePrior":
        precisions = np.stack([np.linalg.inv(c) for c in covs]).astype(np.float32)
        sqrdets = np.array([np.sqrt(np.linalg.det(c.astype(np.float64))) for c in covs])
        const = (2 * np.pi) ** (means.shape[1] / 2.0)
        nll_weights = (weights / (const * (sqrdets / sqrdets.min()))).astype(np.float32)
        return cls(means.astype(np.float32), precisions, nll_weights)

    @classmethod
    def synthetic(cls, rng: np.random.RandomState, dim: int = 69, k: int = 4
                  ) -> "MaxMixturePrior":
        """The JAX package's synthetic prior: its draws, in its order."""
        means = rng.randn(k, dim).astype(np.float32) * 0.1
        covs = np.stack([np.eye(dim, dtype=np.float32) * (0.5 + rng.rand()) for _ in range(k)])
        weights = np.full(k, 1.0 / k, dtype=np.float32)
        return cls.from_arrays(means, covs, weights)

    def _arrays(self, like: torch.Tensor) -> tuple:
        key = (like.device, like.dtype)
        if key not in self._on_device:
            self._on_device[key] = tuple(
                torch.as_tensor(a, dtype=like.dtype, device=like.device)
                for a in (self.means, self.precisions, np.log(self.nll_weights)))
        return self._on_device[key]

    def __call__(self, body_pose: torch.Tensor, betas=None) -> torch.Tensor:
        """The merged min-component NLL; parity prior.py:180-196."""
        means, precisions, log_w = self._arrays(body_pose)
        diff = body_pose[:, None, :] - means[None]
        prod = torch.einsum("mij,bmj->bmi", precisions, diff)
        quad = (prod * diff).sum(-1)
        return (0.5 * quad - log_w[None]).min(dim=1).values


def camera_fitting_loss_3d(model_joints, camera_t, camera_t_est, j3d, joints_idx,
                           depth_loss_weight: float = 100.0) -> torch.Tensor:
    """Torso alignment + depth anchor; parity customloss.py:196-226."""
    err = gmof((model_joints[:, joints_idx] + camera_t[:, None]) - j3d[:, joints_idx],
               sigma=100).sum(dim=(1, 2))
    # the reference broadcasts the (B, 1, 3) depth term against the (B, 4, 3)
    # joint error before summing (customloss.py:219-226), so the depth anchor
    # counts once per torso joint
    depth = (depth_loss_weight ** 2) * ((camera_t - camera_t_est) ** 2).sum(-1)
    return (err + len(joints_idx) * depth).sum()


def body_fitting_loss_3d(body_pose, preserve_pose, betas, model_joints, camera_translation,
                         j3d, pose_prior: MaxMixturePrior, joints3d_conf, sigma=100.0,
                         pose_prior_weight=4.78 * 1.5, shape_prior_weight=5.0,
                         angle_prior_weight=15.2, joint_loss_weight=500.0,
                         pose_preserve_weight=0.0) -> torch.Tensor:
    """parity customloss.py:128-192 (the collision term omitted, off by default)."""
    err = gmof((model_joints + camera_translation[:, None]) - j3d, sigma)
    joint3d = (joints3d_conf ** 2) * err.sum(-1)
    joint3d_loss = ((joint_loss_weight ** 2) * joint3d).sum(-1)
    pose_prior_loss = (pose_prior_weight ** 2) * pose_prior(body_pose, betas)
    angle_loss = (angle_prior_weight ** 2) * angle_prior(body_pose).sum(-1)
    shape_loss = (shape_prior_weight ** 2) * (betas ** 2).sum(-1)
    preserve = (pose_preserve_weight ** 2) * ((body_pose - preserve_pose) ** 2).sum(-1)
    return (joint3d_loss + pose_prior_loss + angle_loss + shape_loss + preserve).sum()


class SMPLifyResult(NamedTuple):
    vertices: torch.Tensor
    joints: torch.Tensor
    pose: torch.Tensor  # (B, 72) axis-angle, the global orientation first
    betas: torch.Tensor
    camera_translation: torch.Tensor
    joint_loss: torch.Tensor


class SMPLify3D:
    """Two-stage SMPL fitting to 3D joints with Adam, on the joints' device."""

    def __init__(self, smpl: SMPL, pose_prior: Optional[MaxMixturePrior] = None,
                 step_size: float = 1e-2, num_iters: int = 100,
                 joints_category: str = "AMASS"):
        self.smpl = smpl
        self.num_iters = num_iters
        self.step_size = step_size
        if pose_prior is None:
            try:
                pose_prior = MaxMixturePrior.load()
            except (FileNotFoundError, OSError):
                print("WARNING: GMM prior asset not found; using a weak synthetic prior")
                pose_prior = MaxMixturePrior.synthetic(np.random.RandomState(0))
        self.pose_prior = pose_prior
        n = 22 if joints_category == "AMASS" else 24
        self.smpl_index = self.corr_index = list(range(n))
        self._torso_smpl = [JOINT_MAP[j] for j in ("RHip", "LHip", "RShoulder", "LShoulder")]

    def _joints_of(self, pose_aa: torch.Tensor, betas: torch.Tensor, skin: bool = False):
        """(vertices or None, the 24 SMPL joints) of an axis-angle pose."""
        mats = rot.axis_angle_to_matrix(pose_aa.reshape(-1, 24, 3))
        return lbs(self.smpl.model, betas, mats, skin=skin)

    def __call__(self, init_pose: torch.Tensor, init_betas: torch.Tensor,
                 init_cam_t: torch.Tensor, j3d: torch.Tensor, conf_3d=1.0, seq_ind: int = 0,
                 num_iters: Optional[int] = None) -> SMPLifyResult:
        """init_pose (B, 72) axis-angle, init_betas (B, 10), j3d (B, J, 3)
        float32 (or float64: the fit runs in j3d's dtype); num_iters
        overrides the constructor's stage-2 step count. The camera starts
        from the torso offset (guess_init_3d, smplify.py:18): like the JAX
        fit, init_cam_t is not read."""
        dev, dtype = j3d.device, j3d.dtype  # float32, or float64 where asked
        conf = torch.as_tensor(conf_3d, dtype=dtype, device=dev) * torch.ones(
            len(self.corr_index), dtype=dtype, device=dev)
        fit_betas = seq_ind == 0
        iters = self.num_iters if num_iters is None else int(num_iters)
        init_pose = torch.as_tensor(init_pose, dtype=dtype, device=dev)
        betas = torch.as_tensor(init_betas, dtype=dtype, device=dev)
        preserve_pose = init_pose[:, 3:]
        torso, smpl_sel, corr_sel = self._torso_smpl, self.smpl_index, self.corr_index

        with torch.no_grad():
            _, joints0 = self._joints_of(init_pose, betas)
        init_cam = (j3d[:, torso] - joints0[:, torso]).mean(dim=1)

        # ---- stage 1: camera translation + global orientation ----
        orient = init_pose[:, :3].clone().requires_grad_(True)
        cam = init_cam.clone().requires_grad_(True)
        body_pose = init_pose[:, 3:]

        def cam_loss():
            _, joints = self._joints_of(torch.cat([orient, body_pose], dim=-1), betas)
            return camera_fitting_loss_3d(joints, cam, init_cam, j3d, torso)

        _adam([orient, cam], cam_loss, CAMERA_ITERS, self.step_size)

        # ---- stage 2: the full body (+ the betas on a sequence's first clip) ----
        body = body_pose.clone().requires_grad_(True)
        leaves = [body, orient, cam]
        if fit_betas:
            betas = betas.clone().requires_grad_(True)
            leaves.append(betas)

        def body_loss():
            _, joints = self._joints_of(torch.cat([orient, body], dim=-1), betas)
            return body_fitting_loss_3d(
                body, preserve_pose, betas, joints[:, smpl_sel], cam, j3d[:, corr_sel],
                self.pose_prior, conf, joint_loss_weight=600.0, pose_preserve_weight=5.0)

        _adam(leaves, body_loss, iters, self.step_size)

        with torch.no_grad():
            pose = torch.cat([orient, body], dim=-1)
            betas, cam = betas.detach(), cam.detach()
            verts, joints = self._joints_of(pose, betas, skin=True)
            joint_loss = gmof((joints[:, smpl_sel] + cam[:, None]) - j3d[:, corr_sel],
                              100).sum()
        return SMPLifyResult(verts, joints, pose, betas, cam, joint_loss)


class Joints2SMPL:
    """joints (T, 22, 3) -> the (1, 25, 6, T) rot6d pose tensor with its
    root row, fitted on `device` ('cuda' unless asked).

    Parity: visualize/simplify_loc2rot.py:63-114 (joint2smpl), with the
    fix_foot confidence boost and the init-params warm start."""

    def __init__(self, smpl: SMPL, num_smplify_iters: int = 150, fix_foot: bool = False,
                 mean_pose: Optional[np.ndarray] = None, mean_shape: Optional[np.ndarray] = None,
                 device="cuda"):
        self.smplify = SMPLify3D(smpl, num_iters=num_smplify_iters)
        self.fix_foot = fix_foot
        self.mean_pose = mean_pose if mean_pose is not None else np.zeros(72, np.float32)
        self.mean_shape = mean_shape if mean_shape is not None else np.zeros(10, np.float32)
        self.device = torch.device(device)

    def joint2smpl(self, input_joints: np.ndarray, init_params: Optional[dict] = None,
                   num_iters: Optional[int] = None):
        """Returns (the (1, 25, 6, T) numpy pose tensor, the next clip's warm
        start {pose, betas, cam} as numpy)."""
        B = input_joints.shape[0]
        def as_t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        j3d = as_t(input_joints)
        if init_params is None:
            pred_pose = as_t(np.tile(self.mean_pose[None], (B, 1)))
            pred_betas = as_t(np.tile(self.mean_shape[None], (B, 1)))
            pred_cam = torch.zeros((B, 3), device=self.device)
        else:
            pred_pose, pred_betas, pred_cam = (as_t(init_params[k])
                                               for k in ("pose", "betas", "cam"))
        conf = np.ones(22, dtype=np.float32)
        if self.fix_foot:
            conf[[7, 8, 10, 11]] = 1.5
        res = self.smplify(pred_pose, pred_betas, pred_cam, j3d, conf_3d=as_t(conf),
                           num_iters=num_iters)
        thetas = rot.matrix_to_rotation_6d(rot.axis_angle_to_matrix(res.pose.reshape(B, 24, 3)))
        root_loc = j3d[:, 0]
        root_row = torch.cat([root_loc, torch.zeros_like(root_loc)], dim=-1)[:, None]
        out = torch.cat([thetas, root_row], dim=1)[None].permute(0, 2, 3, 1)  # (1, 25, 6, T)
        next_init = {"pose": res.pose.cpu().numpy(), "betas": res.betas.cpu().numpy(),
                     "cam": res.camera_translation.cpu().numpy()}
        return out.cpu().numpy(), next_init
