"""SMPL body model: linear blend skinning in PyTorch.

Counterpart of motionstyle/models/smpl.py (parity: model/smpl.py's joint
maps and extra regressor, and smplx's SMPLLayer math: shape blendshapes,
pose blendshapes, joint regression, the rigid transform chain, LBS). The
model assets (SMPL_NEUTRAL.pkl, J_regressor_extra.npy) are external
downloads, as in the reference (body_models/smpl/): load_smpl_model reads
them when present, chumpy-pickled .pkl files included, and raises when they
are absent. Everything is testable on the synthetic `random_smpl_model`,
which draws the same numbers from the same np.random.RandomState as the JAX
package's.

The model's arrays are numpy; lbs and SMPL.__call__ run on the device of
the pose they are given (a batch of frames is one call). Keep TF32 off on a
card (torch.backends.cuda.matmul.allow_tf32): the transform chain multiplies
4x4 matrices 23 deep.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

SMPL_DATA_PATH = os.environ.get("SMPL_DATA_PATH", "./body_models/smpl")
SMPL_MODEL_PATH = os.path.join(SMPL_DATA_PATH, "SMPL_NEUTRAL.pkl")
JOINT_REGRESSOR_TRAIN_EXTRA = os.path.join(SMPL_DATA_PATH, "J_regressor_extra.npy")

# action2motion joint selection over the VIBE 49-joint set (model/smpl.py:13)
ACTION2MOTION_JOINTS = [8, 1, 2, 3, 4, 5, 6, 7, 0, 9, 10, 11, 12, 13, 14, 21, 24, 38]
JOINTSTYPE_ROOT = {"a2m": 0, "smpl": 0, "a2mpl": 0, "vibe": 8}
JOINT_MAP = {
    "OP Nose": 24, "OP Neck": 12, "OP RShoulder": 17, "OP RElbow": 19, "OP RWrist": 21,
    "OP LShoulder": 16, "OP LElbow": 18, "OP LWrist": 20, "OP MidHip": 0, "OP RHip": 2,
    "OP RKnee": 5, "OP RAnkle": 8, "OP LHip": 1, "OP LKnee": 4, "OP LAnkle": 7,
    "OP REye": 25, "OP LEye": 26, "OP REar": 27, "OP LEar": 28, "OP LBigToe": 29,
    "OP LSmallToe": 30, "OP LHeel": 31, "OP RBigToe": 32, "OP RSmallToe": 33,
    "OP RHeel": 34, "Right Ankle": 8, "Right Knee": 5, "Right Hip": 45, "Left Hip": 46,
    "Left Knee": 4, "Left Ankle": 7, "Right Wrist": 21, "Right Elbow": 19,
    "Right Shoulder": 17, "Left Shoulder": 16, "Left Elbow": 18, "Left Wrist": 20,
    "Neck (LSP)": 47, "Top of Head (LSP)": 48, "Pelvis (MPII)": 49, "Thorax (MPII)": 50,
    "Spine (H36M)": 51, "Jaw (H36M)": 52, "Head (H36M)": 53, "Nose": 24, "Left Eye": 26,
    "Right Eye": 25, "Left Ear": 28, "Right Ear": 27,
}
# smplx's surface joints picked from mesh vertices (the 'smplh' VERTEX_IDS
# table) in VertexJointSelector order, face, feet, hand tips: joints 24..44
# of the 45-joint output JOINT_MAP indexes
VERTEX_IDS = {
    "nose": 332, "reye": 6260, "leye": 2800, "rear": 4071, "lear": 583,
    "LBigToe": 3216, "LSmallToe": 3226, "LHeel": 3387,
    "RBigToe": 6617, "RSmallToe": 6624, "RHeel": 6787,
    "lthumb": 2746, "lindex": 2319, "lmiddle": 2445, "lring": 2556,
    "lpinky": 2673, "rthumb": 6191, "rindex": 5782, "rmiddle": 5905,
    "rring": 6016, "rpinky": 6133,
}

JOINT_NAMES = [
    "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist", "OP LShoulder",
    "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip", "OP RKnee", "OP RAnkle",
    "OP LHip", "OP LKnee", "OP LAnkle", "OP REye", "OP LEye", "OP REar", "OP LEar",
    "OP LBigToe", "OP LSmallToe", "OP LHeel", "OP RBigToe", "OP RSmallToe", "OP RHeel",
    "Right Ankle", "Right Knee", "Right Hip", "Left Hip", "Left Knee", "Left Ankle",
    "Right Wrist", "Right Elbow", "Right Shoulder", "Left Shoulder", "Left Elbow",
    "Left Wrist", "Neck (LSP)", "Top of Head (LSP)", "Pelvis (MPII)", "Thorax (MPII)",
    "Spine (H36M)", "Jaw (H36M)", "Head (H36M)", "Nose", "Left Eye", "Right Eye",
    "Left Ear", "Right Ear",
]


@dataclass(frozen=True)
class SMPLModel:
    """SMPL asset arrays (numpy, moved to the pose's device on use)."""

    v_template: np.ndarray  # (V, 3)
    shapedirs: np.ndarray  # (V, 3, n_betas)
    posedirs: np.ndarray  # (207, V*3)
    j_regressor: np.ndarray  # (24, V)
    lbs_weights: np.ndarray  # (V, 24)
    parents: np.ndarray  # (24,)
    j_regressor_extra: Optional[np.ndarray] = None  # (k, V)

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]


class _NumpyCoercingUnpickler(pickle.Unpickler):
    """Unpickle chumpy-era SMPL pkl files without chumpy installed."""

    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return lambda *a, **k: None
        if module in ("scipy.sparse.csc", "scipy.sparse._csc"):
            import scipy.sparse

            return getattr(scipy.sparse, name, scipy.sparse.csc_matrix)
        return super().find_class(module, name)


def _to_np(x):
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray())
    if hasattr(x, "r"):
        return np.asarray(x.r)
    return np.asarray(x)


def load_smpl_model(model_path: str = SMPL_MODEL_PATH,
                    extra_regressor_path: str = JOINT_REGRESSOR_TRAIN_EXTRA,
                    num_betas: int = 10) -> SMPLModel:
    """The SMPL assets (.pkl or .npz) as an SMPLModel; raises when the file
    is absent, as the JAX package does (no asset ships with the repository)."""
    if model_path.endswith(".npz"):
        d = dict(np.load(model_path, allow_pickle=True))
    else:
        with open(model_path, "rb") as f:
            d = _NumpyCoercingUnpickler(f, encoding="latin1").load()
    extra = None
    if extra_regressor_path and os.path.exists(extra_regressor_path):
        extra = np.load(extra_regressor_path).astype(np.float32)
    kintree = _to_np(d["kintree_table"]).astype(np.int64)
    parents = kintree[0].copy()
    parents[0] = -1
    return SMPLModel(
        v_template=_to_np(d["v_template"]).astype(np.float32),
        shapedirs=_to_np(d["shapedirs"])[..., :num_betas].astype(np.float32),
        posedirs=_to_np(d["posedirs"]).reshape(-1, 207).T.astype(np.float32),
        j_regressor=_to_np(d["J_regressor"]).astype(np.float32),
        lbs_weights=_to_np(d["weights"]).astype(np.float32),
        parents=parents,
        j_regressor_extra=extra,
    )


def random_smpl_model(rng: np.random.RandomState, n_verts: int = 64) -> SMPLModel:
    """Tiny synthetic SMPL-shaped model for tests (no asset needed): the JAX
    package's draws, in its order, from the same RandomState."""
    parents = np.array([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
                        19, 20, 21])
    w = np.abs(rng.rand(n_verts, 24))
    return SMPLModel(
        v_template=rng.randn(n_verts, 3).astype(np.float32) * 0.3,
        shapedirs=rng.randn(n_verts, 3, 10).astype(np.float32) * 0.01,
        posedirs=rng.randn(207, n_verts * 3).astype(np.float32) * 0.001,
        j_regressor=(np.abs(rng.rand(24, n_verts)) / n_verts).astype(np.float32),
        lbs_weights=(w / w.sum(-1, keepdims=True)).astype(np.float32),
        parents=parents,
        # 9 extra rows like the real J_regressor_extra.npy, so every joint map
        # (vibe reaches index 53 = 24 + 21 + 9) works on the synthetic model
        j_regressor_extra=(np.abs(rng.rand(9, n_verts)) / n_verts).astype(np.float32),
    )


def _on(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def lbs(model: SMPLModel, betas: torch.Tensor, pose_mats: torch.Tensor,
        transl: Optional[torch.Tensor] = None, skin: bool = True) -> tuple:
    """Linear blend skinning on pose_mats' device. betas (B, n_betas);
    pose_mats (B, 24, 3, 3), the global orientation at 0. Returns (vertices
    (B, V, 3), joints (B, 24, 3)); with skin=False (vertices None, joints):
    the joints alone, which do not depend on the pose blendshapes or the
    skinning (a fit's loss reads only them), their rest positions regressed
    from the template and the shape directions instead of from every
    vertex."""
    B = pose_mats.shape[0]
    parents = [int(p) for p in model.parents]
    betas = betas.to(pose_mats)

    # shape blendshapes and the rest joints
    j_reg, shapedirs = _on(model.j_regressor, pose_mats), _on(model.shapedirs, pose_mats)
    if skin:
        v_shaped = _on(model.v_template, pose_mats) + torch.einsum("bl,vcl->bvc", betas,
                                                                   shapedirs)
        j_rest = torch.einsum("jv,bvc->bjc", j_reg, v_shaped)
    else:  # J (v_template + S betas) = J v_template + (J S) betas: no (B, V, 3) array
        j_rest = (j_reg @ _on(model.v_template, pose_mats))[None] + torch.einsum(
            "bl,jcl->bjc", betas, torch.einsum("jv,vcl->jcl", j_reg, shapedirs))

    # the rigid transform chain
    rel_j = torch.cat([j_rest[:, :1], j_rest[:, 1:] - j_rest[:, parents[1:]]], dim=1)
    local = torch.zeros((B, 24, 4, 4), dtype=pose_mats.dtype, device=pose_mats.device)
    local[:, :, :3, :3] = pose_mats
    local[:, :, :3, 3] = rel_j
    local[:, :, 3, 3] = 1.0
    transforms = [local[:, 0]]
    for i in range(1, 24):
        transforms.append(transforms[parents[i]] @ local[:, i])
    A = torch.stack(transforms, dim=1)  # (B, 24, 4, 4)
    posed_joints = A[:, :, :3, 3]
    if not skin:
        return None, posed_joints if transl is None else posed_joints + transl[:, None]

    # pose blendshapes: the 23 body joints' rotations minus the identity
    ident = torch.eye(3, dtype=pose_mats.dtype, device=pose_mats.device)
    pose_feature = (pose_mats[:, 1:] - ident).reshape(B, -1)  # (B, 207)
    v_posed = v_shaped + (pose_feature @ _on(model.posedirs, pose_mats)).reshape(B, -1, 3)

    # remove the rest-pose joint location from each transform
    j_h = torch.cat([j_rest, j_rest.new_zeros((B, 24, 1))], dim=-1)
    corr = torch.einsum("bjmn,bjn->bjm", A, j_h)
    A_skin = A.clone()
    A_skin[:, :, :3, 3] = A[:, :, :3, 3] - corr[:, :, :3]

    W = torch.einsum("vj,bjmn->bvmn", _on(model.lbs_weights, pose_mats), A_skin)
    v_h = torch.cat([v_posed, v_posed.new_ones((B, v_posed.shape[1], 1))], dim=-1)
    verts = torch.einsum("bvmn,bvn->bvm", W, v_h)[..., :3]
    if transl is not None:
        verts = verts + transl[:, None]
        posed_joints = posed_joints + transl[:, None]
    return verts, posed_joints


class SMPL:
    """Joint-map wrapper; parity: model/smpl.py SMPL.forward :86-96."""

    def __init__(self, model: Optional[SMPLModel] = None, model_path: str = SMPL_MODEL_PATH):
        self.model = model if model is not None else load_smpl_model(model_path)
        vibe = np.array([JOINT_MAP[n] for n in JOINT_NAMES])
        self.maps = {
            "vibe": vibe,
            "a2m": vibe[ACTION2MOTION_JOINTS],
            "smpl": np.arange(24),
            "a2mpl": np.unique(np.r_[np.arange(24), vibe[ACTION2MOTION_JOINTS]]),
        }

    @property
    def num_betas(self) -> int:
        return self.model.num_betas

    def __call__(self, body_pose: torch.Tensor, global_orient: torch.Tensor,
                 betas: Optional[torch.Tensor] = None) -> dict:
        """body_pose (B, 23, 3, 3), global_orient (B, 3, 3) -> the joint sets
        and vertices, one batched LBS call: 24 regressed + 21 surface-vertex
        joints (VERTEX_IDS) + the J_regressor_extra joints, 54 in all, which
        JOINT_MAP indexes."""
        B = body_pose.shape[0]
        if betas is None:
            betas = body_pose.new_zeros((B, self.num_betas))
        pose_mats = torch.cat([global_orient[:, None], body_pose], dim=1)
        verts, joints24 = lbs(self.model, betas, pose_mats)
        n_verts = verts.shape[1]
        full_ids = np.array(list(VERTEX_IDS.values()))
        # a synthetic mesh is smaller than SMPL's topology: clamp the ids so
        # they stay valid (only jointstype 'smpl' is exact then)
        surface = verts[:, np.minimum(full_ids, n_verts - 1)]
        if self.model.j_regressor_extra is not None:
            extra = torch.einsum("kv,bvc->bkc", _on(self.model.j_regressor_extra, verts), verts)
        else:
            extra = verts.new_zeros((B, 0, 3))
        all_joints = torch.cat([joints24, surface, extra], dim=1)
        out = {"vertices": verts}
        for name, idx in self.maps.items():
            if (idx >= all_joints.shape[1]).any():
                # compacting the joint axis would shift every later joint for
                # fixed-index consumers; the reference raises here too
                raise IndexError(
                    f"joint map '{name}' needs indices up to {int(idx.max())} but only "
                    f"{all_joints.shape[1]} joints are available — is "
                    "J_regressor_extra.npy missing next to the SMPL model?")
            out[name] = all_joints[:, idx]
        return out
