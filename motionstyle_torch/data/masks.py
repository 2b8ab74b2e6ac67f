"""Inpainting feature masks over the hml_vec channel layouts (numpy).

Counterpart of motionstyle/data/masks.py, with its own copy of the channel
layouts (motionstyle/core/features.py) and joint tables. Mask semantics:
1.0 = keep the ground-truth (content) feature, 0.0 = denoise it.

Mask names (comma-separated): root, root_horizontal, y_rotation,
linear_vel, xz_plane, upper_body, lower_body, right_hand (humanml layouts),
prefix, in_between, or any joint name of the dataset (masks that joint's
ric channels).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class FeatureLayout:
    """One hml_vec channel layout."""

    njoints: int
    has_vel_fc: bool  # humanml (263): +3J local velocities +4 foot contacts
    rot_includes_root: bool  # posrot layouts: 6*J rotation channels, else 6*(J-1)

    @property
    def dim(self) -> int:
        j = self.njoints
        d = 4 + 3 * (j - 1) + 6 * (j if self.rot_includes_root else j - 1)
        if self.has_vel_fc:
            d += 3 * j + 4
        return d

    @property
    def ric_slice(self) -> slice:
        return slice(4, 4 + 3 * (self.njoints - 1))

    @property
    def rot_slice(self) -> slice:
        start = 4 + 3 * (self.njoints - 1)
        return slice(start, start + 6 * (self.njoints if self.rot_includes_root
                                         else self.njoints - 1))


LAYOUTS = {
    "humanml": FeatureLayout(22, has_vel_fc=True, rot_includes_root=False),
    "kit": FeatureLayout(21, has_vel_fc=True, rot_includes_root=False),
    "stylexia_posrot": FeatureLayout(20, has_vel_fc=False, rot_includes_root=True),
    "bandai-1_posrot": FeatureLayout(21, has_vel_fc=False, rot_includes_root=True),
    "bandai-2_posrot": FeatureLayout(21, has_vel_fc=False, rot_includes_root=True),
    "humanml_posrot": FeatureLayout(22, has_vel_fc=False, rot_includes_root=True),
}

# joint-name tables (stylexia_posrot_utils.py:3-47, bandai_posrot_utils.py:3-49,
# humanml_posrot_utils.py:3-50)
XIA_JOINT_NAMES = [
    "root", "pelvis", "thorax", "rclavicle", "rhumerus", "rradius", "rhand",
    "lclavicle", "lhumerus", "lradius", "lhand", "head", "rfemur", "rtibia",
    "rfoot", "rtoes", "lfemur", "ltibia", "lfoot", "ltoes",
]
XIA_LOWER_BODY = ["root", "pelvis", "rfemur", "rtibia", "rfoot", "rtoes", "lfemur", "ltibia", "lfoot", "ltoes"]
BANDAI_JOINT_NAMES = [
    "Hips", "Spine", "Chest", "Neck", "Head", "Shoulder_L", "UpperArm_L",
    "LowerArm_L", "Hand_L", "Shoulder_R", "UpperArm_R", "LowerArm_R", "Hand_R",
    "UpperLeg_L", "LowerLeg_L", "Foot_L", "Toes_L", "UpperLeg_R", "LowerLeg_R",
    "Foot_R", "Toes_R",
]
BANDAI_LOWER_BODY = ["Hips", "UpperLeg_L", "LowerLeg_L", "Foot_L", "Toes_L", "UpperLeg_R", "LowerLeg_R", "Foot_R", "Toes_R"]
SMPL_JOINT_NAMES = [
    "pelvis", "left_hip", "right_hip", "spine1", "left_knee", "right_knee",
    "spine2", "left_ankle", "right_ankle", "spine3", "left_foot", "right_foot",
    "neck", "left_collar", "right_collar", "head", "left_shoulder",
    "right_shoulder", "left_elbow", "right_elbow", "left_wrist", "right_wrist",
]
SMPL_LOWER_BODY = ["pelvis", "left_hip", "right_hip", "left_knee", "right_knee", "left_ankle", "right_ankle", "left_foot", "right_foot"]
SMPL_RIGHT_HAND = ["right_wrist", "right_elbow"]

# BVH export joint names, in the same order (post/bvh.py's writers)
XIA_BVH_JOINT_NAMES = list(XIA_JOINT_NAMES)
BANDAI_BVH_JOINT_NAMES = list(BANDAI_JOINT_NAMES)
SMPL_BVH_JOINT_NAMES = [
    "Pelvis", "L_Hip", "R_Hip", "Spine1", "L_Knee", "R_Knee", "Spine2",
    "L_Ankle", "R_Ankle", "Spine3", "L_Foot", "R_Foot", "Neck", "L_Collar",
    "R_Collar", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
    "L_Wrist", "R_Wrist",
]


@dataclass(frozen=True)
class MaskSpec:
    layout: FeatureLayout
    joint_names: tuple
    lower_body_names: tuple
    right_hand_names: tuple = ()

    @property
    def njoints(self) -> int:
        return self.layout.njoints

    def _assemble(self, root4, joint_binary_ric, joint_binary_rot, vel_binary=None,
                  fc=False) -> np.ndarray:
        """Per-channel boolean mask from per-group selections."""
        parts = [np.asarray(root4, dtype=bool),
                 np.repeat(np.asarray(joint_binary_ric, dtype=bool)[1:], 3)]
        rotj = joint_binary_rot if self.layout.rot_includes_root else joint_binary_rot[1:]
        parts.append(np.repeat(np.asarray(rotj, dtype=bool), 6))
        if self.layout.has_vel_fc:
            vel = joint_binary_ric if vel_binary is None else vel_binary
            parts.append(np.repeat(np.asarray(vel, dtype=bool), 3))
            parts.append(np.full(4, fc, dtype=bool))
        out = np.concatenate(parts)
        assert out.shape[0] == self.layout.dim, (out.shape, self.layout.dim)
        return out

    def _none(self) -> np.ndarray:
        return np.zeros(self.njoints, dtype=bool)

    def root_mask(self) -> np.ndarray:
        rootb = self._none()
        rootb[0] = True
        return self._assemble([1, 1, 1, 1], rootb, rootb, vel_binary=rootb)

    def root_horizontal_mask(self) -> np.ndarray:
        # yaw velocity + xz velocity kept, root height denoised
        return self._assemble([1, 1, 1, 0], self._none(), self._none())

    def y_rotation_mask(self) -> np.ndarray:
        return self._assemble([1, 0, 0, 0], self._none(), self._none())

    def linear_vel_mask(self) -> np.ndarray:
        return self._assemble([0, 1, 1, 0], self._none(), self._none())

    xz_plane_mask = linear_vel_mask

    def lower_body_mask(self) -> np.ndarray:
        lb = np.array([n in self.lower_body_names for n in self.joint_names])
        return self._assemble([1, 1, 1, 1], lb, lb, vel_binary=lb, fc=True)

    def upper_body_mask(self) -> np.ndarray:
        return ~self.lower_body_mask()

    def right_hand_mask(self) -> np.ndarray:
        rh = np.array([n in self.right_hand_names for n in self.joint_names])
        return self._assemble([0, 0, 0, 0], rh, rh, vel_binary=rh)

    def joints_mask(self, names) -> np.ndarray:
        jb = np.array([n in names for n in self.joint_names])
        return self._assemble([0, 0, 0, 0], jb, self._none(), vel_binary=self._none())


MASK_SPECS = {
    "stylexia_posrot": MaskSpec(LAYOUTS["stylexia_posrot"], tuple(XIA_JOINT_NAMES), tuple(XIA_LOWER_BODY)),
    "bandai-1_posrot": MaskSpec(LAYOUTS["bandai-1_posrot"], tuple(BANDAI_JOINT_NAMES), tuple(BANDAI_LOWER_BODY)),
    "bandai-2_posrot": MaskSpec(LAYOUTS["bandai-2_posrot"], tuple(BANDAI_JOINT_NAMES), tuple(BANDAI_LOWER_BODY)),
    "humanml_posrot": MaskSpec(LAYOUTS["humanml_posrot"], tuple(SMPL_JOINT_NAMES), tuple(SMPL_LOWER_BODY), tuple(SMPL_RIGHT_HAND)),
    "humanml": MaskSpec(LAYOUTS["humanml"], tuple(SMPL_JOINT_NAMES), tuple(SMPL_LOWER_BODY), tuple(SMPL_RIGHT_HAND)),
}


BVH_JOINT_NAMES = {
    "stylexia_posrot": XIA_BVH_JOINT_NAMES,
    "bandai-1_posrot": BANDAI_BVH_JOINT_NAMES,
    "bandai-2_posrot": BANDAI_BVH_JOINT_NAMES,
    "humanml": SMPL_BVH_JOINT_NAMES,
    "humanml_posrot": SMPL_BVH_JOINT_NAMES,
}


def expand_mask(mask: np.ndarray, shape) -> np.ndarray:
    """(D,) or (D, T) mask -> broadcast to (B, D, 1, T)."""
    return np.ones(shape) * mask.reshape((1, shape[1], 1, -1))


def get_in_between_mask(shape, lengths, prefix_end, suffix_end) -> np.ndarray:
    mask = np.ones(shape)
    for i, length in enumerate(lengths):
        mask[i, :, :, int(prefix_end * length):int(suffix_end * length)] = 0
    return mask


def get_prefix_mask(shape, prefix_length: int = 20) -> np.ndarray:
    _, num_feat, _, seq_len = shape
    m = np.concatenate([np.ones((num_feat, prefix_length)),
                        np.zeros((num_feat, seq_len - prefix_length))], axis=-1)
    return expand_mask(m, shape)


_NAMED = {
    "root": MaskSpec.root_mask,
    "root_horizontal": MaskSpec.root_horizontal_mask,
    "y_rotation": MaskSpec.y_rotation_mask,
    "linear_vel": MaskSpec.linear_vel_mask,
    "xz_plane": MaskSpec.xz_plane_mask,
    "upper_body": MaskSpec.upper_body_mask,
    "lower_body": MaskSpec.lower_body_mask,
    "right_hand": MaskSpec.right_hand_mask,
}


def get_inpainting_mask(mask_name: str, shape, dataset: str = "stylexia_posrot",
                        **kwargs) -> np.ndarray:
    """Compose a (B, D, 1, T) float mask from comma-separated mask names."""
    spec = MASK_SPECS[dataset]
    names = mask_name.split(",")
    mask = np.zeros(shape)
    if "in_between" in names:
        mask = np.maximum(mask, get_in_between_mask(shape, **kwargs))
    if "prefix" in names:
        mask = np.maximum(mask, get_prefix_mask(shape, **kwargs))
    for key, fn in _NAMED.items():
        if key in names:
            mask = np.maximum(mask, expand_mask(fn(spec).astype(np.float64), shape))
    joint_names = [n for n in names if n in spec.joint_names]
    return np.maximum(mask, expand_mask(spec.joints_mask(joint_names).astype(np.float64), shape))
