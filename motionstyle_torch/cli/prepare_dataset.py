"""Raw BVH directory -> processed posrot dataset (one command): the port's
counterpart of motionstyle/cli/prepare_dataset.py, with its four PROFILES.

Closes the reference's own unreleased TODO (its README's "Release the data
process code"): there, the `processed_data/<ds>/
new_joint_vecs + Mean.npy/Std.npy` layout its loaders consume
(humanml/data/dataset.py:1210-1211) has no shipped producer. This CLI
composes the pieces that DO exist — BVH parsing (post/bvh.py::read_bvh,
parity bvh_utils.py:84-295), FK (core/rotations.py::quat_fk), the posrot
feature codec (core/features.py::process_file_with_rotation, golden-matched
vs bvh_utils.py:1091-1287) — into the full path:

  raw/*.bvh -> (resample) -> FK global positions -> posrot hml_vec
            -> <out>/new_joint_vecs/<name>.npy  (+ Mean.npy / Std.npy)

Filenames must follow the dataset's naming convention (the loaders parse
style/content from them): stylexia `NNN{style}_{content}.npy`
(dataset.py:400-401), bandai `..._{content}_{style}_{NNN}.npy`
(dataset.py:234-235). Input BVH basenames are kept (.bvh -> .npy); a
non-conforming name gets a warning, not an error.

The FK and the re-derived local rotations run in float32 on the run's
device: the card unless `--device cpu` is given, as the JAX CLI runs its jnp
calls on its default backend. The IK and the feature codec are numpy.

Run:  python -m motionstyle_torch.cli.prepare_dataset --dataset stylexia_posrot \
        --bvh_dir raw_bvh/ --out processed_data/style_xia \
        [--downsample 4] [--feet_thre 0.002] [--no_stats] [--device cpu]
"""
from __future__ import annotations

import os
from argparse import ArgumentParser
from os.path import join as pjoin

import numpy as np
import torch

from motionstyle_torch.cli.model_util import resolve_device
from motionstyle_torch.core import features as F
from motionstyle_torch.core import params as skel_params
from motionstyle_torch.core import rotations as rot
from motionstyle_torch.core.skeleton import Skeleton
from motionstyle_torch.data.masks import BVH_JOINT_NAMES
from motionstyle_torch.post.bvh import read_bvh, resample_anim

# Per-dataset processing profiles. face_joint_idx = (r_hip, l_hip, sdr_r,
# sdr_l) drives the forward-facing canonicalization (skeleton.py IK); the
# humanml values are the reference's (process_smpl_from_hybrik.py:184-186);
# the xia/bandai values are the same four anatomical joints read off each
# family's joint table (data/masks.py).
PROFILES = {
    "stylexia_posrot": dict(
        joints=20, dim=181, face=[12, 16, 3, 7], fid_l=[18, 19],
        fid_r=[14, 15], chains="xia", offsets="xia",
        name_hint="NNN{style}_{content}.npy"),
    "bandai-2_posrot": dict(
        joints=21, dim=190, face=[17, 13, 9, 5], fid_l=[15, 16],
        fid_r=[19, 20], chains="bandai", offsets="bandai",
        name_hint="dataset-2_{content}_{style}_{NNN}.npy"),
    "bandai-1_posrot": dict(
        joints=21, dim=190, face=[17, 13, 9, 5], fid_l=[15, 16],
        fid_r=[19, 20], chains="bandai", offsets="bandai",
        name_hint="dataset-1_{content}_{style}_{NNN}.npy"),
    "humanml_posrot": dict(
        joints=22, dim=199, face=[2, 1, 17, 16], fid_l=[7, 10],
        fid_r=[8, 11], chains="t2m", offsets="smpl",
        name_hint="{name}.npy"),
}


def _skeleton(profile):
    raw = getattr(skel_params, f"{profile['offsets']}_raw_offsets")
    chains = getattr(skel_params, f"{profile['chains']}_kinematic_chain")
    return Skeleton(raw, chains)


def _name_conforms(dataset: str, stem: str) -> bool:
    parts = stem.split("_")
    if dataset == "stylexia_posrot":
        return len(parts) >= 2 and len(parts[0]) > 3 and parts[0][:3].isdigit()
    if dataset.startswith("bandai"):
        return len(parts) >= 4
    return True


def _map_joints(anim, expected_names):
    """Indices of `expected_names` inside anim.bones.

    Exact-name selection, so BVHs carrying extra joints (end effectors,
    props) still process; a missing expected joint is an error listing the
    available names.
    """
    pos_of = {n: i for i, n in enumerate(anim.bones)}
    missing = [n for n in expected_names if n not in pos_of]
    if missing:
        raise ValueError(
            f"BVH skeleton lacks joints {missing}; available: "
            f"{list(anim.bones)}. Rename joints to the dataset's table "
            f"(data/masks.py BVH_JOINT_NAMES) or pass --any_skeleton to "
            f"accept the first {len(expected_names)} joints positionally.")
    return [pos_of[n] for n in expected_names]


def process_bvh_file(path: str, dataset: str, *, downsample: float = 0.0,
                     feet_thre: float = 0.002, any_skeleton: bool = False,
                     start=None, end=None, device="cuda") -> np.ndarray:
    """One BVH file -> (T-1, dim) denormalized posrot feature array; the FK
    on `device` (the card unless 'cpu' is asked for; raises without a card)."""
    device = resolve_device(device)
    profile = PROFILES[dataset]
    anim = read_bvh(path, start=start, end=end)
    if downsample and downsample != 1.0:
        anim = resample_anim(anim, downsample)
    expected = BVH_JOINT_NAMES["bandai-2_posrot" if dataset == "bandai-1_posrot"
                               else dataset]
    J = profile["joints"]
    if any_skeleton or list(anim.bones) == list(expected):
        idx = list(range(J))
        if anim.quats.shape[1] < J:
            raise ValueError(
                f"{path}: {anim.quats.shape[1]} joints < the {J} the "
                f"{dataset} layout needs")
    else:
        idx = _map_joints(anim, expected)

    quats = torch.as_tensor(np.asarray(anim.quats), dtype=torch.float32, device=device)
    lpos = torch.as_tensor(np.asarray(anim.pos), dtype=torch.float32, device=device)
    # global positions by FK over the FULL file skeleton (so extra
    # intermediate joints still contribute their offsets), then select
    gq_full, gpos = rot.quat_fk(quats, lpos, list(anim.parents))
    gpos = gpos.cpu().numpy().astype(np.float64)[:, idx]
    # local rotations of the SELECTED joints: re-derived from the global
    # rotations so collapsed intermediate joints fold into their child
    gq = gq_full[:, idx]
    skel = _skeleton(profile)
    parents = skel.parents
    lq = gq.cpu().numpy().astype(np.float64)
    for j in range(len(parents) - 1, 0, -1):
        lq[:, j] = rot.qmul(rot.qinv(gq[:, parents[j]]), gq[:, j]).cpu().numpy()
    data, _, _, _ = F.process_file_with_rotation(
        gpos.astype(np.float64), lq.astype(np.float32), skel,
        profile["face"], fid_l=profile["fid_l"], fid_r=profile["fid_r"],
        feet_thre=feet_thre)
    assert data.shape[1] == profile["dim"], (data.shape, profile["dim"])
    return data.astype(np.float32)


def prepare(bvh_dir: str, out_dir: str, dataset: str, *,
            downsample: float = 0.0, feet_thre: float = 0.002,
            min_frames: int = 10, any_skeleton: bool = False,
            stats: bool = True, device="cuda") -> list:
    """Process every *.bvh under bvh_dir; returns the written npy paths."""
    device = resolve_device(device)
    vec_dir = pjoin(out_dir, "new_joint_vecs")
    os.makedirs(vec_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(bvh_dir) if f.endswith(".bvh"))
    if not files:
        raise FileNotFoundError(f"no .bvh files in {bvh_dir}")
    written, all_feats = [], []
    for f in files:
        stem = f[:-4]
        if not _name_conforms(dataset, stem):
            print(f"WARNING: '{f}' does not follow the {dataset} naming "
                  f"convention ({PROFILES[dataset]['name_hint']}); the "
                  f"loader will mis-parse its style/content")
        try:
            feats = process_bvh_file(pjoin(bvh_dir, f), dataset,
                                     downsample=downsample,
                                     feet_thre=feet_thre,
                                     any_skeleton=any_skeleton, device=device)
        except Exception as e:  # keep going: one bad capture, not the corpus
            print(f"SKIP {f}: {e}")
            continue
        if feats.shape[0] < min_frames:
            print(f"SKIP {f}: only {feats.shape[0]} frames (<{min_frames})")
            continue
        out_path = pjoin(vec_dir, stem + ".npy")
        np.save(out_path, feats)
        written.append(out_path)
        all_feats.append(feats)
        print(f"[prepare] {f}: {feats.shape[0]} frames -> {out_path}")
    if not written:
        raise RuntimeError("no clips survived processing")
    if stats:
        stacked = np.concatenate(all_feats, axis=0)
        np.save(pjoin(out_dir, "Mean.npy"),
                stacked.mean(axis=0).astype(np.float32))
        np.save(pjoin(out_dir, "Std.npy"),
                np.maximum(stacked.std(axis=0), 1e-3).astype(np.float32))
        print(f"[prepare] Mean/Std over {stacked.shape[0]} frames "
              f"({len(written)} clips) -> {out_dir}")
    return written


def main(argv=None):
    p = ArgumentParser()
    p.add_argument("--dataset", required=True, choices=sorted(PROFILES))
    p.add_argument("--bvh_dir", required=True, type=str)
    p.add_argument("--out", required=True, type=str,
                   help="processed dataset root (gains new_joint_vecs/ + "
                        "Mean.npy + Std.npy); pass it to the train/demo "
                        "CLIs as --data_dir")
    p.add_argument("--downsample", default=0.0, type=float,
                   help="frame-rate divisor (e.g. 6 for 120fps->20fps); "
                        "fractional rates slerp (read_bvh parity). 0 = keep")
    p.add_argument("--feet_thre", default=0.002, type=float,
                   help="foot-contact velocity threshold "
                        "(process_file parity, motion_process.py:256)")
    p.add_argument("--min_frames", default=10, type=int)
    p.add_argument("--any_skeleton", action="store_true",
                   help="skip joint-name matching: take the first J joints "
                        "positionally (for conforming BVHs with renamed "
                        "joints)")
    p.add_argument("--no_stats", action="store_true",
                   help="skip Mean/Std (when appending to an existing corpus)")
    p.add_argument("--device", default="cuda",
                   help="device of the FK (cuda unless cpu is asked for)")
    args = p.parse_args(argv)
    return prepare(args.bvh_dir, args.out, args.dataset,
                   downsample=args.downsample, feet_thre=args.feet_thre,
                   min_frames=args.min_frames,
                   any_skeleton=args.any_skeleton, stats=not args.no_stats,
                   device=args.device)


if __name__ == "__main__":
    main()
