"""Sequence SMPLify CLI of the PyTorch port: fit whole npy motion files to
SMPL (counterpart of motionstyle/cli/fit_seq.py).

Parity: visualize/joints2smpl/fit_seq.py:1-132, which walks a folder of
(T, 22, 3) joint npy files and runs SMPLify3D frame by frame, each frame
warm-started from the previous one's pkl. Here, as in the JAX CLI, a whole
sequence is one batched fit on the device (post/smplify.py::Joints2SMPL: the
frames are the batch of the Adam loop), optionally in chunks warm-started
from the previous chunk's last frame. Each input gives one
`<name>_smpl_params.npy` dict {pose (T, 72) axis-angle, betas (T, 10), cam
(T, 3), motion (1, 25, 6, T) rot6d, num_frames}, and with --save_obj 1 one
OBJ mesh a frame under `<name>_obj/`, written by hand. Without the SMPL asset
(SMPL_DATA_PATH) the fit runs on the seeded synthetic mesh, as the JAX CLI's
does.

Run:  python -m motionstyle_torch.cli.fit_seq --data_folder demo_data \\
        [--files test_motion.npy | --all] [--save_folder demo_results] \\
        [--num_smplify_iters 100] [--fix_foot 1] [--chunk 64] [--save_obj 1] \\
        [--device cuda]
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
import torch

from motionstyle_torch.core import rotations as rot
from motionstyle_torch.models.smpl import SMPL, lbs, random_smpl_model
from motionstyle_torch.post.smplify import Joints2SMPL, SMPLify3D


def load_smpl(what: str) -> SMPL:
    """The SMPL asset, or the seeded synthetic mesh where it is absent."""
    try:
        return SMPL()
    except (FileNotFoundError, OSError):
        print(f"WARNING: SMPL asset not found (SMPL_DATA_PATH); using the seeded synthetic "
              f"mesh — {what} NOT meaningful")
        return SMPL(model=random_smpl_model(np.random.RandomState(0)))


def fit_file(path: str, save_dir: str, j2s: Joints2SMPL, smpl: SMPL, chunk: int = 0,
             save_obj: bool = False) -> str:
    name = os.path.splitext(os.path.basename(path))[0]
    data = np.load(path)
    if data.ndim != 3 or data.shape[2] != 3:
        raise ValueError(f"{path}: expected (T, J, 3) joints, got {data.shape}")
    T = data.shape[0]
    chunks = [data] if not chunk else [data[i:i + chunk] for i in range(0, T, chunk)]
    outs, poses, betas, cams = [], [], [], []
    init = None
    for c in chunks:  # each chunk warm-starts from the previous fit's last frame
        # (the reference warm-starts frame i from frame i-1's pkl,
        # fit_seq.py:93-97; chunks generalise that to batched fits)
        if init is not None:
            init = {k: np.tile(v[-1:], (len(c), 1)) for k, v in init.items()}
        out, init = j2s.joint2smpl(c.astype(np.float32), init_params=init)
        outs.append(out)
        poses.append(init["pose"])
        betas.append(init["betas"])
        cams.append(init["cam"])
    motion = np.concatenate(outs, axis=-1)  # (1, 25, 6, T)
    os.makedirs(save_dir, exist_ok=True)
    out_path = os.path.join(save_dir, f"{name}_smpl_params.npy")
    np.save(out_path, {
        "pose": np.concatenate(poses, 0), "betas": np.concatenate(betas, 0),
        "cam": np.concatenate(cams, 0), "motion": motion, "num_frames": T,
    })
    if save_obj:
        obj_dir = os.path.join(save_dir, name + "_obj")
        os.makedirs(obj_dir, exist_ok=True)
        dev = j2s.device
        pose_aa = torch.as_tensor(np.concatenate(poses, 0).reshape(T, 24, 3), device=dev)
        # the meshes of the fitted (pose, betas, cam) written above: the
        # fitted betas, and the camera translation the losses add to the model
        with torch.no_grad():
            verts, _ = lbs(smpl.model, torch.as_tensor(np.concatenate(betas, 0), device=dev),
                           rot.axis_angle_to_matrix(pose_aa))
        verts = verts.cpu().numpy() + np.concatenate(cams, 0)[:, None, :]
        faces = getattr(smpl, "faces", None)
        for t in range(T):
            with open(os.path.join(obj_dir, f"{t:04d}.obj"), "w") as f:
                for v in verts[t]:
                    f.write(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}\n")
                if faces is not None:
                    for fc in faces:
                        f.write(f"f {fc[0]+1} {fc[1]+1} {fc[2]+1}\n")
    print(f"[fit_seq] {name}: {T} frames -> {out_path}")
    return out_path


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--data_folder", required=True, type=str)
    parser.add_argument("--files", default="", type=str,
                        help="one npy inside --data_folder (reference API); "
                             "omit with --all to fit every *.npy")
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--save_folder", default="./fit_results", type=str)
    parser.add_argument("--num_smplify_iters", default=100, type=int)
    parser.add_argument("--joint_category", default="AMASS", type=str)
    parser.add_argument("--fix_foot", default=0, type=int)
    parser.add_argument("--chunk", default=0, type=int,
                        help="fit in chunks of N frames (warm-started); "
                             "0 = the whole sequence as one batched fit")
    parser.add_argument("--save_obj", default=0, type=int)
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device the fit runs on (cuda unless asked)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    smpl = load_smpl("fitted params are")
    j2s = Joints2SMPL(smpl, num_smplify_iters=args.num_smplify_iters,
                      fix_foot=bool(args.fix_foot), device=args.device)
    j2s.smplify = SMPLify3D(smpl, num_iters=args.num_smplify_iters,
                            joints_category=args.joint_category)

    if args.all:
        files = sorted(f for f in os.listdir(args.data_folder) if f.endswith(".npy"))
    else:
        if not args.files:
            raise SystemExit("pass --files NAME.npy or --all")
        files = [args.files]
    outs = [fit_file(os.path.join(args.data_folder, f), args.save_folder, j2s, smpl,
                     chunk=args.chunk, save_obj=bool(args.save_obj)) for f in files]
    print(f"[Done] fitted {len(outs)} file(s) -> {args.save_folder}")
    return outs


if __name__ == "__main__":
    main()
