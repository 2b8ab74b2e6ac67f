"""Per-frame SMPL OBJ export for a demo output, in the PyTorch port
(counterpart of motionstyle/cli/render_mesh.py).

Parity: visualize/render_mesh.py:1-33: given one of the demo's
`sample{i:02d}_rep{j:02d}.mp4` outputs (or --results with --sample_i /
--rep_i), SMPLify-fit the motion on the device (post/smplify.py) and write
frame{NNN}.obj meshes (by hand: no pyrender or trimesh is needed) and a
_smpl_params.npy beside it. Without the SMPL asset (SMPL_DATA_PATH) the
meshes are the seeded synthetic mesh's, as the JAX CLI's are.

Run:  python -m motionstyle_torch.cli.render_mesh --input_path out/sample00_rep00.mp4
  or: python -m motionstyle_torch.cli.render_mesh --results out/results.npy \\
        [--sample_i 0] [--rep_i 0] [--device cuda]
"""
from __future__ import annotations

import os
import shutil
from argparse import ArgumentParser

from motionstyle_torch.cli.fit_seq import load_smpl
from motionstyle_torch.models.rotation2xyz import Rotation2xyz
from motionstyle_torch.post.smplify import Joints2SMPL
from motionstyle_torch.post.vis_utils import Npy2Obj


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--input_path", default="", type=str,
                        help="a demo sample{i}_rep{j}.mp4 (reference API); "
                             "results.npy is looked up next to it")
    parser.add_argument("--results", default="", type=str,
                        help="direct path to a results.npy (alternative)")
    parser.add_argument("--sample_i", default=0, type=int)
    parser.add_argument("--rep_i", default=0, type=int)
    parser.add_argument("--num_smplify_iters", default=150, type=int)
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device the fit and the vertices run on (cuda unless asked)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.input_path:
        if not args.input_path.endswith(".mp4"):
            raise SystemExit("--input_path must be an .mp4")
        parsed = os.path.basename(args.input_path)[:-4]
        parsed = parsed.replace("sample", "").replace("rep", "")
        args.sample_i, args.rep_i = [int(e) for e in parsed.split("_")]
        npy_path = os.path.join(os.path.dirname(args.input_path), "results.npy")
        out_stem = args.input_path[:-4]
    else:
        if not args.results:
            raise SystemExit("pass --input_path or --results")
        npy_path = args.results
        out_stem = os.path.join(os.path.dirname(npy_path),
                                f"sample{args.sample_i:02d}_rep{args.rep_i:02d}")
    if not os.path.exists(npy_path):
        raise FileNotFoundError(npy_path)

    smpl = load_smpl("geometry is")
    j2s = Joints2SMPL(smpl, num_smplify_iters=args.num_smplify_iters, device=args.device)

    results_dir = out_stem + "_obj"
    if os.path.exists(results_dir):
        shutil.rmtree(results_dir)
    os.makedirs(results_dir)
    npy2obj = Npy2Obj(npy_path, args.sample_i, args.rep_i, Rotation2xyz(smpl), j2s=j2s)

    print(f"saving obj files to [{os.path.abspath(results_dir)}]")
    faces = getattr(smpl, "faces", None)
    for frame_i in range(npy2obj.real_num_frames):
        npy2obj.save_obj(os.path.join(results_dir, f"frame{frame_i:03d}.obj"), frame_i,
                         faces=faces)
    npy2obj.save_npy(out_stem + "_smpl_params.npy")
    print(f"[Done] {npy2obj.real_num_frames} frames")
    return results_dir


if __name__ == "__main__":
    main()
