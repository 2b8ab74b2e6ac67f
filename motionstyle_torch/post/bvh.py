"""BVH skeletal-animation I/O: the port's own copy of motionstyle/post/bvh.py.

A reader and writer for the standard BVH format (a hierarchy of OFFSET /
CHANNELS / End Site blocks and a MOTION table), with the reference's Anim
container (bvh_utils.py:29-81, read_bvh :84, save_bvh :499).

Conventions: quaternions (w, x, y, z); Euler channels written as
"Zrotation Yrotation Xrotation" with R = Rz @ Ry @ Rx (intrinsic zyx), which
read and write round-trip; degrees on disk. The Euler conversions run in
float32 on the host through core/rotations.py, as the JAX package runs them
through jnp. The MOTION table is parsed by parse_floats, the port's copy of
the numpy branch of motionstyle/native/ingest.py::parse_floats, with the
same exact-count check (a corrupt row raises).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from motionstyle_torch.core import rotations as rot

def parse_floats(text: str) -> np.ndarray:
    """Whitespace-separated floats as float32 (numpy's own string parsing);
    a token that is no float raises ValueError."""
    return np.array(text.split(), np.float32) if text.strip() else np.empty((0,), np.float32)


CHANNEL_AXIS = {"Xrotation": "x", "Yrotation": "y", "Zrotation": "z"}
AXIS_CHANNEL = {"x": "Xrotation", "y": "Yrotation", "z": "Zrotation"}


@dataclass
class Anim:
    """quats (T, J, 4) local; pos (T, J, 3) local positions (root animated);
    offsets (J, 3) rest offsets; parents (J,); bones (J,) names."""

    quats: np.ndarray
    pos: np.ndarray
    offsets: np.ndarray
    parents: np.ndarray
    bones: List[str]
    end_offsets: Optional[dict] = None  # joint index -> (3,) end-site offset
    frametime: float = 1.0 / 20.0

    def __post_init__(self):
        if self.bones is None:
            self.bones = [f"joint_{i}" for i in range(len(self.parents))]

    @property
    def shape(self):
        return (self.quats.shape[0], self.quats.shape[1])

    def clip(self, sl):
        self.quats = self.quats[sl]
        self.pos = self.pos[sl]


def read_bvh(filename: str, start=None, end=None, end_sites: bool = False,
             order: Optional[str] = None) -> Anim:
    """Parse a BVH file into an Anim. end_sites=True keeps End Site joints as
    'End Site' named bones (reference behavior with end_sites flag).

    Channel handling is PER JOINT (a superset of bvh_utils.py:84-295, which
    locks the rotation order from the first CHANNELS line): each joint's
    position/rotation columns and euler order come from its own CHANNELS
    declaration, so files mixing e.g. zyx roots with xyz limbs parse
    correctly. `order` (reference API) overrides the declared rotation order
    for every joint."""
    names: List[str] = []
    offsets: List[list] = []
    parents: List[int] = []
    joint_channels: List[List[str]] = []
    end_offsets = {}
    active = -1
    frames = None
    frametime = 1.0 / 20.0
    motion_rows = []
    in_motion = False
    pending_end = False
    in_end_site = False

    with open(filename) as f:
        for line in f:
            if in_motion:
                if m := re.match(r"\s*Frames:\s*(\d+)", line):
                    frames = int(m.group(1))
                    continue
                if m := re.match(r"\s*Frame Time:\s*([\d.eE+-]+)", line):
                    frametime = float(m.group(1))
                    continue
                if line.strip():
                    motion_rows.append(line)
                continue
            if "MOTION" in line:
                in_motion = True
                continue
            if m := re.match(r"\s*(ROOT|JOINT)\s+(\S+)", line):
                names.append(m.group(2))
                offsets.append([0.0, 0.0, 0.0])
                joint_channels.append([])
                parents.append(active)
                active = len(parents) - 1
                continue
            if re.match(r"\s*End Site", line):
                pending_end = True
                if end_sites:
                    names.append("End Site")
                    offsets.append([0.0, 0.0, 0.0])
                    joint_channels.append([])
                    parents.append(active)
                    active = len(parents) - 1
                if "{" in line:  # 'End Site {' brace on the same line: the
                    # brace handler below never sees it
                    if not end_sites:
                        in_end_site = True
                    pending_end = False
                continue
            if m := re.match(r"\s*OFFSET\s+([-+\d.eE]+)\s+([-+\d.eE]+)\s+([-+\d.eE]+)", line):
                vals = [float(m.group(i)) for i in (1, 2, 3)]
                if in_end_site and not end_sites:
                    end_offsets[active] = np.array(vals)
                else:
                    offsets[active] = vals
                continue
            if m := re.match(r"\s*CHANNELS\s+(\d+)\s+(.*)", line):
                n = int(m.group(1))
                joint_channels[active] = m.group(2).split()[:n]
                continue
            if "{" in line:
                if pending_end and not end_sites:
                    in_end_site = True
                pending_end = False
                continue
            if "}" in line:
                if in_end_site:
                    in_end_site = False
                else:
                    active = parents[active]
                continue

    J = len(names)
    offsets = np.array(offsets, dtype=np.float32)
    parents = np.array(parents, dtype=int)
    # one parse over the whole MOTION block, held to the EXACT expected count
    # (rows x cols): divisibility alone would take a file with a garbage line
    # at a row boundary; anything else falls through to the strict row-major
    # parse, which raises
    n_cols = sum(len(c) for c in joint_channels)
    flat = parse_floats("".join(motion_rows))
    # valid counts: one physical line per frame, OR the header-declared
    # frame count (exporters may wrap a frame across lines)
    ok_counts = {len(motion_rows) * n_cols}
    if frames is not None:
        ok_counts.add(frames * n_cols)
    if n_cols and len(flat) in ok_counts:
        motion = flat.reshape(-1, n_cols)
    else:  # ragged/odd files: preserve the strict row-major error behavior
        motion = np.array([r.split() for r in motion_rows], dtype=np.float32)
    T = motion.shape[0]
    if frames is not None and frames != T:
        print(f"WARNING: {filename}: header declares Frames: {frames} but "
              f"the MOTION table has {T} rows; using {T}")

    quats = np.zeros((T, J, 4), dtype=np.float32)
    quats[..., 0] = 1.0
    pos = np.tile(offsets[None], (T, 1, 1)).astype(np.float32)
    col = 0
    for j in range(J):
        chans = joint_channels[j]
        if not chans:
            continue
        block = motion[:, col : col + len(chans)]
        col += len(chans)
        rot_idx = [i for i, c in enumerate(chans) if c in CHANNEL_AXIS]
        for i, c in enumerate(chans):  # name-mapped, any declaration order
            if c in ("Xposition", "Yposition", "Zposition"):
                pos[:, j, "XYZ".index(c[0])] = block[:, i]
        if len(rot_idx) == 3:
            jorder = order or "".join(CHANNEL_AXIS[chans[i]] for i in rot_idx)
            e = block[:, rot_idx]
            quats[:, j] = rot.euler_to_quaternion(torch.as_tensor(
                np.radians(e.astype(np.float64)), dtype=torch.float32), jorder).numpy()

    anim = Anim(quats, pos, offsets, parents, names, end_offsets or None, frametime)
    if start is not None or end is not None:
        anim.clip(slice(start, end))
    return anim


def resample_anim(anim: Anim, rate: float) -> Anim:
    """Fractional-rate temporal resampling: slerp rotations, lerp positions.

    Parity with read_bvh's downsample_rate path (bvh_utils.py:84-295), e.g.
    rate=1.5 converts 30 fps capture to 20 fps.
    """
    T = anim.quats.shape[0]
    new_T = int(np.floor((T - 1) / rate)) + 1
    src = np.arange(new_T) * rate
    i0 = np.clip(np.floor(src).astype(int), 0, T - 1)
    i1 = np.clip(i0 + 1, 0, T - 1)
    frac = (src - i0).astype(np.float32)

    q0 = torch.as_tensor(anim.quats[i0], dtype=torch.float32)
    q1 = torch.as_tensor(anim.quats[i1], dtype=torch.float32)
    quats = rot.qslerp(q0, q1, torch.from_numpy(frac[:, None])).numpy()
    pos = anim.pos[i0] * (1 - frac)[:, None, None] + anim.pos[i1] * frac[:, None, None]
    return Anim(quats.astype(np.float32), pos.astype(np.float32), anim.offsets,
                anim.parents, anim.bones, anim.end_offsets, anim.frametime * rate)


def save_bvh(filename: str, anim: Anim, frametime: Optional[float] = None,
             order="zyx", positions: bool = False) -> None:
    """Write an Anim as BVH: 6 channels on the root (+all joints when
    positions=True), 3 rotation channels elsewhere, End Sites from
    anim.end_offsets (zero end sites added to leaves otherwise).
    `order` is one euler order string, or a length-J sequence of per-joint
    order strings (mirrors read_bvh's per-joint channel support).
    frametime defaults to anim.frametime (so read->resample->save keeps the
    adjusted rate); pass a float to override."""
    if frametime is None:
        frametime = anim.frametime
    J = anim.quats.shape[1]
    orders = [order] * J if isinstance(order, str) else list(order)
    assert len(orders) == J, (len(orders), J)
    children = [[] for _ in range(J)]
    for j in range(1, J):
        children[anim.parents[j]].append(j)
    end_offsets = anim.end_offsets or {}

    lines = ["HIERARCHY"]
    dfs_order: List[int] = []  # BVH motion columns follow hierarchy DFS order

    def emit(j, depth):
        dfs_order.append(j)
        t = "\t" * depth
        tag = "ROOT" if depth == 0 else "JOINT"
        lines.append(f"{t}{tag} {anim.bones[j]}")
        lines.append(f"{t}{{")
        t2 = "\t" * (depth + 1)
        o = anim.offsets[j]
        lines.append(f"{t2}OFFSET {o[0]:.6f} {o[1]:.6f} {o[2]:.6f}")
        rot_chans = " ".join(AXIS_CHANNEL[a] for a in orders[j])
        if depth == 0 or positions:
            lines.append(f"{t2}CHANNELS 6 Xposition Yposition Zposition {rot_chans}")
        else:
            lines.append(f"{t2}CHANNELS 3 {rot_chans}")
        if children[j]:
            for c in children[j]:
                emit(c, depth + 1)
        else:
            eo = end_offsets.get(j, np.zeros(3))
            lines.append(f"{t2}End Site")
            lines.append(f"{t2}{{")
            lines.append(f"{t2}\tOFFSET {eo[0]:.6f} {eo[1]:.6f} {eo[2]:.6f}")
            lines.append(f"{t2}}}")
        lines.append(f"{t}}}")

    emit(0, 0)
    T = anim.quats.shape[0]
    lines.append("MOTION")
    lines.append(f"Frames: {T}")
    lines.append(f"Frame Time: {frametime:.6f}")

    eul = np.zeros((T, J, 3), dtype=np.float64)
    for o in sorted(set(orders)):  # one vectorized convert per unique order
        js = [j for j in range(J) if orders[j] == o]
        eul[:, js] = np.degrees(rot.quaternion_to_euler(
            torch.as_tensor(anim.quats[:, js], dtype=torch.float32), o).numpy())
    rows = []
    for f_i in range(T):
        vals = []
        for j in dfs_order:
            if j == 0 or positions:
                vals.extend(f"{v:.6f}" for v in anim.pos[f_i, j])
            vals.extend(f"{v:.6f}" for v in eul[f_i, j])
        rows.append(" ".join(vals))
    lines.extend(rows)
    with open(filename, "w") as f:
        f.write("\n".join(lines) + "\n")


def extract_chains(anim: Anim):
    """Derive (kinematic_chains, unit_offsets, real_offsets) from an Anim;
    parity: bvh_utils.py:815 (extract_chains)."""
    J = len(anim.parents)
    children = [[] for _ in range(J)]
    for j in range(1, J):
        children[anim.parents[j]].append(j)
    chains = []

    def walk(j, chain):
        chain = chain + [j]
        if not children[j]:
            chains.append(chain)
            return
        for i, c in enumerate(children[j]):
            if i == 0:
                walk(c, chain)
            else:
                walk(c, [j])

    walk(0, [])
    real = np.array(anim.offsets, dtype=np.float32)
    norms = np.linalg.norm(real, axis=-1, keepdims=True)
    unit = np.where(norms > 1e-8, real / np.maximum(norms, 1e-8), 0.0)
    return chains, unit.astype(np.float32), real
