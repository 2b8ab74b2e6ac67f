"""The one traffic generator. A mix is a data file under portbench/traffic/
(sizes, counts, plans and a caption grammar); everything a run sends is
drawn here from `--seed`, so the same seed sends the same work, and every
seed sends the same sizes.
"""
from __future__ import annotations

import os

import numpy as np


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one named stream of a run's draws."""
    words = [int(seed) % 2 ** 64] + [int.from_bytes(str(t).encode(), "little") % 2 ** 64
                                     for t in tags]
    hi, lo = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *tags))


def captions(seed: int, n: int, grammar: dict, tag: str = "captions") -> list:
    """n distinct captions, each one choice from every slot of the grammar
    ({"slots": [[phrase, ...], ...]}), drawn without replacement."""
    slots = grammar["slots"]
    sizes = [len(s) for s in slots]
    total = int(np.prod(sizes))
    if n > total:
        raise ValueError(f"the grammar makes {total} captions, {n} asked for")
    out = []
    for k in rng(seed, tag).choice(total, size=n, replace=False):
        words = []
        for slot, size in zip(slots, sizes):
            k, j = divmod(int(k), size)
            if slot[j]:
                words.append(slot[j])
        out.append(" ".join(words))
    return out


def clips(seed: int, n: int, channels: int, frames: int, tag: str = "clips") -> np.ndarray:
    """(n, channels, 1, frames) float32 z-normalised synthetic motion: white
    noise smoothed over time by a 5-frame moving average, rescaled to unit
    variance."""
    smooth = 5
    x = rng(seed, tag).standard_normal((n, channels, frames + smooth - 1)).astype(np.float32)
    k = np.ones(smooth, np.float32) / smooth
    x = np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"), -1, x)
    x = x / x.std(axis=-1, keepdims=True).clip(1e-6)
    return np.ascontiguousarray(x[:, :, None, :], dtype=np.float32)


def inpainting_mask(name: str, channels: int, frames: int) -> np.ndarray:
    """(channels, 1, frames) float32 keep-mask. root_horizontal keeps the
    root's yaw velocity and its x and z velocities (hml_vec channels 0-2)
    and denoises the rest (the paper's mask)."""
    if name != "root_horizontal":
        raise ValueError(f"inpainting mask {name!r} is not defined here")
    m = np.zeros((channels, 1, frames), np.float32)
    m[:3] = 1.0
    return m


def write_humanml_corpus(root: str, seed: int, mix: dict, channels: int) -> dict:
    """A HumanML3D-layout corpus under root (new_joint_vecs/*.npy (T, C)
    float32, texts/*.txt with 'caption#tokens#0.0#0.0' lines, train.txt,
    Mean.npy, Std.npy), every clip with `captions_per_clip` distinct
    captions. Returns {'clips', 'captions', 'bytes'}."""
    c = mix["corpus"]
    n, per = c["clips"], c["captions_per_clip"]
    lo, hi = c["min_frames"], c["max_frames"]
    r = rng(seed, "corpus")
    texts = captions(seed, n * per, mix["grammar"], tag="corpus_captions")
    os.makedirs(os.path.join(root, "new_joint_vecs"))
    os.makedirs(os.path.join(root, "texts"))
    names, nbytes = [], 0
    for i in range(n):
        name = f"{i:06d}"
        frames = int(r.integers(lo, hi + 1))
        motion = (r.standard_normal((frames, channels), dtype=np.float32) * 0.5
                  + np.float32(0.1))
        np.save(os.path.join(root, "new_joint_vecs", name + ".npy"), motion)
        nbytes += motion.nbytes
        with open(os.path.join(root, "texts", name + ".txt"), "w") as f:
            for t in texts[i * per:(i + 1) * per]:
                f.write(f"{t}#{'/X '.join(t.split())}/X#0.0#0.0\n")
        names.append(name)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    np.save(os.path.join(root, "Mean.npy"), (r.standard_normal(channels) * 0.1).astype(np.float32))
    np.save(os.path.join(root, "Std.npy"),
            (np.abs(r.standard_normal(channels)) * 0.5 + 0.5).astype(np.float32))
    return {"clips": n, "captions": len(texts), "bytes": nbytes}


XIA_STYLES = ("angry", "childlike", "depressed", "neutral", "old", "proud", "sexy", "strutting")
XIA_CONTENTS = ("normal walking", "running", "jumping", "punching", "kicking")


def write_xia_corpus(root: str, seed: int, mix: dict, channels: int) -> dict:
    """A Xia-layout corpus under root (new_joint_vecs/<3 digits><style>_
    <content>.npy (T, C) float32, Mean.npy, Std.npy): `clips` clips of
    min_frames to max_frames frames, styles and contents in turn, numbered
    from 100. The dataset names each clip's captions from its file name."""
    c = mix["corpus"]
    r = rng(seed, "corpus")
    os.makedirs(os.path.join(root, "new_joint_vecs"))
    nbytes = 0
    for i in range(c["clips"]):
        style = XIA_STYLES[i % len(XIA_STYLES)]
        content = XIA_CONTENTS[(i // len(XIA_STYLES)) % len(XIA_CONTENTS)]
        frames = int(r.integers(c["min_frames"], c["max_frames"] + 1))
        motion = (r.standard_normal((frames, channels), dtype=np.float32) * 0.5
                  + np.float32(0.1))
        np.save(os.path.join(root, "new_joint_vecs", f"{100 + i:03d}{style}_{content}.npy"),
                motion)
        nbytes += motion.nbytes
    np.save(os.path.join(root, "Mean.npy"), (r.standard_normal(channels) * 0.1).astype(np.float32))
    np.save(os.path.join(root, "Std.npy"),
            (np.abs(r.standard_normal(channels)) * 0.5 + 0.5).astype(np.float32))
    return {"clips": c["clips"], "bytes": nbytes}


CORPUS_WRITERS = {"humanml": write_humanml_corpus, "xia": write_xia_corpus}
