"""The training batches as the T2M data pipeline draws them (Guo et al.
2022's Text2MotionDatasetV2 without word vectors for HumanML3D; the style
datasets' window slicing for Xia; MDM's collate): the clips ordered by
length; one shuffled pass after another (numpy RandomState(0)); per clip a
caption drawn at random, a crop of whole 4-frame units (one unit shorter
one time in three) at a random offset (Python's `random`, seeded by the
caller), z-normalised and zero-padded, with its frame mask.

HumanML3D: clips of 40 to 199 frames, whole-clip captions (from and to tags
0) from texts/. Xia: every clip longer than the window cut into windows of
8 to 76 frames drawn from RandomState(0), one every 10 frames; captions
"<subject> <content> <style>" from the file name ("<3 digits><style>_
<content>.npy"), for the subjects "A person is", "A man is", "A figure is";
the clips of the published test split left out.
"""
from __future__ import annotations

import os
import random

import numpy as np

XIA_SUBJECTS = ("A person is", "A man is", "A figure is")
# the Xia set's held-out clips (the reference code's test split), not trained on
XIA_TEST = ('001angry_normal walking.npy', '278angry_running.npy', '350angry_jumping.npy',
    '393angry_punching.npy', '479angry_kicking.npy', '005childlike_normal walking.npy',
    '282childlike_running.npy', '353childlike_jumping.npy', '396childlike_punching.npy',
    '483childlike_kicking.npy', '009depressed_normal walking.npy',
    '286depressed_running.npy', '356depressed_jumping.npy', '399depressed_punching.npy',
    '487depressed_kicking.npy', '029neutral_normal walking.npy', '304neutral_running.npy',
    '368neutral_jumping.npy', '410neutral_punching.npy', '506neutral_kicking.npy',
    '021old_normal walking.npy', '297old_running.npy', '363old_jumping.npy',
    '406old_punching.npy', '499old_kicking.npy', '024proud_normal walking.npy',
    '300proud_running.npy', '366proud_jumping.npy', '409proud_punching.npy',
    '503proud_kicking.npy', '017sexy_normal walking.npy', '294sexy_running.npy',
    '360sexy_jumping.npy', '405sexy_punching.npy', '495sexy_kicking.npy',
    '012strutting_normal walking.npy', '290strutting_running.npy',
    '358strutting_jumping.npy', '402strutting_punching.npy', '491strutting_kicking.npy')


def humanml_clips(root: str, min_len: int = 40) -> list:
    with open(os.path.join(root, "train.txt")) as f:
        ids = [line.strip() for line in f if line.strip()]
    clips = []
    for name in ids:
        motion = np.load(os.path.join(root, "new_joint_vecs", name + ".npy"))
        if len(motion) < min_len or len(motion) >= 200:
            continue
        with open(os.path.join(root, "texts", name + ".txt")) as f:
            caps = [p[0] for p in (line.strip().split("#") for line in f)
                    if len(p) >= 4 and float(p[2] or 0) == 0.0 and float(p[3] or 0) == 0.0]
        if caps:
            clips.append((motion, caps))
    return clips


def xia_clips(root: str, window: int = 76, min_len: int = 8, offset: int = 10) -> list:
    rs = np.random.RandomState(0)
    clips = []
    motion_dir = os.path.join(root, "new_joint_vecs")
    for file in sorted(os.listdir(motion_dir)):
        if not file.endswith(".npy") or file in XIA_TEST:
            continue
        style, content = file.split("_")[0][3:], file.split("_")[1][:-4]
        caps = [f"{s} {content} {style}" for s in XIA_SUBJECTS]
        motion = np.load(os.path.join(motion_dir, file))
        if len(motion) < min_len:
            continue
        if len(motion) > window:
            i, n = 0, int(rs.randint(min_len, window + 1))
            while i + n < len(motion):
                clips.append((motion[i:i + n], caps))
                n = int(rs.randint(min_len, window + 1))
                i += offset
        else:
            clips.append((motion[:int(rs.randint(min_len, len(motion) + 1))], caps))
    return clips


class Batches:
    def __init__(self, root: str, batch: int, py_seed: int, max_len: int = 196,
                 layout: str = "humanml", unit: int = 4):
        self.batch, self.max_len, self.unit = batch, max_len, unit
        self.mean = np.load(os.path.join(root, "Mean.npy"))
        self.std = np.load(os.path.join(root, "Std.npy"))
        clips = humanml_clips(root) if layout == "humanml" else xia_clips(root, max_len)
        order = np.argsort([len(m) for m, _ in clips], kind="stable")
        self.clips = [clips[i] for i in order]
        self.shuffle = np.random.RandomState(0)
        self.py = random.Random(py_seed)
    def __iter__(self):
        while True:
            idx = np.arange(len(self.clips))
            self.shuffle.shuffle(idx)
            for s in range(0, len(idx) - (self.batch - 1), self.batch):
                yield self._collate([self._item(int(i)) for i in idx[s:s + self.batch]])

    def _item(self, i: int):
        motion, caps = self.clips[i]
        caption = self.py.choice(caps)
        double = self.py.choice(["single", "single", "double"]) == "double"
        m = (len(motion) // self.unit - (1 if double else 0)) * self.unit
        off = self.py.randint(0, len(motion) - m)
        clip = (motion[off:off + m] - self.mean) / self.std
        out = np.zeros((self.max_len, clip.shape[1]), np.float32)
        out[:m] = clip
        return caption, out, m

    def _collate(self, items):
        x = np.stack([it[1].T[:, None, :] for it in items]).astype(np.float32)
        lengths = np.asarray([it[2] for it in items])
        mask = (np.arange(self.max_len)[None] < lengths[:, None]).astype(np.float32)
        return x, [it[0] for it in items], mask[:, None, None, :]
