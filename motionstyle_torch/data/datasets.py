"""The style dataset for the finetune: Xia clips as host-side numpy, z-normed
and padded (counterpart of motionstyle/data/datasets.py, whose module the
port keeps its own copy of; parity: StyleXia in
data_loaders/humanml/data/dataset.py:207-553).

Only stylexia_posrot is on this slice; the humanml and bandai loaders wait
(ROADMAP §1 item 10).
"""
from __future__ import annotations

import os
import random
from dataclasses import dataclass
from os.path import join as pjoin
from typing import Optional

import numpy as np

STYLEXIA_TEST_LIST = [
    "001angry_normal walking.npy", "278angry_running.npy", "350angry_jumping.npy",
    "393angry_punching.npy", "479angry_kicking.npy", "005childlike_normal walking.npy",
    "282childlike_running.npy", "353childlike_jumping.npy", "396childlike_punching.npy",
    "483childlike_kicking.npy", "009depressed_normal walking.npy", "286depressed_running.npy",
    "356depressed_jumping.npy", "399depressed_punching.npy", "487depressed_kicking.npy",
    "029neutral_normal walking.npy", "304neutral_running.npy", "368neutral_jumping.npy",
    "410neutral_punching.npy", "506neutral_kicking.npy", "021old_normal walking.npy",
    "297old_running.npy", "363old_jumping.npy", "406old_punching.npy", "499old_kicking.npy",
    "024proud_normal walking.npy", "300proud_running.npy", "366proud_jumping.npy",
    "409proud_punching.npy", "503proud_kicking.npy", "017sexy_normal walking.npy",
    "294sexy_running.npy", "360sexy_jumping.npy", "405sexy_punching.npy",
    "495sexy_kicking.npy", "012strutting_normal walking.npy", "290strutting_running.npy",
    "358strutting_jumping.npy", "402strutting_punching.npy", "491strutting_kicking.npy",
]


@dataclass
class DataOpt:
    """Per-dataset options; parity with get_opt.py:29-106 hard-coded dims."""

    dataset_name: str
    data_root: str
    joints_num: int
    dim_pose: int
    max_motion_length: int
    unit_length: int = 4
    max_text_len: int = 20

    @property
    def motion_dir(self) -> str:
        return pjoin(self.data_root, "new_joint_vecs")


def get_opt(dataset_name: str, data_root: Optional[str] = None) -> DataOpt:
    if dataset_name != "stylexia_posrot":
        raise NotImplementedError(
            f"dataset {dataset_name!r} is not ported to motionstyle_torch "
            "(ROADMAP §1 item 10: humanml and bandai loaders); use stylexia_posrot")
    return DataOpt(dataset_name, data_root or "./processed_data/style_xia/", 20, 181, 76)


class StyleMotionDataset:
    """StyleXia: filename -> (style, content), caption synthesis, window
    slicing of long clips, z-norm and padding (dataset.py:384-553)."""

    SUBJECTS = ["A person is", "A man is", "A figure is"]

    def __init__(self, opt: DataOpt, split: str = "train", offset: int = 10,
                 rng: Optional[np.random.RandomState] = None):
        self.opt = opt
        self.max_motion_length = opt.max_motion_length
        self.rng = rng or np.random.RandomState(0)
        min_motion_len = 8  # dataset.py:387
        if split == "eval":
            split = "test"
        self.mean = np.load(pjoin(opt.data_root, "Mean.npy"))
        self.std = np.load(pjoin(opt.data_root, "Std.npy"))

        data_dict, name_list, length_list = {}, [], []
        for file in sorted(os.listdir(opt.motion_dir)):
            if not file.endswith(".npy"):
                continue
            style = file.split("_")[0][3:]
            content = file.split("_")[1][:-4]
            if (split == "train") == (file in STYLEXIA_TEST_LIST):
                continue
            try:
                motion = np.load(pjoin(opt.motion_dir, file))
            except (OSError, ValueError):
                continue
            if len(motion) < min_motion_len:
                continue
            text_data = [{"caption": f"{s} {content} {style}"} for s in self.SUBJECTS]

            def _add(name, sub_motion, sub_len):
                data_dict[name] = {"motion": sub_motion, "length": sub_len, "text": text_data,
                                   "style_name": style, "content": content}
                name_list.append(name)
                length_list.append(sub_len)

            if len(motion) > opt.max_motion_length:
                i = 0
                rand_len = int(self.rng.randint(min_motion_len, opt.max_motion_length + 1))
                while i + rand_len < len(motion):
                    _add(f"{file}_{i}", motion[i: i + rand_len], rand_len)
                    rand_len = int(self.rng.randint(min_motion_len, opt.max_motion_length + 1))
                    i += offset
            else:
                rand_len = int(self.rng.randint(min_motion_len, len(motion) + 1))
                _add(file, motion[:rand_len], rand_len)

        order = np.argsort(length_list, kind="stable")
        self.name_list = [name_list[i] for i in order]
        self.length_arr = np.array([length_list[i] for i in order])
        self.data_dict = data_dict

    def __len__(self):
        return len(self.name_list)

    def inv_transform(self, data):
        return data * self.std + self.mean

    def transform(self, data):
        return (data - self.mean) / self.std

    def _pad(self, motion: np.ndarray) -> np.ndarray:
        if len(motion) < self.max_motion_length:
            motion = np.concatenate(
                [motion, np.zeros((self.max_motion_length - len(motion), motion.shape[1]))], 0)
        return motion

    def process_np_motion(self, motion_path):
        """One clip (a path or an array), z-normed, padded or trimmed to the
        max length: (motion (L, D), m_length). Parity: dataset.py:484-519."""
        data = np.load(motion_path) if isinstance(motion_path, str) else motion_path
        m_length = min(data.shape[0], self.max_motion_length)
        motion = self._pad(self.transform(data))[: self.max_motion_length]
        return motion, m_length

    def __getitem__(self, item):
        """(caption, z-normed padded motion, length, style name): a random
        caption and a unit-length crop at a random start (dataset.py:522-553)."""
        d = self.data_dict[self.name_list[item]]
        motion, m_length = d["motion"], d["length"]
        caption = random.choice(d["text"])["caption"]
        coin2 = random.choice(["single", "single", "double"]) if self.opt.unit_length < 10 \
            else "single"
        units = m_length // self.opt.unit_length - (1 if coin2 == "double" else 0)
        m_length = units * self.opt.unit_length
        idx = random.randint(0, len(motion) - m_length)
        motion = self._pad(self.transform(motion[idx: idx + m_length]))
        return caption, motion, m_length, d["style_name"]
