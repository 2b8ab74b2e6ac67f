"""Motion datasets as host-side numpy: the style datasets (StyleXia and
Bandai) and HumanML3D (counterpart of motionstyle/data/datasets.py, whose
module the port keeps its own copy of).

Parity targets:
  - StyleXia / BandaiDataset caption synthesis + window slicing + z-norm
    (data_loaders/humanml/data/dataset.py:207-553)
  - Text2MotionDatasetV2 (HumanML3D) caption/token sampling + unit-length
    crop (dataset.py:558-739), without the GloVe word vectors: the T2M
    evaluator embeds the captions itself (eval/evaluators.py::WordVectorizer,
    eval/motion_loaders.py::embed_texts), as in the JAX package
  - process_np_motion / inv_transform (dataset.py:484-519, 641-684)
  - get_opt's per-dataset table and opt.txt parsing (get_opt.py:29-106)
  - the stylexia test split (dataset/stylexia_split.py — data, not code)

The random draws (a clip's caption, the unit-length crop and its start) come
from Python's `random` module, the window lengths of long clips from the
dataset's np.random.RandomState: the same calls in the same order as the JAX
package's, so one seed gives both packages the same items.
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

    @property
    def text_dir(self) -> str:
        return pjoin(self.data_root, "texts")


def parse_opt_file(opt_path: str) -> dict:
    """Parse a key: value opt.txt into a dict with bool/float/int coercion.

    Parity: data_loaders/humanml/utils/get_opt.py:29-50 (including its quirk
    that 'True'/'False' both coerce to bool('True'/'False') == True).
    """
    skip = ("-------------- End ----------------", "------------ Options -------------")
    out = {}
    with open(opt_path) as f:
        for line in f:
            line = line.strip()
            if not line or line in skip:
                continue
            key, value = line.split(": ", 1)
            if value in ("True", "False"):
                out[key] = bool(value)
            else:
                try:
                    out[key] = int(value)
                except ValueError:
                    try:
                        out[key] = float(value)
                    except ValueError:
                        out[key] = value
    return out


def get_opt(dataset_name: str, data_root: Optional[str] = None,
            opt_path: Optional[str] = None) -> DataOpt:
    table = {
        "t2m": ("./processed_data/HumanML3D", 22, 263, 196),
        "humanml": ("./processed_data/HumanML3D", 22, 263, 196),
        "kit": ("./processed_data/KIT-ML", 21, 251, 196),
        "bandai-1_posrot": ("./processed_data/bandai-1/", 21, 190, 196),
        "bandai-2_posrot": ("./processed_data/bandai-2/", 21, 190, 196),
        "stylexia_posrot": ("./processed_data/style_xia/", 20, 181, 76),
    }
    if dataset_name not in table:
        raise KeyError(f"Dataset not recognized: {dataset_name}")
    root, j, d, m = table[dataset_name]
    opt = DataOpt(dataset_name, data_root or root, j, d, m)
    if opt_path and os.path.exists(opt_path):
        parsed = parse_opt_file(opt_path)
        for key in ("unit_length", "max_text_len"):
            if key in parsed:
                setattr(opt, key, parsed[key])
    return opt


class _BaseMotionDataset:
    """Shared z-norm / padding helpers (dataset.py:478-519 semantics)."""

    mean: np.ndarray
    std: np.ndarray
    max_motion_length: int

    @property
    def t2m_dataset(self):
        """API parity: the reference wraps the inner dataset as
        data.dataset.t2m_dataset (dataset.py:1176+); here they are one."""
        return self

    def inv_transform(self, data):
        return data * self.std + self.mean

    def transform(self, data):
        return (data - self.mean) / self.std

    def process_np_motion(self, motion_path):
        """Load one clip, z-normalize, pad/trim to max length.

        Returns (motion (L, D), m_length). Parity: dataset.py:484-519.
        """
        if isinstance(motion_path, str):
            data = np.load(motion_path)
        else:
            data = motion_path
        motion = data
        m_length = data.shape[0]
        motion = (motion - self.mean) / self.std
        if m_length < self.max_motion_length:
            motion = np.concatenate(
                [motion, np.zeros((self.max_motion_length - m_length, motion.shape[1]))], axis=0
            )
        if m_length > self.max_motion_length:
            motion = motion[: self.max_motion_length]
            m_length = self.max_motion_length
        return motion, m_length


class StyleMotionDataset(_BaseMotionDataset):
    """StyleXia / Bandai: filename -> (style, content), caption synthesis,
    window slicing of long clips. One class, parameterized by naming scheme.
    """

    SUBJECTS_XIA = ["A person is", "A man is", "A figure is"]
    SUBJECTS_BANDAI = ["A person", "A man", "A figure"]

    def __init__(self, opt: DataOpt, split: str = "train", offset: Optional[int] = None,
                 rng: Optional[np.random.RandomState] = None):
        self.opt = opt
        self.max_motion_length = opt.max_motion_length
        self.rng = rng or np.random.RandomState(0)
        is_xia = opt.dataset_name == "stylexia_posrot"
        offset = offset if offset is not None else (10 if is_xia else 40)
        # reference: StyleXia min=8 (dataset.py:387); BandaiDataset:213 is
        # `40 if dataset_name in ['bandai-1','bandai-2'] else 24` — the
        # posrot names this framework serves fall through to 24
        min_motion_len = 8 if is_xia else 24
        subjects = self.SUBJECTS_XIA if is_xia else self.SUBJECTS_BANDAI
        if split == "eval":
            split = "test"
        test_list = STYLEXIA_TEST_LIST if is_xia else self._load_test_list(opt)

        self.mean = np.load(pjoin(opt.data_root, "Mean.npy"))
        self.std = np.load(pjoin(opt.data_root, "Std.npy"))

        data_dict = {}
        name_list, length_list = [], []
        for file in sorted(os.listdir(opt.motion_dir)):
            if not file.endswith(".npy"):
                continue
            if is_xia:
                style = file.split("_")[0][3:]
                content = file.split("_")[1][:-4]
                description = content + " " + style
            else:
                style = file.split("_")[-2]
                content_parts = file.split("_")[-3].split("-")
                content_parts[0] += "s"
                content = " ".join(content_parts)
                description = content + " " + style.replace("-", " ")
            if split == "train" and file in test_list:
                continue
            if split != "train" and file not in test_list:
                continue
            try:
                motion = np.load(pjoin(opt.motion_dir, file))
            except (OSError, ValueError):
                continue
            if len(motion) < min_motion_len:
                continue
            text_data = [{"caption": f"{s} {description}"} for s in subjects]

            def _add(name, sub_motion, sub_len):
                data_dict[name] = {
                    "motion": sub_motion, "length": sub_len, "text": text_data,
                    "style_name": style, "content": content,
                }
                name_list.append(name)
                length_list.append(sub_len)

            if len(motion) > opt.max_motion_length:
                i = 0
                rand_len = int(self.rng.randint(min_motion_len, opt.max_motion_length + 1))
                while i + rand_len < len(motion):
                    _add(f"{file}_{i}", motion[i : i + rand_len], rand_len)
                    rand_len = int(self.rng.randint(min_motion_len, opt.max_motion_length + 1))
                    i += offset
            else:
                rand_len = int(self.rng.randint(min_motion_len, len(motion) + 1))
                _add(file, motion[:rand_len], rand_len)

        order = np.argsort(length_list, kind="stable")
        self.name_list = [name_list[i] for i in order]
        self.length_arr = np.array([length_list[i] for i in order])
        self.data_dict = data_dict
        if not self.name_list and split == "test":
            # permissive here (the demo builds a test-split dataset just for
            # its normalization stats); consumers that ITERATE an empty
            # eval set must fail loudly instead (cli/eval_metrics.py)
            print(f"WARNING: {opt.dataset_name} test split is empty")

    @staticmethod
    def _load_test_list(opt: DataOpt) -> list:
        path = pjoin(os.path.dirname(opt.data_root.rstrip("/")), "splits",
                     f"{opt.dataset_name}_test.txt")
        if os.path.exists(path):
            with open(path) as f:
                return [l.strip() for l in f if l.strip()]
        print(f"WARNING: no bandai split file at {path}; the reference pins "
              "its held-out clips in dataset/bandaiN_split.py — without it "
              "the test split is EMPTY and train uses every clip")
        return []

    def __len__(self):
        return len(self.name_list)

    def sample_spec(self, item):
        """The per-item RANDOM decisions only (caption pick, unit-length
        crop, window start) — no array work. Shared by __getitem__ and the
        native batch loader (native/loader.py), so both consume the `random`
        stream identically; parity: dataset.py:522-553."""
        d = self.data_dict[self.name_list[item]]
        motion, m_length = d["motion"], d["length"]
        caption = random.choice(d["text"])["caption"]
        if self.opt.unit_length < 10:
            coin2 = random.choice(["single", "single", "double"])
        else:
            coin2 = "single"
        if coin2 == "double":
            m_length = (m_length // self.opt.unit_length - 1) * self.opt.unit_length
        else:
            m_length = (m_length // self.opt.unit_length) * self.opt.unit_length
        idx = random.randint(0, len(motion) - m_length)
        return d, caption, idx, m_length

    def __getitem__(self, item):
        """Returns (caption, z-normed padded motion, length, style_name);
        parity: dataset.py:522-553 (unit-length crop + random sub-window)."""
        d, caption, idx, m_length = self.sample_spec(item)
        motion = d["motion"][idx : idx + m_length]
        motion = (motion - self.mean) / self.std
        if m_length < self.max_motion_length:
            motion = np.concatenate(
                [motion, np.zeros((self.max_motion_length - m_length, motion.shape[1]))], axis=0
            )
        return caption, motion, m_length, d["style_name"]


class Text2MotionDataset(_BaseMotionDataset):
    """HumanML3D-style dataset (caption files with tokens + f/to tags).

    Parity: Text2MotionDatasetV2 (dataset.py:558-739), minus the GloVe word
    vectors: only the T2M evaluator needs them, and it embeds the captions
    itself (eval/evaluators.py::WordVectorizer, eval/motion_loaders.py::
    embed_texts).
    """

    def __init__(self, opt: DataOpt, split: str = "train", mode: str = "train",
                 eval_meta_dir: Optional[str] = None):
        self.opt = opt
        self.mode = mode
        self.max_motion_length = opt.max_motion_length
        min_motion_len = 40 if opt.dataset_name in ("t2m", "humanml") else 24

        self.mean = np.load(pjoin(opt.data_root, "Mean.npy"))
        self.std = np.load(pjoin(opt.data_root, "Std.npy"))
        # T2M evaluator re-norm stats (dataset.py:1145-1149): generated
        # motions are re-normalized into these before FID/R-precision.
        meta = eval_meta_dir or pjoin("t2m", "Comp_v6_KLD01", "meta")
        if os.path.exists(pjoin(meta, "mean.npy")):
            self.mean_for_eval = np.load(pjoin(meta, "mean.npy"))
            self.std_for_eval = np.load(pjoin(meta, "std.npy"))

        split_file = pjoin(opt.data_root, f"{split}.txt")
        id_list = []
        if os.path.exists(split_file):
            with open(split_file) as f:
                id_list = [l.strip() for l in f if l.strip()]

        data_dict, name_list, length_list = {}, [], []
        for name in id_list:
            try:
                motion = np.load(pjoin(opt.motion_dir, name + ".npy"))
            except (OSError, ValueError):
                continue
            if len(motion) < min_motion_len or len(motion) >= 200:
                continue
            text_data, flag = [], False
            text_path = pjoin(opt.text_dir, name + ".txt")
            if not os.path.exists(text_path):
                continue
            with open(text_path) as f:
                for line in f:
                    parts = line.strip().split("#")
                    if len(parts) < 4:
                        continue
                    caption, tokens = parts[0], parts[1].split(" ")
                    f_tag = 0.0 if parts[2] in ("nan", "") else float(parts[2])
                    to_tag = 0.0 if parts[3] in ("nan", "") else float(parts[3])
                    td = {"caption": caption, "tokens": tokens}
                    if f_tag == 0.0 and to_tag == 0.0:
                        flag = True
                        text_data.append(td)
                    else:
                        n_motion = motion[int(f_tag * 20) : int(to_tag * 20)]
                        if len(n_motion) < min_motion_len or len(n_motion) >= 200:
                            continue
                        new_name = f"{len(data_dict):06d}_{name}"
                        data_dict[new_name] = {"motion": n_motion, "length": len(n_motion),
                                               "text": [td]}
                        name_list.append(new_name)
                        length_list.append(len(n_motion))
            if flag:
                data_dict[name] = {"motion": motion, "length": len(motion), "text": text_data}
                name_list.append(name)
                length_list.append(len(motion))

        order = np.argsort(length_list, kind="stable")
        self.name_list = [name_list[i] for i in order]
        self.length_arr = np.array([length_list[i] for i in order])
        self.data_dict = data_dict

    def __len__(self):
        return len(self.name_list)

    def __getitem__(self, item):
        name = self.name_list[item]
        d = self.data_dict[name]
        motion, m_length = d["motion"], d["length"]
        td = random.choice(d["text"])
        caption, tokens = td["caption"], td["tokens"]
        if self.opt.unit_length < 10:
            coin2 = random.choice(["single", "single", "double"])
        else:
            coin2 = "single"
        if coin2 == "double":
            m_length = (m_length // self.opt.unit_length - 1) * self.opt.unit_length
        else:
            m_length = (m_length // self.opt.unit_length) * self.opt.unit_length
        idx = random.randint(0, len(motion) - m_length)
        motion = motion[idx : idx + m_length]
        motion = (motion - self.mean) / self.std
        if m_length < self.max_motion_length:
            motion = np.concatenate(
                [motion, np.zeros((self.max_motion_length - m_length, motion.shape[1]))], axis=0
            )
        return caption, motion, m_length, "_".join(tokens), name
