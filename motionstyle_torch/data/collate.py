"""Batch assembly: (motion (B, C, 1, T), cond {'y': {...}}) numpy batches
from a shuffled iterator, for the style datasets and HumanML3D (counterpart
of motionstyle/data/collate.py; parity: data_loaders/tensors.py
lengths_to_mask :3, collate :22, t2m_collate :78, t2m_style_collate :90, and
the DataLoader wrapper get_data.py:43-53). With native=True the style
datasets assemble their batches in C++ (native/loader.py, --native_loader),
and prefetch=N keeps N batches ready in a background thread (--prefetch).
"""
from __future__ import annotations

import numpy as np

from motionstyle_torch.data.datasets import StyleMotionDataset, Text2MotionDataset, get_opt


def lengths_to_mask(lengths: np.ndarray, max_len: int) -> np.ndarray:
    return (np.arange(max_len)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)


def collate(samples: list) -> tuple:
    """samples: list of dicts with 'inp' (C, 1, T) [+ text/lengths/...].

    Returns (motion (B, C, 1, T) float32, cond {'y': {mask, lengths, ...}}).
    mask has shape (B, 1, 1, T) for broadcasting, like tensors.py:32.
    """
    samples = [s for s in samples if s is not None]
    motion = np.stack([np.asarray(s["inp"], dtype=np.float32) for s in samples])
    if "lengths" in samples[0]:
        lengths = np.asarray([s["lengths"] for s in samples])
    else:
        lengths = np.asarray([s["inp"].shape[-1] for s in samples])
    mask = lengths_to_mask(lengths, motion.shape[-1])[:, None, None, :]
    cond = {"y": {"mask": mask, "lengths": lengths}}
    for key in ("text", "tokens", "file_name", "style", "action_text"):
        if key in samples[0]:
            cond["y"][key] = [s[key] for s in samples]
    if "action" in samples[0]:
        cond["y"]["action"] = np.asarray([s["action"] for s in samples])[:, None]
    return motion, cond


def t2m_collate(batch: list) -> tuple:
    """HumanML3D item tuples -> batch; parity: tensors.py:78-87."""
    return collate(
        [
            {
                "inp": np.asarray(b[1], dtype=np.float32).T[:, None, :],  # (T,D)->(D,1,T)
                "text": b[0],
                "lengths": b[2],
                "tokens": b[3],
                "file_name": b[4],
            }
            for b in batch
        ]
    )


def t2m_style_collate(batch: list) -> tuple:
    """Style dataset item tuples -> batch; parity: tensors.py:90-97."""
    return collate(
        [
            {
                "inp": np.asarray(b[1], dtype=np.float32).T[:, None, :],
                "text": b[0],
                "lengths": b[2],
                "style": b[3],
            }
            for b in batch
        ]
    )


class DataLoader:
    """Minimal shuffled batch iterator with drop_last, numpy end to end."""

    def __init__(self, dataset, batch_size: int, collate_fn, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        stop = len(idx) - (self.batch_size - 1 if self.drop_last else 0)
        for s in range(0, stop, self.batch_size):
            chunk = idx[s : s + self.batch_size]
            yield self.collate_fn([self.dataset[int(i)] for i in chunk])


def get_dataset(name: str, num_frames: int, split: str = "train", data_root=None):
    opt = get_opt(name, data_root)
    if name in ("humanml", "t2m", "kit"):
        return Text2MotionDataset(opt, split=split)
    if name in ("bandai-1_posrot", "bandai-2_posrot", "stylexia_posrot"):
        return StyleMotionDataset(opt, split=split)
    raise ValueError(f"Unsupported dataset name [{name}]")


def get_dataset_loader(name: str, batch_size: int, num_frames: int, split: str = "train",
                       shuffle: bool = True, data_root=None, native: bool = False,
                       prefetch: int = 0):
    """Parity: get_data.py:43-53, the in-process numpy iterator; `native`
    swaps in the C++ batch assembly of the style datasets
    (motionstyle_torch/native/loader.py) and `prefetch` overlaps assembly
    with the device step, as motionstyle/data/collate.py:106-139 does. Where
    the JAX package warns and uses numpy when its library is unavailable, a
    native loader that does not build or load raises here with the reason."""
    dataset = get_dataset(name, num_frames, split, data_root)
    loader = None
    if native:
        if name not in ("bandai-1_posrot", "bandai-2_posrot", "stylexia_posrot"):
            print(f"WARNING: --native_loader covers the style datasets only; "
                  f"'{name}' uses the numpy path")
        else:
            from motionstyle_torch.native.ingest import load_library
            from motionstyle_torch.native.loader import NativeStyleLoader

            load_library()  # raises with the compiler's message
            loader = NativeStyleLoader(dataset, batch_size, shuffle=shuffle, drop_last=True)
    if loader is None:
        # kit items carry (caption, motion, len, tokens, name) like t2m
        collate_fn = t2m_collate if name in ("humanml", "t2m", "kit") else t2m_style_collate
        loader = DataLoader(dataset, batch_size, collate_fn, shuffle=shuffle, drop_last=True)
    if prefetch > 0:
        from motionstyle_torch.native.loader import PrefetchLoader

        loader = PrefetchLoader(loader, depth=prefetch)
    return loader


def require_batches(loader: DataLoader, what: str) -> DataLoader:
    """Fail loudly when a training loader yields no full batches — a
    `while steps: for batch in loader` loop would otherwise spin forever
    (e.g. humanml without train.txt/texts/, or batch_size > dataset)."""
    if len(loader) == 0:
        raise SystemExit(
            f"{what}: dataset yields no full batches ({len(loader.dataset)} "
            f"items, batch_size {loader.batch_size}). For humanml-style "
            "datasets check <data_root>/train.txt and <data_root>/texts/; "
            "otherwise lower --batch_size")
    return loader
