"""Batch assembly for the style dataset: (motion (B, C, 1, T), cond {'y':
{...}}) numpy batches from a shuffled iterator (counterpart of
motionstyle/data/collate.py; parity: data_loaders/tensors.py
lengths_to_mask :3, collate :22, t2m_style_collate :90, get_data.py:43-53).
"""
from __future__ import annotations

import numpy as np

from motionstyle_torch.data.datasets import StyleMotionDataset, get_opt


def lengths_to_mask(lengths, max_len: int) -> np.ndarray:
    return (np.arange(max_len)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)


def t2m_style_collate(batch: list) -> tuple:
    """Style dataset items -> (motion (B, C, 1, T) float32, cond): mask
    (B, 1, 1, T), lengths, text, style."""
    motion = np.stack([np.asarray(b[1], dtype=np.float32).T[:, None, :] for b in batch])
    lengths = np.asarray([b[2] for b in batch])
    cond = {"y": {"mask": lengths_to_mask(lengths, motion.shape[-1])[:, None, None, :],
                  "lengths": lengths, "text": [b[0] for b in batch],
                  "style": [b[3] for b in batch]}}
    return motion, cond


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
            yield self.collate_fn([self.dataset[int(i)] for i in idx[s: s + self.batch_size]])


def get_dataset_loader(name: str, batch_size: int, split: str = "train", shuffle: bool = True,
                       data_root=None) -> DataLoader:
    dataset = StyleMotionDataset(get_opt(name, data_root), split=split)
    return DataLoader(dataset, batch_size, t2m_style_collate, shuffle=shuffle, drop_last=True)


def require_batches(loader: DataLoader, what: str) -> DataLoader:
    """Fail loudly when a training loader yields no full batches (a
    `while steps: for batch in loader` loop would otherwise spin forever)."""
    if len(loader) == 0:
        raise SystemExit(
            f"{what}: dataset yields no full batches ({len(loader.dataset)} items, "
            f"batch_size {loader.batch_size}); lower --batch_size")
    return loader
