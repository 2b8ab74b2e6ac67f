"""Native-backed data loaders (the port's own copy of
motionstyle/native/loader.py).

NativeStyleLoader stands in for data.collate.DataLoader + t2m_style_collate
over a StyleMotionDataset: the per-item random decisions run through the
dataset's own sample_spec (the same `random` stream), while the array work
(crop, normalise, pad, transpose, stack, mask) is one multithreaded C++ call
(native/ingest.py). Its batches equal the numpy path's to float32 rounding.
They stay host numpy arrays, as the numpy path's do: the trainers copy them
to the card.

PrefetchLoader overlaps host batch assembly with the device step: a
background thread keeps up to `depth` ready batches in a queue, the role the
reference's torch DataLoader workers play (get_data.py:43-53).
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from motionstyle_torch.data.collate import DataLoader
from motionstyle_torch.native.ingest import lengths_to_mask, window_normalize_collate


class NativeStyleLoader(DataLoader):
    """Shuffled batch iterator over a StyleMotionDataset with native batch
    assembly; shares DataLoader's shuffle, len and drop_last."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, nthreads: int = 0):
        super().__init__(dataset, batch_size, collate_fn=None, shuffle=shuffle,
                         drop_last=drop_last, seed=seed)
        self.nthreads = nthreads

    def _assemble(self, idx_chunk) -> tuple:
        ds = self.dataset
        specs = [ds.sample_spec(int(i)) for i in idx_chunk]
        motion = window_normalize_collate(
            [d["motion"] for d, _, _, _ in specs], [start for _, _, start, _ in specs],
            [m_len for _, _, _, m_len in specs], ds.max_motion_length, ds.mean, ds.std,
            nthreads=self.nthreads)
        lengths = np.asarray([m_len for _, _, _, m_len in specs])
        cond = {"y": {
            "mask": lengths_to_mask(lengths, ds.max_motion_length),
            "lengths": lengths,
            "text": [caption for _, caption, _, _ in specs],
            "style": [d["style_name"] for d, _, _, _ in specs],
        }}
        return motion, cond

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        stop = len(idx) - (self.batch_size - 1 if self.drop_last else 0)
        for s in range(0, stop, self.batch_size):
            yield self._assemble(idx[s:s + self.batch_size])


class PrefetchLoader:
    """Wraps any batch iterable: a producer thread stays `depth` batches
    ahead. The order is unchanged, and an exception of the producer re-raises
    where the consumer takes the next batch."""

    _DONE = object()

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    @property
    def dataset(self):
        return self.loader.dataset

    @property
    def batch_size(self):
        return self.loader.batch_size

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        err: list = []

        def put(item) -> bool:
            # a bounded put that gives up once the consumer has left (the
            # training loops break on their last step)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for batch in self.loader:
                    if not put(batch):
                        return
            except BaseException as ex:  # noqa: BLE001 — re-raised by the consumer
                err.append(ex)
            finally:
                put(self._DONE)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()  # on a break or an error: end the producer
            t.join(timeout=5)
