"""Dynamic request batching for serving (stdlib threading only).

Counterpart of motionstyle/serve/batcher.py. Serving traffic arrives one
clip at a time, but the card is used far better at batch > 1: the batcher
coalesces concurrent requests into padded device batches at fixed BUCKET
sizes, bounded by a wait deadline so a lone request never waits more than
`max_wait_ms`. All device work goes through one worker thread, one queue
feeding one card.
"""
from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Sequence


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (buckets sorted ascending; last is the cap)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _percentile_ms(xs, q: float) -> float:
    """Nearest-rank percentile of a latency window, in milliseconds."""
    if not xs:
        return 0.0
    s = sorted(xs)
    return round(s[min(len(s) - 1, int(q / 100.0 * len(s)))] * 1e3, 2)


# sliding observability window: enough for stable p99 under load, bounded
# so a long-lived server never grows its stats without limit
_WINDOW = 2048


@dataclass
class BatcherStats:
    requests: int = 0
    batches: int = 0
    padded_items: int = 0
    batch_sizes: list = field(default_factory=list)
    # per-request queue+device latency (submit -> future resolved) and
    # per-batch device time over the last _WINDOW observations
    latencies_s: deque = field(default_factory=lambda: deque(maxlen=_WINDOW))
    batch_seconds: deque = field(default_factory=lambda: deque(maxlen=_WINDOW))

    def as_dict(self) -> dict:
        lat = list(self.latencies_s)
        bt = list(self.batch_seconds)
        return {
            "requests": self.requests,
            "batches": self.batches,
            "padded_items": self.padded_items,
            "mean_batch_size": (sum(self.batch_sizes) / len(self.batch_sizes)
                                if self.batch_sizes else 0.0),
            "latency_p50_ms": _percentile_ms(lat, 50),
            "latency_p90_ms": _percentile_ms(lat, 90),
            "latency_p99_ms": _percentile_ms(lat, 99),
            "batch_p50_ms": _percentile_ms(bt, 50),
            "window": len(lat),
        }


class DynamicBatcher:
    """Coalesce submit()ed items into run_batch calls on a worker thread.

    run_batch(items: list) -> list of per-item results (same order/length).
    An Exception INSTANCE in the result list fails just that item's future
    (per-group isolation — serve/engine.py:_run_groups); an exception
    RAISED by run_batch propagates to every waiting future of the batch.
    """

    def __init__(self, run_batch: Callable, max_batch: int = 8,
                 max_wait_ms: float = 5.0,
                 buckets: Sequence[int] = (1, 2, 4, 8),
                 max_queue: int = 0):
        """max_queue > 0 bounds the admission queue: submits past the bound
        fail fast with RuntimeError (backpressure) instead of growing an
        unbounded backlog whose tail latency the client gave up on anyway."""
        assert max_batch <= max(buckets)
        self.run_batch = run_batch
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.buckets = tuple(sorted(buckets))
        self.stats = BatcherStats()
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        # guards the stop-check + enqueue pair in submit() against close():
        # without it an item enqueued between close()'s drain and the final
        # stop-set would leave its Future unresolved forever
        self._admit = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, item) -> Future:
        import time

        fut: Future = Future()
        with self._admit:
            if self._stop.is_set():
                raise RuntimeError("batcher is shut down")
            try:
                self._q.put_nowait((item, fut, time.monotonic()))
            except queue.Full:
                raise RuntimeError(
                    f"request queue full ({self._q.maxsize}); shed load or "
                    "raise max_queue") from None
        return fut

    def queue_depth(self) -> int:
        """Items admitted but not yet collected into a batch (approximate —
        the queue drains concurrently)."""
        return self._q.qsize()

    def close(self, drain_timeout: float = 600.0):
        """Stop admitting, let the worker FINISH its in-flight batch (up to
        drain_timeout), then fail anything still queued."""
        with self._admit:
            self._stop.set()
        try:
            self._q.put_nowait(None)  # wake the worker
        except queue.Full:
            pass
        self._thread.join(timeout=drain_timeout)
        if self._thread.is_alive():
            print(f"WARNING: batcher worker still busy after "
                  f"{drain_timeout:.0f}s drain; abandoning in-flight batch")
        while True:  # fail anything still queued instead of hanging waiters
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].done():
                item[1].set_exception(RuntimeError("batcher is shut down"))

    # -- worker ---------------------------------------------------------

    def _collect(self):
        """Block for the first item, then drain up to max_batch within the
        wait deadline."""
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        import time

        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _loop(self):
        import time

        while not self._stop.is_set():
            pairs = self._collect()
            if not pairs:
                continue
            items = [p[0] for p in pairs]
            self.stats.requests += len(items)
            self.stats.batches += 1
            self.stats.batch_sizes.append(len(items))
            self.stats.padded_items += bucket_for(len(items), self.buckets) - len(items)
            t_run = time.monotonic()
            try:
                results = self.run_batch(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"run_batch returned {len(results)} results for "
                        f"{len(items)} items")
            except Exception as ex:  # propagate to all waiters
                for _, fut, _t in pairs:
                    if not fut.done():
                        fut.set_exception(ex)
                continue
            done = time.monotonic()
            self.stats.batch_seconds.append(done - t_run)
            for (_, fut, t_enq), res in zip(pairs, results):
                self.stats.latencies_s.append(done - t_enq)
                if isinstance(res, Exception):
                    fut.set_exception(res)
                else:
                    fut.set_result(res)
