"""Serving engine: dynamic batching over the one-device Sampler with a
batching-invariant sampling contract.

Counterpart of motionstyle/serve/engine.py. Contract: a request's result
depends only on its own payload and `seed`, never on what other requests
shared its device batch or on the bucket padding, within one bucket shape:

  1. every stochastic draw is pinned per item: the initial noise (and the
     per-step noise stack, where the chain uses one) comes from a
     torch.Generator on the device seeded with the request's seed
     (Sampler.item_noise), fed through sample_loop's noise/step_noise hooks;
  2. every model op is batch-elementwise (LayerNorm and attention reduce over
     feature and time axes only), so co-batched items cannot mix;
  3. batches are padded to fixed bucket sizes by repeating the first item
     (pad results are discarded).

The JAX package derives its noise from threefry (fold_in(PRNGKey(seed),
0/1)); torch's generators give other numbers, so the same seed gives a
different sample in the two packages. The contract is invariance within
this package, not bit-equality with JAX.

Precision: across bucket shapes the library matmuls around the kernel may
pick other algorithms, so the same request served in two bucket sizes can
differ by rounding. deterministic=True collapses the buckets to the largest
one, so every request is served in one shape.

Named styles (styles=): each a style-encoder state dict that the sampler
turns into a view of its model once (Sampler.prepare_params); a device batch
serves exactly one style (the style is part of _compat_key), so a style's
answer equals a single-style engine's within a bucket shape. The sampler may
also be an exported artifact (serve/export.py::ExportedSampler).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from motionstyle_torch.diffusion.ddpm import Inpainting
from motionstyle_torch.serve.batcher import DynamicBatcher, bucket_for


class Request:
    """One sampling request: cond entries are per-item arrays (no batch
    axis); init_image (C, F, T); inpainting_mask optional (C, F, T); style
    names a style registered with the engine (None = the sampler's own
    model)."""

    def __init__(self, cond: dict, init_image: Optional[np.ndarray] = None,
                 inpainting_mask: Optional[np.ndarray] = None, seed: int = 0,
                 style: Optional[str] = None):
        self.cond = cond
        self.init_image = init_image
        self.inpainting_mask = inpainting_mask
        self.seed = int(seed)
        self.style = style


class ServingEngine:
    """Wraps a Sampler (or an ExportedSampler) in a DynamicBatcher.
    item_shape: (C, F, T) of one clip; dump_pick: which entry of a
    dump_all_xstart stack to serve (pair it with the sampler's
    stop_timesteps via sampling.min_latency_plan); styles: {name:
    style-encoder state dict} served by a request's "style"."""

    def __init__(self, sampler, item_shape: tuple, max_batch: int = 8,
                 max_wait_ms: float = 5.0, buckets: Sequence[int] = (1, 2, 4, 8),
                 deterministic: bool = False, max_queue: int = 0,
                 dump_pick: int = -1, styles: Optional[dict] = None):
        self.sampler = sampler
        self.item_shape = tuple(item_shape)
        self.dump_pick = dump_pick
        self.buckets = tuple(sorted(buckets))
        # named styles, each placed on the sampler's device once
        self._styles = {name: sampler.prepare_params(state)
                        for name, state in (styles or {}).items()}
        if deterministic:
            self.buckets = (self.buckets[-1],)
        self._batcher = DynamicBatcher(self._run_groups, max_batch=max_batch,
                                       max_wait_ms=max_wait_ms, buckets=self.buckets,
                                       max_queue=max_queue)

    # -- public API -----------------------------------------------------

    def submit(self, request: Request):
        """Returns a concurrent.futures.Future resolving to (C, F, T)."""
        if request.style is not None and request.style not in self._styles:
            raise ValueError(f"unknown style {request.style!r}; registered: "
                             f"{sorted(self._styles)}")
        for name in ("init_image", "inpainting_mask"):
            arr = getattr(request, name)
            if arr is not None and tuple(np.shape(arr)) != self.item_shape:
                raise ValueError(f"{name} must have shape {self.item_shape}, "
                                 f"got {tuple(np.shape(arr))}")
        if request.inpainting_mask is not None and request.init_image is None:
            raise ValueError("inpainting_mask requires init_image")
        return self._batcher.submit(request)

    def sample(self, request: Request) -> np.ndarray:
        return self.submit(request).result()

    def warmup(self, example: Request, log: bool = True) -> dict:
        """Run every reachable bucket once with copies of `example` before
        taking traffic (first-use costs: kernel build and load, allocator
        growth, library heuristics). Returns {bucket_size: seconds}."""
        import time

        reachable = bucket_for(self._batcher.max_batch, self.buckets)
        took = {}
        for b in (b for b in self.buckets if b <= reachable):
            t0 = time.perf_counter()
            self._run([example] * b)
            took[b] = round(time.perf_counter() - t0, 3)
            if log:
                print(f"warmup: bucket {b} ready in {took[b]:.3f}s", flush=True)
        return took

    def stats(self) -> dict:
        """Batcher counters, latency percentiles and queue depth."""
        d = self._batcher.stats.as_dict()
        d["queue_depth"] = self._batcher.queue_depth()
        return d

    def close(self):
        self._batcher.close()

    # -- batch execution ------------------------------------------------

    @staticmethod
    def _compat_key(r: Request):
        """Requests sharing a device batch must agree on structure, cond
        shapes and style (a device batch runs one style's parameters)."""
        return (tuple((k, tuple(np.shape(v))) for k, v in sorted(r.cond.items())),
                r.init_image is not None, r.inpainting_mask is not None, r.style)

    def _run_groups(self, items: list) -> list:
        """Split a coalesced batch into compatible groups, run each, restore
        submission order. A failing group maps its own items to the
        exception; co-batched groups keep their results."""
        groups: dict = {}
        for i, r in enumerate(items):
            groups.setdefault(self._compat_key(r), []).append(i)
        results = [None] * len(items)
        for idxs in groups.values():
            try:
                out = self._run([items[i] for i in idxs])
            except Exception as ex:  # noqa: BLE001 — isolated per group
                out = [ex] * len(idxs)
            for i, res in zip(idxs, out):
                results[i] = res
        return results

    def _run(self, items: list) -> list:
        n = len(items)
        bucket = bucket_for(n, self.buckets)
        padded = items + [items[0]] * (bucket - n)
        cond = {k: np.stack([np.asarray(r.cond[k], np.float32) for r in padded])
                for k in sorted(padded[0].cond)}
        batch = {"cond": cond, "item_seeds": [r.seed for r in padded]}
        if padded[0].init_image is not None:
            batch["init_image"] = np.stack(
                [np.asarray(r.init_image, np.float32) for r in padded])
        else:
            batch["shape"] = (bucket,) + self.item_shape
        if padded[0].inpainting_mask is not None:
            mask = np.stack([np.asarray(r.inpainting_mask, np.float32) for r in padded])
            batch["inpainting"] = Inpainting(mask=mask, motion=batch["init_image"])
        style = padded[0].style  # _compat_key groups one style per batch
        params = None if style is None else self._styles[style]
        out = self.sampler(batch, params=params).float().cpu().numpy()
        if out.ndim == len(self.item_shape) + 2:
            out = out[self.dump_pick]  # dump_all_xstart stack (S, B, ...)
        return [out[i] for i in range(n)]
