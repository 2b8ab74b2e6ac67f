"""Batch style transfer of a motion library, closed loop.

Each unit is one call of parallel/inference.py::Sampler.__call__ with the
serving plan that cli/serve.py::build_sampler builds (DDIM over the mix's
`respacing`, `skip_steps` of the configuration's steps skipped, stopped at
the demo's pick, sampling.min_latency_plan), over `clips` content clips
with the mix's inpainting mask, a caption each through the bundle's
per-caption memo (filled at set-up, as a server's memo is) and a seed each
(`item_seeds`); the dump pick is read to the host, as the engine does. A
call's latency runs from the call until its clips are on the host.

The content library and the calls' batches are drawn from the seed at
set-up. The check runs the plain reference over every clip of the calls
drawn from the seed (`check_calls` among the first `check_among`, and the
window's first call).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import counts
from portbench.harness import program, traffic
from portbench.harness.compare import ReferenceMode, worst_rel_l2
from portbench.reference import clip as ref_clip
from portbench.reference import diffusion as ref_diff
from portbench.reference import mdm as ref_mdm


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.mix = ctx.cfg, ctx.mix
        self.latency = []
        self.kept = {}

    # -- set-up ---------------------------------------------------------
    def setup(self):
        from motionstyle_torch.diffusion.ddpm import Inpainting
        from motionstyle_torch.diffusion.sampling import min_latency_plan
        from motionstyle_torch.diffusion.schedule import make_schedule
        from motionstyle_torch.parallel.inference import Sampler

        ctx, cfg, mix = self.ctx, self.cfg, self.mix
        dev = ctx.device
        self.Inpainting = Inpainting
        t0 = time.perf_counter()
        self.bundle = program.build(cfg, ctx.seed, dev, int8=ctx.control)
        ctx.say(f"model and text tower built in {time.perf_counter() - t0:.2f} s")
        self.sched = make_schedule(cfg["noise_schedule"], cfg["diffusion_steps"],
                                   mix["respacing"], device=dev)
        n = self.sched.num_timesteps
        self.skip = int(mix["skip_steps"] / cfg["diffusion_steps"] * n)
        self.stop, self.pick = min_latency_plan(n, self.skip)

        def builder(model):
            fn = lambda x, t_orig, cond: model(x, t_orig, cond.get("enc_text"))  # noqa: E731
            return fn if ctx.spans is None else ctx.spans.wrap("portbench.denoiser", fn)

        self.sampler = Sampler(self.sched, builder, self.bundle.model, method="ddim",
                               skip_timesteps=self.skip, stop_timesteps=self.stop,
                               dump_all_xstart=True)
        c, t = cfg["njoints"] * cfg["nfeats"], cfg["nframes"]
        self.captions = traffic.captions(ctx.seed, mix["caption_set"], mix["grammar"])
        self.bundle.encode_text(self.captions, cfg["dataset"])  # the server's memo
        self.library = traffic.clips(ctx.seed, mix["library"], c, t)
        self.mask = np.ascontiguousarray(np.broadcast_to(
            traffic.inpainting_mask(mix["inpainting"], c, t), (mix["clips"], c, 1, t)))
        self.batches = []
        for r in range(mix["distinct_batches"]):
            g = traffic.rng(ctx.seed, "batch", r)
            idx = g.choice(mix["library"], size=mix["clips"], replace=False)
            caps = g.integers(0, len(self.captions), mix["clips"])
            self.batches.append((np.ascontiguousarray(self.library[idx]),
                                 [self.captions[i] for i in caps], caps))
        t0 = time.perf_counter()
        for n_warm in range(2):
            self._call(-1 - n_warm)
        ctx.say(f"warm-up {time.perf_counter() - t0:.2f} s")

    def _seeds(self, n: int) -> list:
        base = self.ctx.sub_seed("item_seeds", n) % (2 ** 62)
        return [base + i for i in range(self.mix["clips"])]

    def _call(self, n: int) -> np.ndarray:
        content, caps, _ = self.batches[n % len(self.batches)]
        enc = self.bundle.encode_text(caps, self.cfg["dataset"])
        batch = {"init_image": content, "cond": {"enc_text": enc},
                 "inpainting": self.Inpainting(mask=self.mask, motion=content),
                 "item_seeds": self._seeds(n)}
        with self.ctx.span("portbench.sampler"):
            out = self.sampler(batch)
        return out[self.pick].float().cpu().numpy()

    # -- window ---------------------------------------------------------
    def unit(self, n: int):
        t0 = time.perf_counter()
        res = self._call(n)
        self.latency.append(time.perf_counter() - t0)
        if self.ctx.fault == "altered_answer":  # every clip given another's answer
            res = np.roll(res, 1, axis=0)
        if n in self._check_set():
            self.kept[n] = res

    def _check_set(self) -> set:
        if not hasattr(self, "_calls"):
            m = self.mix
            self._calls = {0} | set(int(i) for i in traffic.rng(self.ctx.seed, "check").choice(
                m["check_among"], size=m["check_calls"], replace=False))
        return self._calls

    def end_to_end(self, units: int, window_s: float) -> dict:
        return {"transfer_clips_per_s": (units * self.mix["clips"] / window_s, "clips/s")}

    def work(self, first: int, stop: int) -> dict:
        """The traced calls' work, and every window call's latency."""
        calls = (stop - first) * (self.sched.num_timesteps - self.skip - (self.stop or 0))
        rows, frames = self.mix["clips"], self.cfg["nframes"]
        return {"steps": calls,
                "call_ms": [1e3 * s for s in self.latency],
                "flops": calls * counts.denoiser_flops(rows, frames, self.cfg),
                "layer_calls": [(rows, frames + 1, calls * self.cfg["num_layers"])]}

    def free(self):
        del self.bundle, self.sampler, self.sched

    # -- check ----------------------------------------------------------
    def check(self) -> tuple:
        ctx, cfg, mix = self.ctx, self.cfg, self.mix
        dev = ctx.device
        failed = sum(int(not np.isfinite(v).all()) for v in self.kept.values())
        gaps = []
        with ReferenceMode():
            w = program.model_weights(cfg, ctx.seed, dev)
            feats = ref_clip.encode_texts(program.clip_weights(cfg, ctx.seed, dev),
                                          self.captions, cfg["clip"], dev)
            s = ref_diff.Schedule(cfg["diffusion_steps"], mix["respacing"], dev)
            mask = torch.as_tensor(self.mask, device=dev)
            for n, got in sorted(self.kept.items()):
                content, _, caps = self.batches[n % len(self.batches)]
                ref = reference_call(w, cfg, s, torch.as_tensor(content, device=dev), mask,
                                     feats[caps], self._seeds(n), self.skip, self.stop or 0,
                                     self.pick, dev)
                gaps.append(worst_rel_l2(got, ref.cpu().numpy()))
        return [("transfer_rel_l2", max(gaps))], failed


def reference_call(w, cfg, s, content, mask, enc, seeds, skip, stop, pick, dev):
    """The plain serving plan over one call: each clip's initial noise from
    its own generator seeded with its item seed, q_sample of the content at
    the first kept step with the kept features noiseless, then DDIM (eta 0)
    over the style encoder, the x0 blended with the content at every step;
    the x0 of the pick."""
    shape = tuple(content.shape[1:])
    noise = torch.stack([torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(
        int(sd)), device=dev) for sd in seeds])
    steps = list(range(s.n - skip - 1, stop - 1, -1))
    x = ref_diff.q_sample(s, content, steps[0], noise, mask)
    dumps = []
    for i in steps:
        t = s.tmap[i].expand(len(content))
        x0 = ref_diff.blend(ref_mdm.denoise(w, x, t, enc, cfg, encoder="style_encoder"), mask,
                            content)
        dumps.append(x0)
        x = ref_diff.ddim_step(s, x, i, x0)
    return dumps[pick]
