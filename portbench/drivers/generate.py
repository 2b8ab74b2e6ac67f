"""Text-to-motion generation: guided DDPM chains back to back, closed loop.

Each unit is one chain over the configuration's whole schedule
(`diffusion_steps` DDPM steps) for `clips` clips
under classifier-free guidance (`guidance`), through
diffusion/sampling.py::sample_loop over diffusion/ddpm.py::cfg_model_fn of
StyleDiffusion.denoise_prior, as cli/eval_metrics.py and the humanml demo's
prior_content call it; its clips are read to the host when it ends. The
captions come from a seeded set, encoded once at set-up by the bundle's
text tower. Each chain draws its noise from a generator on the device
seeded from the run's seed and the chain's index.

The check follows the program step by step from its own state. One chain
drawn from the seed among the first `check_among` records, on the device
as it runs, its sampler's state and the guided denoiser's answer at the
first and last steps and at `check_steps` - 2 steps drawn from the seed,
each with the state after it. Once the window has closed the plain
reference (fp32, the same seeded weights, captions and noise) works out
again from each recorded state the guided x0, from state, x0 and noise the
DDPM update into the next recorded state (the last into the clips
returned), and the chain's first state from the generator. The compared
number, `step_rel_l2`, is the worst clip's relative L2 gap over all of
them. A whole chain is not compared with the reference's: 1000 guided
steps amplify rounding chaotically, up to the int8 control's gap on some
seeds and clips, so no limit would separate the two.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import counts
from portbench.harness import program, traffic
from portbench.harness.compare import ReferenceMode, rel_l2
from portbench.reference import clip as ref_clip
from portbench.reference import diffusion as ref_diff
from portbench.reference import mdm as ref_mdm


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.mix = ctx.cfg, ctx.mix
        self.outputs = {}

    # -- set-up ---------------------------------------------------------
    def setup(self):
        from motionstyle_torch.diffusion import sampling
        from motionstyle_torch.diffusion.ddpm import cfg_model_fn
        from motionstyle_torch.diffusion.schedule import make_schedule

        ctx, cfg, mix = self.ctx, self.cfg, self.mix
        dev = ctx.device
        self.sampling = sampling
        t0 = time.perf_counter()
        self.bundle = program.build(cfg, ctx.seed, dev, int8=ctx.control)
        ctx.say(f"model and text tower built in {time.perf_counter() - t0:.2f} s")
        self.steps = cfg["diffusion_steps"]
        self.sched = make_schedule(cfg["noise_schedule"], self.steps, None, device=dev)
        self.captions = traffic.captions(ctx.seed, mix["caption_set"], mix["grammar"])
        self.enc_all = self.bundle.encode_text(self.captions, cfg["dataset"])
        self.shape = (mix["clips"], cfg["njoints"], cfg["nfeats"], cfg["nframes"])
        model = self.bundle.model

        def denoiser(x, t, c):
            return model.denoise_prior(x, t, c["enc_text"])

        if ctx.spans is not None:
            denoiser = ctx.spans.wrap("portbench.denoiser", denoiser)
        self.model_fn = cfg_model_fn(denoiser, torch.full((mix["clips"],), mix["guidance"],
                                                          device=dev))
        if ctx.fault == "half_rows":  # half the clips' answer left out, as by a short launch
            guided = self.model_fn

            def model_fn(x, t, c):
                out = guided(x, t, c).clone()
                out[: len(out) // 2] = 0
                return out

            self.model_fn = model_fn
        r = traffic.rng(ctx.seed, "check")
        self.checked = int(r.integers(mix["check_among"]))
        inner = list(r.choice(np.arange(1, self.steps - 1), mix["check_steps"] - 2,
                              replace=False))
        pos = {0, self.steps - 1, *inner}
        self.record_at = pos | {p + 1 for p in pos if p + 1 < self.steps}
        self.record, self.pos = {}, 0
        guided_fn = self.model_fn

        def recording(x, t, c):  # the checked chain's state and answer, kept on the device
            out = guided_fn(x, t, c)
            if self.recording and self.pos in self.record_at:
                self.record[self.pos] = (x.clone(), out.clone())
            self.pos += 1
            return out

        self.model_fn, self.recording = recording, False
        # warm-up: the chain's shapes through two steps of its own loop
        t0 = time.perf_counter()
        self._chain(-1, skip=self.steps - 2)
        ctx.say(f"warm-up {time.perf_counter() - t0:.2f} s")

    def _plan(self, n: int):
        """(caption indices, noise seed) of chain n."""
        idx = traffic.rng(self.ctx.seed, "chain_captions", n).integers(
            0, len(self.captions), self.mix["clips"])
        return idx, self.ctx.sub_seed("chain_noise", n)

    def _chain(self, n: int, skip: int = 0):
        idx, seed = self._plan(n)
        dev = self.ctx.device
        enc = torch.as_tensor(self.enc_all[idx], device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.pos, self.recording = 0, n == self.checked
        with self.ctx.span("portbench.sampler"):
            out = self.sampling.sample_loop(self.sched, self.model_fn, {"enc_text": enc}, gen,
                                            shape=self.shape, method="ddpm",
                                            skip_timesteps=skip)
        return out.cpu().numpy()

    # -- window ---------------------------------------------------------
    def unit(self, n: int):
        out = self._chain(n)
        if self.ctx.fault == "altered_answer":  # every clip given another's answer
            out = np.roll(out, 1, axis=0)
        self.outputs[n] = out

    def end_to_end(self, units: int, window_s: float) -> dict:
        return {"gen_clips_per_s": (units * self.mix["clips"] / window_s, "clips/s")}

    def work(self, first: int, stop: int) -> dict:
        steps = (stop - first) * self.steps
        rows = 2 * self.mix["clips"]
        return {"steps": steps,
                "flops": steps * counts.denoiser_flops(rows, self.cfg["nframes"], self.cfg),
                "layer_calls": [(rows, self.cfg["nframes"] + 1, steps * self.cfg["num_layers"])]}

    def free(self):
        del self.bundle, self.model_fn, self.sched

    # -- check ----------------------------------------------------------
    def check(self) -> tuple:
        ctx, cfg, mix = self.ctx, self.cfg, self.mix
        dev, n, c = ctx.device, self.steps, self.checked
        if c not in self.outputs or len(self.record) != len(self.record_at):
            ctx.say(f"chain {c} was not run to its end in the window")
            return [("step_rel_l2", float("nan"))], 1
        failed = int(not np.isfinite(self.outputs[c]).all())
        k = mix["clips"]
        x0_gaps, update_gaps = [], []
        with ReferenceMode():
            w = program.model_weights(cfg, ctx.seed, dev)
            feats = ref_clip.encode_texts(program.clip_weights(cfg, ctx.seed, dev),
                                          self.captions, cfg["clip"], dev)
            s = ref_diff.Schedule(n, None, dev)
            idx, seed = self._plan(c)
            enc = feats[idx]
            enc2 = torch.cat([enc, torch.zeros_like(enc)])
            gen = torch.Generator(device=dev).manual_seed(seed)
            start = torch.randn(self.shape, generator=gen, device=dev)
            update_gaps.append(rel_l2(_np(self.record[0][0]), _np(start)))
            for p in range(n):
                noise = torch.randn(self.shape, generator=gen, device=dev)
                if p not in self.record:
                    continue
                x, x0 = self.record[p]
                i = n - 1 - p
                out = ref_mdm.denoise(w, torch.cat([x, x]), s.tmap[i].expand(2 * k), enc2, cfg)
                x0_gaps.append(rel_l2(_np(x0), _np(ref_diff.guided(out[:k], out[k:],
                                                                   mix["guidance"]))))
                after = (self.outputs[c] if p == n - 1 else
                         _np(self.record[p + 1][0]) if p + 1 in self.record else None)
                if after is not None:
                    update_gaps.append(rel_l2(after, _np(ref_diff.ddpm_step(s, x, i, x0, noise))))
        x0_gap, update_gap = float(np.max(x0_gaps)), float(np.max(update_gaps))
        ctx.say(f"chain {c}: {len(x0_gaps)} answers, median gap {np.median(x0_gaps):.4g}, "
                f"worst {x0_gap:.4g}; {len(update_gaps)} states, worst {update_gap:.4g}")
        ctx.notes[f"chain_{c}"] = {"x0": [g.tolist() for g in x0_gaps],
                                   "update": [g.tolist() for g in update_gaps]}
        return [("step_rel_l2", max(x0_gap, update_gap))], failed


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
