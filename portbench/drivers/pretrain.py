"""Prior pretraining, step after step: the loop of cli/pretrain_prior.py
(the numpy loader, ModelBundle.encode_text on the batch's captions, then
train/pretrain.py::PriorTrainer.run_step), on a corpus in the dataset's
layout (`corpus.layout`: humanml, with `captions_per_clip` captions a clip,
or xia, captions named from the files) written from the seed into TMPDIR at
set-up.

Set-up builds the trainer once and drives it through its first `check_steps`
steps by the window's own call; the window goes on with that same trainer.
The check replays those steps in the plain reference (the same corpus,
weights and draws) and compares each step's loss, the first step's gradient
as the optimizer holds it (AdamW's first moment after one step over
1 - beta1) and the parameters' change over the steps, leaf by leaf as gaps
of norms (the packed q, k, v projections as three leaves each). The change
leaves out leaves whose reference gradient is under a thousandth of the
median leaf's: their Adam steps are round-off (a key's bias under softmax).
"""
from __future__ import annotations

import os
import random
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench import counts
from portbench.harness import program, traffic
from portbench.harness.compare import ReferenceMode, leaf_norms, worst_leaf_gap
from portbench.reference import loader as ref_loader
from portbench.reference import train as ref_train

BETA1 = 0.9


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.mix = ctx.cfg, ctx.mix
        self.root = None

    # -- set-up ---------------------------------------------------------
    def setup(self):
        from motionstyle_torch.data.collate import get_dataset_loader
        from motionstyle_torch.diffusion.schedule import make_schedule
        from motionstyle_torch.train.pretrain import PretrainConfig, PriorTrainer

        ctx, cfg, mix = self.ctx, self.cfg, self.mix
        dev = ctx.device
        t0 = time.perf_counter()
        self.root = tempfile.mkdtemp(prefix="portbench_corpus_")
        self.layout = mix["corpus"]["layout"]
        self.corpus = traffic.CORPUS_WRITERS[self.layout](
            os.path.join(self.root, "data"), ctx.seed, mix, cfg["njoints"] * cfg["nfeats"])
        ctx.say(f"corpus written in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        self.bundle = program.build(cfg, ctx.seed, dev)
        ctx.say(f"model and text tower built in {time.perf_counter() - t0:.2f} s")
        sched = make_schedule(cfg["noise_schedule"], cfg["diffusion_steps"], device=dev)
        random.seed(ctx.sub_seed("loader"))  # the dataset's crops and captions
        data = get_dataset_loader(cfg["dataset"], mix["batch"], cfg["nframes"], split="train",
                                  data_root=os.path.join(self.root, "data"))
        self.it = _forever(data)
        pcfg = PretrainConfig(save_dir=os.path.join(self.root, "save"), lr=mix["lr"],
                              weight_decay=mix["weight_decay"], num_steps=1 << 40,
                              log_interval=0, save_interval=0,
                              cond_mask_prob=cfg["cond_mask_prob"],
                              seed=ctx.sub_seed("trainer"), schedule_sampler=mix["t_sampler"])
        self.trainer = PriorTrainer(pcfg, self.bundle.model, sched)
        if ctx.fault == "unchanged_state":
            self.trainer.opt.step = lambda *a, **k: None
        t0 = time.perf_counter()
        named = dict(self.bundle.model.mdm.named_parameters())
        start = {k: p.detach().clone() for k, p in named.items()}
        self.losses, self.grad, self.change = [], {}, {}
        for step in range(mix["check_steps"]):
            self.losses.append(float(self._step()))
            if step == 0:
                st = self.trainer.opt.state
                self.grad = leaf_norms({"mdm." + k: st[p]["exp_avg"] / (1 - BETA1) if p in st
                                        else torch.zeros_like(p) for k, p in named.items()})
        self.change = leaf_norms({"mdm." + k: p.detach() - start[k] for k, p in named.items()})
        del start
        ctx.say(f"first {mix['check_steps']} steps in {time.perf_counter() - t0:.2f} s")

    def _step(self):
        with self.ctx.span("portbench.loader"):
            motion, cond = next(self.it)
        enc = self.bundle.encode_text(list(cond["y"]["text"]), self.cfg["dataset"])
        batch = {"x_start": motion.astype(np.float32), "enc_text": enc,
                 "mask": cond["y"]["mask"][:, :1, :1, :].astype(np.float32)}
        if self.ctx.fault == "half_batch":
            batch = {k: v[: len(v) // 2] for k, v in batch.items()}
        with self.ctx.span("portbench.step"):
            return self.trainer.run_step(batch)

    # -- window ---------------------------------------------------------
    def unit(self, n: int):
        self.last = self._step()

    def end_to_end(self, units: int, window_s: float) -> dict:
        return {"train_clips_per_s": (units * self.mix["batch"] / window_s, "clips/s")}

    def work(self, first: int, stop: int) -> dict:
        steps = stop - first
        b, s = self.mix["batch"], self.cfg["nframes"]
        return {"steps": steps,
                "flops": steps * 3 * counts.denoiser_flops(b, s, self.cfg),
                "train_layer_calls": [(b, s + 1, steps * self.cfg["num_layers"])]}

    def free(self):
        self.final_loss = float(self.last)
        del self.trainer, self.bundle, self.it

    # -- check ----------------------------------------------------------
    def check(self) -> tuple:
        ctx, cfg, mix = self.ctx, self.cfg, self.mix
        dev = ctx.device
        try:
            batches = []
            for b in ref_loader.Batches(os.path.join(self.root, "data"), mix["batch"],
                                        ctx.sub_seed("loader"), cfg["nframes"], self.layout):
                batches.append(b)
                if len(batches) == mix["check_steps"]:
                    break
            w = program.model_weights(cfg, ctx.seed, dev)
            cw = program.clip_weights(cfg, ctx.seed, dev)
            with ReferenceMode():
                want = ref_train.run(w, cw, cfg, batches, ctx.sub_seed("trainer"), dev,
                                     mix["lr"], weight_decay=mix["weight_decay"])
                want = {"loss": want["loss"], "grad": leaf_norms(want["grad"]),
                        "change": leaf_norms(want["change"])}
                if ctx.control:  # the reference in float8 in the program's place
                    got = ref_train.run(w, cw, cfg, batches, ctx.sub_seed("trainer"), dev,
                                        mix["lr"], weight_decay=mix["weight_decay"], prec="fp8")
                    got = {"loss": got["loss"], "grad": leaf_norms(got["grad"]),
                           "change": leaf_norms(got["change"])}
                else:
                    got = {"loss": self.losses, "grad": self.grad, "change": self.change}
        finally:
            shutil.rmtree(self.root, ignore_errors=True)
        med = float(np.median(list(want["grad"].values())))
        still = {k for k, g in want["grad"].items() if g < 1e-3 * med}
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
        failed = int(not np.isfinite(self.final_loss)) + sum(
            int(not np.isfinite(x)) for x in got["loss"])
        return [("loss_rel", loss_gap),
                ("grad_norm_gap", worst_leaf_gap(got["grad"], want["grad"])),
                ("change_norm_gap", worst_leaf_gap(got["change"], want["change"], still))], failed


def _forever(loader):
    while True:
        yield from loader
