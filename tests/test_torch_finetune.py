"""The port's few-shot finetune against the JAX package on the CPU: the loss
and its gradients (a toy model, then StyleDiffusion with weights carried over
by from_jax_params), one trainer step, the checkpoint round trip both ways,
resume, the CLI end to end, and the flags this slice refuses.

The JAX draws (the uniform t2m noise and the unroll's initial noise) are
recomputed from the same PRNGKey splits and pinned on the port's side.
Dropout and condition dropout are 0 where the two are compared. Tolerances:
loss rel 1e-5 and gradient max-rel 1e-3 per leaf in fp32 (the two sum in
other orders through a 6-step unroll); a trainer step's updated weights atol
2e-4 (tests/test_models.py:35).
"""
import csv
import glob
import inspect
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.diffusion import losses as jlosses
from motionstyle.diffusion.ddpm import Inpainting as JInpainting
from motionstyle.diffusion.schedule import make_schedule as jmake_schedule
from motionstyle.models import denoiser as jden
from motionstyle.models.torch_import import convert_encoder as jconvert_encoder
from motionstyle.models.torch_import import export_style_encoder as jexport_style_encoder
from motionstyle.train.finetune import FinetuneConfig as JFinetuneConfig
from motionstyle.train.finetune import StyleFinetuneTrainer as JTrainer
from motionstyle_torch.cli import model_util
from motionstyle_torch.cli.finetune_style_diffusion import main as ft_main
from motionstyle_torch.cli.parser_util import finetune_inpainting_style_args
from motionstyle_torch.diffusion import losses, sampling
from motionstyle_torch.diffusion.ddpm import Inpainting
from motionstyle_torch.diffusion.schedule import make_schedule
from motionstyle_torch.models.params import (
    convert_encoder, encoder_from_jax, export_style_encoder)
from motionstyle_torch.ops import fused_encoder_train as ft
from motionstyle_torch.train.finetune import FinetuneConfig, StyleFinetuneTrainer
from tests.test_torch_models import one_torch_thread, style_pair  # noqa: F401

LOSS_REL, GRAD_REL, STEP_ATOL = 1e-5, 1e-3, 2e-4
C, T, D = 12, 8, 64


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _jax_draws(key, x_start_shape, content_shape):
    """The noise the JAX loss draws from `key`: uniform t2m noise, then the
    unroll's initial normal noise (losses.py:96-99, sampling.py:131-133)."""
    rng_noise, rng_loop = jax.random.split(key)
    noise_t2m = jax.random.uniform(rng_noise, x_start_shape, dtype=jnp.float32)
    _, sub = jax.random.split(rng_loop)
    noise = jax.random.normal(sub, content_shape, dtype=jnp.float32)
    return np.asarray(noise_t2m), np.asarray(noise)


def _max_rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def test_toy_loss_and_grads_match_jax(goldens):
    """tests/test_diffusion.py:166-195's toy model through both losses."""
    g = goldens["sampler_toy"]
    Ct, Tt = 8, 10
    mask = np.ones((1, 1, 1, Tt), np.float32)
    inp_mask, content = np.asarray(g["mask"]), np.asarray(g["content"])
    style = np.random.RandomState(5).randn(1, Ct, 1, Tt).astype(np.float32)
    key = jax.random.PRNGKey(0)

    def jloss(w):
        terms = jlosses.few_shot_style_finetune_loss(
            jmake_schedule("cosine", 1000, "ddim20"),
            lambda x, t, c: jnp.einsum("bcft,cd->bdft", x, w),
            jnp.asarray(style), jnp.asarray([3], jnp.int32), jnp.asarray(content),
            jnp.asarray(style), key, mask=jnp.asarray(mask), cond_style={}, cond_t2m={},
            inpainting_style=JInpainting(jnp.asarray(inp_mask), jnp.asarray(content)),
            inpainting_t2m_mask=jnp.asarray(inp_mask), skip_steps=700, use_ddim=True,
            semantic_guidance=True, motion_enc_fn=lambda m, c: m.mean(axis=(2, 3)),
            text_features=jnp.ones((1, Ct)), ls_weight=10.0)
        return terms["loss"]

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(g["W"]))
    noise_t2m, noise = _jax_draws(key, style.shape, content.shape)
    w = _t(g["W"]).requires_grad_(True)
    terms = losses.few_shot_style_finetune_loss(
        make_schedule("cosine", 1000, "ddim20", device="cpu"),
        lambda x, t, c: torch.einsum("bcft,cd->bdft", x, w),
        _t(style), torch.tensor([3]), _t(content), _t(style), mask=_t(mask),
        cond_style={}, cond_t2m={}, inpainting_style=Inpainting(_t(inp_mask), _t(content)),
        inpainting_t2m_mask=_t(inp_mask), skip_steps=700, use_ddim=True,
        semantic_guidance=True, motion_enc_fn=lambda m, c: m.mean(dim=(2, 3)),
        text_features=torch.ones(1, Ct), ls_weight=10.0,
        noise_t2m=_t(noise_t2m), noise=_t(noise))
    terms["loss"].backward()
    assert abs(float(terms["loss"]) - float(want)) <= LOSS_REL * abs(float(want))
    assert _max_rel(w.grad.numpy(), np.asarray(want_g)) < GRAD_REL


def _batch(seed: int, B: int = 2):
    """A finetune batch as numpy: dataset clips, one neutral content and one
    style example, masks, text features (clip_dim = latent_dim = 64)."""
    rs = np.random.RandomState(seed)
    inp = np.zeros((1, C, 1, T), np.float32)
    inp[:, :3] = 1.0
    frame = np.ones((B, T), bool)
    frame[1, 6:] = False
    return {
        "x_start": rs.randn(B, C, 1, T).astype(np.float32),
        "content": rs.randn(1, C, 1, T).astype(np.float32),
        "style_target": rs.randn(1, C, 1, T).astype(np.float32),
        "mask": np.concatenate([np.ones((1, 1, 1, 6)), np.zeros((1, 1, 1, 2))], -1)
                  .astype(np.float32),
        "inp_mask": inp,
        "enc_text_style": rs.randn(1, D).astype(np.float32),
        "enc_text_t2m": rs.randn(B, D).astype(np.float32),
        "inp_mask_t2m": np.repeat(inp, B, 0),
        "frame_mask_t2m": frame,
        "text_features": rs.randn(1, D).astype(np.float32),
    }


def _pair(seed: int):
    return style_pair(seed, latent_dim=D, clip_dim=D, dropout=0.0, cond_mask_prob=0.0)


def _jtrainer(jmodel, params, tmp_path, **kw):
    cfg = JFinetuneConfig(save_dir=str(tmp_path / "jax"), dropout_rng_impl="threefry", **kw)
    return JTrainer(cfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                    jmake_schedule("cosine", 1000, "ddim20"))


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_style_diffusion_loss_and_grads_match_jax(tmp_path):
    jmodel, params, port = _pair(21)
    batch = _batch(22)
    t = np.asarray([2, 5], np.int32)
    jt = _jtrainer(jmodel, params, tmp_path)
    key = jax.random.PRNGKey(3)

    def jloss(p):
        terms = jlosses.few_shot_style_finetune_loss(
            jt.sched, lambda x, tt, c: jmodel.apply({"params": p}, x, tt, c["enc_text"],
                                                    deterministic=False),
            batch["x_start"], jnp.asarray(t), batch["content"], batch["style_target"], key,
            mask=batch["mask"], cond_style={"enc_text": batch["enc_text_style"]},
            cond_t2m={"enc_text": batch["enc_text_t2m"], "frame_mask": batch["frame_mask_t2m"]},
            inpainting_style=JInpainting(batch["inp_mask"], batch["style_target"]),
            inpainting_t2m_mask=batch["inp_mask_t2m"],
            motion_enc_fn=lambda m, c: jmodel.apply({"params": p}, m, c["frame_mask"],
                                                    method=jden.StyleDiffusion.encode_motion),
            text_features=batch["text_features"])
        return terms["loss"]

    want, jgrads = jax.value_and_grad(jloss)(jt.params)
    noise_t2m, noise = _jax_draws(key, batch["x_start"].shape, batch["content"].shape)
    trainer = StyleFinetuneTrainer(FinetuneConfig(save_dir=str(tmp_path / "port")), port,
                                   make_schedule("cosine", 1000, "ddim20", device="cpu"))
    terms = trainer.loss_terms(_port_batch(batch), torch.from_numpy(t).long(), 0,
                               noise_t2m=_t(noise_t2m), noise=_t(noise))
    terms["loss"].backward()
    assert abs(float(terms["loss"]) - float(want)) <= LOSS_REL * abs(float(want))
    want_g = {f"style_encoder.{k}": v.numpy() for k, v in
              encoder_from_jax(jax.device_get(jgrads["style_encoder"])).items()}
    got_g = {n: p.grad.numpy() for n, p in port.named_parameters() if p.requires_grad}
    assert got_g.keys() == want_g.keys()
    for k in want_g:
        assert _max_rel(got_g[k], want_g[k]) < GRAD_REL, (k, _max_rel(got_g[k], want_g[k]))
    assert all(p.grad is None for n, p in port.named_parameters() if not p.requires_grad)


def test_trainer_step_matches_jax(tmp_path):
    """One AdamW step on the style encoder against the JAX trainer's jitted
    step: same batch, t and noise."""
    jmodel, params, port = _pair(31)
    batch = _batch(32)
    t = np.asarray([1, 4], np.int32)
    kw = dict(lr=1e-4, weight_decay=1e-2)
    jt = _jtrainer(jmodel, params, tmp_path, **kw)
    rng = jax.random.PRNGKey(7)
    new_params, _, _ = jt._train_step(jt.params, jt.opt_state, rng,
                                      dict(jax.tree_util.tree_map(jnp.asarray, batch),
                                           t=jnp.asarray(t)))
    rng_loss = jax.random.split(rng, 3)[0]
    noise_t2m, noise = _jax_draws(rng_loss, batch["x_start"].shape, batch["content"].shape)
    before = {k: v.clone() for k, v in port.style_encoder.state_dict().items()}
    trainer = StyleFinetuneTrainer(FinetuneConfig(save_dir=str(tmp_path / "port"), **kw), port,
                                   make_schedule("cosine", 1000, "ddim20", device="cpu"))
    trainer.train_step(_port_batch(batch), torch.from_numpy(t).long(), 0,
                       noise_t2m=_t(noise_t2m), noise=_t(noise))
    want = encoder_from_jax(jax.device_get(new_params["style_encoder"]))
    got = port.style_encoder.state_dict()
    moved = max(float((got[k] - before[k]).abs().max()) for k in got)
    assert moved > 5e-5  # the step did move the weights
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=STEP_ATOL, err_msg=k)
    # Adam's first step is lr * g / (|g| + eps): where a gradient is near zero
    # the two sides' rounding can flip its sign (a difference of up to 2 lr,
    # inside atol). Everywhere else the updates agree closely.
    diff = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
    assert float((diff < 1e-6).float().mean()) > 0.95
    # frozen modules did not move
    assert all(not p.requires_grad for n, p in port.named_parameters()
               if not n.startswith("style_encoder."))


def test_checkpoints_cross_over_both_ways(tmp_path):
    jmodel, params, port = _pair(41)
    trainer = StyleFinetuneTrainer(FinetuneConfig(save_dir=str(tmp_path)), port,
                                   make_schedule("cosine", 1000, "ddim20", device="cpu"))
    trainer.save()
    path = tmp_path / "model000000000.pt"
    # the port's file -> the JAX package's convert_encoder: the same tree
    sd = {k: v.numpy() for k, v in torch.load(path).items()}
    jtree = jconvert_encoder(sd, "seqTransEncoder", 2)
    want = jax.tree_util.tree_structure(params["params"]["style_encoder"])
    assert jax.tree_util.tree_structure(jtree) == want
    for k, v in encoder_from_jax(jtree).items():
        torch.testing.assert_close(v, port.style_encoder.state_dict()[k], rtol=0, atol=0)
    # a JAX-written file -> the port
    jsd = jexport_style_encoder(params, 2)
    jpath = tmp_path / "jax_model.pt"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in jsd.items()}, jpath)
    got = convert_encoder(torch.load(jpath), "seqTransEncoder", 2)
    for k, v in encoder_from_jax(params["params"]["style_encoder"]).items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    assert set(export_style_encoder(port)) == set(jsd)


def test_resume_picks_the_newest_checkpoint(tmp_path):
    sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
    _, _, a = _pair(51)
    _, _, b = _pair(52)
    for model, step in ((a, 2), (b, 5)):
        tr = StyleFinetuneTrainer(FinetuneConfig(save_dir=str(tmp_path)), model, sched)
        tr.step = step
        tr.save()
    assert sorted(os.listdir(tmp_path)) == ["model000000002.pt", "model000000005.pt",
                                            "opt000000002.pt", "opt000000005.pt"]
    _, _, c = _pair(53)
    tr = StyleFinetuneTrainer(FinetuneConfig(save_dir=str(tmp_path / "next"),
                                             resume_checkpoint=str(tmp_path)), c, sched)
    assert tr.resume_step == 5 and tr.ckpt_file_name() == "model000000005.pt"
    for k, v in b.style_encoder.state_dict().items():
        torch.testing.assert_close(c.style_encoder.state_dict()[k], v, rtol=0, atol=0)


def _adam_state(jt):
    """The JAX trainer's Adam state and schedule count (None without an
    anneal): PartitionState -> 'trainable' -> MaskedState -> chain."""
    chain = jt.opt_state.inner_states["trainable"].inner_state
    sched = chain[-1]
    return chain[0], (sched.count if "count" in getattr(sched, "_fields", ()) else None)


@pytest.mark.parametrize("anneal", [0, 10])
def test_optimizer_state_crosses_from_jax_to_the_port(anneal, tmp_path):
    """An opt*.pt written by the JAX trainer resumes the port's trainer with
    the same Adam moments, step and learning rate."""
    jmodel, params, port = _pair(71)
    kw = dict(lr=1e-4, weight_decay=1e-2, lr_anneal_steps=anneal)
    jt = _jtrainer(jmodel, params, tmp_path, **kw)
    leaves, treedef = jax.tree_util.tree_flatten(jt.opt_state)
    rs = np.random.RandomState(0)
    jt.opt_state = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(3, a.dtype) if a.ndim == 0
        else jnp.asarray(np.abs(rs.randn(*a.shape)).astype(np.float32)) for a in leaves])
    jt.step = 3
    jt.save()
    trainer = StyleFinetuneTrainer(
        FinetuneConfig(save_dir=str(tmp_path / "port"), resume_checkpoint=str(tmp_path / "jax"),
                       **kw), port, make_schedule("cosine", 1000, "ddim20", device="cpu"))
    assert trainer.resume_step == 3
    adam, _ = _adam_state(jt)
    mu = encoder_from_jax(jax.device_get(adam.mu["style_encoder"]))
    nu = encoder_from_jax(jax.device_get(adam.nu["style_encoder"]))
    for name, p in port.style_encoder.named_parameters():
        st = trainer.opt.state[p]
        assert float(st["step"]) == 3
        assert float(st["exp_avg"].abs().min()) > 0  # the file's moments, not fresh zeros
        torch.testing.assert_close(st["exp_avg"], mu[name], rtol=0, atol=0)
        torch.testing.assert_close(st["exp_avg_sq"], nu[name], rtol=0, atol=0)
    want_lr = 1e-4 * (1 - 3 / anneal) if anneal else 1e-4
    assert trainer.opt.param_groups[0]["lr"] == pytest.approx(want_lr, rel=1e-6)
    assert trainer.lr_schedule.get_last_lr()[0] == pytest.approx(want_lr, rel=1e-6)


@pytest.mark.parametrize("anneal", [0, 10])
def test_optimizer_state_crosses_from_the_port_to_jax(anneal, tmp_path):
    """An opt*.pt written by the port's trainer resumes the JAX trainer with
    the same Adam moments, count and schedule position (the JAX loader
    unflattens into its own treedef and swallows a mismatch, so the loaded
    leaves themselves are compared)."""
    jmodel, params, port = _pair(72)
    kw = dict(lr=1e-4, weight_decay=1e-2, lr_anneal_steps=anneal)
    trainer = StyleFinetuneTrainer(FinetuneConfig(save_dir=str(tmp_path / "port"), **kw), port,
                                   make_schedule("cosine", 1000, "ddim20", device="cpu"))
    rs = np.random.RandomState(1)
    for p in trainer.opt.param_groups[0]["params"]:
        trainer.opt.state[p] = {
            "step": torch.tensor(3.0),
            "exp_avg": torch.from_numpy(rs.randn(*p.shape).astype(np.float32)),
            "exp_avg_sq": torch.from_numpy(np.abs(rs.randn(*p.shape)).astype(np.float32))}
    trainer.lr_schedule.last_epoch = 3
    trainer.step = 3
    trainer.save()
    jt = _jtrainer(jmodel, params, tmp_path, resume_checkpoint=str(tmp_path / "port"), **kw)
    assert jt.resume_step == 3
    adam, sched_count = _adam_state(jt)
    assert int(adam.count) == 3
    assert (sched_count is None) == (anneal == 0)
    if anneal:
        assert int(sched_count) == 3
    mu = encoder_from_jax(jax.device_get(adam.mu["style_encoder"]))
    nu = encoder_from_jax(jax.device_get(adam.nu["style_encoder"]))
    for name, p in port.style_encoder.named_parameters():
        st = trainer.opt.state[p]
        torch.testing.assert_close(mu[name], st["exp_avg"], rtol=0, atol=0)
        torch.testing.assert_close(nu[name], st["exp_avg_sq"], rtol=0, atol=0)


def test_optimizer_state_of_the_old_port_layout_still_loads(tmp_path):
    """A file in the port's earlier layout (a torch state_dict) loads."""
    sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
    _, _, a = _pair(73)
    tr = StyleFinetuneTrainer(FinetuneConfig(save_dir=str(tmp_path), lr_anneal_steps=10), a, sched)
    for p in tr.opt.param_groups[0]["params"]:
        tr.opt.state[p] = {"step": torch.tensor(2.0), "exp_avg": torch.ones_like(p),
                           "exp_avg_sq": torch.ones_like(p)}
    tr.step = 2
    tr.save()
    torch.save({"optimizer": tr.opt.state_dict(), "lr_schedule": tr.lr_schedule.state_dict()},
               tmp_path / "opt000000002.pt")
    _, _, b = _pair(74)
    tr2 = StyleFinetuneTrainer(FinetuneConfig(save_dir=str(tmp_path / "next"), lr_anneal_steps=10,
                                              resume_checkpoint=str(tmp_path)), b, sched)
    assert all(float(tr2.opt.state[p]["step"]) == 2 for p in tr2.opt.param_groups[0]["params"])


@pytest.mark.parametrize("fused_train", [False, True])
def test_checkpointed_unroll_equals_unchecked_under_dropout(fused_train, tmp_path):
    """The finetune unroll with dropout and condition dropout on: the
    checkpointed steps recompute the same masks, so the gradients equal the
    unchecked unroll's exactly."""
    _, _, port = style_pair(61, latent_dim=D, clip_dim=D, dropout=0.1, cond_mask_prob=0.1,
                            fused_train=fused_train, dtype="bfloat16" if fused_train
                            else "float32")
    batch = _port_batch(_batch(62))
    sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
    trainer = StyleFinetuneTrainer(FinetuneConfig(save_dir=str(tmp_path)), port, sched)
    grads = []
    for remat in (False, True):
        port.zero_grad(set_to_none=True)
        xs = sampling.sample_loop(
            sched, trainer._model_fn(99), {"enc_text": batch["enc_text_style"]},
            noise=torch.zeros_like(batch["content"]), init_image=batch["content"],
            method="ddim", skip_timesteps=14,
            inpainting=Inpainting(batch["inp_mask"], batch["style_target"]),
            dump_all_xstart=True, differentiable=True, remat=remat)
        (xs ** 2).sum().backward()
        grads.append({n: p.grad.clone() for n, p in port.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and grads[0]
    for k in grads[0]:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=0, atol=0, msg=k)


@pytest.fixture(scope="module")
def xia_root(tmp_path_factory):
    """The synthetic Xia-layout corpus of tests/test_cli.py:13-22."""
    root = tmp_path_factory.mktemp("style_xia_torch")
    (root / "new_joint_vecs").mkdir()
    r = np.random.RandomState(0)
    for f in ["350angry_jumping.npy", "306neutral_running.npy", "100angry_walking.npy",
              "101proud_walking.npy"]:
        np.save(root / "new_joint_vecs" / f,
                (r.randn(int(r.randint(30, 76)), 181) * 0.5).astype(np.float32))
    np.save(root / "Mean.npy", (r.randn(181) * 0.1).astype(np.float32))
    np.save(root / "Std.npy", (np.abs(r.randn(181)) + 0.5).astype(np.float32))
    return str(root)


CLI_ARGS = ["--dataset", "stylexia_posrot", "--style_example", "350angry_jumping.npy",
            "--num_steps", "2", "--batch_size", "1", "--overwrite",
            "--train_platform_type", "NoPlatform", "--skip_render", "--layers", "1",
            "--latent_dim", "128", "--diffusion_steps", "40", "--skip_steps", "28",
            "--semantic_guidance", "0", "--device", "cpu"]


def test_cli_finetune_end_to_end(xia_root, tmp_path):
    save_dir = ft_main(["--save_dir", str(tmp_path / "ft"), "--data_dir", xia_root,
                        "--fused", "1", "--fused_train", "1"] + CLI_ARGS)
    ckpts = sorted(glob.glob(os.path.join(save_dir, "model*.pt")))
    assert [os.path.basename(c) for c in ckpts] == ["model000000001.pt", "model000000002.pt"]
    assert os.path.exists(os.path.join(save_dir, "args.json"))
    with open(os.path.join(save_dir, "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    losses_ = [float(r["loss"]) for r in rows]
    assert len(losses_) == 2 and np.isfinite(losses_).all()
    assert all(float(r["step_seconds"]) > 0 for r in rows)
    sd = torch.load(ckpts[-1])
    assert all(re.match(r"seqTransEncoder\.layers\.0\.", k) for k in sd)


def test_cli_finetune_store_probs(xia_root, tmp_path, monkeypatch):
    """--fused_train_store 1 alone implies the fused training layer, and the
    CLI trains through the store-probs twins (kernels 8 and 9 on the card)."""
    args = finetune_inpainting_style_args(["--save_dir", "x", "--fused_train_store", "1"])
    cfg = model_util.get_transfer_config(args)
    assert cfg.fused_train and cfg.fused_train_store
    calls = {"store": 0, "recompute": 0}
    for name, key in (("fused_layer_train_forward_store_reference", "store"),
                      ("fused_layer_train_forward_reference", "recompute")):
        fn = getattr(ft, name)

        def counted(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ft, name, counted)
    save_dir = ft_main(["--save_dir", str(tmp_path / "ft"), "--data_dir", xia_root,
                        "--fused", "1", "--fused_train_store", "1"] + CLI_ARGS)
    with open(os.path.join(save_dir, "progress.csv")) as f:
        losses_ = [float(r["loss"]) for r in csv.DictReader(f)]
    assert len(losses_) == 2 and np.isfinite(losses_).all()
    assert calls["store"] > 0 and calls["recompute"] == 0
    assert os.path.exists(os.path.join(save_dir, "opt000000002.pt"))


def test_cli_finetune_prng_from_the_ports_own_prior(xia_root, tmp_path, monkeypatch):
    """The paper's workflow in the port: pretrain a prior with the CLI, then
    finetune from its mdm.pt with --fused_train_prng 1 (which implies the
    fused training layer): 2 steps through the twins with per-layer seeds,
    no mask arrays."""
    from motionstyle_torch.cli.pretrain_prior import main as pretrain_main

    prior_dir = str(tmp_path / "prior")
    pretrain_main(["--dataset", "stylexia_posrot", "--data_dir", xia_root, "--save_dir",
                   prior_dir, "--batch_size", "2", "--layers", "1", "--latent_dim", "128",
                   "--diffusion_steps", "40", "--num_steps", "2", "--log_interval", "1",
                   "--fused_train_prng", "1", "--device", "cpu"])
    seeded = {"forward": 0}
    fn = ft.fused_layer_train_forward_reference

    def counted(*a, **k):
        seeded["forward"] += inspect.signature(fn).bind(*a, **k).arguments.get("seeds") is not None
        return fn(*a, **k)

    monkeypatch.setattr(ft, "fused_layer_train_forward_reference", counted)
    calls = ft.make_dropout_masks.calls
    save_dir = ft_main(["--save_dir", str(tmp_path / "ft"), "--data_dir", xia_root,
                        "--mdm_path", os.path.join(prior_dir, "mdm.pt"), "--fused", "1",
                        "--fused_train_prng", "1"] + CLI_ARGS)
    with open(os.path.join(save_dir, "progress.csv")) as f:
        losses_ = [float(r["loss"]) for r in csv.DictReader(f)]
    assert len(losses_) == 2 and np.isfinite(losses_).all()
    assert seeded["forward"] > 0 and ft.make_dropout_masks.calls == calls
    assert os.path.exists(os.path.join(save_dir, "model000000002.pt"))


@pytest.mark.parametrize("flag", [
    ["--lora_rank", "4"], ["--fsdp", "1"], ["--model_parallel", "2"],
    ["--data_parallel", "1"], ["--quant_int8", "1"], ["--orbax_checkpoints", "1"], ["--dataset", "humanml"], ["--dataset", "bandai-2_posrot"],
    ["--render"], ["--train_platform_type", "TensorboardPlatform"]])
def test_cli_refuses_what_is_not_ported(flag, xia_root, tmp_path):
    args = ["--save_dir", str(tmp_path / "ft"), "--data_dir", xia_root] + CLI_ARGS + flag
    if flag == ["--render"]:
        args = [a for a in args if a not in ("--skip_render", "--render")]
    # --quant_int8 is no gap of the port: neither package trains through int8
    match = "no int8 path" if flag == ["--quant_int8", "1"] else "ROADMAP"
    with pytest.raises(NotImplementedError, match=match):
        ft_main(args)


def test_port_imports_neither_jax_nor_the_jax_package():
    """motionstyle_torch (its quality protocol, semantic trainer, parallel
    sampler and style metrics among them), chip_smoke.py and profile_layers.py
    import nothing of JAX or of the JAX package."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = glob.glob(os.path.join(root, "motionstyle_torch", "**", "*.py"), recursive=True)
    files += [os.path.join(root, f) for f in ("chip_smoke.py", "profile_layers.py",
                                              "quality_sweep.py")]
    for new in ("eval/style_metrics.py", "eval/quality_protocol.py", "train/semantic.py",
                "diffusion/parallel_sampling.py", "cli/train_semantic_discriminator.py"):
        assert os.path.join(root, "motionstyle_torch", new) in files, new
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|motionstyle)(\.|\s|$)",
                     re.MULTILINE)
    offenders = [f for f in files if bad.search(open(f).read())]
    assert len(files) > 20 and not offenders, offenders
