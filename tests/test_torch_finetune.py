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
from motionstyle_torch.train.finetune import (
    FinetuneConfig, StyleFinetuneTrainer, linear_anneal, set_schedule_position)
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
    """A file in the port's earlier layout (a torch AdamW state_dict over the
    style encoder in named_parameters order) loads: each parameter gets its
    own moments, and the LR schedule its position."""
    sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
    _, _, a = _pair(73)
    tr = StyleFinetuneTrainer(FinetuneConfig(save_dir=str(tmp_path), lr_anneal_steps=10), a, sched)
    tr.step = 2
    tr.save()
    names = [n for n, _ in a.named_parameters() if a.is_trainable(n)]
    old = torch.optim.AdamW([a.get_parameter(n) for n in names], lr=tr.cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=tr.cfg.weight_decay)
    for i, n in enumerate(names):  # moments that name their parameter
        p = a.get_parameter(n)
        old.state[p] = {"step": torch.tensor(2.0), "exp_avg": torch.full_like(p, 1.0 + i),
                        "exp_avg_sq": torch.full_like(p, 1000.0 + i)}
    old_schedule = torch.optim.lr_scheduler.LambdaLR(old, linear_anneal(10))
    set_schedule_position(old_schedule, 2, linear_anneal(10))
    torch.save({"optimizer": old.state_dict(), "lr_schedule": old_schedule.state_dict()},
               tmp_path / "opt000000002.pt")
    _, _, b = _pair(74)
    tr2 = StyleFinetuneTrainer(FinetuneConfig(save_dir=str(tmp_path / "next"), lr_anneal_steps=10,
                                              resume_checkpoint=str(tmp_path)), b, sched)
    assert tr2.resume_step == 2 and tr2.lr_schedule.last_epoch == 2
    for i, n in enumerate(names):
        p = b.get_parameter(n)
        st = tr2.opt.state[p]
        assert float(st["step"]) == 2, n
        assert torch.equal(st["exp_avg"], torch.full_like(p, 1.0 + i)), n
        assert torch.equal(st["exp_avg_sq"], torch.full_like(p, 1000.0 + i)), n


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
    ["--fsdp", "1"], ["--model_parallel", "2"], ["--data_parallel", "1"],
    ["--orbax_checkpoints", "1"]])
def test_cli_refuses_what_is_not_ported(flag, xia_root, tmp_path, capsys):
    """The scale-out flags are ported (tests/test_torch_mesh.py and its
    siblings run them on several ranks); on one rank each does what the JAX
    CLI does on one device: --fsdp without a mesh and --model_parallel 2
    exit before training, --data_parallel 1 trains on one device, and
    --orbax_checkpoints 1 also writes the DCP checkpoint."""
    save_dir = str(tmp_path / "ft")
    args = ["--save_dir", save_dir, "--data_dir", xia_root] + CLI_ARGS + flag
    if flag[0] == "--fsdp":
        with pytest.raises(SystemExit, match="--fsdp needs a mesh"):
            ft_main(args)
        return
    if flag[0] == "--model_parallel":
        with pytest.raises(ValueError, match="--model_parallel 2 does not divide"):
            ft_main(args)
        return
    run_dir = ft_main(args)
    names = os.listdir(run_dir)
    assert "model000000002.pt" in names
    if flag[0] == "--data_parallel":
        assert "running single-device" in capsys.readouterr().out
    else:
        assert "dcp_000000002" in names


def run_losses(main, argv: list, loss_key: str, seed: int = 0) -> tuple:
    """Run a training CLI with the loaders' `random` stream seeded; returns
    (its save dir, the losses of its progress.csv)."""
    import random

    random.seed(seed)
    main(argv)
    csv_path, = glob.glob(os.path.join(argv[argv.index("--save_dir") + 1], "**",
                                       "progress.csv"), recursive=True)
    save_dir = os.path.dirname(csv_path)
    with open(csv_path) as f:
        return save_dir, [float(r[loss_key]) for r in csv.DictReader(f)
                          if r.get(loss_key) not in (None, "")]


def check_item12_flag(flag: str, main, argv: list, loss_key: str, tmp_path, monkeypatch,
                      plain: list) -> str:
    """A training CLI with one flag of the host pieces (--profile DIR,
    --native_loader 1 or --prefetch 2) against its run without it (`plain`,
    its losses): the trace parses; the native run assembles its batches in
    C++ and trains to the same losses within rel 1e-5 (the twin divides by
    std where the library multiplies by its inverse); the prefetching run to
    the same losses bit for bit. Returns the run's save dir."""
    import json

    from motionstyle_torch.native import loader as native_loader

    calls = {"n": 0}
    collate = native_loader.window_normalize_collate

    def counted(*a, **k):
        calls["n"] += 1
        return collate(*a, **k)

    monkeypatch.setattr(native_loader, "window_normalize_collate", counted)
    extra = {"--profile": [str(tmp_path / "trace")], "--native_loader": ["1"],
             "--prefetch": ["2"]}[flag]
    save_dir, losses = run_losses(main, argv + [flag, *extra], loss_key)
    assert len(losses) == len(plain) > 0 and np.isfinite(losses).all()
    assert (calls["n"] > 0) == (flag == "--native_loader")
    if flag == "--profile":
        with open(tmp_path / "trace" / "trace.json") as f:
            assert len(json.load(f)["traceEvents"]) > 0
    if flag == "--native_loader":
        np.testing.assert_allclose(losses, plain, rtol=1e-5)
    else:
        assert losses == plain
    return save_dir


@pytest.fixture(scope="module")
def plain_finetune(xia_root, tmp_path_factory):
    return run_losses(ft_main, ["--save_dir", str(tmp_path_factory.mktemp("ft_plain")),
                                "--data_dir", xia_root] + CLI_ARGS, "loss")[1]


@pytest.mark.parametrize("flag", ["--profile", "--native_loader", "--prefetch",
                                  "--train_platform_type"])
def test_cli_runs_the_host_pieces(flag, xia_root, tmp_path, monkeypatch, plain_finetune):
    """The flags of ROADMAP item 12 on the finetune CLI. Without
    --train_platform_type the run takes the parsers' default,
    TensorboardPlatform: an event file of every step's loss terms under
    Loss/, the values progress.csv holds."""
    argv = ["--save_dir", str(tmp_path / "ft"), "--data_dir", xia_root] + CLI_ARGS
    if flag != "--train_platform_type":
        save_dir = check_item12_flag(flag, ft_main, argv, "loss", tmp_path, monkeypatch,
                                     plain_finetune)
        assert not any("tfevents" in n for n in os.listdir(save_dir))
        return
    i = argv.index("--train_platform_type")
    del argv[i:i + 2]
    assert finetune_inpainting_style_args(argv).train_platform_type == "TensorboardPlatform"
    save_dir, losses = run_losses(ft_main, argv, "loss")
    assert losses == plain_finetune
    from tests.test_torch_platforms import read_events

    events = read_events(save_dir)
    assert sorted((s, t) for t, s, _ in events) == [
        (s, f"Loss/{k}") for s in range(2) for k in ("loss", "rot_mse")]
    np.testing.assert_allclose([v for t, _, v in events if t == "Loss/loss"], losses, rtol=1e-6)


def short_post(monkeypatch, fit_module, plot_module):
    """The post chain at the suite's size where a CLI finds it: 10 IK steps
    a fit (fit_module.fit_joints_bvh), 5 frames a render
    (plot_module.plot_3d_motion)."""
    fit, plot = fit_module.fit_joints_bvh, plot_module.plot_3d_motion

    def short_fit(*a, **k):
        return fit(*a, **dict(k, iter_num=10))

    def short_plot(path, chains, joints, *a, **k):
        return plot(path, chains, joints[:5], *a, **k)

    monkeypatch.setattr(fit_module, "fit_joints_bvh", short_fit)
    monkeypatch.setattr(plot_module, "plot_3d_motion", short_plot)


def test_cli_finetune_writes_the_jax_runs_renders(xia_root, tmp_path, monkeypatch):
    """Without --skip_render the port's finetune writes the JAX finetune's
    files: the noised and clean neutral motions as BVH and video, and the
    style example's reconstruction (videos as mp4, or gif without ffmpeg),
    beside the checkpoints; each BVH reads back with 20 joints, finite, over
    the style example's frames. Both at the suite's size (10 IK steps, 5
    frames a render)."""
    from motionstyle.cli.finetune_style_diffusion import main as jft_main
    from motionstyle.post import ik as jik, render as jrender
    from motionstyle_torch.cli import finetune_style_diffusion as ft_cli
    from motionstyle_torch.post.bvh import read_bvh

    short_post(monkeypatch, ft_cli, ft_cli)
    short_post(monkeypatch, jik, jrender)  # the JAX CLI imports them when it renders
    args = [a for a in CLI_ARGS if a != "--skip_render"] + ["--num_steps", "1"]
    port = ft_main(["--save_dir", str(tmp_path / "port"), "--data_dir", xia_root] + args)
    i = args.index("--device")
    want = jft_main(["--save_dir", str(tmp_path / "jax"), "--data_dir", xia_root]
                    + args[:i] + args[i + 2:])
    files = sorted(os.listdir(port))
    assert files == sorted(os.listdir(want))
    renders = sorted(f for f in files if f.endswith((".bvh", ".mp4", ".gif")))
    assert [f.rsplit(".", 1)[0] for f in renders] == [
        "generated_neutral_motion", "generated_neutral_motion00",
        "generated_noised_neutral_motion", "generated_noised_neutral_motion00",
        "style_example_rec00"]
    length = np.load(os.path.join(xia_root, "new_joint_vecs", "350angry_jumping.npy")).shape[0]
    for f in (f for f in renders if f.endswith(".bvh")):
        anim = read_bvh(os.path.join(port, f))
        assert anim.shape == (min(length, 76), 20) and np.isfinite(anim.quats).all(), f


TRAIN_TWINS = ("fused_layer_train_forward_reference", "fused_layer_train_forward_store_reference",
               "bwd_ffn_reference", "bwd_attn_reference", "bwd_attn_stored_reference")


def _count_twins(monkeypatch) -> dict:
    """Count the calls of the training kernels' twins (kernels 5-9 on the
    card) and of kernel 2's twin."""
    from motionstyle_torch.ops import fused_encoder as fe

    calls = dict.fromkeys(TRAIN_TWINS + ("fused_encoder_layer_int8_reference",), 0)
    for module, names in ((ft, TRAIN_TWINS), (fe, ("fused_encoder_layer_int8_reference",))):
        for name in names:
            def counted(*a, _fn=getattr(module, name), _name=name, **k):
                calls[_name] += 1
                return _fn(*a, **k)

            monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("cli", ["finetune", "pretrain"])
def test_cli_quant_int8_trains_on_the_plain_layers(cli, xia_root, tmp_path, monkeypatch):
    """--quant_int8 1 --fused_train 1: the training forwards take the plain
    layers, as the JAX denoiser routes them (motionstyle/models/
    transformer.py:217-218), so no twin of kernels 5-9 runs; the finetune's
    gradient-free forwards (neutral generation, the final resample) run
    kernel 2's twin."""
    from motionstyle_torch.cli.pretrain_prior import main as pretrain_main

    calls = _count_twins(monkeypatch)
    flags = ["--quant_int8", "1", "--fused_train", "1"]
    if cli == "finetune":
        save_dir = ft_main(["--save_dir", str(tmp_path / "ft"), "--data_dir", xia_root]
                           + CLI_ARGS + flags)
    else:
        save_dir = str(tmp_path / "prior")
        pretrain_main(["--dataset", "stylexia_posrot", "--data_dir", xia_root, "--save_dir",
                       save_dir, "--batch_size", "2", "--layers", "1", "--latent_dim", "128",
                       "--diffusion_steps", "40", "--num_steps", "2", "--log_interval", "1",
                       "--device", "cpu"] + flags)
    with open(os.path.join(save_dir, "progress.csv")) as f:
        key = "loss" if cli == "finetune" else "prior_loss"
        losses_ = [float(r[key]) for r in csv.DictReader(f)]
    assert len(losses_) == 2 and np.isfinite(losses_).all()
    assert all(calls[n] == 0 for n in TRAIN_TWINS), calls
    if cli == "finetune":
        # 1 layer: the neutral DDPM from t = 39 down to its stop at 0.9 x 40,
        # then the final DDIM-20 resample after its skip of 28 / 40
        assert calls["fused_encoder_layer_int8_reference"] == 4 + 6, calls


INT8_LOSS_REL = 1e-2  # bf16 plain layers in both packages (tests/test_torch_int8.py's bound)


def test_quant_int8_finetune_loss_matches_jax(tmp_path):
    """Under quant_int8 and fused_train (bf16, as the CLIs set them) the
    few-shot loss before any step matches the JAX package's, whose training
    forwards run its plain layers too; the JAX draws pinned."""
    jmodel, params, port = style_pair(41, latent_dim=D, clip_dim=D, dropout=0.0,
                                      cond_mask_prob=0.0, quant_int8=True, fused=True,
                                      fused_train=True, dtype="bfloat16")
    batch = _batch(42)
    t = np.asarray([2, 5], np.int32)
    jt = _jtrainer(jmodel, params, tmp_path)
    key = jax.random.PRNGKey(5)
    want = jlosses.few_shot_style_finetune_loss(
        jt.sched, lambda x, tt, c: jmodel.apply({"params": jt.params}, x, tt, c["enc_text"],
                                                deterministic=False),
        batch["x_start"], jnp.asarray(t), batch["content"], batch["style_target"], key,
        mask=batch["mask"], cond_style={"enc_text": batch["enc_text_style"]},
        cond_t2m={"enc_text": batch["enc_text_t2m"], "frame_mask": batch["frame_mask_t2m"]},
        inpainting_style=JInpainting(batch["inp_mask"], batch["style_target"]),
        inpainting_t2m_mask=batch["inp_mask_t2m"],
        motion_enc_fn=lambda m, c: jmodel.apply({"params": jt.params}, m, c["frame_mask"],
                                                method=jden.StyleDiffusion.encode_motion),
        text_features=batch["text_features"])["loss"]
    noise_t2m, noise = _jax_draws(key, batch["x_start"].shape, batch["content"].shape)
    trainer = StyleFinetuneTrainer(FinetuneConfig(save_dir=str(tmp_path / "port")), port,
                                   make_schedule("cosine", 1000, "ddim20", device="cpu"))
    got = trainer.loss_terms(_port_batch(batch), torch.from_numpy(t).long(), 0,
                             noise_t2m=_t(noise_t2m), noise=_t(noise))["loss"]
    assert abs(float(got) - float(want)) <= INT8_LOSS_REL * abs(float(want)), (got, want)


def test_port_imports_neither_jax_nor_the_jax_package():
    """motionstyle_torch (its quality protocol, semantic trainer, parallel
    sampler, style metrics, post chain, long-form sampler, named styles,
    exporter, LoRA adapters, distiller, SMPL body model, other architectures,
    the humanml and bandai data path, the T2M evaluation stack, the trainer
    platforms, the native loader, the SMPLify chain and the scale-out
    modules among them), chip_smoke.py, profile_layers.py,
    profile_attention_bwd.py, profile_tracing.py, quality_sweep.py, serve_bench.py and the
    multi-rank tests' rank bodies
    (tests/torch_dist_ranks.py) import nothing of JAX or of the JAX package; the native loader builds its
    own copy of the C++ source into the port's own build directory."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = glob.glob(os.path.join(root, "motionstyle_torch", "**", "*.py"), recursive=True)
    files += [os.path.join(root, f) for f in ("chip_smoke.py", "profile_layers.py",
                                              "profile_attention_bwd.py", "profile_tracing.py",
                                              "quality_sweep.py", "serve_bench.py",
                                              os.path.join("tests", "torch_dist_ranks.py"))]
    for new in ("eval/style_metrics.py", "eval/quality_protocol.py", "train/semantic.py",
                "diffusion/parallel_sampling.py", "cli/train_semantic_discriminator.py",
                "core/params.py", "core/rotations.py", "core/skeleton.py", "core/features.py",
                "data/masks.py", "post/footskate.py", "post/bvh.py", "post/ik.py",
                "post/render.py", "diffusion/longform.py", "serve/export.py",
                "cli/export_model.py", "cli/serve.py", "serve/server.py", "serve/engine.py",
                "parallel/inference.py", "cli/model_util.py", "ops/fused_encoder.py",
                "models/lora.py", "diffusion/distillation.py", "cli/distill_prior.py",
                "models/smpl.py", "models/rotation2xyz.py", "models/transformer.py",
                "models/denoiser.py", "models/params.py", "data/datasets.py",
                "data/collate.py", "data/preprocess.py", "cli/prepare_dataset.py",
                "cli/finetune_style_diffusion.py", "cli/demo_style_transfer.py",
                "cli/pretrain_prior.py", "utils.py", "eval/metrics.py", "eval/evaluators.py",
                "eval/motion_loaders.py", "eval/trainers.py", "eval/t2m_generator.py",
                "cli/eval_metrics.py", "cli/train_evaluator.py", "cli/train_t2m_generator.py",
                "train/platforms.py", "native/build.py", "native/ingest.py",
                "native/loader.py", "post/smplify.py", "post/vis_utils.py",
                "post/motions2hik.py", "cli/fit_seq.py", "cli/render_mesh.py",
                "parallel/mesh.py", "parallel/pipeline.py", "parallel/sequence.py",
                "train/checkpoints.py", "tracing.py"):
        assert os.path.join(root, "motionstyle_torch", new) in files, new
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|motionstyle)(\.|\s|$)",
                     re.MULTILINE)
    offenders = [f for f in files if bad.search(open(f).read())]
    assert len(files) > 20 and not offenders, offenders
    from motionstyle_torch.native import build

    port = os.path.join(root, "motionstyle_torch") + os.sep
    assert build.SRC.startswith(port) and build.BUILD_DIR.startswith(port)
    assert os.path.exists(build.SRC)


# ---------------------------------------------------------------------------
# the humanml and bandai finetunes (ROADMAP §1 item 10)
# ---------------------------------------------------------------------------

FAMILY_STYLE = {"humanml": "jumping_angry_000606.npy",
                "bandai-2_posrot": "dataset-2_jumping_angry_606.npy",
                "bandai-1_posrot": "dataset-2_jumping_angry_606.npy"}


def family_root(tmp_path_factory, dataset: str) -> str:
    """A procedural corpus of the family (eval/quality_protocol.make_corpus:
    196-frame clips; humanml with texts/ and the split files), 8 clips."""
    from motionstyle_torch.eval.quality_protocol import make_corpus

    root = str(tmp_path_factory.mktemp(dataset.replace("-", "_")) / "data")
    make_corpus(root, clips_per_pair=2, seed=1,
                dataset="bandai-2_posrot" if dataset.startswith("bandai") else dataset)
    return root


@pytest.fixture(scope="module")
def hml_root(tmp_path_factory):
    return family_root(tmp_path_factory, "humanml")


@pytest.fixture(scope="module")
def bandai_root(tmp_path_factory):
    return family_root(tmp_path_factory, "bandai-2_posrot")


def jax_prior(path: str, njoints: int, latent_dim: int = 64) -> str:
    """A 1-layer prior the JAX package writes (export_mdm of numpy-made
    weights), so both packages' CLIs load the same weights."""
    from motionstyle.models.torch_import import export_mdm as jexport_mdm
    from tests.test_torch_models import numpy_params

    jcfg = jden.MDMConfig(njoints=njoints, nfeats=1, latent_dim=latent_dim, ff_size=1024,
                          num_layers=1, num_heads=4, clip_dim=512)
    tree = jden.StyleDiffusion(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, njoints, 1, 8)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 512)), method=jden.StyleDiffusion.full_init)
    torch.save({k: torch.as_tensor(np.asarray(v))
                for k, v in jexport_mdm(numpy_params(tree, 3), 1).items()}, path)
    return path


def family_args(dataset: str, diffusion_steps: int = 20) -> list:
    return ["--dataset", dataset, "--style_example", FAMILY_STYLE[dataset], "--num_steps", "1",
            "--batch_size", "2", "--overwrite", "--train_platform_type", "NoPlatform",
            "--skip_render", "--layers", "1", "--latent_dim", "64", "--diffusion_steps",
            str(diffusion_steps), "--skip_steps", str(int(0.7 * diffusion_steps)),
            "--semantic_guidance", "0"]


def pin_samplers(monkeypatch, modules: dict, seed: int = 11) -> None:
    """Wrap each (module, sampler name) to take numpy-made initial noise,
    for a DDPM chain per-step noise too, one draw per shape and step count,
    and numpy-made text features in place of cond['enc_text']: the same
    arrays in both packages (their generators and seeded text towers
    differ; the text tower's parity is tests/test_torch_models.py's)."""
    tables = {}
    enc = {}

    def noise_for(shape, steps):
        key = (tuple(shape), steps)
        if key not in tables:
            rs = np.random.RandomState(seed + len(tables))
            tables[key] = (rs.randn(*shape).astype(np.float32),
                           rs.randn(steps, *shape).astype(np.float32) if steps else None)
        return tables[key]

    for (module, name), to_array in modules.items():
        orig = getattr(module, name)

        def pinned(sched, model_fn, cond, rng, *a, _orig=orig, _to=to_array, **kw):
            steps = (sched.num_timesteps - kw.get("skip_timesteps", 0)
                     - (kw.get("stop_timesteps") or 0))
            noise, step = noise_for(kw["shape"],
                                    steps if kw.get("method", "ddpm") == "ddpm" else 0)
            kw["noise"] = _to(noise)
            if step is not None:
                kw["step_noise"] = _to(step)
            if "enc_text" in cond:
                shape = tuple(cond["enc_text"].shape)
                if shape not in enc:
                    enc[shape] = (np.random.RandomState(seed - 1).randn(*shape) * 0.1
                                  ).astype(np.float32)
                cond = dict(cond, enc_text=_to(enc[shape]))
            return _orig(sched, model_fn, cond, rng, *a, **kw)

        monkeypatch.setattr(module, name, pinned)


@pytest.mark.parametrize("dataset", ["humanml", "bandai-2_posrot"])
def test_cli_family_finetune_matches_the_jax_cli(dataset, hml_root, bandai_root, tmp_path,
                                                 monkeypatch):
    """One finetune step through both CLIs on the family's corpus, the noise
    of the prior's neutral chain pinned (on humanml the whole 20-step chain,
    keeping its final sample; on bandai the chain stopped at 0.9 T): every
    array of the trainer's batch (the neutral content at atol 1e-4, the
    rest exactly) and the captions equal the JAX CLI's; the port's step is
    finite and writes its checkpoint. The JAX trainer's step is not run (its
    dropout draws differ from the port's)."""
    from motionstyle.cli import finetune_style_diffusion as jft
    from motionstyle.diffusion import sampling as jsampling
    from motionstyle_torch.cli import finetune_style_diffusion as pft

    root = hml_root if dataset == "humanml" else bandai_root
    njoints = model_util.DATASET_DIMS[dataset][0]
    prior = jax_prior(str(tmp_path / "prior.pt"), njoints)
    pin_samplers(monkeypatch, {(sampling, "sample_loop"): torch.from_numpy,
                               (jsampling, "sample_loop"): jnp.asarray})
    batches = {"port": [], "jax": []}
    port_step = StyleFinetuneTrainer.run_step

    def port_record(self, batch):
        batches["port"].append(batch)
        return port_step(self, batch)

    def jax_record(self, batch):
        batches["jax"].append(batch)
        return {"loss": 0.0}

    monkeypatch.setattr(StyleFinetuneTrainer, "run_step", port_record)
    monkeypatch.setattr(jft.StyleFinetuneTrainer, "run_step", jax_record)
    captions = {"port": [], "jax": []}
    for mod, key in ((pft, "port"), (jft, "jax")):
        orig = mod.style_caption
        monkeypatch.setattr(mod, "style_caption", lambda *a, _o=orig, _k=key:
                            captions[_k].append(_o(*a)) or captions[_k][-1])
    common = ["--data_dir", root, "--mdm_path", prior] + family_args(dataset)
    import random

    random.seed(3)
    save_dir = ft_main(["--save_dir", str(tmp_path / "port"), "--device", "cpu"] + common)
    random.seed(3)
    jft.main(["--save_dir", str(tmp_path / "jax")] + common)
    assert captions["port"] == captions["jax"] and len(batches["port"]) == 1
    got, want = batches["port"][0], batches["jax"][0]
    for k in ("content", "style_target", "mask", "inp_mask", "x_start", "inp_mask_t2m",
              "frame_mask_t2m"):
        g = np.asarray(torch.as_tensor(got[k]).float()) if k != "frame_mask_t2m" \
            else np.asarray(got[k])
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w.astype(g.dtype), atol=1e-4 if k == "content" else 0,
                                   err_msg=k)
    frames = 196
    assert got["content"].shape == (1, njoints, 1, frames)
    with open(os.path.join(save_dir, "progress.csv")) as f:
        assert np.isfinite([float(r["loss"]) for r in csv.DictReader(f)]).all()
    assert os.path.exists(os.path.join(save_dir, "model000000001.pt"))


@pytest.mark.parametrize("dataset, example, want", [
    ("humanml", "M008551.npy", ("a figure skips in a circle", "happily")),
    ("bandai-2_posrot", "dataset-2_walk-turn-right_feminine_018.npy",
     ("a person walks turn right normal", "feminine")),
    ("bandai-1_posrot", "", ("a person walks turn right normal", "feminine")),
    ("stylexia_posrot", "/abs/path/350angry_jumping.npy", ("a person is jumping neutral",
                                                           "angry"))])
def test_style_caption_and_its_edit_match_jax(dataset, example, want):
    """The neutral caption and the semantic-guidance edit of each family,
    humanml's token splice after every /VERB included."""
    from motionstyle.cli import finetune_style_diffusion as jft
    from motionstyle_torch.cli import finetune_style_diffusion as pft

    assert pft.style_caption(dataset, example) == jft.style_caption(dataset, example) == want
    cases = [("a man walks and then runs forward", None),
             ("a man walks and then runs forward",
              "a/DET_man/NOUN_walk/VERB_and/CCONJ_then/ADV_run/VERB_forward/ADV")]
    for caption, tokens in cases:
        assert pft.edit_caption_with_style(caption, "angry", dataset, tokens=tokens) == \
            jft.edit_caption_with_style(caption, "angry", dataset, tokens=tokens)
    if dataset == "humanml":  # one style word a /VERB token
        assert pft.edit_caption_with_style(cases[1][0], "angry", dataset,
                                           tokens=cases[1][1]).split().count("angry") == 2


def test_skeleton_assets_match_jax():
    from motionstyle.cli import finetune_style_diffusion as jft
    from motionstyle_torch.cli import finetune_style_diffusion as pft

    for dataset in ("humanml", "bandai-1_posrot", "bandai-2_posrot", "stylexia_posrot"):
        (skel, real, chains, feet), (jskel, jreal, jchains, jfeet) = \
            pft.skeleton_assets(dataset), jft.skeleton_assets(dataset)
        assert np.array_equal(skel.raw_offsets, np.asarray(jskel.raw_offsets))
        assert np.array_equal(real, jreal) and chains == jchains and feet == jfeet
        assert tuple(skel.parents) == tuple(jskel.parents)
