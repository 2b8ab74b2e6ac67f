"""The port's semantic-discriminator trainer and CLI against the JAX package
on the CPU.

One SemanticTrainer step against the JAX trainer's jitted step on the same
weights (from_jax_params), batch, timesteps and noise (recomputed from the
JAX step's PRNGKey split), with dropout and cond_mask_prob 0: loss rel
1e-5 and the updated discriminator weights atol 2e-4
(tests/test_models.py:35). Every other parameter, the frozen prior's among
them, is bit-equal after the step, with weight decay on. A discriminator
checkpoint written by either package loads in the other bit for bit.
"""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.models.denoiser import MDMConfig as JMDMConfig
from motionstyle.models.torch_import import assemble_style_diffusion_params
from motionstyle.diffusion.schedule import make_schedule as jmake_schedule
from motionstyle.train.semantic import SemanticConfig as JSemanticConfig
from motionstyle.train.semantic import SemanticTrainer as JSemanticTrainer
from motionstyle_torch.cli import model_util
from motionstyle_torch.cli.finetune_style_diffusion import main as ft_main
from motionstyle_torch.cli.train_semantic_discriminator import main as sem_main
from motionstyle_torch.cli.train_semantic_discriminator import parse_args
from motionstyle_torch.diffusion.schedule import make_schedule
from motionstyle_torch.models.params import from_jax_params, from_torch_state_dict
from motionstyle_torch.train.semantic import SemanticConfig, SemanticTrainer, is_trainable
from tests.test_torch_finetune import _pair, xia_root  # noqa: F401

LOSS_REL, STEP_ATOL = 1e-5, 2e-4
C, T, B = 12, 8, 3


def _batch(seed: int) -> dict:
    rs = np.random.RandomState(seed)
    frame = np.ones((B, T), bool)
    frame[1, 5:] = False
    frame[2, 7:] = False
    return {"x_start": rs.randn(B, C, 1, T).astype(np.float32), "frame_mask": frame,
            "mask": frame[:, None, None, :].astype(np.float32)}


def _step_pair(tmp_path, seed: int):
    """(JAX trainer after one step, its loss, port trainer after the same
    step, its loss, the port's parameters before the step)."""
    jmodel, params, port = _pair(seed)
    batch = _batch(seed + 1)
    t = np.asarray([5, 400, 999], np.int32)
    kw = dict(lr=1e-4, weight_decay=1e-2, cond_mask_prob=0.0)
    jt = JSemanticTrainer(JSemanticConfig(save_dir=str(tmp_path / "jax"),
                                          dropout_rng_impl="threefry", **kw),
                          jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                          jmake_schedule("cosine", 1000))
    rng = jax.random.PRNGKey(9)
    jt.params, jt.opt_state, jloss = jt._train_step(
        jt.params, jt.opt_state, rng,
        dict(jax.tree_util.tree_map(jnp.asarray, batch), t=jnp.asarray(t)))
    noise = jax.random.normal(jax.random.split(rng, 3)[0], batch["x_start"].shape, jnp.float32)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    trainer = SemanticTrainer(SemanticConfig(save_dir=str(tmp_path / "port"), **kw), port,
                              make_schedule("cosine", 1000, device="cpu"))
    loss = trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                              torch.from_numpy(t).long(), torch.from_numpy(np.asarray(noise)))
    return jt, float(jloss), trainer, float(loss), before


def test_semantic_step_matches_jax(tmp_path):
    jt, jloss, trainer, loss, before = _step_pair(tmp_path, 91)
    assert abs(loss - jloss) <= LOSS_REL * abs(jloss)
    want = from_jax_params(jax.device_get(jt.params), trainer.model.cfg)
    got = trainer.model.state_dict()
    moved = max(float((got[k] - before[k]).abs().max()) for k in got if is_trainable(k))
    assert moved > 5e-5  # the step moved the discriminator
    keys = [k for k in want if is_trainable(k)]
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=STEP_ATOL, err_msg=k)
    # Adam's first step is lr * g / (|g| + eps): where a gradient is near zero
    # (the key bias's, in exact arithmetic) the two sides' rounding can flip
    # its sign, a difference of up to 2 lr, inside atol; elsewhere they agree
    diff = torch.cat([(got[k] - want[k]).abs().flatten() for k in keys])
    assert float((diff < 1e-6).float().mean()) > 0.95


def test_semantic_step_leaves_the_frozen_modules_bit_equal(tmp_path):
    _, _, trainer, _, before = _step_pair(tmp_path, 92)
    frozen = [k for k in before if not is_trainable(k)]
    assert any(k.startswith("mdm.") for k in frozen)
    assert any(k.startswith("style_encoder.") for k in frozen)
    for k in frozen:
        assert torch.equal(trainer.model.state_dict()[k], before[k]), k
    in_opt = {id(p) for g in trainer.opt.param_groups for p in g["params"]}
    for name, p in trainer.model.named_parameters():
        assert (id(p) in in_opt) == is_trainable(name) == p.requires_grad, name


def test_discriminator_written_by_the_port_loads_in_jax(tmp_path):
    _, _, trainer, _, _ = _step_pair(tmp_path, 93)
    path = trainer.save()
    sd = {k: v.numpy() for k, v in torch.load(path).items()}
    cfg = trainer.model.cfg
    jcfg = JMDMConfig(njoints=cfg.njoints, nfeats=1, latent_dim=cfg.latent_dim,
                      ff_size=cfg.ff_size, num_layers=cfg.num_layers,
                      num_heads=cfg.num_heads, clip_dim=cfg.clip_dim)
    tree = jax.device_get(assemble_style_diffusion_params(jcfg, semantic_sd=sd))
    got = from_jax_params(tree, cfg)
    for k, v in trainer.model.state_dict().items():
        if is_trainable(k):
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_discriminator_written_by_jax_loads_in_the_port(tmp_path):
    jt, _, trainer, _, _ = _step_pair(tmp_path, 94)
    sd = torch.load(jt.save())
    state = from_torch_state_dict(sd, trainer.model.cfg, part="semantic")
    want = from_jax_params(jax.device_get(jt.params), trainer.model.cfg)
    assert state.keys() == {k for k in want if is_trainable(k)}
    for k in state:
        torch.testing.assert_close(state[k], want[k], rtol=0, atol=0, msg=k)


def test_device_defaults_to_cuda():
    assert parse_args(["--save_dir", "x"]).device == "cuda"


@pytest.mark.parametrize("flag, item", [
    (["--dataset", "humanml"], 10), (["--dataset", "bandai-2_posrot"], 10),
    (["--native_loader", "1"], 12), (["--prefetch", "2"], 12), (["--profile", "trace"], 12)])
def test_cli_refuses_what_is_not_ported(flag, item, xia_root, tmp_path):  # noqa: F811
    argv = ["--dataset", "stylexia_posrot", "--data_dir", xia_root, "--save_dir",
            str(tmp_path / "sem"), "--device", "cpu"] + flag
    with pytest.raises(NotImplementedError, match=rf"ROADMAP §1 item {item}\b"):
        sem_main(argv)
    assert not os.path.exists(tmp_path / "sem")


def test_cli_trains_a_discriminator_the_finetune_loads(xia_root, tmp_path):  # noqa: F811
    """The paper's workflow with the full reference loss: pretrain a prior,
    train its discriminator (--fused_train 1: the prior's training twins on
    the CPU), then finetune with --semantic_guidance 1 from both; the
    finetune's model carries the discriminator's weights."""
    from motionstyle_torch.cli.pretrain_prior import main as pretrain_main

    common = ["--dataset", "stylexia_posrot", "--data_dir", xia_root, "--layers", "1",
              "--latent_dim", "512", "--diffusion_steps", "40", "--device", "cpu"]
    prior_dir = str(tmp_path / "prior")
    pretrain_main(["--save_dir", prior_dir, "--batch_size", "2", "--num_steps", "1"] + common)
    mdm = os.path.join(prior_dir, "mdm.pt")
    path = sem_main(["--save_dir", str(tmp_path / "sem"), "--mdm_path", mdm, "--batch_size",
                     "2", "--num_steps", "2", "--log_interval", "1", "--fused_train", "1"]
                    + common)
    assert os.path.basename(path) == "semantic_discriminator.pt"
    with open(os.path.join(tmp_path, "sem", "progress.csv")) as f:
        losses = [float(r["semantic_loss"]) for r in csv.DictReader(f)]
    assert len(losses) == 2 and np.isfinite(losses).all()
    sd = torch.load(path)
    assert {"muQuery", "sigmaQuery"} <= set(sd) and all(
        k.startswith("seqTransEncoder.layers.0.") for k in sd if "Query" not in k)
    save_dir = ft_main(["--save_dir", str(tmp_path / "ft"), "--mdm_path", mdm,
                        "--semantic_discriminator_path", path, "--semantic_guidance", "1",
                        "--style_example", "350angry_jumping.npy", "--num_steps", "1",
                        "--batch_size", "1", "--skip_steps", "28", "--overwrite",
                        "--train_platform_type", "NoPlatform", "--skip_render"] + common)
    with open(os.path.join(save_dir, "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    assert np.isfinite(float(rows[0]["text_cosine"])) and np.isfinite(float(rows[0]["loss"]))
    args = parse_args(["--save_dir", "x", "--layers", "1", "--latent_dim", "512", "--dataset",
                       "stylexia_posrot"])
    args.semantic_discriminator_path, args.mdm_path = path, mdm
    model = model_util.build_model(args, device="cpu").model
    for k, v in from_torch_state_dict(sd, model.cfg, part="semantic").items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0, msg=k)
