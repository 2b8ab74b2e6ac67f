"""LoRA style adapters of the port (motionstyle_torch/models/lora.py, the
finetune's --lora_rank and the CLIs' adapter loading) against the JAX
package's (motionstyle/models/lora.py, tests/test_lora.py) on the CPU.

Weights and factors come from numpy seeds and go into both packages. The
JAX draws of a loss (the t2m noise and the unroll's initial noise) are
recomputed from the same PRNGKey splits and pinned on the port's side, with
dropout and condition dropout 0. Tolerances: a merge atol 2e-4
(tests/test_models.py:35); the loss rel 1e-5 and every factor's gradient
max-rel 1e-3 (tests/test_torch_finetune.py:45); a trainer step's factors
atol 2e-4; files and optimizer moments bit for bit.
"""
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.cli import model_util as jmodel_util
from motionstyle.diffusion import losses as jlosses
from motionstyle.diffusion.ddpm import Inpainting as JInpainting
from motionstyle.diffusion.schedule import make_schedule as jmake_schedule
from motionstyle.models import denoiser as jden
from motionstyle.models import lora as jlora
from motionstyle.models.torch_import import export_style_encoder as jexport_style_encoder
from motionstyle.train.finetune import FinetuneConfig as JFinetuneConfig
from motionstyle.train.finetune import StyleFinetuneTrainer as JTrainer
from motionstyle_torch.cli import model_util
from motionstyle_torch.cli.demo_style_transfer import main as demo_main
from motionstyle_torch.cli.finetune_style_diffusion import main as ft_main
from motionstyle_torch.diffusion.schedule import make_schedule
from motionstyle_torch.models import lora
from motionstyle_torch.models.denoiser import MDMConfig, StyleDiffusion
from motionstyle_torch.models.params import convert_encoder, encoder_from_jax, seeded_init_
from motionstyle_torch.train.finetune import FinetuneConfig, StyleFinetuneTrainer
from tests.test_torch_finetune import (  # noqa: F401
    CLI_ARGS, _count_twins, _jax_draws, xia_root)
from tests.test_torch_models import one_torch_thread, style_pair  # noqa: F401

ATOL, LOSS_REL, GRAD_REL, STEP_ATOL = 2e-4, 1e-5, 1e-3, 2e-4
LAYERS, WIDTH, C, T, RANK = 2, 32, 12, 8, 4


def _pair(seed: int):
    return style_pair(seed, latent_dim=WIDTH, clip_dim=WIDTH, ff_size=64, dropout=0.0,
                      cond_mask_prob=0.0)


def _numpy_factors(seed: int, rank: int = RANK, layers: int = LAYERS) -> dict:
    """A JAX adapter tree of numpy draws, b away from zero."""
    rs = np.random.RandomState(seed)
    tree = {}
    for site, key in lora.adapter_sites(layers):
        node = tree
        for k in site.split(".")[:-1]:
            node = node.setdefault(k, {})
        dout, din = {"linear1": (64, WIDTH), "linear2": (WIDTH, 64),
                     "in_proj": (3 * WIDTH, WIDTH),
                     "out_proj": (WIDTH, WIDTH)}[site.rsplit(".", 1)[-1]]
        node[site.rsplit(".", 1)[-1]] = {
            "a": (rs.randn(din, rank) / np.sqrt(din)).astype(np.float32),
            "b": (0.1 * rs.randn(rank, dout)).astype(np.float32)}
    return tree


def _port_factors(tree) -> dict:
    """A JAX adapter tree -> the port's factors (through the file format)."""
    return lora.import_lora({k: torch.from_numpy(np.asarray(v))
                             for k, v in jlora.export_lora(tree, 0.0).items()})[0]


def _leaf(tree, site):
    for k in site.split("."):
        tree = tree[k]
    return tree


def _max_rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


# -- the math ---------------------------------------------------------------

def test_zero_init_merge_is_identity():
    _, _, port = _pair(1)
    base = port.style_encoder.state_dict()
    factors = lora.init_lora(base, RANK, torch.Generator().manual_seed(0))
    assert len(factors) == 4 * LAYERS and lora.lora_rank(factors) == RANK
    assert all(float(p["b"].abs().max()) == 0.0 for p in factors.values())
    merged = lora.merge_lora(base, factors)
    assert merged.keys() == base.keys()
    assert all(torch.equal(merged[k], base[k]) for k in base)
    # A ~ N(0, 1/din): a fan-in scaled draw
    a = factors["layers_0.linear2"]["a"]
    assert a.shape == (64, RANK) and 0.5 < float(a.std() * 8.0) < 1.5


def test_alpha_scales_the_delta():
    _, _, port = _pair(2)
    base = port.style_encoder.state_dict()
    factors = _port_factors(_numpy_factors(3))
    key = "layers.0.linear1.weight"
    d2 = lora.merge_lora(base, factors, alpha=2.0)[key] - base[key]
    d8 = lora.merge_lora(base, factors, alpha=8.0)[key] - base[key]
    torch.testing.assert_close(d8, 4.0 * d2, rtol=1e-5, atol=1e-7)
    # alpha 0 or None means alpha = rank: scale 1
    d0 = lora.merge_lora(base, factors, alpha=0.0)[key] - base[key]
    torch.testing.assert_close(d0, lora.merge_lora(base, factors, alpha=RANK)[key] - base[key],
                               rtol=0, atol=0)


@pytest.mark.parametrize("alpha", [0.0, 6.0])
def test_merge_matches_jax(alpha):
    _, params, port = _pair(4)
    tree = _numpy_factors(5)
    want = jlora.merge_lora(params["params"]["style_encoder"], jax.tree_util.tree_map(
        jnp.asarray, tree), alpha)
    want = encoder_from_jax(jax.tree_util.tree_map(np.asarray, want))
    got = lora.merge_lora(port.style_encoder.state_dict(), _port_factors(tree), alpha)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=ATOL, err_msg=k)


def test_sites_follow_the_jax_flattening_order():
    """12 layers: 'layers_10' sorts before 'layers_2', as flax flattens."""
    tree = {f"layers_{i}": {n: {"a": 0, "b": 0} for n in ("linear1", "linear2")}
            | {"self_attn": {n: {"a": 0, "b": 0} for n in ("in_proj", "out_proj")}}
            for i in range(12)}
    paths = [".".join(str(getattr(p, "key", p)) for p in path[:-1])
             for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]][::2]
    assert [site for site, _ in lora.adapter_sites(12)] == paths


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adapter_files_cross_both_ways(writer, tmp_path):
    tree = _numpy_factors(6)
    path = tmp_path / "adapter000000003.pt"
    if writer == "jax":
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in jlora.export_lora(tree, 6.0).items()}, path)
        factors, alpha = lora.import_lora(torch.load(path))
        assert alpha == 6.0
        for site, _ in lora.adapter_sites(LAYERS):
            for n in ("a", "b"):
                np.testing.assert_array_equal(factors[site][n].numpy(), _leaf(tree, site)[n])
    else:
        torch.save(lora.export_lora(_port_factors(tree), 6.0), path)
        sd = {k: v.numpy() for k, v in torch.load(path).items()}
        assert lora.is_adapter_state_dict(sd) and jlora.is_adapter_state_dict(sd)
        back, alpha = jlora.import_lora(sd)
        assert alpha == 6.0
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
            jax.tree_util.tree_map(jnp.asarray, tree))
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_import_refuses_a_file_without_every_site():
    sd = lora.export_lora(_port_factors(_numpy_factors(7)), 4.0)
    with pytest.raises(ValueError, match="no lora"):
        lora.import_lora({"seqTransEncoder.layers.0.linear1.weight": torch.zeros(2, 2)})
    del sd["lora.layers_1.linear2.b"]
    with pytest.raises(ValueError, match="each with 'a' and 'b'"):
        lora.import_lora(sd)


# -- the trainer ------------------------------------------------------------

def _batch(seed: int, B: int = 2):
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
        "enc_text_style": rs.randn(1, WIDTH).astype(np.float32),
        "enc_text_t2m": rs.randn(B, WIDTH).astype(np.float32),
        "inp_mask_t2m": np.repeat(inp, B, 0),
        "frame_mask_t2m": frame,
        "text_features": rs.randn(1, WIDTH).astype(np.float32),
    }


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _jtrainer(jmodel, params, save_dir, **kw):
    cfg = JFinetuneConfig(save_dir=str(save_dir), dropout_rng_impl="threefry", **kw)
    return JTrainer(cfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                    jmake_schedule("cosine", 1000, "ddim20"))


def _trainer(port, save_dir, **kw):
    return StyleFinetuneTrainer(FinetuneConfig(save_dir=str(save_dir), **kw), port,
                                make_schedule("cosine", 1000, "ddim20", device="cpu"))


def _set_factors(trainer, tree):
    with torch.no_grad():
        for site, pair in _port_factors(tree).items():
            for n, v in pair.items():
                trainer.lora[site][n].copy_(v)


@pytest.mark.parametrize("alpha", [0.0, 8.0])
def test_lora_loss_and_factor_grads_match_jax(alpha, tmp_path):
    jmodel, params, port = _pair(21)
    batch = _batch(22)
    t = np.asarray([2, 5], np.int32)
    tree = _numpy_factors(23)
    jt = _jtrainer(jmodel, params, tmp_path / "jax", lora_rank=RANK, lora_alpha=alpha)
    key = jax.random.PRNGKey(3)

    def jloss(factors):
        p = jlora.effective_params(dict(jt.params, lora_style=factors), alpha or RANK)
        return jlosses.few_shot_style_finetune_loss(
            jt.sched, lambda x, tt, c: jmodel.apply({"params": p}, x, tt, c["enc_text"],
                                                    deterministic=False),
            batch["x_start"], jnp.asarray(t), batch["content"], batch["style_target"], key,
            mask=batch["mask"], cond_style={"enc_text": batch["enc_text_style"]},
            cond_t2m={"enc_text": batch["enc_text_t2m"], "frame_mask": batch["frame_mask_t2m"]},
            inpainting_style=JInpainting(batch["inp_mask"], batch["style_target"]),
            inpainting_t2m_mask=batch["inp_mask_t2m"],
            motion_enc_fn=lambda m, c: jmodel.apply({"params": p}, m, c["frame_mask"],
                                                    method=jden.StyleDiffusion.encode_motion),
            text_features=batch["text_features"])["loss"]

    want, jgrads = jax.value_and_grad(jloss)(jax.tree_util.tree_map(jnp.asarray, tree))
    noise_t2m, noise = _jax_draws(key, batch["x_start"].shape, batch["content"].shape)
    trainer = _trainer(port, tmp_path / "port", lora_rank=RANK, lora_alpha=alpha)
    _set_factors(trainer, tree)
    terms = trainer.loss_terms({k: torch.from_numpy(v) for k, v in batch.items()},
                               torch.from_numpy(t).long(), 0, noise_t2m=_t(noise_t2m),
                               noise=_t(noise))
    terms["loss"].backward()
    assert abs(float(terms["loss"]) - float(want)) <= LOSS_REL * abs(float(want))
    for site, _ in lora.adapter_sites(LAYERS):
        for n in ("a", "b"):
            got = trainer.lora[site][n].grad.numpy()
            ref = np.asarray(_leaf(jgrads, site)[n])
            assert _max_rel(got, ref) < GRAD_REL, (site, n, _max_rel(got, ref))
    # nothing of the model itself trains or takes a gradient
    assert all(not p.requires_grad and p.grad is None for p in port.parameters())


def test_lora_trainer_step_matches_jax(tmp_path):
    """One AdamW step on the factors against the JAX trainer's jitted step
    (same batch, t and noise); the base encoder bit-equal."""
    jmodel, params, port = _pair(31)
    batch = _batch(32)
    t = np.asarray([1, 4], np.int32)
    tree = _numpy_factors(33)
    kw = dict(lr=1e-4, weight_decay=1e-2, lora_rank=RANK)
    jt = _jtrainer(jmodel, params, tmp_path / "jax", **kw)
    jt.params["lora_style"] = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = jax.random.PRNGKey(7)
    new_params, _, _ = jt._train_step(jt.params, jt.opt_state, rng,
                                      dict(jax.tree_util.tree_map(jnp.asarray, batch),
                                           t=jnp.asarray(t)))
    noise_t2m, noise = _jax_draws(jax.random.split(rng, 3)[0], batch["x_start"].shape,
                                  batch["content"].shape)
    base = {k: v.clone() for k, v in port.state_dict().items()}
    trainer = _trainer(port, tmp_path / "port", **kw)
    _set_factors(trainer, tree)
    trainer.train_step({k: torch.from_numpy(v) for k, v in batch.items()},
                       torch.from_numpy(t).long(), 0, noise_t2m=_t(noise_t2m), noise=_t(noise))
    assert all(torch.equal(v, base[k]) for k, v in port.state_dict().items())
    diffs = []
    for site, _ in lora.adapter_sites(LAYERS):
        for n in ("a", "b"):
            got = trainer.lora[site][n].detach().numpy()
            want = np.asarray(_leaf(new_params["lora_style"], site)[n])
            assert float(np.abs(got - _leaf(tree, site)[n]).max()) > 5e-5  # it moved
            np.testing.assert_allclose(got, want, atol=STEP_ATOL, err_msg=f"{site}.{n}")
            diffs.append(np.abs(got - want).ravel())
    # Adam's first step is lr * g / (|g| + eps): a sign flip of a near-zero
    # gradient moves one element by 2 lr; everywhere else they agree closely
    assert float((np.concatenate(diffs) < 1e-6).mean()) > 0.95


def _adam_state(jt):
    chain = jt.opt_state.inner_states["trainable"].inner_state
    return chain[0]


def test_optimizer_state_crosses_from_jax_to_the_port(tmp_path):
    """A LoRA run's opt*.pt and adapter*.pt written by the JAX trainer resume
    the port's trainer with the same factors, Adam moments and step."""
    jmodel, params, port = _pair(41)
    jt = _jtrainer(jmodel, params, tmp_path / "jax", lora_rank=RANK, lora_alpha=6.0)
    jt.params["lora_style"] = jax.tree_util.tree_map(jnp.asarray, _numpy_factors(42))
    leaves, treedef = jax.tree_util.tree_flatten(jt.opt_state)
    rs = np.random.RandomState(0)
    jt.opt_state = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(3, a.dtype) if a.ndim == 0
        else jnp.asarray(np.abs(rs.randn(*a.shape)).astype(np.float32)) for a in leaves])
    assert len(leaves) == 1 + 2 * 2 * 4 * LAYERS  # count, mu and nu of a and b at 8 sites
    jt.step = 3
    jt.save()
    assert {"adapter000000003.pt", "model000000003.pt"} <= set(os.listdir(tmp_path / "jax"))
    trainer = _trainer(port, tmp_path / "port", lora_rank=RANK,
                       resume_checkpoint=str(tmp_path / "jax"))
    assert trainer.resume_step == 3 and trainer.lora_alpha == 6.0
    adam = _adam_state(jt)
    for site, _ in lora.adapter_sites(LAYERS):
        for n in ("a", "b"):
            p = trainer.lora[site][n]
            np.testing.assert_array_equal(p.detach().numpy(),
                                          np.asarray(_leaf(jt.params["lora_style"], site)[n]))
            st = trainer.opt.state[p]
            assert float(st["step"]) == 3
            np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                          np.asarray(_leaf(adam.mu["lora_style"], site)[n]))
            np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                          np.asarray(_leaf(adam.nu["lora_style"], site)[n]))


def test_optimizer_state_crosses_from_the_port_to_jax(tmp_path):
    jmodel, params, port = _pair(43)
    trainer = _trainer(port, tmp_path / "port", lora_rank=RANK)
    _set_factors(trainer, _numpy_factors(44))
    rs = np.random.RandomState(1)
    for p, _ in trainer.params:
        trainer.opt.state[p] = {
            "step": torch.tensor(3.0),
            "exp_avg": torch.from_numpy(rs.randn(*p.shape).astype(np.float32)),
            "exp_avg_sq": torch.from_numpy(np.abs(rs.randn(*p.shape)).astype(np.float32))}
    trainer.step = 3
    trainer.save()
    assert sorted(os.listdir(tmp_path / "port")) == [
        "adapter000000003.pt", "model000000003.pt", "opt000000003.pt"]
    jt = _jtrainer(jmodel, params, tmp_path / "jax", lora_rank=RANK,
                   resume_checkpoint=str(tmp_path / "port"))
    assert jt.resume_step == 3
    adam = _adam_state(jt)
    assert int(adam.count) == 3
    for site, _ in lora.adapter_sites(LAYERS):
        for n in ("a", "b"):
            p = trainer.lora[site][n]
            np.testing.assert_array_equal(np.asarray(_leaf(jt.params["lora_style"], site)[n]),
                                          p.detach().numpy())
            np.testing.assert_array_equal(np.asarray(_leaf(adam.mu["lora_style"], site)[n]),
                                          trainer.opt.state[p]["exp_avg"].numpy())
            np.testing.assert_array_equal(np.asarray(_leaf(adam.nu["lora_style"], site)[n]),
                                          trainer.opt.state[p]["exp_avg_sq"].numpy())


def test_checkpoints_hold_the_merged_encoder_and_the_adapter(tmp_path):
    """model*.pt is the merge of adapter*.pt onto the frozen base, and the
    JAX package reads both (convert_encoder, import_lora + merge_lora)."""
    jmodel, params, port = _pair(45)
    base = port.style_encoder.state_dict()
    trainer = _trainer(port, tmp_path, lora_rank=RANK, lora_alpha=2.0)
    _set_factors(trainer, _numpy_factors(46))
    trainer.save()
    merged = convert_encoder(torch.load(tmp_path / "model000000000.pt"), "seqTransEncoder",
                             LAYERS)
    factors, alpha = lora.import_lora(torch.load(tmp_path / "adapter000000000.pt"))
    assert alpha == 2.0
    remerged = lora.merge_lora(base, factors, alpha)
    assert all(torch.equal(merged[k], remerged[k]) for k in merged)
    sd = {k: v.numpy() for k, v in torch.load(tmp_path / "adapter000000000.pt").items()}
    jmerged = jlora.merge_lora(params["params"]["style_encoder"], jlora.import_lora(sd)[0], 2.0)
    for k, v in encoder_from_jax(jax.tree_util.tree_map(np.asarray, jmerged)).items():
        np.testing.assert_allclose(merged[k].numpy(), v.numpy(), atol=ATOL, err_msg=k)


def test_resume_restores_the_factors_exactly(tmp_path):
    _, _, port = _pair(51)
    trainer = _trainer(port, tmp_path, lora_rank=RANK, lr=1e-2)
    batch = {k: torch.from_numpy(v) for k, v in _batch(52).items()}
    for step in range(2):
        trainer.train_step(batch, torch.tensor([3, 5]), step)
        trainer.step += 1
    trainer.save()
    _, _, again = _pair(51)
    resumed = _trainer(again, tmp_path / "next", lora_rank=RANK, resume_checkpoint=str(tmp_path))
    assert resumed.resume_step == 2
    for site, pair in trainer.lora.items():
        for n, p in pair.items():
            assert float(p.detach().abs().max()) > 0
            assert torch.equal(resumed.lora[site][n].detach(), p.detach()), (site, n)
            assert torch.equal(resumed.opt.state[resumed.lora[site][n]]["exp_avg"],
                               trainer.opt.state[p]["exp_avg"])


@pytest.mark.parametrize("case", ["rank_mismatch", "full_resume_of_an_adapter"])
def test_resume_refusals(case, tmp_path):
    _, _, port = _pair(61)
    _trainer(port, tmp_path, lora_rank=RANK).save()
    _, _, again = _pair(61)
    if case == "rank_mismatch":
        with pytest.raises(ValueError, match="rank 4 but --lora_rank is 2"):
            _trainer(again, tmp_path / "next", lora_rank=2, resume_checkpoint=str(tmp_path))
    else:
        with pytest.raises(ValueError, match="adapter checkpoint"):
            _trainer(again, tmp_path / "next",
                     resume_checkpoint=str(tmp_path / "adapter000000000.pt"))


# -- the CLIs ---------------------------------------------------------------

def _lora_args(xia, save_dir, *extra):
    return ["--save_dir", str(save_dir), "--data_dir", xia, *CLI_ARGS, "--save_interval", "1",
            "--lora_rank", "2", "--lr", "1e-2", *extra]


@pytest.fixture(scope="module")
def lora_run(xia_root, tmp_path_factory):  # noqa: F811
    """A port LoRA finetune of 2 steps on the tiny corpus (1 layer, latent
    128), from its seeded start."""
    return ft_main(_lora_args(xia_root, tmp_path_factory.mktemp("lora") / "ft"))


def test_cli_writes_the_merged_model_the_adapter_and_the_moments(lora_run):
    files = sorted(os.listdir(lora_run))
    for step in (1, 2):
        assert {f"model{step:09d}.pt", f"adapter{step:09d}.pt", f"opt{step:09d}.pt"} <= set(files)
    with open(os.path.join(lora_run, "args.json")) as f:
        saved = json.load(f)
    assert saved["lora_rank"] == 2 and saved["package"] == model_util.PACKAGE
    cfg = MDMConfig(njoints=181, nfeats=1, latent_dim=128, num_layers=1)
    start = seeded_init_(StyleDiffusion(cfg), saved["seed"]).style_encoder.state_dict()
    factors, alpha = lora.import_lora(torch.load(os.path.join(lora_run, "adapter000000002.pt")))
    assert alpha == 2.0 and lora.lora_rank(factors) == 2
    assert any(float(p["b"].abs().max()) > 0 for p in factors.values())
    merged = convert_encoder(torch.load(os.path.join(lora_run, "model000000002.pt")),
                             "seqTransEncoder", 1)
    want = lora.merge_lora(start, factors, alpha)
    assert all(torch.equal(merged[k], want[k]) for k in want)
    # 4 sites x (a, b): count, mu, nu
    assert len(torch.load(os.path.join(lora_run, "opt000000002.pt"), weights_only=False)) == 17


def test_demo_with_the_adapter_runs_the_merged_encoder(lora_run, xia_root, tmp_path,  # noqa: F811
                                                      monkeypatch):
    """The demo with --model_path adapter*.pt rebuilds the run's base, merges
    the factors and samples with the same encoder as the run's model*.pt."""
    from motionstyle_torch.cli import demo_style_transfer

    built = []
    factory = model_util.creat_serval_diffusion

    def capture(*a, **k):
        out = factory(*a, **k)
        built.append(out[0])
        return out

    monkeypatch.setattr(demo_style_transfer.model_util, "creat_serval_diffusion", capture)
    out = demo_main(["--model_path", os.path.join(lora_run, "adapter000000002.pt"),
                     "--input_content", "306neutral_running.npy", "--data_dir", xia_root,
                     "--skip_render", "--num_samples", "2", "--output_dir", str(tmp_path),
                     "--device", "cpu"])
    results = np.load(os.path.join(out, "results.npy"), allow_pickle=True).item()
    assert results["motion"].shape == (2, 20, 3, 76) and np.isfinite(results["motion"]).all()
    want = convert_encoder(torch.load(os.path.join(lora_run, "model000000002.pt")),
                           "seqTransEncoder", 1)
    got = built[0].model.style_encoder.state_dict()
    assert all(torch.equal(got[k].cpu(), want[k]) for k in want)


def test_cli_trains_through_the_same_training_kernels(xia_root, tmp_path,  # noqa: F811
                                                      monkeypatch):
    """--lora_rank 2 --fused_train 1: the training kernels' twins (kernels
    5-7 on the card) run as often as without LoRA; the base stays frozen."""
    counts = []
    for extra in ([], ["--lora_rank", "2"]):
        calls = _count_twins(monkeypatch)
        argv = ["--save_dir", str(tmp_path / f"ft{len(counts)}"), "--data_dir", xia_root,
                *CLI_ARGS, "--fused", "1", "--fused_train", "1", *extra]
        ft_main(argv)
        counts.append(dict(calls))
    assert counts[0] == counts[1], counts
    assert counts[1]["fused_layer_train_forward_reference"] > 0


@pytest.mark.parametrize("flags", [
    ["--fused_train_prng", "1"], ["--parallel_finetune", "1", "--fused_train", "1"],
    ["--quant_int8", "1", "--fused_train", "1"], ["--auto_stop", "1", "--auto_stop_interval", "1"],
    ["--fused_train_store", "1", "--lr_anneal_steps", "10"]],
    ids=["prng", "parallel", "quant_int8", "auto_stop", "store_anneal"])
def test_cli_combines_lora_with_the_finetunes_other_flags(flags, xia_root, tmp_path):  # noqa: F811
    """--lora_rank with the flags the JAX finetune combines it with: the
    merged model*.pt is the adapter's merge onto the seeded start, and
    opt*.pt holds the factors' moments (and the schedule's count)."""
    save = ft_main(_lora_args(xia_root, tmp_path / "ft", *flags))
    with open(os.path.join(save, "progress.csv")) as f:
        assert len(f.read().strip().splitlines()) == 3
    cfg = MDMConfig(njoints=181, nfeats=1, latent_dim=128, num_layers=1)
    start = seeded_init_(StyleDiffusion(cfg), 10).style_encoder.state_dict()
    factors, alpha = lora.import_lora(torch.load(os.path.join(save, "adapter000000002.pt")))
    merged = convert_encoder(torch.load(os.path.join(save, "model000000002.pt")),
                             "seqTransEncoder", 1)
    want = lora.merge_lora(start, factors, alpha)
    assert all(torch.equal(merged[k], want[k]) for k in want)
    leaves = torch.load(os.path.join(save, "opt000000002.pt"), weights_only=False)
    assert len(leaves) == 17 + ("--lr_anneal_steps" in flags)
    if "--auto_stop" in flags:
        with open(os.path.join(save, "auto_stop.json")) as f:
            assert sorted(json.load(f)["trace"]) == ["1", "2"]


def test_adapter_resume_through_the_cli(lora_run, xia_root, tmp_path):  # noqa: F811
    """--resume_checkpoint <the run's dir> --lora_rank 2: the factors of its
    newest adapter, the step after it; the demo's base for the new run is
    its seeded start, so its adapter merges to its model*.pt."""
    save = ft_main(_lora_args(xia_root, tmp_path / "ft2", "--resume_checkpoint", lora_run))
    files = os.listdir(save)
    assert "adapter000000004.pt" in files and "model000000004.pt" in files
    cfg = MDMConfig(njoints=181, nfeats=1, latent_dim=128, num_layers=1)
    got = model_util.style_encoder_state(cfg, os.path.join(save, "adapter000000004.pt"), 10)
    want = convert_encoder(torch.load(os.path.join(save, "model000000004.pt")),
                           "seqTransEncoder", 1)
    assert all(torch.equal(got[k], want[k]) for k in want)


# -- adapters where a style is loaded ----------------------------------------

def test_adapter_as_a_styles_and_a_style_mix_entry(lora_run):
    cfg = MDMConfig(njoints=181, nfeats=1, latent_dim=128, num_layers=1)
    adapter = os.path.join(lora_run, "adapter000000002.pt")
    merged_path = os.path.join(lora_run, "model000000002.pt")
    args = SimpleNamespace(model_path=adapter, seed=10, style_strength=1.0, style_mix="")
    styles = model_util.load_named_styles(args, f"a={adapter},m={merged_path}", cfg)
    assert all(torch.equal(styles["a"][k], styles["m"][k]) for k in styles["m"])
    half = model_util.load_named_styles(
        SimpleNamespace(**{**vars(args), "style_strength": 0.5}), f"a={adapter}", cfg)["a"]
    base = model_util._style_base(cfg, adapter, 10)
    for k in half:
        torch.testing.assert_close(half[k], base[k] + 0.5 * (styles["m"][k] - base[k]),
                                   rtol=0, atol=0)
    mixed = []
    for entry in (adapter, merged_path):
        model = seeded_init_(StyleDiffusion(cfg), 0)
        bundle = SimpleNamespace(cfg=cfg, model=model)
        assert model_util.apply_style_mix(bundle, SimpleNamespace(
            **{**vars(args), "style_mix": f"{entry}:0.6"}))
        mixed.append(model.style_encoder.state_dict())
    assert all(torch.equal(mixed[0][k], mixed[1][k]) for k in mixed[0])
    for k in mixed[0]:
        torch.testing.assert_close(mixed[0][k], base[k] + 0.6 * (styles["m"][k] - base[k]),
                                   rtol=0, atol=0)


@pytest.fixture()
def jax_run(tmp_path):
    """A run directory the JAX package wrote: a JAX adapter beside an
    args.json with the given resume checkpoint (a full encoder file)."""
    jcfg = jden.MDMConfig(njoints=181, nfeats=1, latent_dim=WIDTH, ff_size=64,
                          num_layers=LAYERS, num_heads=4, clip_dim=512)
    tree = jden.StyleDiffusion(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 181, 1, 8)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 512)), method=jden.StyleDiffusion.full_init)
    base = tmp_path / "base.pt"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in jexport_style_encoder(tree, LAYERS).items()}, base)

    def make(resume: str):
        run = tmp_path / ("with_base" if resume else "seeded")
        run.mkdir()
        with open(run / "args.json", "w") as f:
            json.dump({"resume_checkpoint": resume, "seed": 10, "lora_rank": RANK}, f)
        path = run / "adapter000000005.pt"
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in jlora.export_lora(_numpy_factors(71), 3.0).items()}, path)
        return str(path)

    return make, str(base)


def test_jax_written_adapter_merges_as_the_jax_package_merges_it(jax_run):
    """A JAX run that recorded its resume checkpoint: the port merges the JAX
    adapter onto that base as the JAX package's apply_style_adapter does."""
    make, base = jax_run
    adapter = make(base)
    cfg = MDMConfig(njoints=181, nfeats=1, latent_dim=WIDTH, ff_size=64, num_layers=LAYERS,
                    clip_dim=512)
    got = model_util.style_encoder_state(cfg, adapter, 10)
    jcfg = jden.MDMConfig(njoints=181, nfeats=1, latent_dim=WIDTH, ff_size=64,
                          num_layers=LAYERS, num_heads=4, clip_dim=512)
    jbundle = SimpleNamespace(cfg=jcfg, params={"params": {}})
    jmodel_util.apply_style_adapter(jbundle, SimpleNamespace(model_path=adapter, seed=10),
                                    jmodel_util.load_torch_state_dict(adapter))
    want = encoder_from_jax(jax.tree_util.tree_map(
        np.asarray, jbundle.params["params"]["style_encoder"]))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=ATOL, err_msg=k)


def test_jax_written_seeded_run_is_refused(jax_run):
    make, _ = jax_run
    adapter = make("")
    cfg = MDMConfig(njoints=181, nfeats=1, latent_dim=WIDTH, ff_size=64, num_layers=LAYERS,
                    clip_dim=512)
    with pytest.raises(SystemExit, match="not written by motionstyle_torch"):
        model_util.style_encoder_state(cfg, adapter, 10)
    args = SimpleNamespace(dataset="stylexia_posrot", latent_dim=WIDTH, layers=LAYERS, seed=10,
                           model_path=adapter, mdm_path="", clip_weights="")
    with pytest.raises(SystemExit, match="not written by motionstyle_torch"):
        model_util.build_model(args, device="cpu")
