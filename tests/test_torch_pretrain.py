"""The port's prior pretraining (train/pretrain.py, cli/pretrain_prior.py)
against the JAX package's PriorTrainer on the CPU, mirroring
tests/test_pretrain.py: one step's loss and updated prior against the JAX
trainer's jitted step with t, noise and the condition mask pinned and
dropout off; the frozen subtrees; grad_accum; the LR anneal; EMA; the
loss-second-moment sampler; mdm.pt, model_pretrained.pt, mdm_ema.pt and
opt{step}.pt crossing both ways; the CLI's total-budget resume and the flags
this slice refuses.

Model: 2 layers, d=64, 4 heads, ff 128 (tests/test_torch_models.py's small
config), weights carried over from the JAX tree by from_jax_params.
Tolerances: loss rel 1e-5 and a step's updated weights atol 2e-4 (Adam's
first update is lr * sign(g) where g is far from 0; where it is near 0 the
two sides' summation order can flip the sign, a difference of up to 2 lr,
tests/test_torch_finetune.py), EMA atol 1e-6 (tests/test_pretrain.py).
"""
import csv
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.diffusion.resample import LossSecondMomentResampler as JLossSampler
from motionstyle.diffusion.schedule import make_schedule as jmake_schedule
from motionstyle.models import denoiser as jden
from motionstyle.models.torch_import import convert_encoder as jconvert_encoder
from motionstyle.models.torch_import import convert_mdm as jconvert_mdm
from motionstyle.train.pretrain import PretrainConfig as JPretrainConfig
from motionstyle.train.pretrain import PriorTrainer as JPriorTrainer
from motionstyle_torch.cli.pretrain_prior import main as pretrain_main
from motionstyle_torch.diffusion.resample import (
    LossSecondMomentResampler, UniformSampler, create_named_schedule_sampler)
from motionstyle_torch.diffusion.schedule import make_schedule
from motionstyle_torch.models.params import encoder_from_jax, from_jax_params, mdm_leaves
from motionstyle_torch.ops import fused_encoder_train as ft
from motionstyle_torch.train.pretrain import PretrainConfig, PriorTrainer
from tests.test_torch_models import one_torch_thread, small_cfgs, style_pair  # noqa: F401

LOSS_REL, STEP_ATOL, EMA_ATOL = 1e-5, 2e-4, 1e-6
C, T, CLIP, L = 12, 8, 32, 2
STEPS = 50  # diffusion steps of the schedules


def _pair(seed: int, **kw):
    kw.setdefault("dropout", 0.0)
    return style_pair(seed, **kw)


def _batch(seed: int, B: int = 4) -> dict:
    rs = np.random.RandomState(seed)
    mask = np.ones((B, 1, 1, T), np.float32)
    mask[1, ..., 6:] = 0.0
    return {"x_start": (rs.randn(B, C, 1, T) * 0.5).astype(np.float32),
            "enc_text": rs.randn(B, CLIP).astype(np.float32), "mask": mask}


def _trainer(port, tmp_path, name="port", **kw):
    cfg = PretrainConfig(save_dir=str(tmp_path / name), log_interval=0, seed=3, **kw)
    return PriorTrainer(cfg, port, make_schedule("cosine", STEPS, device="cpu"))


def _jtrainer(jmodel, params, tmp_path, name="jax", **kw):
    cfg = JPretrainConfig(save_dir=str(tmp_path / name), log_interval=0, seed=3,
                          dropout_rng_impl="threefry", **kw)
    return JPriorTrainer(cfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                         jmake_schedule("cosine", STEPS))


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _mdm_state(tree) -> dict:
    """A flax MDM subtree as the port's MDM state dict."""
    return from_jax_params(jax.device_get(tree), small_cfgs()[1])


def _jax_pinned(jt, rng, batch):
    """The noise and masked condition the JAX step draws from `rng`
    (pretrain.py:217-233)."""
    _, rng_noise, _, rng_cond = jax.random.split(rng, 4)
    noise = jax.random.normal(rng_noise, batch["x_start"].shape, dtype=jnp.float32)
    enc = jden.mask_cond(rng_cond, jnp.asarray(batch["enc_text"]), jt.cfg.cond_mask_prob)
    return torch.from_numpy(np.asarray(noise)), torch.from_numpy(np.asarray(enc))


def test_mdm_leaves_are_the_jax_flattening_order():
    jmodel, params, port = _pair(1)
    want = [tuple(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(params["params"]["mdm"])]
    got = mdm_leaves(L)
    assert [path for path, _, _ in got] == want
    names = dict(port.mdm.named_parameters())
    assert sorted(key for _, key, _ in got) == sorted(names)


@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_one_step_matches_jax(wd, tmp_path):
    """One AdamW step on the prior against the JAX trainer's jitted step:
    same batch, t and importance weights, the JAX step's noise and masked
    condition pinned, dropout off."""
    jmodel, params, port = _pair(11)
    batch = _batch(12)
    t = np.asarray([3, 17, 40, 0], np.int32)
    tw = np.asarray([1.0, 0.5, 2.0, 1.0], np.float32)
    jt = _jtrainer(jmodel, params, tmp_path, lr=1e-4, weight_decay=wd, cond_mask_prob=0.5)
    rng = jax.random.PRNGKey(7)
    noise, enc = _jax_pinned(jt, rng, batch)
    jbatch = dict(jax.tree_util.tree_map(jnp.asarray, batch), t=jnp.asarray(t),
                  t_weights=jnp.asarray(tw))
    new_params, _, _, jloss, jper = jt._train_step(jt.params, jt.opt_state, jt.ema, rng, jbatch)

    frozen = {k: v.clone() for k, v in port.state_dict().items() if not k.startswith("mdm.")}
    before = {k: v.clone() for k, v in port.mdm.state_dict().items()}
    tr = _trainer(port, tmp_path, lr=1e-4, weight_decay=wd)
    loss, per = tr.train_step(_tensors(batch), torch.from_numpy(t).long(), torch.from_numpy(tw),
                              noise=noise, enc=enc)
    assert abs(float(loss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), rtol=LOSS_REL)
    want = _mdm_state(new_params["mdm"])
    got = port.mdm.state_dict()
    assert max(float((got[k] - before[k]).abs().max()) for k in got) > 5e-5
    diffs = []
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=STEP_ATOL, err_msg=k)
        diffs.append((v - want[k]).abs().flatten())
    assert float((torch.cat(diffs) < 1e-6).float().mean()) > 0.95
    # the style encoder, the discriminator and the queries did not move
    for k, v in port.state_dict().items():
        if not k.startswith("mdm."):
            torch.testing.assert_close(v, frozen[k], rtol=0, atol=0, msg=k)
    assert all(not p.requires_grad for n, p in port.named_parameters() if not n.startswith("mdm."))


def test_quant_int8_first_loss_matches_jax(tmp_path):
    """Under quant_int8 and fused_train (bf16, as the CLIs set them) the
    first step's loss matches the JAX trainer's: both packages' training
    forwards take their plain layers (motionstyle/models/transformer.py:
    217-218), within rel 1e-2 (bf16, tests/test_torch_int8.py's bound)."""
    jmodel, params, port = _pair(13, quant_int8=True, fused=True, fused_train=True,
                                 dtype="bfloat16")
    batch = _batch(14)
    t = np.asarray([3, 17, 40, 0], np.int32)
    tw = np.ones(4, np.float32)
    jt = _jtrainer(jmodel, params, tmp_path, lr=1e-4, cond_mask_prob=0.5)
    rng = jax.random.PRNGKey(9)
    noise, enc = _jax_pinned(jt, rng, batch)
    jbatch = dict(jax.tree_util.tree_map(jnp.asarray, batch), t=jnp.asarray(t),
                  t_weights=jnp.asarray(tw))
    jloss = jt._train_step(jt.params, jt.opt_state, jt.ema, rng, jbatch)[3]
    loss, _ = _trainer(port, tmp_path, lr=1e-4).train_step(
        _tensors(batch), torch.from_numpy(t).long(), torch.from_numpy(tw), noise=noise, enc=enc)
    assert abs(float(loss) - float(jloss)) <= 1e-2 * abs(float(jloss)), (loss, jloss)


def test_grad_accum_equals_the_full_batch(tmp_path):
    """grad_accum=4 is the full-batch trajectory at dropout 0: the same draws
    of t, noise and condition mask, and equal-sized microbatch means."""
    _, _, a = _pair(21)
    _, _, b = _pair(21)
    t1 = _trainer(a, tmp_path, "a1", lr=1e-3)
    t4 = _trainer(b, tmp_path, "a4", lr=1e-3, grad_accum=4)
    for i in range(3):
        batch = _batch(30 + i, B=8)
        l1, l4 = float(t1.run_step(batch)), float(t4.run_step(batch))
        assert np.isclose(l1, l4, rtol=1e-5), (i, l1, l4)
    with pytest.raises(ValueError, match="grad_accum"):
        _trainer(a, tmp_path, "bad", grad_accum=3).run_step(_batch(1, B=8))


@pytest.mark.parametrize("fused_prng", [False, True])
def test_grad_accum_microbatches_draw_their_own_dropout(fused_prng, tmp_path):
    """At rate > 0 each microbatch draws its own dropout (masks, or with the
    fused prng layer its own seeds): two identical halves of a batch with t,
    noise and condition pinned give different per-sample losses."""
    kw = dict(fused_train_prng=True, dtype="bfloat16") if fused_prng else {}
    _, _, port = _pair(22, dropout=0.5, **kw)
    tr = _trainer(port, tmp_path, grad_accum=2)
    half = _batch(23, B=2)
    batch = _tensors({k: np.concatenate([v, v]) for k, v in half.items()})
    t = torch.tensor([5, 9, 5, 9])
    calls = ft.make_dropout_masks.calls
    _, per = tr.train_step(batch, t, torch.ones(4), noise=torch.zeros(4, C, 1, T),
                           enc=batch["enc_text"])
    assert not torch.allclose(per[:2], per[2:])
    if fused_prng:
        assert ft.make_dropout_masks.calls == calls


def test_lr_anneal_reaches_zero(tmp_path):
    """After lr_anneal_steps updates the LR is 0: the third step leaves the
    prior bit-unchanged (AdamW scales the update and the decay by the LR)."""
    _, _, port = _pair(24)
    tr = _trainer(port, tmp_path, lr=1e-3, lr_anneal_steps=2)
    tr.run_step(_batch(0))
    tr.run_step(_batch(1))
    frozen = {k: v.clone() for k, v in port.mdm.state_dict().items()}
    tr.run_step(_batch(2))
    for k, v in port.mdm.state_dict().items():
        torch.testing.assert_close(v, frozen[k], rtol=0, atol=0, msg=k)


def test_ema_follows_the_reference_recursion(tmp_path):
    """ema_t = rate * ema_{t-1} + (1 - rate) * param_t over 4 steps."""
    _, _, port = _pair(25)
    tr = _trainer(port, tmp_path, lr=1e-3, ema_rate=0.9)
    host = {k: v.clone().double() for k, v in port.mdm.state_dict().items()}
    for i in range(4):
        tr.run_step(_batch(i))
        host = {k: 0.9 * host[k] + 0.1 * v.double() for k, v in port.mdm.state_dict().items()}
    for k, v in tr.ema.items():
        np.testing.assert_allclose(v.numpy(), host[k].numpy(), atol=EMA_ATOL, err_msg=k)
    assert _trainer(port, tmp_path, "off").ema == {}


def test_loss_second_moment_sampler_matches_jax():
    """The same (t, loss) history gives the JAX sampler's weights; draws stay
    in the support and carry 1/(|support| p[t]) as importance weights."""
    rs = np.random.RandomState(0)
    port, jax_s = LossSecondMomentResampler(20), JLossSampler(20)
    for _ in range(12):  # past the warmup (10 losses per timestep), then rolling
        ts = rs.permutation(20)
        ls = rs.rand(20) * (1 + ts)
        port.update_with_local_losses(ts, ls)
        jax_s.update_with_local_losses(ts, ls)
    assert port._warmed_up() and jax_s._warmed_up()
    np.testing.assert_array_equal(port.weights(), jax_s.weights())
    gen = torch.Generator().manual_seed(0)
    for rng in (None, 12, (4, 15)):
        t, w = port.sample(gen, 256, data_range=rng)
        jt, jw = jax_s.sample(jax.random.PRNGKey(0), 256, data_range=rng)
        lo, hi = (0, 20) if rng is None else ((0, rng) if isinstance(rng, int) else rng)
        assert int(t.min()) >= lo and int(t.max()) < hi
        assert set(np.asarray(jt).tolist()) <= set(range(lo, hi))
        p = jax_s.weights() * ((np.arange(20) >= lo) & (np.arange(20) < hi))
        p = p / p.sum()
        np.testing.assert_allclose(w.numpy(), 1.0 / ((hi - lo) * p[t.numpy()]), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(jw), 1.0 / ((hi - lo) * p[np.asarray(jt)]),
                                   rtol=1e-6)
    assert isinstance(create_named_schedule_sampler("uniform", 5), UniformSampler)
    for name in ("loss-second-moment", "loss_second_moment"):
        assert isinstance(create_named_schedule_sampler(name, 5), LossSecondMomentResampler)
    with pytest.raises(ValueError, match="schedule_sampler"):
        create_named_schedule_sampler("bogus", 5)


def test_loss_aware_pretrain_updates_the_history_one_step_late(tmp_path):
    _, _, port = _pair(26)
    tr = _trainer(port, tmp_path, lr=1e-3, grad_accum=2, schedule_sampler="loss_second_moment")
    losses = [float(tr.run_step(_batch(0, B=8))) for _ in range(6)]
    assert np.isfinite(losses).all()
    assert tr.sampler._loss_counts.sum() == 5 * 8  # 5 of 6 steps' losses, none capped yet
    with pytest.raises(ValueError, match="schedule_sampler"):
        _trainer(port, tmp_path, "bad", schedule_sampler="bogus")


def test_checkpoints_cross_both_ways(tmp_path):
    """mdm.pt, model_pretrained.pt and mdm_ema.pt of the port load into the
    JAX converters as the same trees; the JAX trainer's mdm.pt loads into
    the port."""
    jmodel, params, port = _pair(31)
    tr = _trainer(port, tmp_path, ema_rate=0.5, lr=1e-3)
    tr.run_step(_batch(0))
    mdm_path, warm_path = tr.save()
    assert sorted(os.listdir(tmp_path / "port")) == ["mdm.pt", "mdm_ema.pt",
                                                      "model_pretrained.pt"]
    sd = {k: v.numpy() for k, v in torch.load(mdm_path).items()}
    jtree = jconvert_mdm(sd, jmodel.cfg)
    assert jax.tree_util.tree_structure(jtree) == \
        jax.tree_util.tree_structure(params["params"]["mdm"])
    for k, v in _mdm_state(jtree).items():
        torch.testing.assert_close(v, port.mdm.state_dict()[k], rtol=0, atol=0, msg=k)
    warm = {k: v.numpy() for k, v in torch.load(warm_path).items()}
    enc = jconvert_encoder(warm, "seqTransEncoder", L)
    for k, v in encoder_from_jax(enc).items():
        torch.testing.assert_close(v, port.mdm.seqTransEncoder.state_dict()[k], rtol=0, atol=0)
    ema = {k: v.numpy() for k, v in torch.load(tmp_path / "port" / "mdm_ema.pt").items()}
    for k, v in _mdm_state(jconvert_mdm(ema, jmodel.cfg)).items():
        torch.testing.assert_close(v, tr.ema[k], rtol=0, atol=0, msg=k)

    # the JAX trainer's mdm.pt into a fresh port trainer's resume path
    jt = _jtrainer(jmodel, params, tmp_path)
    jt.save()
    _, _, other = _pair(32)
    loaded = PriorTrainer(PretrainConfig(save_dir=str(tmp_path / "x")), other,
                          make_schedule("cosine", STEPS, device="cpu"))._load_prior(
        str(tmp_path / "jax" / "mdm.pt"))
    for k, v in _mdm_state(params["params"]["mdm"]).items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0, msg=k)


def _jax_adam(jt):
    """(Adam state, schedule count or None) of the JAX trainer's optax.adamw
    state: (ScaleByAdamState, EmptyState, schedule state)."""
    sched = jt.opt_state[-1]
    return jt.opt_state[0], (sched.count if "count" in getattr(sched, "_fields", ()) else None)


@pytest.mark.parametrize("anneal", [0, 10])
def test_optimizer_state_crosses_from_the_port_to_jax(anneal, tmp_path):
    """The port's opt{step}.pt resumes the JAX trainer with the same Adam
    count, moments and schedule count over the whole 'mdm' subtree (the JAX
    loader swallows a mismatch, so the loaded leaves are compared)."""
    jmodel, params, port = _pair(41)
    kw = dict(lr=1e-3, weight_decay=1e-2, lr_anneal_steps=anneal)
    tr = _trainer(port, tmp_path, **kw)
    tr.run_step(_batch(0))
    tr.run_step(_batch(1))
    path = tr.save_step()
    assert path.endswith("mdm000000002.pt")
    jt = _jtrainer(jmodel, params, tmp_path, resume_checkpoint=path, **kw)
    assert jt.resume_step == 2
    got = [np.asarray(x) for x in jax.tree_util.tree_leaves(jt.opt_state)]
    want = tr.optimizer_leaves()
    assert len(got) == len(want) == 2 * len(mdm_leaves(L)) + (2 if anneal else 1)
    assert int(got[0]) == 2 and (int(got[-1]) == 2 if anneal else True)
    assert any(a.size > 1 and np.any(a != 0) for a in want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for k, v in _mdm_state(jt.params["mdm"]).items():
        torch.testing.assert_close(v, port.mdm.state_dict()[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("anneal", [0, 10])
def test_optimizer_state_crosses_from_jax_to_the_port(anneal, tmp_path):
    """The JAX trainer's opt{step}.pt resumes the port's trainer with the same
    moments, step and learning rate."""
    jmodel, params, port = _pair(42)
    kw = dict(lr=1e-3, weight_decay=1e-2, lr_anneal_steps=anneal)
    jt = _jtrainer(jmodel, params, tmp_path, **kw)
    for i in range(3):
        jt.run_step(_batch(i))
    jpath = jt.save_step()
    tr = _trainer(port, tmp_path, resume_checkpoint=jpath, **kw)
    assert tr.resume_step == 3
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jt._canon_opt_state())]
    got = tr.optimizer_leaves()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    want_lr = 1e-3 * (1 - 3 / anneal) if anneal else 1e-3
    assert tr.opt.param_groups[0]["lr"] == pytest.approx(want_lr, rel=1e-6)
    for k, v in _mdm_state(jt.params["mdm"]).items():
        torch.testing.assert_close(port.mdm.state_dict()[k], v, rtol=0, atol=0, msg=k)


def test_resume_restores_state_and_keeps_the_anneal_without_an_opt_file(tmp_path):
    """save_step + resume restores the prior, Adam and EMA exactly; without
    opt{step}.pt the moments restart but the LR anneal stays at the resumed
    step, so a resume past the anneal keeps the prior frozen."""
    _, _, a = _pair(51)
    tr = _trainer(a, tmp_path, "run", lr=1e-3, lr_anneal_steps=2, ema_rate=0.5)
    tr.run_step(_batch(0))
    tr.run_step(_batch(1))
    path = tr.save_step()
    _, _, b = _pair(52)
    tr2 = _trainer(b, tmp_path, "run2", lr=1e-3, lr_anneal_steps=2, ema_rate=0.5,
                   resume_checkpoint=str(tmp_path / "run"))
    assert tr2.resume_step == 2
    for x, y in zip(tr.optimizer_leaves(), tr2.optimizer_leaves()):
        np.testing.assert_array_equal(x, y)
    for k, v in tr.ema.items():
        torch.testing.assert_close(tr2.ema[k], v, rtol=0, atol=0)
    os.remove(os.path.join(os.path.dirname(path), "opt000000002.pt"))
    _, _, c = _pair(53)
    tr3 = _trainer(c, tmp_path, "run3", lr=1e-3, lr_anneal_steps=2, resume_checkpoint=path)
    assert tr3.opt.param_groups[0]["lr"] == 0.0
    frozen = {k: v.clone() for k, v in c.mdm.state_dict().items()}
    tr3.run_step(_batch(2))
    for k, v in c.mdm.state_dict().items():
        torch.testing.assert_close(v, frozen[k], rtol=0, atol=0, msg=k)


def test_preemption_sets_the_flag(tmp_path):
    _, _, port = _pair(54)
    tr = _trainer(port, tmp_path)
    old = signal.getsignal(signal.SIGTERM)
    try:
        tr.install_preemption_handler()
        tr.run_step(_batch(0))
        os.kill(os.getpid(), signal.SIGTERM)
        assert tr.preempted
    finally:
        tr.restore_signal_handlers()
        signal.signal(signal.SIGTERM, old)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def xia_root(tmp_path_factory):
    """The synthetic Xia-layout corpus of tests/test_pretrain.py:221-230."""
    root = tmp_path_factory.mktemp("pretrain_xia")
    (root / "new_joint_vecs").mkdir()
    r = np.random.RandomState(0)
    for f in ["350angry_jumping.npy", "306neutral_running.npy", "100angry_walking.npy",
              "101proud_walking.npy"]:
        np.save(root / "new_joint_vecs" / f, (r.randn(40, 181) * 0.5).astype(np.float32))
    np.save(root / "Mean.npy", (r.randn(181) * 0.1).astype(np.float32))
    np.save(root / "Std.npy", (np.abs(r.randn(181)) + 0.5).astype(np.float32))
    return str(root)


from tests.test_torch_finetune import bandai_root, hml_root  # noqa: E402,F401
from tests.test_torch_finetune import check_item12_flag, run_losses  # noqa: E402


def _cli(xia_root, save_dir, *extra):
    return ["--dataset", "stylexia_posrot", "--data_dir", xia_root, "--save_dir", save_dir,
            "--batch_size", "2", "--layers", "1", "--latent_dim", "64", "--diffusion_steps",
            "20", "--log_interval", "1", "--seed", "7", "--device", "cpu", *extra]


def test_cli_resume_counts_the_total_budget(xia_root, tmp_path):
    """--resume_checkpoint picks up the step --save_interval wrote, and
    --num_steps counts the TOTAL budget."""
    save_dir = str(tmp_path / "prior")
    pretrain_main(_cli(xia_root, save_dir, "--num_steps", "3", "--save_interval", "3"))
    assert os.path.exists(os.path.join(save_dir, "mdm000000003.pt"))
    assert os.path.exists(os.path.join(save_dir, "opt000000003.pt"))
    pretrain_main(_cli(xia_root, save_dir, "--num_steps", "5", "--resume_checkpoint", save_dir))
    with open(os.path.join(save_dir, "progress.csv")) as f:
        steps = [int(r["prior_step"]) for r in csv.DictReader(f)]
    assert steps == [4, 5]
    for name in ("mdm.pt", "model_pretrained.pt", "args.json"):
        assert os.path.exists(os.path.join(save_dir, name)), name


def test_cli_trains_with_the_prng_layer_and_writes_ema(xia_root, tmp_path):
    """--fused_train_prng 1 alone trains through the fused layer's twins with
    seeds, never with mask arrays; with --ema_rate, mdm_ema.pt is written."""
    calls = ft.make_dropout_masks.calls
    prng0 = ft.fused_layer_train_forward.prng_launches
    save_dir = str(tmp_path / "prior")
    pretrain_main(_cli(xia_root, save_dir, "--num_steps", "2", "--fused_train_prng", "1",
                       "--grad_accum", "2", "--ema_rate", "0.9",
                       "--schedule_sampler", "loss_second_moment"))
    assert ft.make_dropout_masks.calls == calls
    assert ft.fused_layer_train_forward.prng_launches == prng0  # twins on the CPU: no launch
    with open(os.path.join(save_dir, "progress.csv")) as f:
        losses = [float(r["prior_loss"]) for r in csv.DictReader(f)]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert sorted(n for n in os.listdir(save_dir) if n.endswith(".pt")) == [
        "mdm.pt", "mdm_ema.pt", "model_pretrained.pt"]


@pytest.mark.parametrize("flag", [
    ["--pipeline_parallel", "2"], ["--fsdp", "1"], ["--data_parallel", "1"],
    ["--model_parallel", "2"]])
def test_cli_refuses_what_is_not_ported(flag, xia_root, tmp_path, capsys):
    """The scale-out flags are ported (tests/test_torch_pipeline.py, test_torch_
    fsdp.py); on one rank each does what the JAX CLI does on one device:
    --pipeline_parallel 2 and --model_parallel 2 do not divide it, --fsdp
    needs a mesh, --data_parallel 1 trains on the one device."""
    argv = _cli(xia_root, str(tmp_path / "p"), "--num_steps", "1", *flag)
    if flag[0] in ("--pipeline_parallel", "--model_parallel"):
        with pytest.raises(ValueError, match=f"{flag[0]} 2 does not divide"):
            pretrain_main(argv)
    elif flag[0] == "--fsdp":
        with pytest.raises(SystemExit, match="--fsdp needs a mesh"):
            pretrain_main(argv)
    else:
        pretrain_main(argv)
        assert "running single-device" in capsys.readouterr().out
        assert os.path.exists(tmp_path / "p" / "mdm.pt")


@pytest.fixture(scope="module")
def plain_pretrain(xia_root, tmp_path_factory):
    return run_losses(pretrain_main, _cli(xia_root, str(tmp_path_factory.mktemp("p_plain")),
                                          "--num_steps", "2"), "prior_loss")[1]


@pytest.mark.parametrize("flag", ["--native_loader", "--prefetch", "--profile"])
def test_cli_runs_the_host_pieces(flag, xia_root, tmp_path, monkeypatch, plain_pretrain):
    """--native_loader 1, --prefetch 2 and --profile DIR on the pretrain CLI
    (check_item12_flag): the same losses as without, a parsing trace."""
    check_item12_flag(flag, pretrain_main, _cli(xia_root, str(tmp_path / "p"), "--num_steps",
                                                "2"), "prior_loss", tmp_path, monkeypatch,
                      plain_pretrain)


@pytest.mark.parametrize("dataset", ["humanml", "bandai-1_posrot", "bandai-2_posrot"])
def test_cli_trains_on_every_family(dataset, hml_root, bandai_root, tmp_path,  # noqa: F811
                                    monkeypatch):
    """The humanml and bandai corpora through the pretrain CLI (196-frame
    clips: S=197, the humanml captions from texts/): finite losses, the
    three files, a prior of the family's width; --num_frames reaches the
    loader as the JAX CLI passes it (motionstyle/cli/pretrain_prior.py:110-115)."""
    from motionstyle_torch.cli import pretrain_prior

    seen = []
    orig = pretrain_prior.get_dataset_loader

    def recorded(*a, **k):
        seen.append(a)
        return orig(*a, **k)

    monkeypatch.setattr(pretrain_prior, "get_dataset_loader", recorded)
    root = hml_root if dataset == "humanml" else bandai_root
    save_dir = str(tmp_path / "p")
    argv = _cli(root, save_dir, "--num_steps", "2", "--num_frames", "77")
    argv[argv.index("stylexia_posrot")] = dataset
    pretrain_main(argv)
    assert seen == [(dataset, 2, 77)]
    with open(os.path.join(save_dir, "progress.csv")) as f:
        losses = [float(r["prior_loss"]) for r in csv.DictReader(f)]
    assert len(losses) == 2 and np.isfinite(losses).all()
    sd = torch.load(os.path.join(save_dir, "mdm.pt"))
    assert sd["input_process.poseEmbedding.weight"].shape == (
        64, {"humanml": 263}.get(dataset, 190))
