"""Progressive prior distillation of the port (motionstyle_torch/diffusion/
distillation.py, cli/distill_prior.py) against the JAX package's
(motionstyle/diffusion/distillation.py, tests/test_distillation.py) on the
CPU.

The core identity: the student's x0 target is the exact inversion of one
student DDIM step onto the two-step teacher output, on aligned grids. Then
the stage loss and its gradients against the JAX loss on the same weights
(numpy-made, carried over by from_jax_params) with the student indices j and
the noise pinned to the JAX distiller's draws; one AdamW step against the
JAX distiller's jitted step; the checkpoint both ways; the CLI. The JAX test
samples its students through eval_metrics (not ported); these sample them
with the port's own DDIM sampler. Tolerances: the target identity rtol 2e-4,
atol 2e-5 (as the JAX test); the port against JAX fp32 atol 2e-4
(tests/test_models.py:35), the loss rel 1e-5 and gradients max-rel 1e-3 per
leaf (tests/test_torch_finetune.py:45).
"""
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.diffusion import ddpm as jddpm
from motionstyle.diffusion import distillation as jdist
from motionstyle.diffusion.schedule import make_schedule as jmake_schedule
from motionstyle.models import denoiser as jden
from motionstyle.models.torch_import import (
    assemble_style_diffusion_params, load_torch_state_dict)
from motionstyle_torch.cli import model_util
from motionstyle_torch.cli.distill_prior import main as distill_main, parse_args
from motionstyle_torch.diffusion import ddpm, sampling
from motionstyle_torch.diffusion.distillation import (
    DistillConfig, ProgressiveDistiller, ddim_step, distill_target, snr_weight)
from motionstyle_torch.diffusion.schedule import make_schedule
from motionstyle_torch.models.params import from_jax_params, from_torch_state_dict
from tests.test_torch_models import one_torch_thread, style_pair  # noqa: F401

ATOL, LOSS_REL, GRAD_REL = 2e-4, 1e-5, 1e-3
WIDTH, C, T, B, STEPS = 32, 12, 8, 3, 8


def _toy(x, t_orig, cond):
    """tests/test_distillation.py's toy teacher."""
    return 0.9 * torch.tanh(x) + 0.05 * torch.cos(t_orig.float()).reshape(
        (-1,) + (1,) * (x.ndim - 1))


def _jtoy(x, t_orig, cond):
    return 0.9 * jnp.tanh(x) + 0.05 * jnp.cos(t_orig.astype(jnp.float32)).reshape(
        (-1,) + (1,) * (x.ndim - 1))


def _sched(respacing=None):
    return make_schedule("cosine", 64, respacing, device="cpu")


def test_student_grid_is_every_second_teacher_index():
    base, teacher, student = _sched(), _sched("ddim16"), _sched("ddim8")
    torch.testing.assert_close(teacher.alphas_cumprod, base.alphas_cumprod[::4], rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(student.alphas_cumprod, teacher.alphas_cumprod[::2], rtol=1e-6,
                               atol=0)
    assert torch.equal(student.timestep_map, teacher.timestep_map[::2])


@pytest.mark.parametrize("j_val", [0, 1, 3, 7])
def test_target_inverts_two_teacher_steps(j_val):
    """The target in ONE student step on the halved grid reproduces the TWO
    teacher steps (up to fp32 rounding), and equals the JAX target."""
    teacher, student = _sched("ddim16"), _sched("ddim8")
    x_t = np.random.RandomState(j_val).randn(2, 6, 1, 5).astype(np.float32)
    j = torch.full((2,), j_val)
    tgt = distill_target(teacher, _toy, torch.from_numpy(x_t), j, {})
    x_mid, _ = ddim_step(teacher, _toy, torch.from_numpy(x_t), 2 * j, {})
    x_lo, _ = ddim_step(teacher, _toy, x_mid, (2 * j - 1).clamp_min(0), {})
    x_student, _ = ddim_step(student, lambda x, t, c: tgt, torch.from_numpy(x_t), j, {})
    np.testing.assert_allclose(x_student.numpy(), x_lo.numpy(), rtol=2e-4, atol=2e-5)
    want = jdist.distill_target(jmake_schedule("cosine", 64, "ddim16"), _jtoy, jnp.asarray(x_t),
                                jnp.full((2,), j_val, jnp.int32), {})
    np.testing.assert_allclose(tgt.numpy(), np.asarray(want), rtol=1e-5, atol=ATOL)


def test_ddim_step_matches_jax_and_the_sample_loop_update():
    sched = _sched("ddim16")
    x = np.random.RandomState(0).randn(2, 6, 1, 5).astype(np.float32)
    t = torch.tensor([3, 0])
    ours, x0 = ddim_step(sched, _toy, torch.from_numpy(x), t, {})
    want, _ = jdist.ddim_step(jmake_schedule("cosine", 64, "ddim16"), _jtoy, jnp.asarray(x),
                              jnp.asarray([3, 0], jnp.int32), {})
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    pmv = ddpm.p_mean_variance(sched, _toy, torch.from_numpy(x), t, {})
    ref = sampling._ddim_update(sched, pmv, torch.from_numpy(x), t, torch.zeros(2, 6, 1, 5),
                                None, 0.0)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
    # at t == 0 the update returns the x0 prediction
    np.testing.assert_allclose(ours[1].numpy(), x0[1].numpy(), rtol=0, atol=1e-6)


def test_snr_weight_matches_jax():
    sched, jsched = _sched("ddim16"), jmake_schedule("cosine", 64, "ddim16")
    t = np.arange(16)
    got = snr_weight(sched, torch.from_numpy(t), 4)
    want = jdist.snr_weight(jsched, jnp.asarray(t), 4)
    assert got.shape == (16, 1, 1, 1) and float(got.min()) == 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# -- one stage step against the JAX distiller --------------------------------

def _pair(seed: int):
    return style_pair(seed, njoints=C, latent_dim=WIDTH, clip_dim=WIDTH, ff_size=64,
                      num_layers=1, dropout=0.0)


def _batch(seed: int):
    rs = np.random.RandomState(seed)
    mask = np.ones((B, 1, 1, T), np.float32)
    mask[1, ..., 5:] = 0.0
    return {"x_start": rs.randn(B, C, 1, T).astype(np.float32),
            "enc_text": rs.randn(B, WIDTH).astype(np.float32), "mask": mask}


def _jax_draws(rng, n_student: int):
    """The student indices and noise the JAX stage step draws from `rng`."""
    rng_noise, rng_j = jax.random.split(rng)
    j = jax.random.randint(rng_j, (B,), 0, n_student)
    noise = jax.random.normal(rng_noise, (B, C, 1, T), jnp.float32)
    return torch.from_numpy(np.asarray(j)).long(), torch.from_numpy(np.asarray(noise))


def _port_distiller(port, tmp_path, **kw):
    return ProgressiveDistiller(DistillConfig(save_dir=str(tmp_path), **kw), port, "cosine",
                                STEPS)


def _jloss(jmodel, params, sched, guidance, batch, j, noise):
    """The JAX distiller's stage loss (distillation.py:162-197) as a function
    of the student's 'mdm' subtree, the teacher the given params."""
    def apply_prior(p, x, t, c):
        return jmodel.apply({"params": p}, x, t, c["enc_text"],
                            method=jden.StyleDiffusion.denoise_prior)

    j = jnp.asarray(j.numpy(), jnp.int32)
    x0, mask = jnp.asarray(batch["x_start"]), jnp.asarray(batch["mask"])
    cond = {"enc_text": jnp.asarray(batch["enc_text"])}
    x_t = jddpm.q_sample(sched, x0, 2 * j, jnp.asarray(noise.numpy()))
    teacher_fn = lambda x, t, c: apply_prior(params, x, t, c)  # noqa: E731
    if guidance > 0:
        teacher_fn = jddpm.cfg_model_fn(teacher_fn, jnp.full((B,), guidance, jnp.float32))
    tgt = jdist.distill_target(sched, teacher_fn, x_t, j, cond)

    def loss(mdm):
        out = apply_prior(dict(params, mdm=mdm), x_t, sched.timestep_map[2 * j], cond)
        sse = jnp.sum(jdist.snr_weight(sched, 2 * j, 4) * (out - tgt) ** 2 * mask,
                      axis=(1, 2, 3))
        n = jnp.maximum(jnp.sum(mask, axis=(1, 2, 3)), 1.0) * (C * 1)
        return jnp.mean(sse / n)

    return loss


@pytest.mark.parametrize("guidance", [0.0, 2.5])
def test_stage_loss_and_grads_match_jax(guidance, tmp_path):
    jmodel, params, port = _pair(11)
    params = jax.tree_util.tree_map(jnp.asarray, params["params"])
    batch = _batch(12)
    j, noise = _jax_draws(jax.random.PRNGKey(4), STEPS // 2)
    loss = _jloss(jmodel, params, jmake_schedule("cosine", STEPS), guidance, batch, j, noise)
    want, jgrads = jax.value_and_grad(loss)(params["mdm"])
    d = _port_distiller(port, tmp_path)
    got = d.stage_loss(d.stage_sched(STEPS), guidance,
                       {k: torch.from_numpy(v) for k, v in batch.items()}, noise=noise, j=j)
    got.backward()
    assert abs(float(got) - float(want)) <= LOSS_REL * abs(float(want)), (got, want)
    want_g = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads), port.cfg)
    got_g = {n[len("mdm."):]: p.grad for n, p in port.named_parameters() if p.grad is not None}
    assert got_g.keys() == want_g.keys()
    for k, v in want_g.items():
        rel = float((got_g[k] - v).abs().max() / (v.abs().max() + 1e-12))
        assert rel < GRAD_REL, (k, rel)
    # only the prior trains; the teacher takes no gradient
    assert all(p.grad is None for n, p in port.named_parameters() if not n.startswith("mdm."))
    assert all(p.grad is None for p in d.teacher.parameters())


def test_stage_step_matches_the_jax_distiller(tmp_path):
    """One AdamW step: the port's student against the JAX distiller's jitted
    step from the same rng (its j and noise pinned on the port's side)."""
    jmodel, params, port = _pair(21)
    batch = _batch(22)
    kw = dict(lr=1e-4, weight_decay=1e-2)
    jd = jdist.ProgressiveDistiller(jdist.DistillConfig(save_dir=str(tmp_path / "jax"), **kw),
                                    jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                                    "cosine", STEPS)
    step = jd._build_stage_step(jd._stage_sched(STEPS), 0.0)
    rng = jax.random.PRNGKey(9)
    new, _, jloss = step(jd.params, jd.teacher_params, jd.tx.init(jd.params), rng,
                         {k: jnp.asarray(v) for k, v in batch.items()})
    j, noise = _jax_draws(rng, STEPS // 2)
    d = _port_distiller(port, tmp_path / "port", **kw)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    loss = d.stage_step(d.stage_sched(STEPS), 0.0,
                        {k: torch.from_numpy(v) for k, v in batch.items()}, noise=noise, j=j)
    assert abs(float(loss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, new["mdm"]), port.cfg)
    got = {n[len("mdm."):]: p.detach() for n, p in port.named_parameters() if n.startswith("mdm.")}
    diffs = []
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=ATOL, err_msg=k)
        diffs.append((got[k] - v).abs().flatten())
    assert float((torch.cat(diffs) < 1e-6).float().mean()) > 0.95
    assert max(float((got[k] - before["mdm." + k]).abs().max()) for k in got) > 5e-5
    assert all(torch.equal(p, before[n]) for n, p in port.named_parameters()
               if not n.startswith("mdm."))


def test_guidance_applies_to_the_first_stage_only(tmp_path):
    _, _, port = _pair(31)
    d = _port_distiller(port, tmp_path, guidance=2.5)
    assert [d.stage_guidance(i) for i in (0, 1, 3)] == [2.5, 0.0, 0.0]


def test_the_teacher_is_the_student_after_a_stage(tmp_path):
    _, _, port = _pair(32)
    d = _port_distiller(port, tmp_path, steps_per_stage=2, log_interval=0, lr=1e-2)
    batch = _batch(33)
    data = [(batch["x_start"], {"enc_text": batch["enc_text"], "mask": batch["mask"]})]
    teacher0 = {k: v.clone() for k, v in d.teacher.state_dict().items()}
    loss = d.run_stage(STEPS, data)
    assert np.isfinite(loss)
    student = port.mdm.state_dict()
    assert any(not torch.equal(student[k], teacher0[k]) for k in teacher0)
    assert all(torch.equal(student[k], v) for k, v in d.teacher.state_dict().items())
    assert d.stage_guidance(d._stage_no) == 0.0 and d._stage_no == 1


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_distilled_checkpoints_cross_both_ways(writer, tmp_path):
    """mdm_{n}step.pt written by one package loads through the other's
    --mdm_path path with the same weights."""
    jmodel, params, port = _pair(41)
    jcfg = jmodel.cfg
    if writer == "port":
        path = _port_distiller(port, tmp_path).save(4)
        tree = assemble_style_diffusion_params(jcfg, load_torch_state_dict(path),
                                               rng=jax.random.PRNGKey(0))["params"]["mdm"]
        got = from_jax_params(jax.tree_util.tree_map(np.asarray, tree), port.cfg)
        want = port.mdm.state_dict()
    else:
        jd = jdist.ProgressiveDistiller(jdist.DistillConfig(save_dir=str(tmp_path)), jmodel,
                                        jax.tree_util.tree_map(jnp.asarray, params), "cosine",
                                        STEPS)
        path = jd.save(4)
        got = {k[len("mdm."):]: v for k, v in from_torch_state_dict(
            torch.load(path), port.cfg, part="mdm").items()}
        want = from_jax_params(params["params"]["mdm"], port.cfg)
    assert os.path.basename(path) == "mdm_4step.pt"
    assert set(want) <= set(got) | {"pe"}
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


# -- the CLI ---------------------------------------------------------------

@pytest.fixture(scope="module")
def distill_root(tmp_path_factory):
    """tests/test_distillation.py's corpus: 48-frame clips."""
    root = tmp_path_factory.mktemp("style_xia_distill_torch")
    (root / "new_joint_vecs").mkdir()
    r = np.random.RandomState(0)
    names = [f"{600 + i:03d}neutral_walking.npy" for i in range(4)]
    names += ["350angry_jumping.npy", "304neutral_running.npy"]
    for f in names:
        np.save(root / "new_joint_vecs" / f, (r.randn(48, 181) * 0.5).astype(np.float32))
    allc = np.concatenate([np.load(root / "new_joint_vecs" / f) for f in names])
    np.save(root / "Mean.npy", allc.mean(0).astype(np.float32))
    np.save(root / "Std.npy", np.maximum(allc.std(0), 1e-3).astype(np.float32))
    return str(root)


from tests.test_torch_finetune import bandai_root, hml_root  # noqa: E402,F401
from tests.test_torch_finetune import check_item12_flag, run_losses  # noqa: E402


def _cli(root, save, *extra):
    return ["--dataset", "stylexia_posrot", "--data_dir", root, "--save_dir", str(save),
            "--layers", "1", "--latent_dim", "32", "--diffusion_steps", "8",
            "--batch_size", "4", "--num_frames", "48", "--log_interval", "1",
            "--device", "cpu", *extra]


def test_cli_two_stages_then_sample_the_students(distill_root, tmp_path):
    """8 -> 4 -> 2 steps on a tiny seeded prior; each student loads through
    --mdm_path and samples on its own DDIM grid."""
    save = tmp_path / "distilled"
    paths = distill_main(_cli(distill_root, save, "--stages", "2", "--steps_per_stage", "3"))
    assert [os.path.basename(p) for p in paths] == ["mdm_4step.pt", "mdm_2step.pt"]
    with open(save / "progress.csv") as f:
        header = f.readline()
    assert "distill_8_loss" in header and "distill_4_loss" in header
    with open(save / "args.json") as f:
        assert json.load(f)["package"] == model_util.PACKAGE
    for path, n in zip(paths, (4, 2)):
        args = parse_args(_cli(distill_root, save, "--mdm_path", path))
        args.semantic_discriminator_path = args.model_path = ""
        bundle = model_util.build_model(args, device="cpu")
        sd = torch.load(path)
        assert all(torch.equal(bundle.model.mdm.state_dict()[k], v) for k, v in sd.items())
        sched = make_schedule("cosine", 8, f"ddim{n}", device="cpu")
        enc = torch.zeros(2, 512)
        gen = torch.Generator().manual_seed(0)
        out = sampling.sample_loop(sched, lambda x, t, c: bundle.model.denoise_prior(
            x, t, c["enc_text"]), {"enc_text": enc}, gen, shape=(2, 181, 1, 48), method="ddim")
        assert out.shape == (2, 181, 1, 48) and bool(torch.isfinite(out).all())


def test_cli_guided_distillation_differs_from_plain(distill_root, tmp_path):
    common = ["--stages", "1", "--steps_per_stage", "2"]
    plain = distill_main(_cli(distill_root, tmp_path / "plain", *common))
    guided = distill_main(_cli(distill_root, tmp_path / "guided", *common,
                               "--distill_guidance", "3.0"))
    a, b = torch.load(plain[-1]), torch.load(guided[-1])
    assert a.keys() == b.keys()
    assert max(float((a[k] - b[k]).abs().max()) for k in a) > 1e-6


def test_cli_rejects_odd_grids(distill_root, tmp_path):
    with pytest.raises(SystemExit):
        distill_main(_cli(distill_root, tmp_path / "bad", "--diffusion_steps", "12",
                          "--stages", "3"))


@pytest.mark.parametrize("flag", [["--fused", "1"], ["--quant_int8", "1"]])
def test_cli_refuses_the_forward_only_layers(flag, distill_root, tmp_path):
    """The JAX CLI under --fused 1 fails at its first step (the Pallas layer
    has no reverse-mode rule: "Linearization failed"); the port refuses
    before it."""
    with pytest.raises(ValueError, match="no backward"):
        distill_main(_cli(distill_root, tmp_path / "fused", "--stages", "1", *flag))
    assert not os.path.exists(tmp_path / "fused" / "mdm_4step.pt")


def _one_stage(root, save):
    return _cli(root, save, "--stages", "1", "--steps_per_stage", "2")


@pytest.fixture(scope="module")
def plain_distill(distill_root, tmp_path_factory):
    return run_losses(distill_main, _one_stage(distill_root, tmp_path_factory.mktemp("d_plain")),
                      "distill_8_loss")[1]


@pytest.mark.parametrize("flag", ["--native_loader", "--prefetch", "--profile"])
def test_cli_runs_the_host_pieces(flag, distill_root, tmp_path, monkeypatch, plain_distill):
    """--native_loader 1, --prefetch 2 and --profile DIR on the distiller
    (check_item12_flag): the same stage losses as without, a parsing trace."""
    check_item12_flag(flag, distill_main, _one_stage(distill_root, tmp_path / "x"),
                      "distill_8_loss", tmp_path, monkeypatch, plain_distill)


@pytest.mark.parametrize("dataset", ["humanml", "bandai-2_posrot"])
def test_cli_distills_on_every_family(dataset, hml_root, bandai_root, tmp_path):  # noqa: F811
    """The humanml and bandai corpora through the distiller (196-frame clips):
    one stage, finite losses, the student loads back through --mdm_path at
    the family's width."""
    root = hml_root if dataset == "humanml" else bandai_root
    argv = _cli(root, tmp_path / "d", "--stages", "1", "--steps_per_stage", "2",
                "--batch_size", "2")
    argv[argv.index("stylexia_posrot")] = dataset
    paths = distill_main(argv)
    assert [os.path.basename(p) for p in paths] == ["mdm_4step.pt"]
    sd = torch.load(paths[0])
    assert sd["output_process.poseFinal.weight"].shape[0] == {"humanml": 263}.get(dataset, 190)
    assert all(torch.isfinite(v).all() for v in sd.values())
    with open(os.path.join(tmp_path / "d", "progress.csv")) as f:
        assert np.isfinite([float(v) for r in csv.DictReader(f) for k, v in r.items()
                            if "loss" in k]).all()
