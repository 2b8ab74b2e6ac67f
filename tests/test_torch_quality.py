"""The port's quality path against the JAX package on the CPU: the style
metrics, the Picard-parallel sampler, the parallel finetune unroll,
--auto_stop's evaluator and CLI, the corpus generator and the port's quality
protocol end to end.

Tolerances:
  - style_metrics: exact (the same numpy code on the same inputs);
  - parallel_sample_loop against the port's sample_loop with pinned noise:
    atol 5e-2 at tol 0.02 / tol_floor 2e-3 (tests/test_parallel_sampling.py's
    bound); against the JAX parallel_sample_loop with the same pinned noise
    and a tight tol (1e-4 / 1e-4): atol 1e-4 (tests/test_torch_samplers.py);
  - few_shot_style_finetune_loss(parallel_unroll=True) against JAX's on
    StyleDiffusion (weights carried by from_jax_params, dropout 0): loss rel
    1e-5, gradient max-rel 1e-3 per leaf (tests/test_torch_finetune.py); the
    port's parallel unroll against its own sequential unroll: loss rel 1e-4,
    gradient max-rel 1e-3 (the JAX package's own test of the pair,
    tests/test_diffusion.py::test_parallel_unroll_matches_sequential_grads,
    at the default Picard tolerance);
  - AutoStopEvaluator: the same evaluated steps, intervals and selection as
    JAX's on one sequence of reports; --auto_stop with an unreachable gate
    leaves model*.pt bit-equal;
  - make_corpus: byte-identical files;
  - the protocol at the quick budgets of tests/test_quality.py::
    TestHumanmlFamily: root error < 1e-4 and finite metrics.
"""
import csv
import glob
import json
import os
import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.cli import finetune_style_diffusion as jft_cli
from motionstyle.diffusion import losses as jlosses
from motionstyle.diffusion import parallel_sampling as jpar
from motionstyle.diffusion.ddpm import Inpainting as JInpainting
from motionstyle.diffusion.schedule import make_schedule as jmake_schedule
from motionstyle.eval import style_metrics as jmetrics
from motionstyle.models import denoiser as jden
from motionstyle_torch.cli import finetune_style_diffusion as ft_cli
from motionstyle_torch.diffusion import sampling
from motionstyle_torch.diffusion.ddpm import Inpainting
from motionstyle_torch.diffusion.parallel_sampling import parallel_sample_loop
from motionstyle_torch.diffusion.schedule import make_schedule
from motionstyle_torch.eval import quality_protocol as qp
from motionstyle_torch.eval import style_metrics as metrics
from motionstyle_torch.models.params import encoder_from_jax
from motionstyle_torch.train.finetune import FinetuneConfig, StyleFinetuneTrainer
from tests.test_torch_finetune import (  # noqa: F401
    CLI_ARGS, _batch, _jax_draws, _jtrainer, _max_rel, _pair, _port_batch, _t, xia_root)
from tests.test_torch_models import one_torch_thread  # noqa: F401

LOSS_REL, GRAD_REL, SEQ_LOSS_REL = 1e-5, 1e-3, 1e-4
SEQ_ATOL, JAX_ATOL = 5e-2, 1e-4
SHAPE = (2, 6, 1, 8)


# ---------------------------------------------------------------------------
# (a) style metrics
# ---------------------------------------------------------------------------

def _clips(seed: int, n: int = 3, T: int = 40, D: int = 20):
    rs = np.random.RandomState(seed)
    return [rs.randn(T - 3 * i, D).astype(np.float32) for i in range(n)]


@pytest.mark.parametrize("name", ["style_descriptor", "lowpass", "style_distance",
                                  "content_similarity", "transfer_report"])
def test_style_metrics_equal_jax(name):
    a, b, c = _clips(1)
    args = {"style_descriptor": (a,), "lowpass": (a,), "style_distance": (a, b),
            "content_similarity": (a, b), "transfer_report": (c, a, b)}[name]
    got, want = getattr(metrics, name)(*args), getattr(jmetrics, name)(*args)
    if isinstance(want, dict):
        assert got == want
    else:
        np.testing.assert_array_equal(got, want)


def test_content_similarity_of_a_constant_clip_is_zero():
    a = np.ones((20, 10), np.float32)
    assert metrics.content_similarity(a, a) == jmetrics.content_similarity(a, a) == 0.0


# ---------------------------------------------------------------------------
# (b) the Picard-parallel sampler
# ---------------------------------------------------------------------------

def _model_fn(x, t_orig, cond):
    """tests/test_parallel_sampling.py's contractive stand-in denoiser."""
    tt = (t_orig.float() / 50.0).reshape((-1,) + (1,) * (x.ndim - 1))
    bias = cond["enc_text"].mean(-1).reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.tanh(0.5 * x + 0.3 * torch.sin(3.0 * tt)) + 0.1 * bias


def _jmodel_fn(x, t_orig, cond):
    tt = (t_orig.astype(jnp.float32) / 50.0).reshape((-1,) + (1,) * (x.ndim - 1))
    bias = cond["enc_text"].mean(-1).reshape((-1,) + (1,) * (x.ndim - 1))
    return jnp.tanh(0.5 * x + 0.3 * jnp.sin(3.0 * tt)) + 0.1 * bias


def _cond(batch=SHAPE[0]):
    return np.linspace(-1.0, 1.0, batch * 4).reshape(batch, 4).astype(np.float32)


def _case(method: str):
    """(schedule args, sampler kwargs as numpy) of the two configurations:
    a 50-step DDPM chain, and DDIM on a respaced 40-step schedule with
    inpainting, skip 6 and a warm start."""
    rs = np.random.RandomState({"ddpm": 3, "ddim": 4}[method])
    if method == "ddpm":
        sched, steps, kw = ("cosine", 50, None), 50, {}
    else:
        sched, steps = ("cosine", 40, "ddim20"), 14
        mask = np.zeros(SHAPE, np.float32)
        mask[:, :2] = 1.0
        motion = np.full(SHAPE, 0.3, np.float32)
        kw = dict(skip_timesteps=6, init_image=motion, inpainting=(mask, motion))
    kw.update(noise=rs.randn(*SHAPE).astype(np.float32),
              step_noise=rs.randn(steps, *SHAPE).astype(np.float32))
    return sched, kw


def _torch_kw(kw):
    out = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    if "inpainting" in kw:
        out["inpainting"] = Inpainting(*(torch.from_numpy(a) for a in kw["inpainting"]))
    return out


def _jax_kw(kw):
    out = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    if "inpainting" in kw:
        out["inpainting"] = JInpainting(*(jnp.asarray(a) for a in kw["inpainting"]))
    return out


@pytest.mark.parametrize("method", ["ddpm", "ddim"])
def test_parallel_sampler_matches_the_sequential_loop(method):
    (name, steps, respacing), kw = _case(method)
    sched = make_schedule(name, steps, respacing, device="cpu")
    tkw = _torch_kw(kw)
    seq = sampling.sample_loop(sched, _model_fn, {"enc_text": torch.from_numpy(_cond())},
                               method=method, **tkw)
    par, sweeps = parallel_sample_loop(sched, _model_fn, {"enc_text": torch.from_numpy(_cond())},
                                       method=method, window=10, tol=0.02, tol_floor=2e-3,
                                       **tkw)
    assert torch.isfinite(par).all()
    np.testing.assert_allclose(par.numpy(), seq.numpy(), atol=SEQ_ATOL)
    assert sweeps < kw["step_noise"].shape[0]  # fewer batched sweeps than steps
    if "inpainting" in kw:  # the kept channels hold the motion exactly
        np.testing.assert_allclose(par.numpy()[:, :2], 0.3, atol=1e-5)


@pytest.mark.parametrize("method", ["ddpm", "ddim"])
def test_parallel_sampler_matches_jax(method):
    """The same pinned noise through both parallel samplers at a tight tol:
    the final sample and every dumped state."""
    (name, steps, respacing), kw = _case(method)
    jout, jsweeps, jstates = jpar.parallel_sample_loop(
        jmake_schedule(name, steps, respacing), _jmodel_fn, {"enc_text": jnp.asarray(_cond())},
        jax.random.PRNGKey(0), method=method, window=8, tol=1e-4, tol_floor=1e-4,
        dump_states=True, **_jax_kw(kw))
    out, sweeps, states = parallel_sample_loop(
        make_schedule(name, steps, respacing, device="cpu"), _model_fn,
        {"enc_text": torch.from_numpy(_cond())}, method=method, window=8, tol=1e-4,
        tol_floor=1e-4, dump_states=True, **_torch_kw(kw))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=JAX_ATOL)
    np.testing.assert_allclose(states.numpy(), np.asarray(jstates), atol=JAX_ATOL)
    assert abs(sweeps - int(jsweeps)) <= 2, (sweeps, int(jsweeps))


def test_parallel_sampler_draws_its_own_noise():
    """Unpinned, the DDPM noise table comes from the generator: the same
    seed gives the same sample, another seed another one."""
    sched = make_schedule("cosine", 30, device="cpu")

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return parallel_sample_loop(sched, _model_fn, {"enc_text": torch.from_numpy(_cond())},
                                    gen, shape=SHAPE, window=8)[0]

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))


# ---------------------------------------------------------------------------
# (c) the parallel finetune unroll
# ---------------------------------------------------------------------------

def _port_loss(port, batch, t, noise_t2m, noise, parallel: bool, tmp_path):
    trainer = StyleFinetuneTrainer(
        FinetuneConfig(save_dir=str(tmp_path / "port"), parallel_unroll=parallel), port,
        make_schedule("cosine", 1000, "ddim20", device="cpu"))
    port.zero_grad(set_to_none=True)
    terms = trainer.loss_terms(_port_batch(batch), torch.from_numpy(t).long(), 0,
                               noise_t2m=_t(noise_t2m), noise=_t(noise))
    terms["loss"].backward()
    grads = {n: p.grad.numpy().copy() for n, p in port.named_parameters() if p.grad is not None}
    return float(terms["loss"]), grads, terms


def test_parallel_unroll_matches_jax(tmp_path):
    jmodel, params, port = _pair(81)
    batch = _batch(82)
    t = np.asarray([3, 7], np.int32)
    jt = _jtrainer(jmodel, params, tmp_path)
    key = jax.random.PRNGKey(5)

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
            text_features=batch["text_features"], parallel_unroll=True)
        return terms["loss"]

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(jt.params)
    noise_t2m, noise = _jax_draws(key, batch["x_start"].shape, batch["content"].shape)
    got, grads, terms = _port_loss(port, batch, t, noise_t2m, noise, True, tmp_path)
    assert abs(got - float(want)) <= LOSS_REL * abs(float(want))
    want_g = {f"style_encoder.{k}": v.numpy() for k, v in
              encoder_from_jax(jax.device_get(jgrads["style_encoder"])).items()}
    assert grads.keys() == want_g.keys()
    for k in want_g:
        assert _max_rel(grads[k], want_g[k]) < GRAD_REL, (k, _max_rel(grads[k], want_g[k]))
    assert 1 <= float(terms["picard_sweeps"]) <= 4 * 6 + 16


def test_parallel_unroll_matches_the_sequential_unroll(tmp_path):
    _, _, port = _pair(83)
    batch = _batch(84)
    t = np.asarray([2, 9], np.int32)
    noise_t2m, noise = _jax_draws(jax.random.PRNGKey(6), batch["x_start"].shape,
                                  batch["content"].shape)
    seq, g_seq, terms_seq = _port_loss(port, batch, t, noise_t2m, noise, False, tmp_path)
    par, g_par, _ = _port_loss(port, batch, t, noise_t2m, noise, True, tmp_path)
    assert "picard_sweeps" not in terms_seq
    assert abs(par - seq) <= SEQ_LOSS_REL * abs(seq)
    assert g_par.keys() == g_seq.keys() and g_seq
    for k in g_seq:
        assert _max_rel(g_par[k], g_seq[k]) < GRAD_REL, (k, _max_rel(g_par[k], g_seq[k]))


# ---------------------------------------------------------------------------
# (d) --auto_stop
# ---------------------------------------------------------------------------

# (ratio, content) of successive evaluations: no style, then styling begins
# (densify), then styled but content lost, then the gate
REPORTS = [(1.00, 0.95), (0.99, 0.93), (0.97, 0.90), (0.93, 0.72), (0.88, 0.50),
           (0.87, 0.66), (0.80, 0.70)]


def _report(ratio, content):
    return {"style_dist_to_example": ratio, "style_dist_content_to_example": 1.0,
            "style_dist_ratio": ratio, "content_similarity": content,
            "root_horizontal_max_abs_err": 0.0}


def _drive(evaluate, due, selected, num_steps: int) -> list:
    """The CLIs' loop around an evaluator: the steps evaluated."""
    seen = []
    for step in range(1, num_steps):
        if due(step):
            evaluate(step)
            seen.append(step)
            if selected():
                break
    return seen


@pytest.mark.parametrize("ratio_gate", [0.9, 0.5])
def test_auto_stop_logic_matches_jax(ratio_gate, monkeypatch):
    """Interval, densification and selection against the JAX evaluator on
    one sequence of reports (ratio_gate 0.5: never met)."""
    C, T = 6, 10
    args = SimpleNamespace(auto_stop_ratio=ratio_gate, auto_stop_content=0.6,
                           auto_stop_interval=10, save_interval=50, auto_stop_fine=3, seed=10,
                           skip_steps=700, diffusion_steps=1000)
    ds = SimpleNamespace(inv_transform=lambda a: a)
    zeros = np.zeros((1, C, 1, T), np.float32)
    jev = jft_cli.AutoStopEvaluator(args, SimpleNamespace(model=None),
                                    jmake_schedule("cosine", 1000, "ddim20"), ds, zeros, zeros,
                                    zeros, zeros[:, :1, 0, :1], T)
    ev = ft_cli.AutoStopEvaluator(args, None, make_schedule("cosine", 1000, "ddim20",
                                                            device="cpu"),
                                  ds, torch.zeros(1, C, 1, T), torch.zeros(1, C, 1, T),
                                  torch.zeros(1, C, 1, T), torch.zeros(1, 1), T)
    assert (ev.coarse, ev.fine, ev.pick, ev.skip) == (10, 3, -5, 14)
    traces = []
    for evaluator, module, sample in ((jev, jmetrics, lambda *a: zeros),
                                      (ev, ft_cli, lambda: torch.zeros(1, C, 1, T))):
        reports = iter(REPORTS)
        monkeypatch.setattr(module, "transfer_report", lambda *a: _report(*next(reports)))
        evaluator._sample = sample
        if evaluator is jev:
            steps = _drive(lambda s: jev.evaluate(None, s), jev.due,
                           lambda: jev.selected is not None, 40)
        else:
            steps = _drive(ev.evaluate, ev.due, lambda: ev.selected is not None, 40)
        traces.append((steps, evaluator.selected, evaluator.interval,
                       {k: v["style_dist_ratio"] for k, v in evaluator.trace.items()}))
    assert traces[0] == traces[1]
    steps, selected, interval, _ = traces[1]
    assert steps[:3] == [10, 20, 30] and interval == 3  # densified after 0.97
    assert steps == [10, 20, 30, 33, 36, 39]
    assert selected == (39 if ratio_gate == 0.9 else None)


def _run_cli(xia_root, save_dir, *extra):
    random.seed(0)  # the loader's captions and crops come from Python's random
    return ft_cli.main(["--save_dir", str(save_dir), "--data_dir", xia_root] + CLI_ARGS
                       + ["--save_interval", "1", *extra])


def test_cli_auto_stop_with_an_unreachable_gate_leaves_the_run_unchanged(xia_root, tmp_path):
    """--auto_stop 1 --auto_stop_ratio 0: the same model*.pt and opt*.pt bits
    as the run without the flag, and auto_stop.json with the JAX keys, an
    evaluation at every step and the final one."""
    plain = _run_cli(xia_root, tmp_path / "plain")
    auto = _run_cli(xia_root, tmp_path / "auto", "--auto_stop", "1", "--auto_stop_ratio", "0",
                    "--auto_stop_interval", "1")
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(plain, "*.pt")))
    assert names == ["model000000001.pt", "model000000002.pt", "opt000000001.pt",
                     "opt000000002.pt"]
    for name in names:
        a = torch.load(os.path.join(plain, name), weights_only=False)
        b = torch.load(os.path.join(auto, name), weights_only=False)
        flat = (lambda d: list(d.values())) if isinstance(a, dict) else list
        assert all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
                   for x, y in zip(flat(a), flat(b))), name
    with open(os.path.join(auto, "auto_stop.json")) as f:
        rec = json.load(f)
    assert set(rec) == {"selected_step", "ratio_gate", "content_gate", "trace"}
    assert rec["selected_step"] is None and rec["ratio_gate"] == 0.0
    assert sorted(rec["trace"], key=int) == ["1", "2"]
    assert set(rec["trace"]["1"]) == {"style_dist_to_example", "style_dist_content_to_example",
                                     "style_dist_ratio", "content_similarity",
                                     "root_horizontal_max_abs_err"}
    assert all(r["root_horizontal_max_abs_err"] < 1e-4 for r in rec["trace"].values())


def test_cli_auto_stop_stops_at_the_gate(xia_root, tmp_path):
    """A gate every sample meets (ratio < 100, content > -1): the run stops
    after the first evaluation, saves that step and selects it."""
    out = _run_cli(xia_root, tmp_path / "auto", "--auto_stop", "1", "--auto_stop_ratio", "100",
                   "--auto_stop_content", "-1", "--auto_stop_interval", "1")
    with open(os.path.join(out, "auto_stop.json")) as f:
        rec = json.load(f)
    assert rec["selected_step"] == 1 and list(rec["trace"]) == ["1"]
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(out, "model*.pt"))) == \
        ["model000000001.pt"]


@pytest.mark.parametrize("train_flag", ["--fused_train", "--fused_train_store"])
def test_cli_parallel_finetune_records_its_sweeps(train_flag, xia_root, tmp_path,
                                                  monkeypatch):
    """--parallel_finetune 1 through the training twins: sweeps in
    progress.csv; per step (semantic guidance off) the one differentiable
    forward (with store, the store-probs forward) and one recompute forward
    per sweep (no gradient there, so never the store one)."""
    from motionstyle_torch.ops import fused_encoder_train as ft

    calls = {"store": 0, "recompute": 0}
    for name, key in (("fused_layer_train_forward_store_reference", "store"),
                      ("fused_layer_train_forward_reference", "recompute")):
        fn = getattr(ft, name)

        def counted(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ft, name, counted)
    out = _run_cli(xia_root, tmp_path / "par", "--parallel_finetune", "1", "--fused", "1",
                   train_flag, "1")
    with open(os.path.join(out, "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    # DDIM-20 of 40 steps, skip 28: 6 unrolled steps
    sweeps = [int(float(r["picard_sweeps"])) for r in rows]
    assert all(1 <= n <= 4 * 6 + 16 for n in sweeps)
    if train_flag == "--fused_train_store":  # 1 layer, 2 steps
        assert calls == {"store": 2, "recompute": sum(sweeps)}
    else:
        assert calls == {"store": 0, "recompute": 2 + sum(sweeps)}


# ---------------------------------------------------------------------------
# (f) the corpus and (g) the protocol end to end
# ---------------------------------------------------------------------------

def test_make_corpus_writes_the_jax_tools_files(tmp_path):
    from tools.quality_protocol import make_corpus as jmake_corpus

    names = qp.make_corpus(str(tmp_path / "port"), seed=3)
    assert names == jmake_corpus(str(tmp_path / "jax"), seed=3)
    files = sorted(os.path.relpath(p, tmp_path / "jax")
                   for p in glob.glob(str(tmp_path / "jax" / "**" / "*.npy"), recursive=True))
    assert len(files) == len(names) + 2
    for rel in files:
        with open(tmp_path / "port" / rel, "rb") as a, open(tmp_path / "jax" / rel, "rb") as b:
            assert a.read() == b.read(), rel


@pytest.mark.parametrize("call", [
    lambda: qp.make_corpus("unused", dataset="humanml"),
    lambda: qp.run_protocol("unused", dataset="bandai-2_posrot", device="cpu"),
    lambda: qp.evaluate_transfer({"work": "", "data_root": "", "diffusion_steps": 10, "seed": 0,
                                  "device": "cpu"}, strengths=(0.5,)),
    lambda: qp.evaluate_mixing("unused"),
    lambda: qp.evaluate_longform("unused", "unused")])
def test_protocol_refuses_what_is_not_ported(call):
    with pytest.raises(NotImplementedError, match=r"ROADMAP §1 item (10|6)\b"):
        call()


def test_protocol_end_to_end_at_quick_budgets(one_torch_thread, tmp_path):  # noqa: F811
    """The protocol through the port's CLIs at TestHumanmlFamily's budgets,
    with the ladder, the auto arm, --fused_train 1 and --fused 1 (their
    twins on the CPU)."""
    res = qp.run_protocol(str(tmp_path / "q"), prior_steps=30, finetune_steps=4,
                          diffusion_steps=20, batch_size=4, save_interval=2, ladder=True,
                          auto_stop=True, fused_train=True, fused=True, device="cpu")
    reps = [res["pre"], res["post"], *res["ladder"].values()]
    assert sorted(res["ladder"]) == [3, 4]
    for rep in reps:
        assert rep["root_horizontal_max_abs_err"] < 1e-4
        assert all(np.isfinite(v) for v in rep.values())
    assert res["auto"]["ratio_gate"] == 0.9 and res["auto"]["trace"]
    assert {"ft_run", "demo_pre_run", "demo_post_run", "ftauto_run"} <= set(res["seconds"])
    table = qp.format_markdown(res)
    assert table.count("\n| ") >= 6 and '"fused_train": true' in table


def _protocol_result(pre=(1.0, 0.98), ladder=None, trace=None, selected=100,
                     demo=(0.93, 0.94), root=2e-10):
    rep = lambda rc: dict(style_dist_ratio=rc[0], content_similarity=rc[1],  # noqa: E731
                          root_horizontal_max_abs_err=root, style_dist_to_example=4.0)
    ladder = ladder or {51: (1.0, 0.95), 101: (0.92, 0.94), 151: (0.8, 0.6), 250: (0.76, 0.3)}
    trace = trace or {"50": (1.1, 0.95), "100": (0.6, 0.93)}
    return dict(pre=rep(pre), ladder={s: rep(v) for s, v in ladder.items()},
                auto=dict(selected_step=selected, trace={s: rep(v) for s, v in trace.items()},
                          **({} if demo is None else {"demo_report": rep(demo)})))


# (name, result): the gate met; a rung rescues a weak demo; the demo and every
# rung fail the styled-and-preserved clause (ratio 0.98 / content 0.55); no
# step selected; a styled baseline; a root error; too little style
GATE_CASES = [
    ("met", _protocol_result()),
    ("rung_rescues_the_demo", _protocol_result(
        trace={"50": (0.89, 0.97)}, selected=50, demo=(1.01, 0.97),
        ladder={51: (1.0, 0.96), 101: (0.97, 0.96), 151: (0.7, 0.5)})),
    ("neither_demo_nor_rung", _protocol_result(
        demo=(0.99, 0.95), ladder={51: (1.0, 0.96), 101: (0.985, 0.95), 151: (0.8, 0.45),
                                   201: (0.75, 0.2)})),
    ("no_step_selected", _protocol_result(selected=None, demo=None)),
    ("styled_baseline", _protocol_result(pre=(0.9, 0.98))),
    ("root_error", _protocol_result(root=1e-3)),
    ("too_little_style", _protocol_result(ladder={51: (1.0, 0.96), 101: (0.95, 0.9),
                                                  151: (0.91, 0.6)})),
]


@pytest.mark.parametrize("res", [r for _, r in GATE_CASES], ids=[n for n, _ in GATE_CASES])
def test_quality_gate_is_the_jax_tests_assertions(res):
    """quality_gate (chip_smoke.py's quality phase reads it) against
    tests/test_quality.py's own assertions on the same result: each of its
    tests passes exactly when the clauses it asserts are met."""
    import tests.test_quality as jq

    clauses = qp.quality_gate(res)
    assert set(clauses) == set(qp.GATE)
    asserts = {"test_root_horizontal_preserved_exactly": ("root",),
               "test_style_moves_toward_example": ("min_ladder",),
               "test_styled_point_with_content_preserved_exists": ("selected", "demo_or_rung"),
               "test_pre_finetune_baseline_sane": ("pre",)}
    for test, names in asserts.items():
        try:
            getattr(jq.TestStyleTransferQuality(), test)(res)
            passed = True
        except (AssertionError, KeyError):
            passed = False
        assert passed == all(clauses[n] for n in names), (test, clauses)


@pytest.mark.slow
def test_full_protocol_meets_the_quality_gate(tmp_path):
    """tests/test_quality.py's protocol and assertions through the port's
    CLIs (on the card when there is one)."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    res = qp.run_protocol(str(tmp_path / "quality"), finetune_steps=250, save_interval=50,
                          ladder=True, auto_stop=True, fused_train=device == "cuda",
                          device=device)
    assert res["pre"]["root_horizontal_max_abs_err"] < 1e-4
    for step, rep in res["ladder"].items():
        assert rep["root_horizontal_max_abs_err"] < 1e-4, step
    assert min(r["style_dist_ratio"] for r in res["ladder"].values()) < 0.90
    auto, ladder = res["auto"], res["ladder"]
    ladder_good = {s: r for s, r in ladder.items()
                   if r["style_dist_ratio"] < 0.98 and r["content_similarity"] > 0.55}
    sel = auto.get("selected_step")
    assert sel is not None, (auto.get("trace"), ladder_good)
    rep = auto["trace"][str(sel)]
    assert rep["style_dist_ratio"] < 0.95 and rep["content_similarity"] > 0.6, rep
    demo_rep = auto.get("demo_report")
    assert demo_rep is not None
    assert (demo_rep["style_dist_ratio"] < 0.98 and demo_rep["content_similarity"] > 0.55) \
        or ladder_good, (demo_rep, ladder_good)
    assert res["pre"]["content_similarity"] > 0.8
    assert res["pre"]["style_dist_ratio"] > 0.92
