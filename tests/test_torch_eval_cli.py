"""The port's eval_metrics CLI against the JAX CLI, on the CPU.

Both CLIs run on the same torch-layout prior (a 1-layer seeded prior), the
same finest.tar (the JAX package's save_evaluator of
numpy-made weights) and the same seed, so the loaders' orders, the
multimodality batches, the R-precision pools and the diversity draws agree;
the sampling noise and the text features are pinned (the k-th sampler call
of each CLI takes the k-th numpy draw), since the packages' generators and
seeded text towers differ. Also: the flags of the three eval CLIs one for
one against the JAX parsers, the refused flags, the card requirement, the
--model_path swap, and tests/test_eval_cli.py's end-to-end runs.
"""
import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.diffusion import forecast_sampling as jforecast
from motionstyle.diffusion import sampling as jsampling
from motionstyle_torch.cli import eval_metrics
from motionstyle_torch.diffusion import forecast_sampling, sampling
from tests.test_torch_eval import EVALUATOR_MODULES, abstract_flax_init, eval_params
from tests.test_torch_finetune import family_root

# every metric within rel 1e-3 of the JAX CLI's, plus 1e-4: both CLIs round
# each value to 4 decimals, so two values 1e-6 apart can print 1e-4 apart
REL, ROUNDING = 1e-3, 1e-4
FID_ATOL = 1e-3  # FID: abs 1e-3 + rel 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests share the machine with other test workers: run torch's
    CPU kernels on one thread while they run, and restore the setting."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def hml_root(tmp_path_factory):
    return family_root(tmp_path_factory, "humanml")


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """(prior.pt, finest.tar) both packages load: a 1-layer seeded prior in
    the reference layout (models/params.py::export_mdm) and the JAX
    package's save_evaluator of numpy-made trees (shaped by the port's
    converters, which tests/test_torch_eval.py holds to the JAX package's)."""
    from motionstyle.eval.trainers import save_evaluator as jsave
    from motionstyle_torch.eval import evaluators as tev
    from motionstyle_torch.models.denoiser import MDMConfig, StyleDiffusion
    from motionstyle_torch.models.params import export_mdm, seeded_init_

    root = tmp_path_factory.mktemp("eval_assets")
    prior = str(root / "prior.pt")
    cfg = MDMConfig(njoints=263, nfeats=1, latent_dim=64, ff_size=1024, num_layers=1,
                    num_heads=4, clip_dim=512)
    torch.save(export_mdm(seeded_init_(StyleDiffusion(cfg), 3).mdm), prior)
    tw = tev.EvaluatorWrapper("humanml", device="cpu")
    trees = [eval_params(tev.jax_from_state(spec, m.state_dict()), s) for spec, m, s in
             ((tev.MOVEMENT_SPEC, tw.movement_enc, 1), (tev.TEXT_SPEC, tw.text_enc, 2),
              (tev.MOTION_SPEC, tw.motion_enc, 3))]
    return prior, jsave(str(root / "finest.tar"), *trees, epoch=3)


class _Parsed(Exception):
    pass


def pin_calls(monkeypatch, targets: dict, seed: int = 11) -> dict:
    """Each (module, sampler name) of `targets`, at the k-th call over all of
    them, takes numpy-made initial noise, per-step noise (DDPM) and text
    features drawn from RandomState(seed + k), converted by targets' value."""
    count = {"n": 0}
    for (module, name), to in targets.items():
        orig = getattr(module, name)

        def pinned(sched, model_fn, cond, rng, *a, _orig=orig, _to=to, **kw):
            rs = np.random.RandomState(seed + count["n"])
            count["n"] += 1
            shape = tuple(kw["shape"])
            kw["noise"] = _to(rs.randn(*shape).astype(np.float32))
            if kw.get("method", "ddpm") == "ddpm":
                kw["step_noise"] = _to(rs.randn(sched.num_timesteps, *shape).astype(np.float32))
            enc = (rs.randn(shape[0], cond["enc_text"].shape[-1]) * 0.5).astype(np.float32)
            return _orig(sched, model_fn, dict(cond, enc_text=_to(enc)), rng, *a, **kw)

        monkeypatch.setattr(module, name, pinned)
    return count


def cli_args(root, prior, evaluator, *extra):
    return ["--dataset", "humanml", "--data_dir", root, "--split", "train", "--mdm_path", prior,
            "--evaluator_checkpoint", evaluator, "--layers", "1", "--latent_dim", "64",
            "--diffusion_steps", "10", "--num_samples", "4", "--batch_size", "2", "--seed", "5",
            *extra]


MM = ("--mm_num_samples", "2", "--mm_num_repeats", "3")


def assert_metrics_close(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    assert all(np.isfinite(v) for v in got.values()), got
    for k, w in want.items():
        atol = FID_ATOL if k == "FID" else ROUNDING
        assert abs(got[k] - w) <= atol + REL * abs(w), (k, got[k], w)


@pytest.mark.parametrize("extra", [(), ("--forecast_stride", "4", "--replication_times", "2",
                                        *MM)], ids=["ddpm_fp32", "forecast_mm_replicated"])
def test_metrics_match_the_jax_cli(extra, hml_root, assets, monkeypatch):
    """fp32 --fused 0, guided (2.5); then the forecast sampler with
    multimodality over two replications (the _conf keys)."""
    from motionstyle.cli.eval_metrics import main as jax_main

    from motionstyle.models import clip_text as jclip

    prior, evaluator = assets
    args = cli_args(hml_root, prior, evaluator, *extra)
    calls = pin_calls(monkeypatch, {(jsampling, "sample_loop"): jnp.asarray,
                                    (jforecast, "forecast_sample_loop"): jnp.asarray})
    with monkeypatch.context() as mp:
        # the evaluator's init (the checkpoint replaces it) and the text tower
        # (the pinned features replace its output) are left abstract
        abstract_flax_init(mp, *EVALUATOR_MODULES, jclip.ClipTextEncoder)
        mp.setattr(jclip, "encode_text",
                   lambda params, texts, **kw: jnp.zeros((len(texts), 512), jnp.float32))
        want = jax_main(args)
    n_jax = calls["n"]
    calls = pin_calls(monkeypatch, {(sampling, "sample_loop"): torch.from_numpy,
                                    (forecast_sampling, "forecast_sample_loop"):
                                        torch.from_numpy})
    got = eval_metrics.main(args + ["--device", "cpu"])
    assert calls["n"] == n_jax > 0
    assert ("multimodality" in got) == ("FID_conf" in got) == bool(extra)
    assert_metrics_close(got, want)


def test_model_path_is_scored_as_the_prior(hml_root, monkeypatch):
    """--model_path moves into --mdm_path (motionstyle/cli/eval_metrics.py:
    86-87): the factory sees the checkpoint in the prior's slot and no
    style checkpoint; an explicit --mdm_path wins."""
    from motionstyle_torch.cli import model_util

    seen = []

    def factory(args, respacing, device):
        seen.append((args.mdm_path, args.model_path))
        raise _Parsed()

    monkeypatch.setattr(model_util, "creat_serval_diffusion", factory)
    base = ["--dataset", "humanml", "--data_dir", hml_root, "--batch_size", "2", "--device", "cpu"]
    for extra in (["--model_path", "a.pt"], ["--model_path", "a.pt", "--mdm_path", "b.pt"]):
        with pytest.raises(_Parsed):
            eval_metrics.main(base + extra)
    assert seen == [("a.pt", ""), ("b.pt", "a.pt")]


# ---------------------------------------------------------------------------
# the parsers, refusals and the device
# ---------------------------------------------------------------------------

def jax_parser(monkeypatch, main, argv) -> argparse.ArgumentParser:
    """The parser a JAX CLI's main builds (captured at parse_args)."""
    def capture(self, *a, **k):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as info:
        main(argv)
    monkeypatch.undo()
    return info.value.args[0]


def flags(parser: argparse.ArgumentParser) -> dict:
    return {a.option_strings[0]: (a.default, a.choices, type(a).__name__)
            for a in parser._actions if a.option_strings and a.dest != "help"}


@pytest.mark.parametrize("name", ["eval_metrics", "train_evaluator", "train_t2m_generator"])
def test_cli_declares_the_jax_flags(name, monkeypatch):
    import importlib

    jmod = importlib.import_module(f"motionstyle.cli.{name}")
    tmod = importlib.import_module(f"motionstyle_torch.cli.{name}")
    want = flags(jax_parser(monkeypatch, jmod.main, ["--save_dir", "x"]))
    got = flags(tmod.build_parser())
    assert got.pop("--device") == ("cuda", None, "_StoreAction")
    assert got == want


@pytest.mark.parametrize("flag,value,item", [("--arch", "gru", "trans_enc")])
def test_refused_flags_raise(flag, value, item, hml_root):
    with pytest.raises(NotImplementedError, match=item):
        eval_metrics.main(["--dataset", "humanml", "--data_dir", hml_root, flag, value,
                           "--device", "cpu"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
@pytest.mark.parametrize("name", ["eval_metrics", "train_evaluator", "train_t2m_generator"])
def test_cli_runs_on_the_card_or_raises(name, hml_root, tmp_path):
    import importlib

    main = importlib.import_module(f"motionstyle_torch.cli.{name}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dataset", "humanml", "--data_dir", hml_root, "--save_dir", str(tmp_path)]
             if name != "eval_metrics" else ["--dataset", "humanml", "--data_dir", hml_root])


# ---------------------------------------------------------------------------
# tests/test_eval_cli.py's runs: the Xia test split end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def xia_test_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("style_xia_eval")
    (root / "new_joint_vecs").mkdir()
    r = np.random.RandomState(0)
    # filenames from STYLEXIA_TEST_LIST for the 'test' split
    for f in ["350angry_jumping.npy", "286depressed_running.npy",
              "304neutral_running.npy", "300proud_running.npy"]:
        np.save(root / "new_joint_vecs" / f, (r.randn(60, 181) * 0.5).astype(np.float32))
    np.save(root / "Mean.npy", (r.randn(181) * 0.1).astype(np.float32))
    np.save(root / "Std.npy", (np.abs(r.randn(181)) + 0.5).astype(np.float32))
    return str(root)


def _xia_args(root, *extra) -> list:
    return ["--dataset", "stylexia_posrot", "--data_dir", root, "--layers", "1",
            "--latent_dim", "64", "--diffusion_steps", "40", "--num_samples", "2",
            "--batch_size", "2", "--replication_times", "1", "--guidance_param", "1.0",
            "--device", "cpu", *extra]


@pytest.mark.parametrize("extra", [(), ("--forecast_stride", "4")], ids=["ddpm", "forecast"])
def test_metrics_pipeline_end_to_end(extra, xia_test_root):
    out = eval_metrics.main(_xia_args(xia_test_root, *extra))
    assert {"FID", "matching_score", "diversity"}.issubset(out), out
    assert all(np.isfinite(v) for v in out.values()), out


@pytest.mark.parametrize("flag", ["--native_loader", "--prefetch"])
def test_loader_flags_score_the_same(flag, xia_test_root, monkeypatch):
    """--native_loader 1 (the ground truth assembled in C++) and --prefetch 2
    on the Xia test split: the metrics of the run without the flag."""
    from motionstyle_torch.native import loader as native_loader

    calls = {"n": 0}
    collate = native_loader.window_normalize_collate

    def counted(*a, **k):
        calls["n"] += 1
        return collate(*a, **k)

    monkeypatch.setattr(native_loader, "window_normalize_collate", counted)
    want = eval_metrics.main(_xia_args(xia_test_root))
    got = eval_metrics.main(_xia_args(xia_test_root, flag, "1" if flag == "--native_loader"
                                      else "2"))
    assert (calls["n"] > 0) == (flag == "--native_loader")
    assert_metrics_close(got, want)
