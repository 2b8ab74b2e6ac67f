"""The port's style-transfer demo CLI on the CPU against the JAX package's:
one finetuned model*.pt (a port finetune run on the tiny Xia corpus of
tests/test_torch_finetune.py, with a prior both packages load from
--mdm_path) through both CLIs, the results.npy schema, the flags the port
refuses, the --quant_int8 config and the args.json round trip.

The two packages draw their noise from different generators and seed their
fallback CLIP text towers differently, so the test pins both, as it pins the
noise elsewhere: each CLI module's sampling.sample_loop is wrapped to take
the same numpy-made initial noise and text features (DDIM at eta 0 draws no
step noise). The text tower's parity is tests/test_torch_models.py's.
Tolerances on the denormalised hml_vec: atol 1e-4 on the fp32 path. With
--fused 1 and --quant_int8 1 the model computes in bf16, and its output head
rounds the x0 prediction to bf16 in both packages, which round a different
matmul sum: even through kernel 1, 57 % of the predictions land one bf16 ulp
apart (0.031 at |x0| in [4, 8), 0.044 once denormalised by the corpus's
std). So those paths are held to rel L2 1e-2 on hml (tests/test_torch_int8.py's
bound) and to two bf16 ulps at |x0| in [4, 8), 2^-4, on the model's
normalised output (hml / std), not to the layer's max abs 3e-2, which one ulp
of a large prediction already exceeds.
"""
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from motionstyle.cli import parser_util as jparser_util
from motionstyle.cli.demo_style_transfer import main as jdemo_main
from motionstyle.diffusion import sampling as jsampling
from motionstyle.models import denoiser as jden
from motionstyle.models.torch_import import export_mdm
from motionstyle_torch.cli import model_util
from motionstyle_torch.cli.demo_style_transfer import main as demo_main
from motionstyle_torch.cli.finetune_style_diffusion import main as ft_main
from motionstyle_torch.cli.parser_util import eval_inpainting_style_args
from motionstyle_torch.data.datasets import StyleMotionDataset, get_opt
from motionstyle_torch.diffusion import sampling
from tests.test_torch_finetune import CLI_ARGS, xia_root  # noqa: F401
from tests.test_torch_models import numpy_params, one_torch_thread  # noqa: F401

N, C, T = 2, 181, 76
CONTENT = "306neutral_running.npy"


@pytest.fixture(scope="module")
def finetuned(xia_root, tmp_path_factory):  # noqa: F811
    """(model*.pt, its run directory): one port finetune step on the tiny
    corpus at the CLI's test width (1 layer, latent 128), from a prior the
    JAX package writes (export_mdm) so both demo CLIs load the same weights."""
    root = tmp_path_factory.mktemp("torch_demo")
    jcfg = jden.MDMConfig(njoints=C, nfeats=1, latent_dim=128, ff_size=1024, num_layers=1,
                          num_heads=4, clip_dim=512)
    tree = jden.StyleDiffusion(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, C, 1, 8)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 512)), method=jden.StyleDiffusion.full_init)
    prior = os.path.join(root, "prior.pt")
    torch.save({k: torch.as_tensor(np.asarray(v))
                for k, v in export_mdm(numpy_params(tree, 3), 1).items()}, prior)
    save_dir = ft_main(["--save_dir", str(root / "ft"), "--data_dir", xia_root,
                        "--mdm_path", prior] + CLI_ARGS + ["--num_steps", "1"])
    return sorted(glob.glob(os.path.join(save_dir, "model*.pt")))[-1], save_dir


def _pin(monkeypatch, module, to_array, noise, enc):
    """Wrap module.sample_loop to take the pinned initial noise and text
    features."""
    orig = module.sample_loop

    def pinned(sched, model_fn, cond, rng, **kw):
        assert tuple(cond["enc_text"].shape) == enc.shape
        kw["noise"] = to_array(noise)
        return orig(sched, model_fn, dict(cond, enc_text=to_array(enc)), rng, **kw)

    monkeypatch.setattr(module, "sample_loop", pinned)


def _demo_args(ckpt, xia, out, *flags):
    return ["--model_path", ckpt, "--input_content", CONTENT, "--data_dir", xia,
            "--skip_render", "--num_samples", str(N), "--output_dir", str(out), *flags]


def _results(out_path):
    return np.load(os.path.join(out_path, "results.npy"), allow_pickle=True).item()


@pytest.mark.parametrize("flags", [[], ["--fused", "1"], ["--quant_int8", "1"]],
                         ids=["fp32", "fused", "int8"])
def test_demo_matches_the_jax_demo(flags, finetuned, xia_root, tmp_path,  # noqa: F811
                                   monkeypatch):
    ckpt, _ = finetuned
    rs = np.random.RandomState(4)
    noise = rs.randn(N, C, 1, T).astype(np.float32)
    enc = (rs.randn(N, 512) * 0.1).astype(np.float32)
    _pin(monkeypatch, sampling, torch.from_numpy, noise, enc)
    _pin(monkeypatch, jsampling, jnp.asarray, noise, enc)
    port = _results(demo_main(_demo_args(ckpt, xia_root, tmp_path / "port", *flags,
                                         "--device", "cpu")))
    want = _results(jdemo_main(_demo_args(ckpt, xia_root, tmp_path / "jax", *flags)))

    # the JAX CLI's schema: keys, shapes and types
    assert port.keys() == want.keys()
    for k in port:
        if isinstance(want[k], np.ndarray):
            assert port[k].shape == want[k].shape and port[k].dtype == want[k].dtype, k
        else:
            assert port[k] == want[k], k
    assert port["motion"].shape == (N, 20, 3, T) and port["hml"].shape == (N, T, C)
    assert port["text"] == ["A person is running angry"] * N
    assert np.isfinite(port["motion"]).all() and np.isfinite(port["hml"]).all()

    # the root_horizontal channels are the content clip's, denormalised
    ds = StyleMotionDataset(get_opt("stylexia_posrot", xia_root), split="test")
    content, length = ds.process_np_motion(os.path.join(ds.opt.motion_dir, CONTENT))
    np.testing.assert_allclose(port["hml"][:, :, :3],
                               np.broadcast_to(ds.inv_transform(content)[:, :3], (N, T, 3)),
                               atol=1e-5)
    assert (port["lengths"] == length).all()

    got, ref = port["hml"], want["hml"]
    if not flags:
        np.testing.assert_allclose(got, ref, atol=1e-4)
    else:
        err = float(np.abs((got - ref) / ds.std).max())
        rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
        assert err <= 2.0 ** -4 and rel <= 1e-2, (err, rel)


@pytest.mark.parametrize("flag, item", [
    (None, 1), (["--dataset", "humanml"], 10), (["--dataset", "bandai-2_posrot"], 10),
    (["--long_frames", "200"], 6), (["--style_mix", "a.pt:1"], 6),
    (["--style_strength", "0.5"], 6), (["--parallel_window", "4"], 10),
    (["--forecast_stride", "2"], 10), (["--model_parallel", "2"], 11),
    (["--pipeline_parallel", "2"], 11), (["--sequence_parallel", "2"], 11),
    (["--profile", "trace"], 12)])
def test_demo_refuses_what_is_not_ported(flag, item, finetuned, xia_root,  # noqa: F811
                                         tmp_path):
    """Each refusal names its ROADMAP item and comes before any work (no
    output directory is made). flag None: running without --skip_render."""
    ckpt, _ = finetuned
    argv = _demo_args(ckpt, xia_root, tmp_path / "out", "--device", "cpu")
    argv = [a for a in argv if a != "--skip_render"] if flag is None else argv + flag
    with pytest.raises(NotImplementedError, match=rf"ROADMAP §1 item {item}\b"):
        demo_main(argv)
    assert not os.path.exists(tmp_path / "out")


def test_quant_int8_implies_fused_and_bf16(finetuned):
    ckpt, _ = finetuned
    cfg = model_util.get_transfer_config(
        eval_inpainting_style_args(["--model_path", ckpt, "--quant_int8", "1"]))
    assert cfg.quant_int8 and cfg.fused and cfg.dtype == "bfloat16"
    cfg = model_util.get_transfer_config(eval_inpainting_style_args(
        ["--model_path", ckpt, "--quant_int8", "1", "--dtype", "float32"]))
    assert cfg.quant_int8 and cfg.dtype == "float32"  # an explicit --dtype wins
    cfg = model_util.get_transfer_config(
        eval_inpainting_style_args(["--model_path", ckpt, "--fused", "1"]))
    assert cfg.fused and not cfg.quant_int8 and cfg.dtype == "bfloat16"


def test_args_json_round_trip(tmp_path):
    """args.json supplies the model, data and sampling flags; run-local flags
    and flags given on the command line (an abbreviation too) keep their
    values; the parse equals the JAX package's on the same command line."""
    import json

    recorded = {"dataset": "stylexia_posrot", "layers": 3, "latent_dim": 256,
                "mdm_path": "stale.pt", "skip_steps": 600, "num_samples": 5,
                "cond_mask_prob": 0.0, "fused": 1, "quant_int8": 1, "dtype": "float32",
                "skip_render": True, "output_dir": "elsewhere", "model_path": "other.pt",
                "style_strength": 0.3, "long_frames": 300}
    (tmp_path / "args.json").write_text(json.dumps(recorded))
    ckpt = str(tmp_path / "model000000010.pt")
    argv = ["--model_path", ckpt, "--mdm_path", "mine.pt", "--skip_st", "500"]
    args = eval_inpainting_style_args(argv)
    assert (args.layers, args.latent_dim, args.num_samples) == (3, 256, 5)
    assert args.mdm_path == "mine.pt" and args.skip_steps == 500
    assert (args.fused, args.quant_int8, args.dtype, args.skip_render) == (0, 0, None, False)
    assert (args.output_dir, args.model_path) == ("", ckpt)
    assert (args.style_strength, args.long_frames) == (1.0, 0)
    assert args.guidance_param == 1  # cond_mask_prob 0
    want = vars(jparser_util.eval_inpainting_style_args(argv))
    got = vars(args)
    assert got.keys() == want.keys()
    assert {k: v for k, v in got.items() if k != "device"} == \
        {k: v for k, v in want.items() if k != "device"}
    with pytest.raises(FileNotFoundError, match="args.json"):
        eval_inpainting_style_args(["--model_path", str(tmp_path / "none" / "model.pt")])
