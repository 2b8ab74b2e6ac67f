"""The port's style-transfer demo CLI on the CPU against the JAX package's:
one finetuned model*.pt (a port finetune run on the tiny Xia corpus of
tests/test_torch_finetune.py, with a prior both packages load from
--mdm_path) through both CLIs, the results.npy schema, the BVH and video
outputs of a run without --skip_render, the flags the port refuses, the
--quant_int8 config and the args.json round trip.

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
from tests.test_torch_finetune import (  # noqa: F401
    CLI_ARGS, bandai_root, family_args, hml_root, jax_prior, pin_samplers, short_post, xia_root)
from tests.test_torch_finetune import FAMILY_STYLE
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


def _anim_joints(anim):
    """Global joints (T, J, 3) of a BVH read back, in bone-name order."""
    from motionstyle_torch.core.rotations import quat_fk

    order = sorted(range(len(anim.bones)), key=lambda j: anim.bones[j])
    _, gp = quat_fk(torch.from_numpy(anim.quats), torch.from_numpy(anim.pos), anim.parents)
    return gp.numpy()[:, order]


BVH_ATOL = 1e-3  # global joints of the fitted BVH, port against JAX (metres)


def test_demo_writes_the_jax_demos_outputs(finetuned, xia_root, tmp_path,  # noqa: F811
                                           monkeypatch):
    """Without --skip_render the port's demo writes the JAX demo's file set:
    results.npy unchanged, three IK-fitted BVH files and 2 + 1 renders (mp4,
    or gif without ffmpeg). Both at the suite's size (10 IK steps, 5 frames
    a render); fp32, pinned noise and text features. Each BVH, read back by
    its own package's read_bvh, has the same bones and frames, and its
    global joints agree with the JAX file's within BVH_ATOL (the two fits
    start from hml within 1e-4 and take the same Adam steps; the files keep
    six decimals)."""
    from motionstyle.post import bvh as jbvh, ik as jik, render as jrender
    from motionstyle_torch.cli import demo_style_transfer as demo
    from motionstyle_torch.post import bvh

    ckpt, _ = finetuned
    rs = np.random.RandomState(4)
    noise = rs.randn(N, C, 1, T).astype(np.float32)
    enc = (rs.randn(N, 512) * 0.1).astype(np.float32)
    _pin(monkeypatch, sampling, torch.from_numpy, noise, enc)
    _pin(monkeypatch, jsampling, jnp.asarray, noise, enc)
    short_post(monkeypatch, demo, demo)
    short_post(monkeypatch, jik, jrender)  # the JAX CLI imports them when it renders
    argv = [a for a in _demo_args(ckpt, xia_root, tmp_path / "port", "--device", "cpu")
            if a != "--skip_render"]
    port_out = demo_main(argv)
    jax_out = jdemo_main([a for a in _demo_args(ckpt, xia_root, tmp_path / "jax")
                          if a != "--skip_render"])
    files = sorted(os.listdir(port_out))
    assert files == sorted(os.listdir(jax_out))
    stems = sorted(f.rsplit(".", 1)[0] for f in files)
    assert stems == sorted(["results", "input_content_motion", "input_style_example",
                            "out_transferred_motion", "input_content_motion00",
                            "input_style_motion00", "output_transferred_motion00_rep00"])
    assert all(f.endswith((".npy", ".bvh", ".mp4", ".gif")) for f in files)
    got, want = _results(port_out), _results(jax_out)
    np.testing.assert_allclose(got["hml"], want["hml"], atol=1e-4)
    for f in (f for f in files if f.endswith(".bvh")):
        a, b = bvh.read_bvh(os.path.join(port_out, f)), jbvh.read_bvh(os.path.join(jax_out, f))
        assert a.bones == b.bones and a.quats.shape == b.quats.shape
        assert np.isfinite(a.quats).all() and np.isfinite(a.pos).all()
        np.testing.assert_allclose(_anim_joints(a), _anim_joints(b), atol=BVH_ATOL, err_msg=f)


LONG = 180  # frames of the long-form demo runs: 3 windows of 76 at overlap 10


def test_demo_long_frames_matches_the_jax_demo(finetuned, xia_root, tmp_path,  # noqa: F811
                                               monkeypatch):
    """--long_frames 180 on a 200-frame content clip: the port's demo, with
    its post chain at the suite's size, against the JAX demo's
    results.npy (fp32, the noise and text features pinned in every window,
    atol 1e-4 on hml as the 76-frame test); the content's root channels kept
    at all 180 frames, and the BVH files over all of them."""
    from motionstyle.post import ik as jik, render as jrender
    from motionstyle_torch.cli import demo_style_transfer as demo
    from motionstyle_torch.post import bvh

    ckpt, _ = finetuned
    rs = np.random.RandomState(6)
    long_path = str(tmp_path / "900neutral_walking.npy")
    raw = (rs.randn(LONG + 20, C) * 0.5).astype(np.float32)
    np.save(long_path, raw)
    noise = rs.randn(N, C, 1, T).astype(np.float32)
    enc = (rs.randn(N, 512) * 0.1).astype(np.float32)
    _pin(monkeypatch, sampling, torch.from_numpy, noise, enc)
    _pin(monkeypatch, jsampling, jnp.asarray, noise, enc)
    short_post(monkeypatch, demo, demo)
    short_post(monkeypatch, jik, jrender)

    def argv(out, *extra, frames=LONG):
        return ["--model_path", ckpt, "--input_content", long_path, "--data_dir", xia_root,
                "--num_samples", str(N), "--output_dir", str(out), "--long_frames",
                str(frames), *extra]

    port_out = demo_main(argv(tmp_path / "port", "--device", "cpu"))
    want = _results(jdemo_main(argv(tmp_path / "jax", "--skip_render")))
    got = _results(port_out)
    assert got["motion"].shape == (N, 20, 3, LONG) and got["hml"].shape == (N, LONG, C)
    assert (got["lengths"] == LONG).all() and (want["lengths"] == LONG).all()
    np.testing.assert_allclose(got["hml"], want["hml"], atol=1e-4)
    ds = StyleMotionDataset(get_opt("stylexia_posrot", xia_root), split="test")
    np.testing.assert_allclose(got["hml"][:, :, :3],
                               np.broadcast_to(raw[:LONG, :3], (N, LONG, 3)), atol=1e-5)
    for f in ("input_content_motion.bvh", "out_transferred_motion.bvh"):
        anim = bvh.read_bvh(os.path.join(port_out, f))
        assert anim.quats.shape[0] == LONG and np.isfinite(anim.quats).all(), f
    assert ds.std.shape == (C,)
    with pytest.raises(SystemExit, match="exceeds the content clip"):
        demo_main(argv(tmp_path / "too_long", "--device", "cpu", "--skip_render",
                       frames=LONG + 21))


@pytest.fixture(scope="module")
def based_run(finetuned, tmp_path_factory):  # noqa: F811
    """The finetuned checkpoint in a run whose args.json records a
    resume_checkpoint (a second encoder file), so both packages rebuild the
    same style base."""
    import json
    import shutil

    from motionstyle_torch.models.denoiser import MDMConfig, StyleDiffusion
    from motionstyle_torch.models.params import export_style_encoder, seeded_init_

    ckpt, save_dir = finetuned
    root = tmp_path_factory.mktemp("based") / os.path.basename(save_dir)
    root.mkdir()
    base = str(root.parent / "base000000000.pt")
    torch.save(export_style_encoder(seeded_init_(StyleDiffusion(MDMConfig(
        latent_dim=128, num_layers=1)), 77)), base)
    with open(os.path.join(save_dir, "args.json")) as f:
        saved = json.load(f)
    saved["resume_checkpoint"] = base
    with open(root / "args.json", "w") as f:
        json.dump(saved, f)
    shutil.copy(ckpt, root / os.path.basename(ckpt))
    return str(root / os.path.basename(ckpt)), base


@pytest.mark.parametrize("kind", ["strength", "mix"])
def test_demo_style_arithmetic_matches_the_jax_demo(kind, based_run, xia_root, tmp_path,
                                                   monkeypatch):
    """--style_strength 0.5, and a --style_mix of the finetuned checkpoint
    and the base, through both demos from a run with a recorded
    resume_checkpoint: results.npy equal within the fp32 test's atol 1e-4
    (noise and text pinned), and the root channels kept; the two flags
    together are refused."""
    ckpt, base = based_run
    rs = np.random.RandomState(8)
    noise = rs.randn(N, C, 1, T).astype(np.float32)
    enc = (rs.randn(N, 512) * 0.1).astype(np.float32)
    _pin(monkeypatch, sampling, torch.from_numpy, noise, enc)
    _pin(monkeypatch, jsampling, jnp.asarray, noise, enc)
    flags = (["--style_strength", "0.5"] if kind == "strength"
             else ["--style_mix", f"{ckpt}:0.7,{base}:0.3"])
    got = _results(demo_main(_demo_args(ckpt, xia_root, tmp_path / "port", *flags,
                                        "--device", "cpu")))
    want = _results(jdemo_main(_demo_args(ckpt, xia_root, tmp_path / "jax", *flags)))
    plain = _results(demo_main(_demo_args(ckpt, xia_root, tmp_path / "plain", "--device",
                                          "cpu")))
    assert got["hml"].shape == (N, T, C) and np.isfinite(got["hml"]).all()
    np.testing.assert_allclose(got["hml"], want["hml"], atol=1e-4)
    np.testing.assert_allclose(got["hml"][:, :, :3], plain["hml"][:, :, :3], atol=1e-5)
    assert np.abs(got["hml"] - plain["hml"]).max() > 1e-4
    if kind == "strength":
        with pytest.raises(SystemExit, match="mutually exclusive"):
            demo_main(_demo_args(ckpt, xia_root, tmp_path / "both", "--style_strength", "0.5",
                                 "--style_mix", f"{ckpt}:1", "--device", "cpu"))


@pytest.mark.parametrize("flag, item", [
    (["--model_parallel", "2"], 11),
    (["--pipeline_parallel", "2"], 11), (["--sequence_parallel", "2"], 11)])
def test_demo_refuses_what_is_not_ported(flag, item, finetuned, xia_root,  # noqa: F811
                                         tmp_path):
    """The mesh layouts (ROADMAP item 11) are ported
    (tests/test_torch_mesh.py, test_torch_pipeline.py,
    test_torch_sequence.py); on one rank each raises the JAX CLI's
    ValueError, before any work (no output directory is made)."""
    ckpt, _ = finetuned
    argv = _demo_args(ckpt, xia_root, tmp_path / "out", "--device", "cpu") + flag
    with pytest.raises(ValueError, match=rf"{flag[0]} 2 does not divide the visible device "
                                         "count 1"):
        demo_main(argv)
    assert not os.path.exists(tmp_path / "out")


def test_demo_profile_writes_a_trace(finetuned, xia_root, tmp_path):  # noqa: F811
    """--profile DIR traces the sampling repetitions (the JAX demo's
    jax.profiler trace, :338-392) as a torch.profiler Chrome trace, and the
    results are the run's without it."""
    import json

    ckpt, _ = finetuned
    plain = _results(demo_main(_demo_args(ckpt, xia_root, tmp_path / "plain", "--device",
                                          "cpu")))
    traced = _results(demo_main(_demo_args(ckpt, xia_root, tmp_path / "out", "--device", "cpu",
                                           "--profile", str(tmp_path / "trace"))))
    with open(tmp_path / "trace" / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("linear" in n or "addmm" in n for n in names)
    np.testing.assert_array_equal(traced["hml"], plain["hml"])


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


# ---------------------------------------------------------------------------
# the humanml and bandai demos (ROADMAP §1 item 10)
# ---------------------------------------------------------------------------

FAMILY_CONTENT = {"humanml": "walking_neutral_000600.npy",
                  "bandai-2_posrot": "dataset-2_walking_neutral_600.npy"}


@pytest.fixture(scope="module")
def family_runs(hml_root, bandai_root, tmp_path_factory):  # noqa: F811
    """dataset -> (model*.pt, data root): one port finetune step on each
    family's corpus from a prior the JAX package writes, at diffusion_steps
    20 (args.json carries it to the demos)."""
    out = {}
    for dataset, root in (("humanml", hml_root), ("bandai-2_posrot", bandai_root)):
        base = tmp_path_factory.mktemp(dataset.replace("-", "_"))
        prior = jax_prior(str(base / "prior.pt"), model_util.DATASET_DIMS[dataset][0])
        save_dir = ft_main(["--save_dir", str(base / "ft"), "--data_dir", root, "--mdm_path",
                            prior, "--device", "cpu"] + family_args(dataset))
        out[dataset] = sorted(glob.glob(os.path.join(save_dir, "model*.pt")))[-1], root
    return out


def _pin_family(monkeypatch):
    """The same numpy-made noise, per-step noise and text features in every
    sampler both demo CLIs reach (the prior's chain, the Picard-parallel and
    forecast samplers, each long-form window, the transfer)."""
    from motionstyle.diffusion import forecast_sampling as jforecast
    from motionstyle.diffusion import parallel_sampling as jparallel
    from motionstyle_torch.cli import demo_style_transfer as pdemo

    pin_samplers(monkeypatch, {(sampling, "sample_loop"): torch.from_numpy,
                               (jsampling, "sample_loop"): jnp.asarray,
                               (pdemo, "parallel_sample_loop"): torch.from_numpy,
                               (jparallel, "parallel_sample_loop"): jnp.asarray,
                               (pdemo, "forecast_sample_loop"): torch.from_numpy,
                               (jforecast, "forecast_sample_loop"): jnp.asarray})


@pytest.mark.parametrize("dataset, flags", [
    ("humanml", []), ("humanml", ["--forecast_stride", "4"]),
    ("humanml", ["--parallel_window", "8"]), ("humanml", ["--long_frames", "240"]),
    ("bandai-2_posrot", [])],
    ids=["humanml", "humanml_forecast", "humanml_parallel", "humanml_long", "bandai"])
def test_family_demo_matches_the_jax_demo(dataset, flags, family_runs, tmp_path, monkeypatch):
    """The humanml demo generates its content from the frozen prior (a
    20-step DDPM chain under guidance 2.5, or the forecast or Picard-parallel
    sampler, or 240 frames by window continuation) and keeps the guided
    transfer's final sample; the bandai demo restyles a corpus clip with the
    bandai caption. Noise and text pinned: results.npy equals the JAX CLI's
    (schema, captions, lengths; hml at atol 1e-4, the fp32 path's bound)."""
    ckpt, root = family_runs[dataset]
    _pin_family(monkeypatch)
    argv = ["--model_path", ckpt, "--input_content", FAMILY_CONTENT[dataset], "--data_dir",
            root, "--skip_render", "--num_samples", "2", "--style_example",
            FAMILY_STYLE[dataset]] + flags
    port = _results(demo_main(argv + ["--output_dir", str(tmp_path / "port"),
                                      "--device", "cpu"]))
    want = _results(jdemo_main(argv + ["--output_dir", str(tmp_path / "jax")]))
    assert port.keys() == want.keys()
    for k in port:
        if isinstance(want[k], np.ndarray):
            assert port[k].shape == want[k].shape and port[k].dtype == want[k].dtype, k
        else:
            assert port[k] == want[k], k
    frames = 240 if "--long_frames" in flags else (
        196 if dataset == "humanml" else port["lengths"][0])
    dims = model_util.DATASET_DIMS[dataset][0]
    assert port["hml"].shape[0] == 2 and port["hml"].shape[2] == dims
    assert port["hml"].shape[1] >= frames and np.isfinite(port["hml"]).all()
    if dataset.startswith("bandai"):
        assert port["text"][0] == "A person walkings angry"
    np.testing.assert_allclose(port["hml"], want["hml"], atol=1e-4)


def test_humanml_demo_writes_the_jax_demos_outputs(family_runs, tmp_path, monkeypatch):
    """Without --skip_render on humanml: no BVH (:436-451), the three
    renders (the prior-made content foot-skate cleaned before it is the
    contact reference, :427-433), and the same results as the JAX demo's."""
    from motionstyle_torch.cli import demo_style_transfer as pdemo

    ckpt, root = family_runs["humanml"]
    _pin_family(monkeypatch)
    short_post(monkeypatch, pdemo, pdemo)
    argv = ["--model_path", ckpt, "--input_content", FAMILY_CONTENT["humanml"], "--data_dir",
            root, "--num_samples", "1", "--style_example", FAMILY_STYLE["humanml"]]
    out = demo_main(argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    names = sorted(os.listdir(out))
    assert not [n for n in names if n.endswith(".bvh")]
    assert {n.rsplit(".", 1)[0] for n in names} >= {
        "results", "input_content_motion00", "input_style_motion00",
        "output_transferred_motion00_rep00"}
    jout = jdemo_main(argv + ["--output_dir", str(tmp_path / "jax"), "--skip_render"])
    np.testing.assert_allclose(_results(out)["hml"], _results(jout)["hml"], atol=1e-4)
