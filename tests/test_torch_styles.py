"""Named styles, style strength and style mixes of the port on the CPU: the
task arithmetic of motionstyle_torch/cli/model_util.py against the JAX
package's (motionstyle/cli/model_util.py) from the same base and finetuned
checkpoints, the style base's refusals, --styles' parsing, and the serving
engine's registry of named styles (mirroring tests/test_serve.py's
TestMultiStyle): a style served beside another equals a single-style
engine's answer bit for bit within a bucket."""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
from motionstyle.cli import model_util as jmodel_util
from motionstyle.models import denoiser as jden
from motionstyle_torch.cli import model_util
from motionstyle_torch.models.denoiser import MDMConfig, StyleDiffusion
from motionstyle_torch.models.params import (
    convert_encoder, encoder_from_jax, export_style_encoder, seeded_init_)
from tests.test_torch_models import one_torch_thread  # noqa: F401

LAYERS, WIDTH, FF = 2, 64, 128
STRENGTH_ATOL = 1e-6


def _cfgs():
    kw = dict(njoints=181, nfeats=1, latent_dim=WIDTH, ff_size=FF, num_layers=LAYERS,
              num_heads=4, clip_dim=512)
    return MDMConfig(**kw), jden.MDMConfig(**kw)


def _encoder_file(path, seed: int, scale: float = 1.0) -> str:
    """A style-encoder checkpoint in the reference layout from a seed."""
    cfg, _ = _cfgs()
    model = seeded_init_(StyleDiffusion(cfg), seed)
    sd = export_style_encoder(model)
    gen = torch.Generator().manual_seed(seed)
    sd = {k: v + scale * 0.01 * torch.randn(v.shape, generator=gen) for k, v in sd.items()}
    torch.save(sd, path)
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A base checkpoint, two finetuned ones and run directories whose
    args.json records the base as resume_checkpoint, records none (as the
    JAX package writes it), or records none and this package."""
    root = tmp_path_factory.mktemp("styles")
    base = _encoder_file(root / "base.pt", 1)
    out = {"base": base}
    for name, rc, extra in (("rc", base, {}), ("jax", "", {}),
                            ("port", "", {"package": model_util.PACKAGE}),
                            ("gone", str(root / "missing.pt"), {})):
        d = root / name
        d.mkdir()
        with open(d / "args.json", "w") as f:
            json.dump({"resume_checkpoint": rc, "seed": 3, **extra}, f)
        out[name] = _encoder_file(d / "model000000002.pt", 2)
        out[name + "_b"] = _encoder_file(d / "model000000004.pt", 4, scale=3.0)
    return out


def _port_bundle(path):
    cfg, _ = _cfgs()
    model = seeded_init_(StyleDiffusion(cfg), 0)
    model.style_encoder.load_state_dict(convert_encoder(
        model_util.load_torch_state_dict(path), "seqTransEncoder", LAYERS))
    return SimpleNamespace(cfg=cfg, model=model)


def _jax_bundle(path):
    from motionstyle.models.torch_import import convert_encoder as jconvert
    from motionstyle.models.torch_import import load_torch_state_dict

    _, jcfg = _cfgs()
    enc = jconvert(load_torch_state_dict(path), "seqTransEncoder", LAYERS)
    return SimpleNamespace(cfg=jcfg, params={"params": {"style_encoder": enc}})


def _port_state(bundle) -> dict:
    return {k: v.detach().clone() for k, v in bundle.model.style_encoder.state_dict().items()}


def _args(path, **kw):
    return SimpleNamespace(**{"model_path": path, "seed": 10, "style_strength": 1.0,
                              "style_mix": "", **kw})


@pytest.mark.parametrize("strength", [0.0, 0.5, 1.0, 1.5])
def test_strength_matches_jax(runs, strength):
    port = _port_bundle(runs["rc"])
    before = _port_state(port)
    applied = model_util.apply_style_strength(port, _args(runs["rc"], style_strength=strength))
    jax_b = _jax_bundle(runs["rc"])
    jmodel_util.apply_style_strength(jax_b, _args(runs["rc"], style_strength=strength))
    want = encoder_from_jax(jax.tree_util.tree_map(np.asarray,
                                                   jax_b.params["params"]["style_encoder"]))
    got = _port_state(port)
    assert applied == (strength != 1.0)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=STRENGTH_ATOL, err_msg=k)
    if strength == 1.0:  # a no-op
        assert all(torch.equal(got[k], before[k]) for k in got)
    if strength == 0.0:  # the base, bit for bit
        base = convert_encoder(model_util.load_torch_state_dict(runs["base"]),
                               "seqTransEncoder", LAYERS)
        assert all(torch.equal(got[k], base[k]) for k in got)


def test_mix_matches_jax(runs):
    spec = f"{runs['rc']}:0.6,{runs['rc_b']}:0.4"
    port = _port_bundle(runs["rc"])
    assert model_util.apply_style_mix(port, _args(runs["rc"], style_mix=spec))
    jax_b = _jax_bundle(runs["rc"])
    jmodel_util.apply_style_mix(jax_b, _args(runs["rc"], style_mix=spec))
    want = encoder_from_jax(jax.tree_util.tree_map(np.asarray,
                                                   jax_b.params["params"]["style_encoder"]))
    got = _port_state(port)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=STRENGTH_ATOL, err_msg=k)
    with pytest.raises(SystemExit, match="not path:weight"):
        model_util.apply_style_mix(_port_bundle(runs["rc"]), _args(runs["rc"], style_mix="0.5"))


def test_jax_written_run_without_resume_checkpoint_is_refused(runs):
    with pytest.raises(SystemExit, match="not written by motionstyle_torch"):
        model_util.apply_style_strength(_port_bundle(runs["jax"]),
                                        _args(runs["jax"], style_strength=0.5))


def test_missing_resume_checkpoint_is_refused(runs):
    with pytest.raises(SystemExit, match="no checkpoint exists there"):
        model_util.apply_style_strength(_port_bundle(runs["gone"]),
                                        _args(runs["gone"], style_strength=0.5))


def test_port_written_run_without_resume_checkpoint_uses_its_seeded_start(runs):
    """A run this package wrote (args.json says so) started from its seeded
    init with the run's seed: strength 0 gives exactly that encoder."""
    port = _port_bundle(runs["port"])
    model_util.apply_style_strength(port, _args(runs["port"], style_strength=0.0))
    cfg, _ = _cfgs()
    start = seeded_init_(StyleDiffusion(cfg), 3).style_encoder.state_dict()
    assert all(torch.equal(v, start[k]) for k, v in _port_state(port).items())


def test_finetune_records_the_package(tmp_path):
    """The port's finetune CLI writes "package" into args.json."""
    from motionstyle_torch.cli.finetune_style_diffusion import main as ft_main
    from tests.test_torch_finetune import CLI_ARGS

    root = tmp_path / "xia"
    (root / "new_joint_vecs").mkdir(parents=True)
    r = np.random.RandomState(0)
    for f in ("350angry_jumping.npy", "306neutral_running.npy"):
        np.save(root / "new_joint_vecs" / f, (r.randn(40, 181) * 0.5).astype(np.float32))
    np.save(root / "Mean.npy", np.zeros(181, np.float32))
    np.save(root / "Std.npy", np.ones(181, np.float32))
    argv = CLI_ARGS + ["--save_dir", str(tmp_path / "ft"), "--data_dir", str(root),
                       "--latent_dim", "64"]
    argv[argv.index("--num_steps") + 1] = "1"
    save_dir = ft_main(argv)
    with open(os.path.join(save_dir, "args.json")) as f:
        assert json.load(f)["package"] == "motionstyle_torch"


def test_named_styles_spec(runs, tmp_path):
    cfg, _ = _cfgs()
    args = _args(runs["rc"])
    styles = model_util.load_named_styles(args, f"a={runs['rc']}, b={runs['rc_b']}", cfg)
    assert sorted(styles) == ["a", "b"]
    want = convert_encoder(model_util.load_torch_state_dict(runs["rc_b"]), "seqTransEncoder",
                           LAYERS)
    assert all(torch.equal(styles["b"][k], want[k]) for k in want)
    half = model_util.load_named_styles(_args(runs["rc"], style_strength=0.5),
                                        f"b={runs['rc_b']}", cfg)["b"]
    base = convert_encoder(model_util.load_torch_state_dict(runs["base"]), "seqTransEncoder",
                           LAYERS)
    for k in half:
        torch.testing.assert_close(half[k], base[k] + 0.5 * (want[k] - base[k]), rtol=0, atol=0)
    for spec, match in (("nopath", "name=path"), (f"a/b={runs['rc']}", "must not contain"),
                        (f"a={tmp_path / 'nope.pt'}", "not found")):
        with pytest.raises(SystemExit, match=match):
            model_util.load_named_styles(args, spec, cfg)


def test_adapter_entries_are_merged_onto_their_runs_base(runs, tmp_path):
    """An adapter (LoRA factors in the JAX package's format) in --styles or
    --style_mix: merged onto the base its run recorded, as the JAX package's
    apply_style_adapter merges it (tests/test_torch_lora.py takes one as
    --model_path)."""
    from motionstyle_torch.models import lora

    cfg, _ = _cfgs()
    base = convert_encoder(model_util.load_torch_state_dict(runs["base"]), "seqTransEncoder",
                           LAYERS)
    gen = torch.Generator().manual_seed(5)
    factors = {site: {"a": torch.randn(base[key].shape[1], 2, generator=gen) * 0.1,
                      "b": torch.randn(2, base[key].shape[0], generator=gen) * 0.1}
               for site, key in lora.adapter_sites(LAYERS)}
    adapter = os.path.join(os.path.dirname(runs["rc"]), "adapter000000002.pt")
    torch.save(lora.export_lora(factors, 4.0), adapter)
    want = lora.merge_lora(base, factors, 4.0)
    got = model_util.load_named_styles(_args(runs["rc"]), f"a={adapter}", cfg)["a"]
    assert all(torch.equal(got[k], want[k]) for k in want)
    port = _port_bundle(runs["rc"])
    assert model_util.apply_style_mix(port, _args(runs["rc"], style_mix=f"{adapter}:0.5"))
    for k, v in _port_state(port).items():
        torch.testing.assert_close(v, base[k] + 0.5 * (want[k] - base[k]), rtol=0, atol=0)
    jbundle = SimpleNamespace(cfg=_cfgs()[1], params={"params": {}})
    jmodel_util.apply_style_adapter(jbundle, _args(adapter),
                                    jmodel_util.load_torch_state_dict(adapter))
    jtree = jbundle.params["params"]["style_encoder"]
    for k, v in encoder_from_jax(jax.tree_util.tree_map(np.asarray, jtree)).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=STRENGTH_ATOL, err_msg=k)


# -- the engine's named styles (tests/test_serve.py::TestMultiStyle) --------

ITEM = (12, 1, 8)


def _tiny_engine(model, **kw):
    from motionstyle_torch.diffusion.schedule import make_schedule
    from motionstyle_torch.parallel.inference import Sampler
    from motionstyle_torch.serve.engine import ServingEngine

    sched = make_schedule("cosine", 40, "ddim10", device="cpu")
    sampler = Sampler(sched, lambda m: (lambda x, t, c: m(x, t, c.get("enc_text"))), model,
                      method="ddim", skip_timesteps=3, stop_timesteps=2, dump_all_xstart=True)
    return ServingEngine(sampler, ITEM, max_batch=8, max_wait_ms=50, **kw)


def _tiny_model(style_seed=None):
    cfg = MDMConfig(njoints=12, nfeats=1, latent_dim=16, ff_size=32, num_layers=1,
                    num_heads=2, clip_dim=16)
    model = seeded_init_(StyleDiffusion(cfg), 0).eval()
    if style_seed is not None:
        model.style_encoder.load_state_dict(_style_state(style_seed))
    return model


def _style_state(seed):
    cfg = MDMConfig(njoints=12, nfeats=1, latent_dim=16, ff_size=32, num_layers=1,
                    num_heads=2, clip_dim=16)
    return seeded_init_(StyleDiffusion(cfg), seed).style_encoder.state_dict()


def _request(seed, rng_data=0, style=None):
    from motionstyle_torch.serve.engine import Request

    r = np.random.RandomState(rng_data)
    mask = np.zeros(ITEM, np.float32)
    mask[:3] = 1.0
    return Request({"enc_text": r.randn(16).astype(np.float32)},
                   init_image=r.randn(*ITEM).astype(np.float32), inpainting_mask=mask,
                   seed=seed, style=style)


@pytest.fixture(scope="module")
def styled_engine():
    eng = _tiny_engine(_tiny_model(), deterministic=True,
                       styles={"s5": _style_state(5), "s6": _style_state(6)})
    yield eng
    eng.close()


@pytest.mark.parametrize("style", ["s5", "s6"])
def test_named_style_equals_single_style_engine(styled_engine, style):
    alone = _tiny_engine(_tiny_model(int(style[1:])), deterministic=True)
    try:
        for seed in (3, 7):
            got = styled_engine.sample(_request(seed, seed, style))
            want = alone.sample(_request(seed, seed))
            np.testing.assert_array_equal(got, want)
    finally:
        alone.close()
    default = styled_engine.sample(_request(3, 3))
    assert np.abs(default - styled_engine.sample(_request(3, 3, style))).max() > 1e-4


def test_style_views_share_the_prior(styled_engine):
    model = styled_engine.sampler.params
    for view in styled_engine._styles.values():
        assert view.mdm is model.mdm and view.motion_enc_encoder is model.motion_enc_encoder
        assert view.style_encoder is not model.style_encoder
    own = _tiny_model().style_encoder.state_dict()
    assert all(torch.equal(v, own[k]) for k, v in model.style_encoder.state_dict().items())


def test_mixed_style_queue_invariance(styled_engine):
    """A queue mixing styles splits into per-style device batches and every
    request equals its solo answer (one bucket shape: bit for bit)."""
    keys = [(s, st) for s in (3, 5) for st in (None, "s5", "s6")]
    solo = {k: styled_engine.sample(_request(k[0], k[0], k[1])) for k in keys}
    futs = {k: styled_engine.submit(_request(k[0], k[0], k[1])) for k in keys}
    for k, f in futs.items():
        np.testing.assert_array_equal(f.result(timeout=60), solo[k])


def test_unknown_style_refused(styled_engine):
    with pytest.raises(ValueError, match="unknown style 'nope'"):
        styled_engine.submit(_request(1, style="nope"))
