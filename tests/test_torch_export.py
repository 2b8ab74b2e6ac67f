"""The port's exported artifacts (motionstyle_torch/serve/export.py and
cli/export_model.py) on the CPU, mirroring tests/test_export.py: an
artifact's answers against the live sampler and the live engine, two loads
bit-equal, the platform and format gates (a JAX StableHLO artifact refused),
the refusal of host-pinned noise, bad shapes and a missing item_seeds,
named styles round-tripping, the text plan against encode_text, kernels 1
and 2 as custom-operator nodes of a --fused / --quant_int8 program, and the
CLI export_model then serve --artifact. One export per fixture.

Tolerance: an artifact runs the same eager ops and the same kernels (here
their twins) on the same per-seed noise as the live sampler, so its answers
are held to EXPORT_ATOL = 1e-6 (they are bit-equal on this CPU)."""
import json
import os

import numpy as np
import pytest
import torch

from motionstyle_torch.diffusion.ddpm import Inpainting
from motionstyle_torch.diffusion.sampling import min_latency_plan
from motionstyle_torch.diffusion.schedule import make_schedule
from motionstyle_torch.models.denoiser import MDMConfig, StyleDiffusion
from motionstyle_torch.models.params import seeded_init_
from motionstyle_torch.parallel.inference import Sampler
from motionstyle_torch.serve import export as sx
from motionstyle_torch.serve.engine import Request, ServingEngine
from tests.test_torch_models import one_torch_thread  # noqa: F401

ITEM = (12, 1, 8)
ENC = 16
EXPORT_ATOL = 1e-6


def _sampler(**cfg_kw):
    cfg = MDMConfig(njoints=12, nfeats=1, latent_dim=64, ff_size=128, num_layers=1,
                    num_heads=4, clip_dim=ENC, **cfg_kw)
    model = seeded_init_(StyleDiffusion(cfg), 0).eval()
    sched = make_schedule("cosine", 40, "ddim10", device="cpu")
    stop, _ = min_latency_plan(10, 3)
    return Sampler(sched, lambda m: (lambda x, t, c: m(x, t, c.get("enc_text"))), model,
                   method="ddim", skip_timesteps=3, stop_timesteps=stop, dump_all_xstart=True)


def _meta(sampler, **kw):
    return {"buckets": [1, 2, 4, 8], "dataset": "stylexia_posrot", "item_shape": list(ITEM),
            "cond_spec": {"enc_text": [[ENC], "float32"]}, "inpainting_mask": "root_horizontal",
            "needs_step_noise": sampler.needs_step_noise(), "n_steps": sampler.n_live_steps(),
            "dump_pick": -1, **kw}


def _batch(b, seed=0):
    r = np.random.RandomState(seed)
    init = r.randn(b, *ITEM).astype(np.float32)
    mask = np.zeros_like(init)
    mask[:, :3] = 1.0
    return {"init_image": init, "cond": {"enc_text": r.randn(b, ENC).astype(np.float32)},
            "inpainting": Inpainting(mask, init), "item_seeds": list(range(10, 10 + b))}


def _style_state(seed):
    cfg = MDMConfig(njoints=12, nfeats=1, latent_dim=64, ff_size=128, num_layers=1,
                    num_heads=4, clip_dim=ENC)
    return seeded_init_(StyleDiffusion(cfg), seed).style_encoder.state_dict()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(live sampler, artifact directory): one export of the plain plan for
    the CPU, with a named style stored beside it."""
    sampler = _sampler()
    program, params = sx.export_sampler_plan(sampler, ITEM, ENC)
    path = str(tmp_path_factory.mktemp("artifact") / "tiny")
    sx.save_artifact(path, _meta(sampler), {"cpu": program}, params,
                     styles={"s5": _style_state(5)})
    return sampler, path


def test_artifact_matches_live_sampler(tiny):
    sampler, path = tiny
    art = sx.load_artifact(path, "cpu")
    for b in (1, 3):  # one program, a symbolic batch dim
        got = art.sampler(_batch(b, b))
        want = sampler(_batch(b, b))
        assert got.shape == want.shape == (sampler.n_live_steps(), b, *ITEM)
        torch.testing.assert_close(got, want, rtol=0, atol=EXPORT_ATOL)


def test_independent_loads_bit_equal(tiny):
    _, path = tiny
    a = sx.load_artifact(path, "cpu").sampler(_batch(2, 7))
    b = sx.load_artifact(path, "cpu").sampler(_batch(2, 7))
    assert torch.equal(a, b)


def test_meta_and_params(tiny):
    _, path = tiny
    art = sx.load_artifact(path, "cpu")
    meta = art.meta
    assert meta["format"] == "torch.export" and meta["format_version"] == sx.FORMAT_VERSION
    assert meta["torch_version"] == torch.__version__
    assert meta["platforms"] == [{"platform": "cpu"}] and meta["styles"] == ["s5"]
    assert not meta["has_text_plan"] and art.encode_text is None
    assert all(t.device.type == "cpu" for t in art.sampler.params.values())
    assert sorted(os.listdir(os.path.join(path, "plans"))) == ["sample_cpu.pt2"]
    # the program holds no copy of the parameters: they are its input
    assert os.path.getsize(os.path.join(path, "plans", "sample_cpu.pt2")) < \
        os.path.getsize(os.path.join(path, "params.pt"))


def test_platform_and_format_gates(tiny, tmp_path):
    import shutil

    _, path = tiny
    with pytest.raises(ValueError, match=r"exported for \['cpu'\]; this process serves on cuda"):
        sx.load_artifact(path, "cuda")
    for name, meta, match in (
            ("cuda_only", {"platforms": [{"platform": "cuda", "capability": "9.0"}]},
             r"exported for \['cuda'\]"),
            ("old", {"format_version": 0}, "format version"),
            ("jax", {"format": None, "format_version": 2, "jax_version": "0.4.35"},
             "JAX StableHLO artifact"),
            ("other", {"format": "onnx"}, "artifact format")):
        copy = tmp_path / name
        shutil.copytree(path, copy)
        with open(copy / "meta.json") as f:
            m = json.load(f)
        m.update(meta)
        if m["format"] is None:
            del m["format"]
        with open(copy / "meta.json", "w") as f:
            json.dump(m, f)
        with pytest.raises(ValueError, match=match):
            sx.load_artifact(str(copy), "cpu")


def test_load_without_a_device_runs_on_the_card_or_raises(tmp_path, tiny, monkeypatch):
    """load_artifact(path) asks for the card: without one it raises instead
    of serving on the CPU; load_artifact(path, "cpu") serves as before."""
    import json
    import shutil

    sampler, path = tiny
    both = tmp_path / "both"
    shutil.copytree(path, both)
    meta = json.loads((both / "meta.json").read_text())
    meta["platforms"].append({"platform": "cuda", "capability": "9.0"})
    (both / "meta.json").write_text(json.dumps(meta))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for p in (path, str(both)):
        with pytest.raises((RuntimeError, ValueError), match="no CUDA device|serves on cuda"):
            sx.load_artifact(p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sx.load_artifact(str(both))
    got = sx.load_artifact(str(both), "cpu").sampler(_batch(2, 5))
    torch.testing.assert_close(got, sampler(_batch(2, 5)), rtol=0, atol=EXPORT_ATOL)


def test_rejects_pinned_noise_and_bad_shapes(tiny):
    _, path = tiny
    art = sx.load_artifact(path, "cpu")
    good = _batch(2)
    cases = [
        (dict(good, noise=np.zeros((2, *ITEM), np.float32)), "pinned 'noise'"),
        ({k: v for k, v in good.items() if k != "item_seeds"}, "require per-item 'item_seeds'"),
        (dict(good, init_image=np.zeros((2, 12, 1, 9), np.float32)), "item shape"),
        ({k: v for k, v in good.items() if k != "inpainting"}, "init_image and inpainting"),
        (dict(good, cond={"other": good["cond"]["enc_text"]}), "cond keys"),
    ]
    for batch, match in cases:
        with pytest.raises(ValueError, match=match):
            art.sampler(batch)


def _requests(n, style=None):
    out = []
    for i in range(n):
        b = _batch(1, 20 + i)
        out.append(Request({"enc_text": b["cond"]["enc_text"][0]}, init_image=b["init_image"][0],
                           inpainting_mask=b["inpainting"].mask[0], seed=i, style=style))
    return out


def test_engine_over_artifact_matches_live_engine(tiny):
    """ServingEngine runs the artifact unchanged (dynamic batching, the
    pinned noise), its named style too, and answers as the live engine with
    the same style does."""
    sampler, path = tiny
    art = sx.load_artifact(path, "cpu")
    assert sorted(art.styles) == ["s5"]
    want_s5 = _style_state(5)
    assert all(torch.equal(art.styles["s5"][k], want_s5[k]) for k in want_s5)
    engines = [ServingEngine(s, ITEM, max_wait_ms=20, deterministic=True, dump_pick=-1,
                             styles=styles)
               for s, styles in ((art.sampler, art.styles), (sampler, {"s5": want_s5}))]
    try:
        for style in (None, "s5"):
            got = [f.result(timeout=60) for f in map(engines[0].submit, _requests(3, style))]
            want = [f.result(timeout=60) for f in map(engines[1].submit, _requests(3, style))]
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=0, atol=EXPORT_ATOL)
        assert np.abs(engines[0].sample(_requests(1, "s5")[0])
                      - engines[0].sample(_requests(1)[0])).max() > 1e-4
    finally:
        for e in engines:
            e.close()


@pytest.mark.parametrize("flag, op", [
    ("fused", "motionstyle.fused_encoder_layer.default"),
    ("quant_int8", "motionstyle.fused_encoder_layer_int8.default")])
def test_kernel_plans_hold_the_custom_op(flag, op, tmp_path):
    """A --fused 1 (--quant_int8 1) plan holds kernel 1 (2) as one
    custom-operator node per layer and denoiser call; the loaded program
    equals the eager sampler (the twin on the CPU)."""
    sampler = _sampler(**{flag: True, "dtype": "bfloat16"})
    program, params = sx.export_sampler_plan(sampler, ITEM, ENC)
    assert sx.custom_ops_in(program) == [op] * sampler.n_live_steps()  # 1 layer a call
    sx.save_artifact(str(tmp_path), _meta(sampler), {"cpu": program}, params)
    got = sx.load_artifact(str(tmp_path), "cpu").sampler(_batch(2, 3))
    torch.testing.assert_close(got, sampler(_batch(2, 3)), rtol=0, atol=EXPORT_ATOL)


@pytest.mark.parametrize("int8", [False, True])
def test_operator_packs_once_per_tensor_version(int8):
    """The operators convert a layer's fp32 parameters to the kernel's format
    once for each set of tensor versions (packed_params): a program's second
    call reuses the first call's copy, and an in-place update repacks."""
    from motionstyle_torch.ops import fused_encoder as fe

    layer = seeded_init_(StyleDiffusion(MDMConfig(
        latent_dim=64, ff_size=128, num_layers=1, clip_dim=ENC)), 0).style_encoder.layers[0]
    raw = [fe.layer_params(layer)[k].detach() for k in fe.LAYER_KEYS]
    first = fe.packed_params(raw, int8)
    assert fe.packed_params(raw, int8) is first
    want = (fe.quantize_layer_params if int8 else fe.pack)(dict(zip(fe.LAYER_KEYS, raw)))
    assert all(torch.equal(first[k], want[k]) for k in want)
    op = (torch.ops.motionstyle.fused_encoder_layer_int8 if int8
          else torch.ops.motionstyle.fused_encoder_layer)
    x = torch.randn(2, 5, 64)
    ref = (fe.fused_encoder_layer_int8_reference if int8 else fe.fused_encoder_layer_reference)
    torch.testing.assert_close(op(x, raw, 4, None), ref(x, want, 4), rtol=0, atol=0)
    with torch.no_grad():
        raw[0].mul_(0.5)
    again = fe.packed_params(raw, int8)
    assert again is not first
    assert any(not torch.equal(again[k], first[k]) for k in again)


def test_eager_layer_calls_bypass_the_operator(monkeypatch):
    """Outside tracing the wrapper calls its kernel (here the twin) directly:
    the eager path is the parent's, and the operator is recorded only while
    torch.export traces."""
    from motionstyle_torch.ops import fused_encoder as fe

    calls = []
    monkeypatch.setattr(torch.ops.motionstyle, "fused_encoder_layer",
                        lambda *a: calls.append(a), raising=False)
    x = torch.randn(2, 5, 64)
    p = fe.pack_layer_params(seeded_init_(StyleDiffusion(MDMConfig(
        latent_dim=64, ff_size=128, num_layers=1, clip_dim=ENC)), 0).style_encoder.layers[0])
    out = fe.fused_encoder_layer(x, p, 4)
    assert not calls
    torch.testing.assert_close(out, fe.fused_encoder_layer_reference(x, p, 4), rtol=0, atol=0)


def test_text_plan_matches_encode_text(tmp_path):
    from motionstyle_torch.models import clip_text

    tower = seeded_init_(clip_text.ClipTextEncoder(clip_text.ClipTextConfig(
        layers=1, width=32, heads=2, embed_dim=8)), 42).eval()
    program, params = sx.export_text_plan(tower)
    sx._save_program(program, str(tmp_path / "text.pt2"))
    enc = sx.ExportedTextEncoder(torch.export.load(str(tmp_path / "text.pt2")),
                                 "stylexia_posrot", params, torch.device("cpu"))
    for texts in (["a person walks"], ["a person runs angrily", "", "jumps"]):
        want = clip_text.encode_text(tower, texts).numpy()
        np.testing.assert_allclose(enc(texts), want, rtol=0, atol=EXPORT_ATOL)


COMMON = ["--dataset", "stylexia_posrot", "--layers", "1", "--latent_dim", "64",
          "--diffusion_steps", "40", "--skip_steps", "28", "--timestep_respacing", "ddim10",
          "--device", "cpu"]


def test_cli_refusals():
    from motionstyle_torch.cli import export_model

    base = ["--model_path", "m.pt", "--output", "out"]
    for flags, match in ((["--fused", "1", "--platforms", "cpu"], "--platforms cuda"),
                         (["--quant_int8", "1", "--platforms", "cuda,cpu"], "--platforms cuda"),
                         (["--platforms", "tpu"], "takes cuda and cpu")):
        with pytest.raises(SystemExit, match=match):
            export_model.parse_args(base + flags)
    args = export_model.parse_args(base + ["--platforms", "cuda,cpu"])
    assert args.platforms == ["cuda", "cpu"]
    with pytest.raises(NotImplementedError, match="arch='trans_enc' only"):
        export_model.parse_args(base + ["--arch", "gru"])


def test_cli_export_then_serve_artifact(tmp_path):
    """cli.export_model (plain plan, cpu, a named style, the text plan) then
    cli.serve --artifact: 76-frame and 180-frame (long-form) answers and a
    named style's answer within EXPORT_ATOL of live serving's, the content's
    root channels kept."""
    from motionstyle_torch.cli import export_model, serve
    from motionstyle_torch.data.masks import get_inpainting_mask
    from motionstyle_torch.models.params import export_style_encoder

    model_path = str(tmp_path / "ft" / "model000000001.pt")
    style2 = tmp_path / "style2.pt"
    torch.save(export_style_encoder(seeded_init_(StyleDiffusion(MDMConfig(
        latent_dim=64, num_layers=1)), 5)), style2)
    artifact = str(tmp_path / "artifact")
    # the live engine's largest bucket is 8: with --deterministic 1 both serve
    # every batch in that one shape
    export_model.main(["--model_path", model_path, "--output", artifact, "--buckets", "2,8",
                       "--platforms", "cpu", "--styles", f"fierce={style2}", *COMMON])
    with open(os.path.join(artifact, "meta.json")) as f:
        meta = json.load(f)
    assert meta["buckets"] == [2, 8] and meta["custom_ops"] == [] and meta["has_text_plan"]
    assert sorted(os.listdir(os.path.join(artifact, "plans"))) == ["sample_cpu.pt2",
                                                                   "text_cpu.pt2"]

    r = np.random.RandomState(0)
    payloads = [{"content": r.randn(frames, 181).astype(np.float32).tolist(),
                 "text": "a person walks angrily", "seed": 7, **extra}
                for frames, extra in ((76, {}), (180, {}), (76, {"style": "fierce"}))]
    outs = {}
    for label, argv in (("live", ["--model_path", model_path, "--styles", f"fierce={style2}"]),
                        ("artifact", ["--artifact", artifact])):
        engine, decode, handle, stream = serve.build_engine(serve.parse_args(
            argv + COMMON + ["--max_wait_ms", "1", "--deterministic", "1"]))
        try:
            outs[label] = [np.asarray(handle(p)) for p in payloads]
            if label == "artifact":
                assert engine.buckets == (8,)
                chunks = [np.asarray(c["motion"], np.float32) for c in stream(payloads[1])]
                np.testing.assert_array_equal(np.concatenate(chunks, -1), outs[label][1])
        finally:
            engine.close()
    for got, want in zip(outs["artifact"], outs["live"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=EXPORT_ATOL)
    assert np.abs(outs["artifact"][2] - outs["artifact"][0]).max() > 1e-4
    long = np.asarray(payloads[1]["content"], np.float32).T[:, None, :]
    mask = np.asarray(get_inpainting_mask("root_horizontal", (1, 181, 1, 180),
                                          dataset="stylexia_posrot"), np.float32)[0]
    np.testing.assert_array_equal(outs["artifact"][1] * mask, long * mask)
    with pytest.raises(SystemExit, match="export-time choice"):
        serve.build_engine(serve.parse_args(["--artifact", artifact, "--styles",
                                             f"x={style2}", *COMMON]))
