"""The port's mesh (parallel/mesh.py) and sharded sampling
(parallel/inference.py) against one rank and the JAX package, mirroring
tests/test_parallel.py on two gloo ranks on the CPU
(tests/torch_dist_ranks.py::mesh_cases, one spawn for the file).

  - cli_training_mesh's exits and messages, against the JAX policy at the
    same world size; param_spec and fsdp_spec leaf by leaf against the JAX
    rules on the same parameters; shard_batch with an indivisible leaf;
  - a data-parallel finetune step at world 2 (dropout and condition
    dropout on, so its draws are its rows of the global batch's) against
    world 1: losses rtol 1e-5, gradients rtol 1e-4 atol 1e-6
    (tests/test_parallel.py:216-222), for the CLI's batch (a dataset batch
    beside the B=1 style pair) and the JAX test's (every leaf batched);
    the same with the layers split over 'model';
  - a data-parallel step against the JAX trainer's single-device step on
    the same weights, batch and pinned noise (dropout off): loss rel 1e-5,
    weights atol 2e-4 (tests/test_torch_finetune.py);
  - the sharded sampler against one device: atol 2e-5 (data parallel, the
    min-latency preset, data_parallel_sample; tests/test_parallel.py:77),
    the Picard and forecast arms; tensor parallel against replicated: atol
    1e-4 (:97);
  - the collectives the port issues, the counterpart of the JAX package's
    HLO checks (:282-320): data-parallel sampling makes no all-reduce and
    one all-gather of the result; tensor-parallel sampling all-reduces
    twice per layer call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.parallel import mesh as jmesh
from motionstyle.train.finetune import FinetuneConfig as JFinetuneConfig
from motionstyle.train.finetune import StyleFinetuneTrainer as JTrainer
from motionstyle.diffusion.schedule import make_schedule as jmake_schedule
from motionstyle_torch.diffusion import sampling
from motionstyle_torch.diffusion.schedule import make_schedule
from motionstyle_torch.models.params import encoder_from_jax, encoder_leaves, mdm_leaves
from motionstyle_torch.parallel import mesh
from motionstyle_torch.parallel.inference import Sampler
from tests import torch_dist_ranks as ranks
from tests.test_torch_finetune import _jax_draws
from tests.test_torch_models import one_torch_thread, style_pair  # noqa: F401

C, T, D = 12, 8, 64
FT_KW = dict(lr=1e-3, skip_steps=700, semantic_guidance=True)


def _ft_batch(seed: int, B: int, pair: int) -> dict:
    """A finetune batch: B dataset clips beside a style pair of `pair` rows
    (1: the CLI's; B: the JAX test's)."""
    rs = np.random.RandomState(seed)
    inp = np.zeros((pair, C, 1, T), np.float32)
    inp[:, :3] = 1.0
    frame = np.ones((B, T), bool)
    frame[1, 5:] = False
    return {
        "x_start": rs.randn(B, C, 1, T).astype(np.float32),
        "content": rs.randn(pair, C, 1, T).astype(np.float32),
        "style_target": rs.randn(pair, C, 1, T).astype(np.float32),
        "mask": np.ones((pair, 1, 1, T), np.float32),
        "inp_mask": inp,
        "enc_text_style": rs.randn(pair, D).astype(np.float32),
        "enc_text_t2m": rs.randn(B, D).astype(np.float32),
        "inp_mask_t2m": np.repeat(inp[:1], B, 0),
        "frame_mask_t2m": frame,
        "text_features": rs.randn(pair, D).astype(np.float32),
    }


def _payload(tmp_path):
    _, _, port = style_pair(61, latent_dim=D, clip_dim=D, dropout=0.1, cond_mask_prob=0.1)
    jmodel, params, port0 = style_pair(62, latent_dim=D, clip_dim=D, dropout=0.0,
                                       cond_mask_prob=0.0)
    rs = np.random.RandomState(3)
    B = 4
    content = rs.randn(B, C, 1, T).astype(np.float32)
    mask = np.zeros_like(content)
    mask[:, :3] = 1.0
    # the JAX trainer's step on the same weights, batch and noise
    jbatch = _ft_batch(7, B, 1)
    t = np.asarray([1, 4, 2, 3], np.int32)
    kw = dict(lr=1e-4, weight_decay=1e-2, cond_mask_prob=0.0)
    jt = JTrainer(JFinetuneConfig(save_dir=str(tmp_path / "jax"), dropout_rng_impl="threefry",
                                  **kw), jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                  jmake_schedule("cosine", 1000, "ddim20"))
    rng = jax.random.PRNGKey(7)
    new_params, _, jterms = jt._train_step(
        jt.params, jt.opt_state, rng,
        dict(jax.tree_util.tree_map(jnp.asarray, jbatch), t=jnp.asarray(t)))
    noise_t2m, noise = _jax_draws(jax.random.split(rng, 3)[0], jbatch["x_start"].shape,
                                  jbatch["content"].shape)
    return {
        "tmp": str(tmp_path / "ranks"),
        "state": port.state_dict(), "cfg": dict(port.cfg.__dict__), "ft_kw": FT_KW,
        "batch": _ft_batch(0, B, 1),
        "batches": [_ft_batch(0, B, 1), _ft_batch(1, B, B)],
        "sampler": {"content": content, "mask": mask,
                    "enc_text": rs.randn(B, D).astype(np.float32)},
        "jax_step": {"state": port0.state_dict(), "cfg": dict(port0.cfg.__dict__),
                     "kw": kw, "batch": jbatch, "t": t, "noise_t2m": noise_t2m,
                     "noise": noise},
        "jax_want": {"loss": float(jterms["loss"]),
                     "params": encoder_from_jax(jax.device_get(new_params["style_encoder"]))},
    }


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    payload = _payload(tmp)
    got = ranks.check(ranks.spawn(2, "mesh_cases", tmp, payload))
    return payload, got


@pytest.fixture(scope="module")
def world1(world2):
    """The same steps and samples on one rank, in this process."""
    payload, _ = world2
    torch.set_num_threads(1)
    out = {}
    out["ft"] = ranks.finetune_run(
        lambda: ranks.finetune_trainer(payload, payload["tmp"] + "/one", **payload["ft_kw"]),
        [ranks.tensors(b) for b in payload["batches"]])
    prng = dict(payload, cfg=dict(payload["cfg"], fused_train_prng=True))
    out["ft_prng"] = ranks.finetune_run(
        lambda: ranks.finetune_trainer(prng, payload["tmp"] + "/one_prng", **payload["ft_kw"]),
        [ranks.tensors(b) for b in payload["batches"]])
    out["ft_lora"] = ranks.finetune_run(
        lambda: ranks.finetune_trainer(payload, payload["tmp"] + "/one_lora", lora_rank=4,
                                       **payload["ft_kw"]),
        [ranks.tensors(b) for b in payload["batches"]])
    model = ranks.port_model(payload["state"], payload["cfg"])
    sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
    batch = ranks.sampler_inputs(payload)
    gen = torch.Generator().manual_seed(5)
    out["sample"] = Sampler(sched, ranks.style_builder(model), model, method="ddim",
                            skip_timesteps=14)(batch, gen)
    out["min_latency"] = Sampler(sched, ranks.style_builder(model), model, method="ddim",
                                 skip_timesteps=14, stop_timesteps=4,
                                 dump_all_xstart=True)(batch, torch.Generator().manual_seed(5))
    full = sampling.sample_loop(sched, lambda x, t, c: model(x, t, c["enc_text"]),
                                batch["cond"], torch.Generator().manual_seed(5),
                                shape=tuple(batch["init_image"].shape),
                                init_image=batch["init_image"], method="ddim",
                                skip_timesteps=14, inpainting=batch["inpainting"],
                                dump_all_xstart=True)
    out["dump5"] = full[-5]
    return out


# ---------------------------------------------------------------------------
# the policy and the rules, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args, world", [
    ((True, 1, 8), 8), ((True, 2, 8), 8), ((True, 1, 3), 8), ((False, 1, 8), 8),
    ((True, 2, 8, "training", False, 2), 8), ((True, 2, 8, "training", True), 8),
    ((True, 1, 8, "training", True, 2), 8), ((True, 3, 8), 8), ((True, 1, 8), 1)])
def test_cli_training_mesh_matches_the_jax_policy(args, world, monkeypatch, capsys):
    """The same mesh shape, message and exit as the JAX policy at the same
    device count (the port builds no mesh here: make_mesh is recorded)."""
    monkeypatch.setattr(mesh, "world_size", lambda: world)
    monkeypatch.setattr(mesh, "make_mesh", lambda n, model_parallel=1, pipeline_parallel=1,
                        device="cuda": (n // max(model_parallel, pipeline_parallel),
                                        max(model_parallel, pipeline_parallel)))

    def run(fn):
        try:
            got = fn(*args)
        except (SystemExit, ValueError) as e:
            got = (type(e).__name__, str(e).replace("visible device count", "world size")
                   .replace("Pallas", "CUDA"))
        return got, capsys.readouterr().out

    got, said = run(mesh.cli_training_mesh)
    monkeypatch.setattr(jax, "devices", lambda *a: [object()] * world)
    monkeypatch.setattr(jmesh, "make_mesh", lambda n, model_parallel=1, pipeline_parallel=1:
                        (n // max(model_parallel, pipeline_parallel),
                         max(model_parallel, pipeline_parallel)))
    want, want_said = run(jmesh.cli_training_mesh)
    assert got == want
    assert said.replace("world size", "device count") == want_said


def _flax_leaf(shape, transposed):
    return np.zeros(tuple(reversed(shape)) if transposed else shape, np.float32)


def _norm(spec) -> tuple:
    """A spec without its trailing Nones (P('model', None) is P('model'))."""
    full = list(spec)
    while full and full[-1] is None:
        full.pop()
    return tuple(full)


def _port_spec_as_flax(spec, ndim, transposed):
    full = list(spec) + [None] * (ndim - len(spec))
    return _norm(full[::-1] if transposed else full)


@pytest.mark.parametrize("dp", [1, 2, 4, 8])
def test_param_and_fsdp_specs_match_the_jax_rules(dp):
    """Every leaf of the prior and the style encoder, by its flax path and
    its port name: the same Megatron and ZeRO layout, moved to torch's
    layout (a Linear weight is the transpose of a flax kernel)."""
    from motionstyle_torch.models.denoiser import MDMConfig, StyleDiffusion

    model = StyleDiffusion(MDMConfig(njoints=12, nfeats=1, latent_dim=64, ff_size=128,
                                     num_layers=2, num_heads=4, clip_dim=32))
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    leaves = [(("mdm",) + path, "mdm." + key, tr) for path, key, tr in mdm_leaves(2)]
    leaves += [(("style_encoder",) + path, "style_encoder." + key, tr)
               for path, key, tr in encoder_leaves(2)]
    assert len(leaves) > 40
    for path, key, transposed in leaves:
        shape = shapes[key]
        assert mesh.transposed_name(key, len(shape)) == transposed, key
        jpath = tuple(jax.tree_util.DictKey(p) for p in path)
        leaf = _flax_leaf(shape, transposed)
        assert _port_spec_as_flax(mesh.param_spec(key, shape), len(shape), transposed) == \
            _norm(jmesh.param_spec(jpath, leaf)), key
        for base in (True, False):
            assert _port_spec_as_flax(mesh.fsdp_spec(key, shape, dp, use_model_base=base),
                                      len(shape), transposed) == \
                _norm(jmesh.fsdp_spec(jpath, leaf, dp, use_model_base=base)), (key, dp, base)


def test_small_and_indivisible_leaves_keep_the_base_layout():
    """tests/test_fsdp.py:57-67 on the port's rule."""
    assert mesh.fsdp_spec("norm1.weight", (64,), 8) == ()
    assert "data" in mesh.fsdp_spec("w", (64, 64), 8)
    assert mesh.fsdp_spec("w", (33, 35), 8) == ()


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

def test_all_gather_batch_has_the_global_gradient(world2):
    """Rank r's 3 rows land at rows 3r..3r+2 on both ranks; the gradient of
    the (replicated) sum reaching a rank's rows is both ranks' weights'
    sum."""
    _, got = world2
    w = torch.arange(12.0).reshape(6, 2)
    want = torch.cat([torch.arange(6.0).reshape(3, 2) + 10 * r for r in range(2)])
    for r, res in enumerate(got):
        torch.testing.assert_close(res["gathered"], want)
        torch.testing.assert_close(res["gather_grad"], 2 * w[3 * r:3 * r + 3])


def test_shard_batch_replicates_indivisible_leaves(world2):
    _, got = world2
    for r in got:
        assert r["shard_batch"] == {"x": (2, C, 1, T), "pair": (1, C, 1, T)}
        assert "does not divide" in r["indivisible"]


@pytest.mark.parametrize("layout", ["dp", "tp", "prng", "lora"])
def test_finetune_steps_match_one_rank(world2, world1, layout):
    """A run_step on the CLI's batch and one on the JAX test's, with dropout
    and condition dropout on: the global loss terms and the gradients equal
    one rank's, and both ranks hold the same updated weights. "prng": the
    training layer's in-kernel dropout (its twin here), whose per-row seeds
    a data rank takes as its rows of the global batch's, so its Philox bits
    are one rank's. "lora": rank-4 adapter factors train; their gradients
    and the merged weights are compared."""
    _, got = world2
    for step, want in enumerate(world1.get(f"ft_{layout}", world1["ft"])):
        for r in got:
            res = r[f"ft_{layout}"][step]
            for k in want["terms"]:
                assert np.isclose(res["terms"][k], want["terms"][k], rtol=1e-5), \
                    (step, k, res["terms"][k], want["terms"][k])
            for k, g in want["grads"].items():
                np.testing.assert_allclose(res["grads"][k].numpy(), g.numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=f"{step} {k}")
        for k, v in got[0][f"ft_{layout}"][step]["params"].items():
            torch.testing.assert_close(got[1][f"ft_{layout}"][step]["params"][k], v, rtol=0,
                                       atol=0)


def test_data_parallel_step_matches_the_jax_trainer(world2):
    payload, got = world2
    want = payload["jax_want"]
    for r in got:
        assert abs(r["jax_step"]["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        for k, v in want["params"].items():
            np.testing.assert_allclose(r["jax_step"]["params"][k].numpy(), v.numpy(),
                                       atol=2e-4, err_msg=k)


def test_sharded_sampler_matches_one_device(world2, world1):
    _, got = world2
    for r in got:
        np.testing.assert_allclose(r["dp_sample"].numpy(), world1["sample"].numpy(), atol=2e-5)
        np.testing.assert_allclose(r["dp_helper"].numpy(), world1["sample"].numpy(), atol=2e-5)
        np.testing.assert_allclose(r["min_latency"].numpy(), world1["min_latency"].numpy(),
                                   atol=2e-5)
        assert r["min_latency"].shape[0] == 2  # two denoiser calls: t=5, t=4
        np.testing.assert_allclose(r["min_latency"][-1].numpy(), world1["dump5"].numpy(),
                                   atol=2e-5)


def test_tensor_parallel_matches_replicated(world2, world1):
    _, got = world2
    for r in got:
        np.testing.assert_allclose(r["tp_sample"].numpy(), world1["sample"].numpy(), atol=1e-4)


def test_parallel_in_time_arms_run_sharded(world2, world1):
    """parallel_window draws the sequential chain's clips (DDIM eta=0) and
    forecast_stride runs sharded, finite (tests/test_parallel.py:322-370)."""
    _, got = world2
    for r in got:
        np.testing.assert_allclose(r["window"].numpy(), world1["sample"].numpy(), atol=1e-4)
        assert r["forecast"].shape == world1["sample"].shape
        assert torch.isfinite(r["forecast"]).all()


def test_server_protocol_matches_one_device(world2):
    """cli/serve.py on a mesh: rank 0's engine broadcasts its device batch
    (Leader), rank 1 runs the same call (follow) until the sentinel; the
    answer equals a one-device engine's."""
    from motionstyle_torch.parallel.inference import Sampler
    from motionstyle_torch.serve.engine import Request, ServingEngine

    payload, got = world2
    model = ranks.port_model(payload["state"], payload["cfg"])
    sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
    s = payload["sampler"]
    sampler = Sampler(sched, ranks.style_builder(model), model, method="ddim",
                      skip_timesteps=14, stop_timesteps=4, dump_all_xstart=True)
    engine = ServingEngine(sampler, s["content"].shape[1:], max_batch=2, buckets=(2,))
    try:
        want = engine.sample(Request({"enc_text": s["enc_text"][0]}, init_image=s["content"][0],
                                     inpainting_mask=s["mask"][0], seed=4))
    finally:
        engine.close()
    assert got[1]["followed"] == 1
    np.testing.assert_allclose(got[0]["served"], want, atol=1e-4)


def test_collectives_the_layouts_issue(world2):
    """The JAX package reads its layouts' collectives off the compiled HLO
    (tests/test_parallel.py:309-320); the port counts the calls it makes:
    data-parallel sampling all-reduces nothing and gathers its result once,
    tensor-parallel sampling all-reduces twice per layer call (2 layers, 2
    chain steps of 6 here: out_proj and linear2)."""
    _, got = world2
    for r in got:
        assert r["dp_counts"]["all_reduce"] == 0 and r["dp_counts"]["all_gather"] == 1
        # DDIM-20 skip 14: 6 steps, 2 layers, 2 all-reduces a layer
        assert r["tp_collectives"] == 6 * 2 * 2
