"""Pipeline parallelism of the port (parallel/pipeline.py, GPipe by
point-to-point send and receive) against the JAX package's sequential
encoder stack, mirroring tests/test_pipeline.py on 2 and 4 gloo ranks on
the CPU (tests/torch_dist_ranks.py::pipeline_cases, one spawn per world).

  - the stage stacking round trip;
  - the forward at 2 stages with 1 and 2 microbatches, with and without a
    key mask, and with data parallelism at 2 x 2, against the JAX
    sequential stack: rtol 1e-5, atol 1e-5 (tests/test_pipeline.py:68);
  - the gradients of the stages' layers and of the input, by the
    hand-scheduled drain, against jax.grad of the sequential stack: rtol
    2e-4, atol 1e-5 (:198-232);
  - the pipelined sampler against one device (atol 2e-5);
  - a pretrain step over 2 stages equals a plain step (dropout off), and
    its mdm*.pt and opt*.pt resume a plain run (pretrain.py:407-460).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.models.transformer import TransformerEncoder as JEncoder
from motionstyle_torch.diffusion.schedule import make_schedule
from motionstyle_torch.models.params import encoder_from_jax
from motionstyle_torch.parallel import pipeline
from motionstyle_torch.parallel.inference import Sampler
from tests import torch_dist_ranks as ranks
from tests.test_torch_fsdp import _prior_batch
from tests.test_torch_mesh import C, T
from tests.test_torch_mesh import D as SD
from tests.test_torch_models import one_torch_thread, style_pair  # noqa: F401

L, D, H, F = 4, 32, 4, 64


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    jenc = JEncoder(num_layers=L, d_model=D, nhead=H, dim_feedforward=F)
    params = jax.device_get(jenc.init(jax.random.PRNGKey(0), jnp.zeros((2, 6, D)))["params"])
    rs = np.random.RandomState(0)
    x = rs.randn(8, 6, D).astype(np.float32)
    mask = rs.rand(8, 6) > 0.2
    mask[:, 0] = True
    w = rs.randn(4, 6, D).astype(np.float32)
    _, _, model = style_pair(81, latent_dim=SD, clip_dim=SD)
    _, _, prior = style_pair(82, dropout=0.0)
    content = rs.randn(4, C, 1, T).astype(np.float32)
    smask = np.zeros_like(content)
    smask[:, :3] = 1.0
    payload = {
        "tmp": str(tmp), "dims": (L, D, H, F), "encoder": encoder_from_jax(params),
        "x": x, "mask": mask, "w": w,
        "state": model.state_dict(), "cfg": dict(model.cfg.__dict__),
        "sampler": {"content": content, "mask": smask,
                    "enc_text": rs.randn(4, SD).astype(np.float32)},
        "prior": {"state": prior.state_dict(), "cfg": dict(prior.cfg.__dict__),
                  "batch": _prior_batch(5, 4)},
    }
    got = {wd: ranks.check(ranks.spawn(wd, "pipeline_cases", tmp / f"w{wd}", payload))
           for wd in (2, 4)}
    return jenc, params, payload, got


def _ref(jenc, params, x, mask):
    return np.asarray(jenc.apply({"params": params}, jnp.asarray(x),
                                 key_padding_mask=None if mask is None else jnp.asarray(mask)))


def test_stack_round_trip(setup):
    _, _, payload, _ = setup
    state = payload["encoder"]
    stacked = pipeline.stack_stage_params(state, L, 2)
    assert stacked["linear1.weight"].shape[:2] == (2, 2)
    back = pipeline.unstack_stage_params(stacked, L)
    assert back.keys() == state.keys()
    for k, v in state.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    torch.testing.assert_close(stacked["norm1.weight"][1, 0], state["layers.2.norm1.weight"])


@pytest.mark.parametrize("case", ["fwd_micro1", "fwd_micro2", "fwd_nomask"])
@pytest.mark.parametrize("world", [2, 4])
def test_forward_matches_the_sequential_stack(setup, case, world):
    """Every stage returns the whole (data-shard) output; at world 4 the
    two data shards run their own pipelines."""
    jenc, params, payload, got = setup
    want = _ref(jenc, params, payload["x"], None if case == "fwd_nomask" else payload["mask"])
    for r in got[world]:
        a, b = r["rows"]
        np.testing.assert_allclose(r[case].numpy(), want[a:b], rtol=1e-5, atol=1e-5)


def test_gradients_match_the_sequential_stack(setup):
    jenc, params, payload, got = setup

    def loss(p, x):
        y = jenc.apply({"params": p}, x, key_padding_mask=jnp.asarray(payload["mask"][:4]))
        return jnp.sum(y * payload["w"])

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(payload["x"][:4]))
    want = encoder_from_jax(jax.device_get(gp))
    seen = set()
    for r in got[2]:
        for k, g in r["grads"].items():
            layer = int(k.split(".")[1])
            assert layer in pipeline.stage_layers(L, 2, r["stage"]), k
            np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=2e-4, atol=1e-5,
                                       err_msg=k)
            seen.add(k)
        if r["stage"] == 0:
            np.testing.assert_allclose(r["x_grad"].numpy(), np.asarray(gx), rtol=2e-4, atol=1e-5)
    assert seen == set(want)


def test_pipelined_sampler_matches_one_device(setup):
    _, _, payload, got = setup
    model = ranks.port_model(payload["state"], payload["cfg"])
    sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
    want = Sampler(sched, ranks.style_builder(model), model, method="ddim", skip_timesteps=14)(
        ranks.sampler_inputs(payload), torch.Generator().manual_seed(5))
    for r in got[2]:
        np.testing.assert_allclose(r["sample"].numpy(), want.numpy(), atol=2e-5)


def test_pipelined_pretrain_step_resumes_a_plain_run(setup, tmp_path):
    """The same loss and updated prior as a plain step (dropout off), and a
    plain trainer resumes from the pipelined run's mdm*.pt and opt*.pt."""
    _, _, payload, got = setup
    torch.set_num_threads(1)
    prior = payload["prior"]
    batch = ranks.tensors(prior["batch"])
    plain = ranks.prior_trainer(prior, str(tmp_path / "plain"), lr=1e-4)
    loss = float(plain.run_step(dict(batch)))
    for r in got[2]:
        assert np.isclose(r["prior_loss"], loss, rtol=1e-5), (r["prior_loss"], loss)
    saved = got[2][0]["prior_saved"]
    resumed = ranks.prior_trainer(prior, str(tmp_path / "resumed"), lr=1e-4,
                                  resume_checkpoint=saved)
    assert resumed.resume_step == 1
    want = plain.model.mdm.state_dict()
    for k, v in resumed.model.mdm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=2e-4, err_msg=k)
    leaves, want_leaves = resumed.optimizer_leaves(), plain.optimizer_leaves()
    assert len(leaves) == len(want_leaves) and int(leaves[0]) == 1
    for a, b in zip(leaves[1:], want_leaves[1:]):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert np.isfinite(float(resumed.run_step(dict(batch))))
