"""Sequence parallelism of the port (parallel/sequence.py: the frame axis
over 'seq', k, v and the key mask all-gathered with a gradient) against the
JAX package's sequential encoder stack, mirroring
tests/test_sequence_parallel.py on 2 and 4 gloo ranks on the CPU
(tests/torch_dist_ranks.py::sequence_cases, one spawn per world).

  - the forward with S = 9 frames over 2 ranks (padded to 10, the pad
    masked and stripped), with and without a key mask, and with data
    parallelism at 2 x 2: rtol 1e-5, atol 1e-6
    (tests/test_sequence_parallel.py:45);
  - the gradients of every weight (summed over 'seq') and of the input
    against the port's own sequential stack at the JAX test's bound for
    sharded against unsharded, rtol 2e-4, atol 1e-6 (:134), and against
    jax.grad of the JAX stack at the bound of the port's other gradient
    comparisons across the two frameworks, max-rel 1e-3 per leaf
    (tests/test_torch_finetune.py). The loss is mean(out * w) for a random
    w: the JAX test's sum(out**2) is constant after a last LayerNorm of unit
    scale and zero shift, so its gradient is rounding, which only one
    framework can match; a mean, as the trainers' losses are, keeps the
    gradients at the scale atol 1e-6 was set for;
  - the sequence-parallel sampler against one device (atol 2e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.models.transformer import TransformerEncoder as JEncoder
from motionstyle_torch.diffusion.schedule import make_schedule
from motionstyle_torch.models.params import encoder_from_jax
from motionstyle_torch.parallel.inference import Sampler
from tests import torch_dist_ranks as ranks
from tests.test_torch_finetune import _max_rel
from tests.test_torch_mesh import C, T
from tests.test_torch_mesh import D as SD
from tests.test_torch_models import one_torch_thread, style_pair  # noqa: F401

L, D, H, F, S = 2, 32, 4, 64, 9


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq")
    jenc = JEncoder(num_layers=L, d_model=D, nhead=H, dim_feedforward=F)
    params = jax.device_get(jenc.init(jax.random.PRNGKey(0), jnp.zeros((2, S, D)))["params"])
    rs = np.random.RandomState(1)
    x = rs.randn(4, S, D).astype(np.float32)
    mask = rs.rand(4, S) > 0.25
    mask[:, 0] = True
    _, _, model = style_pair(91, latent_dim=SD, clip_dim=SD)
    content = rs.randn(4, C, 1, T).astype(np.float32)
    smask = np.zeros_like(content)
    smask[:, :3] = 1.0
    payload = {
        "dims": (L, D, H, F), "encoder": encoder_from_jax(params), "x": x, "mask": mask,
        "w": rs.randn(4, S, D).astype(np.float32),
        "state": model.state_dict(), "cfg": dict(model.cfg.__dict__),
        "sampler": {"content": content, "mask": smask,
                    "enc_text": rs.randn(4, SD).astype(np.float32)},
    }
    got = {w: ranks.check(ranks.spawn(w, "sequence_cases", tmp / f"w{w}", payload))
           for w in (2, 4)}
    return jenc, params, payload, got


@pytest.mark.parametrize("case", ["fwd_mask", "fwd_nomask"])
@pytest.mark.parametrize("world", [2, 4])
def test_forward_matches_the_sequential_stack(setup, case, world):
    jenc, params, payload, got = setup
    mask = None if case == "fwd_nomask" else jnp.asarray(payload["mask"])
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(payload["x"]),
                                 key_padding_mask=mask))
    for r in got[world]:
        a, b = r["rows"]
        assert r[case].shape == (b - a, S, D)
        np.testing.assert_allclose(r[case].numpy(), want[a:b], rtol=1e-5, atol=1e-6)


def test_gradients_match_the_sequential_stack(setup):
    jenc, params, payload, got = setup

    def loss(p, x):
        y = jenc.apply({"params": p}, x, key_padding_mask=jnp.asarray(payload["mask"]))
        return jnp.mean(y * payload["w"])

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(payload["x"]))
    jwant = encoder_from_jax(jax.device_get(gp))
    torch.set_num_threads(1)
    enc = ranks.port_encoder(payload)
    x = torch.from_numpy(payload["x"]).requires_grad_(True)
    (enc(x, torch.from_numpy(payload["mask"])) * torch.from_numpy(payload["w"])).mean().backward()
    want = {n: p.grad for n, p in enc.named_parameters()}
    shard = [slice(0, 5), slice(5, S)]  # the frames each rank holds (S padded to 10)
    for rank, r in enumerate(got[2]):
        assert r["grads"].keys() == want.keys() == jwant.keys()
        for k in want:
            g = r["grads"][k].numpy()
            np.testing.assert_allclose(g, want[k].numpy(), rtol=2e-4, atol=1e-6, err_msg=k)
            assert _max_rel(g, jwant[k].numpy()) < 1e-3, (k, _max_rel(g, jwant[k].numpy()))
        # each rank's input gradient covers its own frames
        got_x = r["x_grad"].numpy()[:, shard[rank]]
        np.testing.assert_allclose(got_x, x.grad.numpy()[:, shard[rank]], rtol=2e-4, atol=1e-6)
        assert _max_rel(got_x, np.asarray(gx)[:, shard[rank]]) < 1e-3


def test_sequence_parallel_sampler_matches_one_device(setup):
    _, _, payload, got = setup
    model = ranks.port_model(payload["state"], payload["cfg"])
    sched = make_schedule("cosine", 1000, "ddim20", device="cpu")
    want = Sampler(sched, ranks.style_builder(model), model, method="ddim", skip_timesteps=14)(
        ranks.sampler_inputs(payload), torch.Generator().manual_seed(5))
    for r in got[2]:
        np.testing.assert_allclose(r["sample"].numpy(), want.numpy(), atol=2e-5)
