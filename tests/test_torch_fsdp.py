"""FSDP (ZeRO) training of the port (parallel/mesh.py::shard_params with
fsdp, FSDP2's fully_shard over 'data') against one rank and the JAX
package, mirroring tests/test_fsdp.py on 2 and 4 gloo ranks on the CPU
(tests/torch_dist_ranks.py::fsdp_cases, one spawn per world size).

  - 3 pretrain steps under FSDP at worlds 2 and 4 track one rank's losses
    (rtol 1e-5, tests/test_fsdp.py:126) with dropout on; a fresh step's
    gradients match per leaf (rtol 1e-4, atol 1e-6, :167);
  - one step against the JAX trainer's single-device step (dropout off, t,
    noise and the condition pinned): loss rel 1e-5, weights atol 2e-4;
  - the per-rank parameters and Adam moments shrink with the world, and
    linear1's shard lies on the dim fsdp_spec picks;
  - the training kernels' twins under FSDP track them under data
    parallelism (rtol 1e-3, :281); the finetune trainer under FSDP tracks
    one rank (rtol 1e-4, :243);
  - FSDP units below the encoder stack hand the training path sharded
    weights, which it refuses (the kernels take plain tensors);
  - the collectives: an FSDP step all-gathers parameters where a
    data-parallel step only all-reduces gradients (the counterpart of the
    HLO check, :181).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dist_ranks as ranks
from tests.test_torch_mesh import D as FT_D
from tests.test_torch_mesh import _ft_batch
from tests.test_torch_models import one_torch_thread, style_pair  # noqa: F401
from tests.test_torch_pretrain import _jax_pinned, _jtrainer, _mdm_state

C, T, CLIP = 12, 8, 32


def _prior_batch(seed: int, B: int = 8) -> dict:
    rs = np.random.RandomState(seed)
    mask = np.ones((B, 1, 1, T), np.float32)
    mask[1, ..., 6:] = 0.0
    return {"x_start": (rs.randn(B, C, 1, T) * 0.5).astype(np.float32),
            "enc_text": rs.randn(B, CLIP).astype(np.float32), "mask": mask}


@pytest.fixture(scope="module")
def payload(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    _, _, port = style_pair(71, dropout=0.1)
    jmodel, params, port0 = style_pair(72, dropout=0.0)
    _, _, ft = style_pair(73, latent_dim=FT_D, clip_dim=FT_D, dropout=0.1, cond_mask_prob=0.1)
    batch = _prior_batch(12)
    t = np.asarray([3, 17, 40, 0, 5, 9, 33, 21], np.int32)
    tw = np.linspace(0.5, 2.0, 8).astype(np.float32)
    kw = dict(lr=1e-4, weight_decay=1e-2, cond_mask_prob=0.5)
    jt = _jtrainer(jmodel, params, tmp, **kw)
    rng = jax.random.PRNGKey(7)
    noise, enc = _jax_pinned(jt, rng, batch)
    jbatch = dict(jax.tree_util.tree_map(jnp.asarray, batch), t=jnp.asarray(t),
                  t_weights=jnp.asarray(tw))
    new_params, _, _, jloss, _ = jt._train_step(jt.params, jt.opt_state, jt.ema, rng, jbatch)
    return {
        "tmp": str(tmp / "ranks"), "state": port.state_dict(), "cfg": dict(port.cfg.__dict__),
        "prior_batches": [_prior_batch(i) for i in range(3)],
        "finetune": {"state": ft.state_dict(), "cfg": dict(ft.cfg.__dict__),
                     "kw": dict(lr=1e-3), "batches": [_ft_batch(i, 4, 1) for i in range(2)]},
        "jax_step": {"state": port0.state_dict(), "cfg": dict(port0.cfg.__dict__),
                     "kw": dict(lr=1e-4, weight_decay=1e-2), "batch": batch, "t": t, "tw": tw,
                     "noise": noise.numpy(), "enc": enc.numpy()},
        "jax_want": {"loss": float(jloss), "params": _mdm_state(new_params["mdm"])},
    }


@pytest.fixture(scope="module")
def runs(payload):
    """{world: each rank's results}, world 1 run here."""
    torch.set_num_threads(1)
    got = {w: ranks.check(ranks.spawn(w, "fsdp_cases", payload["tmp"] + f"/w{w}", payload))
           for w in (2, 4)}
    one = {}
    batches = [ranks.tensors(b) for b in payload["prior_batches"]]
    tr = ranks.prior_trainer(payload, payload["tmp"] + "/one")
    one["prior"] = ranks.prior_run(tr, batches[:1])
    one["prior"]["losses"] += ranks.prior_run(tr, batches[1:])["losses"]
    ft = payload["finetune"]
    tr = ranks.finetune_trainer(ft, payload["tmp"] + "/one_ft", **ft["kw"])
    one["finetune"] = [tr.run_step(dict(b)) for b in [ranks.tensors(b) for b in ft["batches"]]]
    return got, one


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_steps_track_one_rank(runs, world):
    got, one = runs
    for r in got[world]:
        np.testing.assert_allclose(r["prior_fsdp"]["losses"], one["prior"]["losses"], rtol=1e-5)


def test_fsdp_composes_with_tensor_parallel(runs):
    """(2 data x 2 model) at world 4: FSDP shards the Megatron split's local
    weights over 'data' (tests/test_fsdp.py:108-126, model_parallel 2)."""
    got, one = runs
    for r in got[4]:
        np.testing.assert_allclose(r["prior_fsdp_tp"]["losses"], one["prior"]["losses"],
                                   rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_gradients_match_per_leaf(runs, world):
    """After one step from the same weights (the first of the three runs)."""
    got, one = runs
    want = one["prior"]["grads"]
    for r in got[world]:
        g = r["prior_fsdp"]["grads"]
        assert g.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(g[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_step_matches_the_jax_trainer(payload, runs, world):
    got, _ = runs
    want = payload["jax_want"]
    for r in got[world]:
        assert abs(r["jax_step"]["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        for k, v in want["params"].items():
            np.testing.assert_allclose(r["jax_step"]["params"][k].numpy(), v.numpy(),
                                       atol=2e-4, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_per_rank_state_shrinks(runs, world):
    """Each rank holds about 1/world of the prior and of both moments (the
    leaves fsdp_spec keeps whole are sharded on dim 0 by FSDP2, padded)."""
    got, _ = runs
    for r in got[world]:
        loc = r["local"]
        assert loc["params"] <= loc["full"] / world * 1.1, loc
        assert loc["moments"] <= 2 * loc["full"] / world * 1.1, loc
        assert r["linear1_placement"]


def test_fused_twins_under_fsdp_track_data_parallel(runs):
    got, _ = runs
    for r in got[2]:
        np.testing.assert_allclose(r["fused"]["fused_fsdp"], r["fused"]["fused_dp"], rtol=1e-3)


def test_finetune_trainer_fsdp_matches_one_rank(runs):
    got, one = runs
    for r in got[2]:
        for t_got, t_want in zip(r["finetune"], one["finetune"]):
            assert np.isclose(t_got["loss"], t_want["loss"], rtol=1e-4), (t_got, t_want)


def test_kernel_path_refuses_sharded_weights(runs):
    got, _ = runs
    for r in got[2]:
        assert "DTensor reached a fused kernel" in r["guard"]
        assert "DTensor reached a fused kernel" in r["guard_inference"]


def test_fsdp_step_gathers_parameters(runs):
    got, _ = runs
    for r in got[2]:
        fs, dp = r["fsdp_counts"], r["dp_counts"]
        assert fs["all_gather_into_tensor"] + fs["all_gather"] > 0, fs
        assert dp["all_gather_into_tensor"] == 0 and dp["all_reduce"] >= 1, dp
