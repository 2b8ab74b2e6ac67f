"""Sharded checkpoints of the port (train/checkpoints.py on
torch.distributed.checkpoint), mirroring tests/test_checkpoints.py: the
FSDP state saved at world 2 over gloo on the CPU
(tests/torch_dist_ranks.py::checkpoint_cases) restores at world 1, into a
data-parallel and an FSDP trainer at world 2, and read whole; the trainer
writes dcp_{step:09d}/ beside model*.pt and opt*.pt; the preemption
checkpoint at a step boundary; latest_sharded's discovery, with the
optimizer state. Restores are bit-equal.

A DCP checkpoint is the port's alone (the JAX package's are orbax's); the
model*.pt and opt*.pt beside it cross both ways (tests/test_torch_finetune.py).
"""
import os
import signal

import numpy as np
import pytest
import torch

from motionstyle_torch.train.checkpoints import latest_sharded, restore_sharded, save_sharded
from tests import torch_dist_ranks as ranks
from tests.test_torch_mesh import D, _ft_batch
from tests.test_torch_models import one_torch_thread, style_pair  # noqa: F401


def _finetune_payload(seed: int) -> dict:
    _, _, port = style_pair(seed, latent_dim=D, clip_dim=D, dropout=0.1, cond_mask_prob=0.1)
    return {"state": port.state_dict(), "cfg": dict(port.cfg.__dict__), "kw": dict(lr=1e-3),
            "batches": [_ft_batch(i, 4, 1) for i in range(2)]}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    payload = {"tmp": str(tmp), "finetune": _finetune_payload(101)}
    return payload, ranks.check(ranks.spawn(2, "checkpoint_cases", tmp / "ranks", payload))


def _assert_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def _assert_leaves_equal(got: list, want: list):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fsdp_checkpoint_restores_at_world_one(world2, tmp_path):
    """Saved as FSDP shards by 2 ranks; read whole, and into a one-rank
    trainer: its parameters and Adam moments are the saving run's, bit for
    bit, and it continues from the saved step."""
    payload, got = world2
    path = os.path.join(payload["tmp"], "fsdp", "dcp_000000001")
    whole = restore_sharded(path)
    assert int(whole["step"]) == 1
    _assert_equal({k: v for k, v in whole["params"].items()}, got[0]["params"])
    torch.set_num_threads(1)
    tr = ranks.finetune_trainer(payload["finetune"], str(tmp_path), **payload["finetune"]["kw"])
    assert tr.load_sharded(path) == 1 and tr.resume_step == 1
    _assert_equal(ranks.state_of(tr.model.style_encoder), got[0]["params"])
    _assert_leaves_equal(tr.optimizer_leaves(), got[0]["opt_leaves"])
    assert np.isfinite(tr.run_step(ranks.tensors(payload["finetune"]["batches"][1]))["loss"])


@pytest.mark.parametrize("fsdp", [0, 1])
def test_fsdp_checkpoint_restores_into_another_layout(world2, fsdp):
    _, got = world2
    for r in got:
        res = r[f"restored{fsdp}"]
        assert res["step"] == 1
        _assert_equal(res["params"], got[0]["params"])
        _assert_leaves_equal(res["opt_leaves"], got[0]["opt_leaves"])


def test_trainer_writes_dcp_beside_the_torch_files(world2):
    """Every rank wrote its shards into dcp_000000001/; rank 0 alone wrote
    model*.pt, opt*.pt."""
    payload, got = world2
    files = got[0]["files"]
    assert {"dcp_000000001", "model000000001.pt", "opt000000001.pt"} <= set(files)
    shards = os.listdir(os.path.join(payload["tmp"], "fsdp", "dcp_000000001"))
    assert sum(f.endswith(".distcp") for f in shards) == 2
    sd = torch.load(os.path.join(payload["tmp"], "fsdp", "model000000001.pt"))
    for k, v in got[0]["params"].items():
        torch.testing.assert_close(sd[f"seqTransEncoder.{k}"], v, rtol=0, atol=0)


def test_preemption_checkpoint_at_step_boundary(tmp_path):
    """SIGTERM during training: the step in flight finishes, model, opt and
    dcp files are written at its boundary, and preempted is set."""
    torch.set_num_threads(1)
    ft = _finetune_payload(102)
    tr = ranks.finetune_trainer(ft, str(tmp_path), save_interval=10 ** 9,
                                orbax_checkpoints=True, **ft["kw"])
    old_term, old_int = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    try:
        tr.install_preemption_handler()
        tr.run_step(ranks.tensors(ft["batches"][0]))
        assert not any(f.startswith("model000000002") for f in os.listdir(tmp_path))
        os.kill(os.getpid(), signal.SIGTERM)
        tr.run_step(ranks.tensors(ft["batches"][1]))
        assert tr.preempted
        assert {"model000000002.pt", "opt000000002.pt", "dcp_000000002"} <= \
            set(os.listdir(tmp_path))
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)


def test_latest_discovery_and_opt_state(tmp_path):
    """save_sharded twice, latest_sharded finds the newer; the optimizer
    state reads back bit-equal (tests/test_checkpoints.py:138-154)."""
    torch.manual_seed(0)
    params = {"layers.0.linear1.weight": torch.randn(8, 4), "layers.0.linear1.bias": torch.randn(8)}
    opt = torch.optim.AdamW(params.values(), lr=1e-3)
    for p in params.values():
        p.grad = torch.randn_like(p)
    opt.step()
    state = {n: {k: opt.state[p][k] for k in ("step", "exp_avg", "exp_avg_sq")}
             for n, p in params.items()}
    save_sharded(str(tmp_path), 1, params, state)
    p2 = save_sharded(str(tmp_path), 12, params, state)
    assert latest_sharded(str(tmp_path)) == p2
    assert latest_sharded(str(tmp_path / "none")) is None
    restored = restore_sharded(p2)
    assert int(restored["step"]) == 12
    _assert_equal(restored["params"], params)
    for n in params:
        _assert_equal(restored["opt_state"][n], state[n])
