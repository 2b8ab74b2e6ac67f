"""Sharded checkpoints on torch.distributed.checkpoint (DCP).

Counterpart of motionstyle/train/checkpoints.py, whose orbax checkpoints
become DCP's. Two formats sit side by side, as in the JAX package:
  - the reference torch layout (model{step:09d}.pt, opt{step:09d}.pt beside
    it) that both packages read and write;
  - this module: the trainer's whole state (its trainable parameters, Adam's
    moments and the step) as one DCP checkpoint, dcp_{step:09d}/, in which
    each rank writes the shards it holds (an FSDP DTensor's local shard; a
    replicated tensor once). A checkpoint saved at one world size or layout
    restores at another: restore_sharded reads each tensor into the layout
    of the `like` tree it is given (DTensors of another mesh, or whole
    tensors).

The format is DCP's, so a sharded checkpoint does not cross packages (orbax
needs tensorstore and the JAX package, DCP needs torch): the JAX package's
orbax_{step:09d}/ and the port's dcp_{step:09d}/ are each read by their own
package only. The model*.pt and opt*.pt files cross both ways.

Without a process group the calls run in one process (DCP's no_dist mode).
"""
from __future__ import annotations

import contextlib
import os
import warnings
from typing import Any, Optional

import torch
import torch.distributed as dist

PREFIX = "dcp_"


def _no_dist() -> bool:
    return not dist.is_initialized()


@contextlib.contextmanager
def _quiet():
    """DCP warns that it runs in one process whenever no group exists: that
    is this module's one-rank case, not news."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*single process.*")
        yield


def save_sharded(ckpt_dir: str, step: int, params: dict, opt_state: Any = None) -> str:
    """Write params (a {name: tensor} dict, tensors or DTensors) and, when
    given, the optimizer state (a nested dict of tensors) as one DCP
    checkpoint at ckpt_dir/dcp_{step:09d}. Every rank of the group calls it
    and writes its own shards."""
    import torch.distributed.checkpoint as dcp

    path = os.path.join(os.path.abspath(ckpt_dir), f"{PREFIX}{step:09d}")
    state = {"params": params, "step": torch.tensor(step, dtype=torch.int64)}
    if opt_state is not None:
        state["opt_state"] = opt_state
    with _quiet():
        dcp.save(state, checkpoint_id=path, no_dist=_no_dist())
    return path


def latest_sharded(ckpt_dir: str) -> Optional[str]:
    """The newest dcp_NNNNNNNNN directory in ckpt_dir, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(f[len(PREFIX):]) for f in os.listdir(ckpt_dir)
             if f.startswith(PREFIX) and f[len(PREFIX):].isdigit()]
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"{PREFIX}{max(steps):09d}")


def restore_sharded(path: str, like: Any = None) -> dict:
    """Restore a checkpoint written by save_sharded.

    like: a tree of the checkpoint's structure ({'params': ..., 'step': ...,
    optionally 'opt_state': ...}) whose tensors give the TARGET layout:
    DTensors of any mesh or whole tensors, each read in place into its own
    layout, whatever layout saved it; it is returned filled. With like=None
    every tensor is read whole (every rank reads the whole state)."""
    import torch.distributed.checkpoint as dcp

    if like is None:
        from torch.distributed.checkpoint.state_dict_loader import _load_state_dict_from_keys

        with _quiet():
            return _load_state_dict_from_keys(checkpoint_id=path)
    with _quiet():
        dcp.load(like, checkpoint_id=path, no_dist=_no_dist())
    return like
