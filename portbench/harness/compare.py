"""Comparisons of the program's outputs with the plain reference's."""
from __future__ import annotations

import numpy as np
import torch


class ReferenceMode:
    """The reference's arithmetic: fp32 matrix products with TF32 off, no
    autograd (the training reference asks for its own); the program's
    settings come back after."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self._grad = torch.no_grad()
        self._grad.__enter__()
        return self

    def __exit__(self, *exc):
        self._grad.__exit__(*exc)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._saved
        return False


def rel_l2(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| / |want| of each clip (axis 0)."""
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    return np.linalg.norm(got - want, axis=1) / np.maximum(np.linalg.norm(want, axis=1), 1e-30)


def worst_rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    """The largest over clips of |got - want| / |want|."""
    return float(np.max(rel_l2(got, want)))


def leaf_norms(leaves: dict) -> dict:
    """{leaf: float norm}, the packed attention projections (in_proj_weight,
    in_proj_bias) taken as their q, k and v parts, each a leaf of its own
    as in layouts that keep them apart."""
    out = {}
    for name, t in leaves.items():
        if name.endswith(("in_proj_weight", "in_proj_bias")):
            for part, chunk in zip("qkv", t.chunk(3, dim=0)):
                out[f"{name}.{part}"] = float(chunk.norm())
        else:
            out[name] = float(t.norm())
    return out


def worst_leaf_gap(got: dict, want: dict, skip=()) -> float:
    """The largest over leaves of |norm_got - norm_want| / max(norm_want,
    the median leaf's norm_want): a gap of norms, not the norm of a gap."""
    keys = [k for k in want if k not in skip]
    med = float(np.median([want[k] for k in keys]))
    return float(max(abs(got[k] - want[k]) / max(want[k], med) for k in keys))
