"""PyTorch port vs the JAX package: the standalone attention (kernel 4's
plain version, its dispatch and its autograd Function), on the CPU.

The JAX Pallas kernel runs in interpret mode: pallas_call is monkeypatched
with interpret=True for the test (the JAX package is untouched). Inputs are
numpy draws fed to both packages; bf16 cases round the same values to bf16
on both sides. Outputs are fp32 of magnitude ~1 from fp32 sums over at most
600 keys, so the two packages differ by summation order: atol 1e-5.
Every row keeps its first key valid: a row with all keys masked is left
out, since the Pallas kernel's padded keys then enter its softmax and the
XLA path's do not (no caller produces such a row).
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from motionstyle.ops import attention as jattn
from motionstyle_torch.ops import attention
from motionstyle_torch.ops.fused_encoder import additive_key_mask
from motionstyle_torch.models.transformer import MultiheadSelfAttention
from tests.test_torch_models import one_torch_thread  # noqa: F401

ATOL = 1e-5
B, D, H = 2, 128, 4  # head width 32, the CLIs' --latent_dim 128 arm


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(S: int, masked: bool, seed: int = 0, d: int = D):
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(B, S, d).astype(np.float32) for _ in range(3))
    kpm = np.ones((B, S), bool)
    if masked:
        kpm[1, S // 3:] = False  # row 1 keeps its first S // 3 keys
        kpm[0, 1::5] = False
    return q, k, v, kpm


def _jax(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [77, 197, 600])
def test_reference_matches_pallas_and_xla(interpret_pallas, S, dtype, masked):
    q, k, v, kpm = _inputs(S, masked)
    mask_add = np.where(kpm, 0.0, -1e9).astype(np.float32)
    jq, jk, jv = (_jax(a, dtype) for a in (q, k, v))
    jmask = jnp.asarray(mask_add)[:, None, None, :] if masked else None
    want_pallas = np.asarray(jattn._pallas_attention(jq, jk, jv, H, jmask))
    want_xla = np.asarray(jattn._xla_attention(jq, jk, jv, H, jmask))
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    got = attention.attention_reference(tq, tk, tv, H,
                                        torch.from_numpy(mask_add) if masked else None)
    assert got.dtype == torch.float32 and got.shape == (B, S, D)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_xla, atol=ATOL)
    # the dispatching entry point runs the plain version on CPU tensors
    via = attention.multihead_attention(tq, tk, tv, H, torch.from_numpy(kpm) if masked else None)
    torch.testing.assert_close(via, got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_width_128_matches_pallas(interpret_pallas, dtype):
    """d 512 with 4 heads, the denoiser's own width, on a short sequence."""
    q, k, v, kpm = _inputs(40, True, seed=3, d=512)
    mask_add = np.where(kpm, 0.0, -1e9).astype(np.float32)
    want = np.asarray(jattn._pallas_attention(*(_jax(a, dtype) for a in (q, k, v)), 4,
                                              jnp.asarray(mask_add)[:, None, None, :]))
    got = attention.attention_reference(*(_torch(a, dtype) for a in (q, k, v)), 4,
                                        torch.from_numpy(mask_add))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("S", [77, 600])
def test_gradients_match_jax(S):
    """dq, dk, dv of sum(out * w) against jax.grad through the JAX
    multihead_attention (its custom_vjp recompute), atol 1e-5."""
    q, k, v, kpm = _inputs(S, True, seed=1)
    w = np.random.RandomState(2).randn(B, S, D).astype(np.float32)

    def jloss(q, k, v):
        return (jattn.multihead_attention(q, k, v, H, key_padding_mask=jnp.asarray(kpm))
                * jnp.asarray(w)).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = attention.multihead_attention(*leaves, H, torch.from_numpy(kpm))
    (out * torch.from_numpy(w)).sum().backward()
    for leaf, ref in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), atol=ATOL)


def test_kernel_function_backward_is_the_plain_recompute(monkeypatch):
    """KernelAttention's backward recomputes the plain version under
    autograd, so its gradients are bit-equal to the plain path's. The
    kernel's forward needs the card; here the plain version stands in for
    it, to check the Function's wiring (q, k, v as views of one packed qkv,
    as the denoiser passes them)."""
    monkeypatch.setattr(attention, "attention_kernel", attention.attention_reference)
    q, k, v, kpm = _inputs(50, True, seed=4)
    packed = np.concatenate([q, k, v], axis=-1)
    w = torch.from_numpy(np.random.RandomState(5).randn(B, 50, D).astype(np.float32))
    mask_add = additive_key_mask(torch.from_numpy(kpm), B, 50, "cpu")
    grads = []
    for fn in (lambda *a: attention.KernelAttention.apply(*a, H, mask_add),
               lambda *a: attention.attention_reference(*a, H, mask_add)):
        qkv = torch.from_numpy(packed).requires_grad_(True)
        (fn(*qkv.split(D, -1)) * w).sum().backward()
        grads.append(qkv.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


def _fake(S: int, device: str, Sk: int = None):
    return (SimpleNamespace(shape=(B, S, D), device=torch.device(device)),
            SimpleNamespace(shape=(B, Sk or S, D), device=torch.device(device)))


@pytest.mark.parametrize("device, S, Sk, env, use_pallas, want", [
    ("cuda", 600, None, None, None, True),     # S > 512 on the card
    ("cuda", 512, None, None, None, False),    # S = 512 is not > 512
    ("cuda", 77, None, "1", None, True),       # the environment variable
    ("cuda", 77, None, "0", None, False),      # only "1" asks
    ("cpu", 600, None, "1", None, False),      # the device
    ("cuda", 600, 77, "1", None, False),       # cross-attention never
    ("cuda", 600, 77, None, True, False),      # not even when asked
    ("cuda", 77, None, None, False, False),    # asked not to
    ("cpu", 77, None, None, True, True),       # asked to (then refused on CPU)
])
def test_dispatch_predicate(monkeypatch, device, S, Sk, env, use_pallas, want):
    """The JAX dispatch (motionstyle/ops/attention.py:164-172) with the card
    in the TPU's place; the variable is read at call time."""
    if env is None:
        monkeypatch.delenv("MOTIONSTYLE_PALLAS_ATTN", raising=False)
    else:
        monkeypatch.setenv("MOTIONSTYLE_PALLAS_ATTN", env)
    q, k = _fake(S, device, Sk)
    assert attention.use_kernel(q, k, use_pallas) is want


def test_use_pallas_on_cpu_raises():
    q, k, v, _ = _inputs(20, False)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    with pytest.raises(ValueError, match="cuda"):
        attention.multihead_attention(*t, H, use_pallas=True)
    with pytest.raises(ValueError, match="cuda"):
        attention.attention_kernel(*t, H)


@pytest.mark.parametrize("dh", [8, 136])
def test_kernel_refuses_head_widths_it_does_not_take(dh):
    t = torch.zeros(1, 5, 4 * dh)
    with pytest.raises(ValueError, match="multiple of 16"):
        attention._check_cuda_inputs(t, t, t, 4, None)


def test_self_attention_module_ignores_the_variable_on_cpu(monkeypatch):
    """MOTIONSTYLE_PALLAS_ATTN=1 routes to the kernel only on the card: on
    the CPU the module's output is unchanged, bit for bit."""
    torch.manual_seed(0)
    mha = MultiheadSelfAttention(D, H)
    x = torch.randn(B, 30, D)
    kpm = torch.ones(B, 30, dtype=torch.bool)
    kpm[1, 10:] = False
    monkeypatch.delenv("MOTIONSTYLE_PALLAS_ATTN", raising=False)
    with torch.no_grad():
        plain = mha(x, kpm, torch.float32)
        monkeypatch.setenv("MOTIONSTYLE_PALLAS_ATTN", "1")
        again = mha(x, kpm, torch.float32)
    torch.testing.assert_close(again, plain, rtol=0, atol=0)
