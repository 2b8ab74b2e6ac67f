"""The port's long-form sampler (motionstyle_torch/diffusion/longform.py) on
the CPU: its window plan and its stream against the JAX package's
(motionstyle/diffusion/longform.py) under a deterministic run_window that
ignores the rng (the two packages' generators differ by design), exactly;
then the sampler contract on a tiny port model: overlap continuity, long
content root preservation, generated padding, overlap 0, per-window seeds
and a decoded root without a seam (mirroring tests/test_longform.py)."""
import numpy as np
import pytest
import torch

import jax
from motionstyle.diffusion import longform as jlongform
from motionstyle_torch.diffusion import longform
from motionstyle_torch.diffusion.ddpm import Inpainting
from tests.test_torch_models import one_torch_thread  # noqa: F401

C, W = 181, 76
GRID = [(76, 76, 10), (142, 76, 10), (143, 76, 10), (76 + 66 * 3, 76, 10), (200, 76, 0),
        (150, 76, 40), (77, 76, 10), (50, 76, 10), (300, 76, 10)]


@pytest.mark.parametrize("n_frames, window, overlap", GRID)
def test_plan_windows_matches_jax(n_frames, window, overlap):
    assert longform.plan_windows(n_frames, window, overlap) == \
        jlongform.plan_windows(n_frames, window, overlap)


def test_plan_windows_cases():
    assert longform.plan_windows(50, 76, 10) == (1, 50)
    assert longform.plan_windows(76 + 66 * 3, 76, 10) == (4, 66)
    assert longform.plan_windows(76 + 66 * 2 + 1, 76, 10) == (4, 66)
    assert longform.plan_windows(300, 76, 10) == (5, 66)


def _fake_run_window(width: int):
    """A deterministic window sampler that ignores its rng and honours the
    inpainting blend exactly; it records each window's inputs."""
    seen = []

    def run_window(init, inpainting, _rng):
        k = len(seen)
        out = np.full((2, 3, 1, width), 10.0 * k, np.float32)
        out += np.arange(width, dtype=np.float32)
        out += np.arange(3, dtype=np.float32)[None, :, None, None] * 0.5
        if inpainting is not None:
            m = np.asarray(inpainting.mask, np.float32)
            out = out * (1 - m) + np.asarray(inpainting.motion, np.float32) * m
        seen.append((None if init is None else np.array(init),
                     None if inpainting is None else np.array(inpainting.mask), out))
        return out
    return run_window, seen


@pytest.mark.parametrize("inputs", ["free", "content", "content_mask"])
@pytest.mark.parametrize("n_frames, window, overlap", GRID)
def test_stream_equals_jax(n_frames, window, overlap, inputs):
    """Offsets, chunks and every window's init and mask equal the JAX
    stream's exactly, free, with a shorter content (default mask: the pad
    generated) and with a content and a time-varying mask; draining equals
    longform_sample."""
    rs = np.random.RandomState(n_frames + overlap)
    kw = {}
    if inputs != "free":
        kw["content"] = rs.randn(2, 3, 1, n_frames - 5 if inputs == "content" else n_frames
                                 ).astype(np.float32)
    if inputs == "content_mask":
        kw["content_mask"] = (rs.rand(2, 3, 1, n_frames) < 0.4).astype(np.float32)
    run, seen = _fake_run_window(window)
    jrun, jseen = _fake_run_window(window)
    got = list(longform.longform_stream(run, n_frames, window, overlap=overlap, seed=7, **kw))
    want = list(jlongform.longform_stream(jrun, n_frames, window, overlap=overlap,
                                          rng=jax.random.PRNGKey(7), **kw))
    assert [o for o, _ in got] == [o for o, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(seen) == len(jseen)
    for (i1, m1, _), (i2, m2, _) in zip(seen, jseen):
        for a, b in ((i1, i2), (m1, m2)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    widths = [c.shape[-1] for _, c in got]
    assert sum(widths) == n_frames and all(w > 0 for w in widths)
    run2, _ = _fake_run_window(window)
    full = longform.longform_sample(run2, n_frames, window, overlap=overlap, seed=7, **kw)
    np.testing.assert_array_equal(np.concatenate([c for _, c in got], axis=-1), full)


def test_window_generators_seeded_per_window():
    """run_window gets a torch.Generator seeded with window_seed(seed, k):
    the JAX serve CLI's per-window request seed."""
    seeds = []

    def run(init, inp, gen):
        seeds.append(gen.initial_seed())
        return np.zeros((1, 3, 1, W), np.float32)

    longform.longform_sample(run, 200, W, overlap=10, seed=4)
    assert seeds == [(4 + 7919 * (k + 1)) & 0x7FFFFFFF for k in range(3)]
    assert longform.window_seed(0x7FFFFFFF, 0) == (0x7FFFFFFF + 7919) & 0x7FFFFFFF


@pytest.fixture(scope="module")
def run_window():
    """A tiny port model behind the one-device Sampler (DDIM-10, skip 3)."""
    from motionstyle_torch.diffusion.schedule import make_schedule
    from motionstyle_torch.models.denoiser import MDMConfig, StyleDiffusion
    from motionstyle_torch.models.params import seeded_init_
    from motionstyle_torch.parallel.inference import Sampler

    cfg = MDMConfig(njoints=C, nfeats=1, latent_dim=32, ff_size=64, num_layers=1,
                    num_heads=2, clip_dim=16)
    model = seeded_init_(StyleDiffusion(cfg), 0).eval()
    sched = make_schedule("cosine", 40, "ddim10", device="cpu")
    sampler = Sampler(sched, lambda m: (lambda x, t, c: m(x, t, c.get("enc_text"))), model,
                      method="ddim", skip_timesteps=3)
    enc = np.zeros((2, 16), np.float32)

    def run(init, inpainting, generator):
        batch = {"cond": {"enc_text": enc}}
        if init is None:
            batch["shape"] = (2, C, 1, W)
        else:
            batch["init_image"] = init
        if inpainting is not None:
            batch["inpainting"] = Inpainting(*inpainting)
        return sampler(batch, generator).numpy()

    return run


def test_unconditional_long(run_window):
    out = longform.longform_sample(run_window, 200, W, overlap=10, seed=1)
    assert out.shape == (2, C, 1, 200) and np.isfinite(out).all()
    assert np.abs(out[..., :50] - out[..., 66:116]).max() > 1e-3
    again = longform.longform_sample(run_window, 200, W, overlap=10, seed=1)
    np.testing.assert_array_equal(out, again)  # one seed, one answer
    other = longform.longform_sample(run_window, 200, W, overlap=10, seed=2)
    assert np.abs(other - out).max() > 1e-3


def test_overlap_zero_independent_windows(run_window):
    out = longform.longform_sample(run_window, 2 * W, W, overlap=0, seed=2)
    assert out.shape == (2, C, 1, 2 * W) and np.isfinite(out).all()


def test_default_mask_padding_is_generated(run_window):
    """Content shorter than n_frames without a mask: the real frames are
    echoed, the frames past them generated (not the zero padding)."""
    content = np.random.RandomState(3).randn(2, C, 1, W + 20).astype(np.float32)
    out = longform.longform_sample(run_window, W + 66, W, overlap=10, seed=3, content=content)
    assert out.shape == (2, C, 1, W + 66)
    np.testing.assert_allclose(out[..., :W + 20], content, atol=1e-5)
    tail = out[..., W + 20:]
    assert np.isfinite(tail).all() and np.abs(tail).max() > 1e-3


def test_overlap_frames_continue_exactly(run_window):
    seen = []

    def recording(init, inp, gen):
        out = run_window(init, inp, gen)
        seen.append((None if init is None else np.asarray(init), np.asarray(out)))
        return out

    longform.longform_sample(recording, W + 66, W, overlap=10, seed=2)
    assert len(seen) == 2
    tail = seen[0][1][..., -10:]
    np.testing.assert_array_equal(seen[1][0][..., :10], tail)
    np.testing.assert_array_equal(seen[1][1][..., :10], tail)


def test_long_content_root_preserved(run_window):
    from motionstyle_torch.data.masks import get_inpainting_mask

    content = np.random.RandomState(0).randn(2, C, 1, 200).astype(np.float32)
    mask = np.asarray(get_inpainting_mask("root_horizontal", (2, C, 1, 200),
                                          dataset="stylexia_posrot"), np.float32)
    out = longform.longform_sample(run_window, 200, W, overlap=10, seed=3, content=content,
                                   content_mask=mask)
    np.testing.assert_array_equal(out * mask, content * mask)
    assert np.abs((out - content) * (1 - mask)).max() > 1e-4


def test_decoded_root_has_no_seam_teleport(run_window):
    """The stitched features decode through one cumsum over the whole
    sequence: the root's step at the seam stays within twice the largest
    step inside the windows."""
    from motionstyle_torch.core.features import recover_root_rot_pos

    out = longform.longform_sample(run_window, W + 66, W, overlap=10, seed=5)
    _, pos = recover_root_rot_pos(torch.as_tensor(out[0, :, 0, :].T))
    pos = pos.numpy()
    step = np.linalg.norm(np.diff(pos, axis=0), axis=-1)
    seam = step[W - 10:W + 1]
    interior = np.concatenate([step[:W - 10], step[W + 1:]])
    assert np.isfinite(pos).all() and seam.max() <= interior.max() * 2.0
