"""The port's native ingest library and loaders (motionstyle_torch/native/)
against the JAX package's (motionstyle/native/) on the CPU, where g++ builds
both libraries.

window_normalize_collate, lengths_to_mask and parse_floats: the port's C++
and its numpy twin bit-equal to the JAX package's on the same inputs (the
same float32 math). NativeStyleLoader: batches bit-equal to the JAX loader's
from one seed, and equal to the numpy DataLoader's to float32 rounding
(rtol 1e-5, atol 1e-6: the twin multiplies by 1/std where the dataset
divides). PrefetchLoader: the same order, errors re-raised, an abandoned
iteration ends its thread. The build: -march=native's retry without it, and
a raise with the compiler's message where the JAX package falls back to
numpy.
"""
import random
import threading

import numpy as np
import pytest

from motionstyle.native import ingest as jingest
from motionstyle.native.loader import NativeStyleLoader as JNativeStyleLoader
from motionstyle_torch.data.collate import (
    DataLoader, get_dataset, get_dataset_loader, t2m_style_collate)
from motionstyle_torch.native import build, ingest
from motionstyle_torch.native.loader import NativeStyleLoader, PrefetchLoader


def _clips(seed: int = 0, n: int = 9, c: int = 181):
    r = np.random.RandomState(seed)
    motions = [r.randn(r.randint(20, 80), c).astype(np.float32) for _ in range(n)]
    starts = [int(r.randint(0, max(1, len(m) - 16))) for m in motions]
    m_lens = [int(min(len(m) - s, r.randint(8, 76))) for m, s in zip(motions, starts)]
    mean = r.randn(c).astype(np.float32)
    std = (np.abs(r.randn(c)) + 0.5).astype(np.float32)
    return motions, starts, m_lens, mean, std


@pytest.mark.parametrize("nthreads, force_numpy", [(1, False), (4, False), (0, False),
                                                   (0, True)])
def test_window_normalize_collate_matches_jax(nthreads, force_numpy):
    motions, starts, m_lens, mean, std = _clips()
    got = ingest.window_normalize_collate(motions, starts, m_lens, 76, mean, std,
                                          nthreads=nthreads, force_numpy=force_numpy)
    for jax_numpy in (False, True):
        want = jingest.window_normalize_collate(motions, starts, m_lens, 76, mean, std,
                                                nthreads=nthreads, force_numpy=jax_numpy)
        np.testing.assert_array_equal(got, want)
    assert got.shape == (9, 181, 1, 76) and got.dtype == np.float32


@pytest.mark.parametrize("window", [(40, 20), (-1, 5), (0, 77)])
def test_a_window_out_of_bounds_raises_before_the_library_runs(window):
    motion = np.zeros((50, 7), np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        ingest.window_normalize_collate([motion], [window[0]], [window[1]], 76, np.zeros(7),
                                        np.ones(7))


def test_twin_is_the_datasets_math():
    """The twin alone reproduces the crop, normalise, pad and transpose."""
    r = np.random.RandomState(1)
    motion = r.randn(50, 7).astype(np.float32)
    mean, std = r.randn(7), np.abs(r.randn(7)) + 0.5
    out = ingest.window_normalize_collate([motion], [10], [30], 48, mean, std, force_numpy=True)
    np.testing.assert_allclose(out[0, :, 0, :30], ((motion[10:40] - mean) / std).T,
                               rtol=1e-6, atol=1e-6)
    assert (out[0, :, 0, 30:] == 0).all()


@pytest.mark.parametrize("lengths", [[5, 12, 12, 0], [76], [1, 75, 76], [80, 3]])
def test_lengths_to_mask_matches_jax(lengths):
    want = jingest.lengths_to_mask(lengths, 76, force_numpy=True)
    for force_numpy in (False, True):
        got = ingest.lengths_to_mask(lengths, 76, force_numpy=force_numpy)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (len(lengths), 1, 1, 76)


@pytest.mark.parametrize("text", ["", "   \n\t ", "1", " 1.5e-3\n-2 ", "table"])
def test_parse_floats_matches_jax(text):
    if text == "table":
        r = np.random.RandomState(0)
        vals = r.randn(5000).astype(np.float32) * r.choice(
            [1e-5, 1.0, 1e4], 5000).astype(np.float32)
        text = "\n".join(" ".join(f"{v:.6f}" for v in row) for row in vals.reshape(100, 50))
    want = jingest.parse_floats(text, force_numpy=True)
    np.testing.assert_array_equal(ingest.parse_floats(text), want)
    np.testing.assert_array_equal(ingest.parse_floats(text, force_numpy=True), want)
    np.testing.assert_array_equal(ingest.parse_floats(text), jingest.parse_floats(text))


def test_native_pass_stops_at_garbage_where_the_twin_raises():
    assert ingest.parse_floats("1 2 x 3").tolist() == [1.0, 2.0]
    with pytest.raises(ValueError):
        ingest.parse_floats("1 2 x 3", force_numpy=True)


@pytest.fixture(scope="module")
def xia_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_xia")
    (root / "new_joint_vecs").mkdir()
    r = np.random.RandomState(0)
    for f in ["350angry_jumping.npy", "306neutral_running.npy", "100angry_walking.npy",
              "101proud_walking.npy", "102childlike_walking.npy", "103depressed_walking.npy"]:
        np.save(root / "new_joint_vecs" / f,
                (r.randn(int(r.randint(30, 76)), 181) * 0.5).astype(np.float32))
    np.save(root / "Mean.npy", (r.randn(181) * 0.1).astype(np.float32))
    np.save(root / "Std.npy", (np.abs(r.randn(181)) + 0.5).astype(np.float32))
    return str(root)


@pytest.fixture(scope="module")
def style_dataset(xia_root):
    return get_dataset("stylexia_posrot", 76, split="train", data_root=xia_root)


def _batches(make_loader, seed: int = 123) -> list:
    random.seed(seed)  # the datasets' caption and crop draws
    return list(make_loader())


def test_native_loader_matches_the_jax_loader(xia_root, style_dataset):
    from motionstyle.data.collate import get_dataset as jget_dataset

    jds = jget_dataset("stylexia_posrot", 76, split="train", data_root=xia_root)
    want = _batches(lambda: JNativeStyleLoader(jds, 2, shuffle=True, seed=7))
    got = _batches(lambda: NativeStyleLoader(style_dataset, 2, shuffle=True, seed=7))
    assert len(got) == len(want) == len(jds) // 2 > 0
    for (m, c), (jm, jc) in zip(got, want):
        np.testing.assert_array_equal(m, jm)
        assert c["y"].keys() == jc["y"].keys()
        for k in ("mask", "lengths"):
            np.testing.assert_array_equal(c["y"][k], jc["y"][k])
        assert c["y"]["text"] == jc["y"]["text"] and c["y"]["style"] == jc["y"]["style"]


def test_native_loader_matches_the_numpy_loader(style_dataset):
    want = _batches(lambda: DataLoader(style_dataset, 2, t2m_style_collate, shuffle=True,
                                       seed=7))
    got = _batches(lambda: NativeStyleLoader(style_dataset, 2, shuffle=True, seed=7))
    assert len(got) == len(want) > 0
    for (m, c), (wm, wc) in zip(got, want):
        assert m.dtype == np.float32 and isinstance(m, np.ndarray)  # host numpy, as before
        np.testing.assert_allclose(m, wm, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(c["y"]["mask"], wc["y"]["mask"])
        np.testing.assert_array_equal(c["y"]["lengths"], wc["y"]["lengths"])
        assert c["y"]["text"] == wc["y"]["text"] and c["y"]["style"] == wc["y"]["style"]


@pytest.mark.parametrize("native", [False, True])
def test_prefetch_keeps_the_order(native, xia_root):
    def make(prefetch):
        return get_dataset_loader("stylexia_posrot", 2, 76, data_root=xia_root, native=native,
                                  prefetch=prefetch)

    plain = _batches(lambda: make(0), seed=5)
    loader = make(2)
    assert isinstance(loader, PrefetchLoader) and len(loader) == len(plain) > 0
    assert isinstance(loader.loader, NativeStyleLoader) == native
    assert loader.batch_size == 2 and len(loader) == len(loader.dataset) // 2
    fetched = _batches(lambda: loader, seed=5)
    for (m_a, c_a), (m_b, c_b) in zip(plain, fetched):
        np.testing.assert_array_equal(m_a, m_b)
        assert c_a["y"]["text"] == c_b["y"]["text"]


def test_prefetch_propagates_errors():
    class Boom:
        dataset, batch_size = None, 1

        def __len__(self):
            return 3

        def __iter__(self):
            yield "ok"
            raise RuntimeError("producer died")

    it = iter(PrefetchLoader(Boom(), depth=1))
    assert next(it) == "ok"
    with pytest.raises(RuntimeError, match="producer died"):
        list(it)


def test_abandoned_prefetch_ends_its_thread():
    """A training loop breaks on its last step: the producer, blocked on a
    full queue, must end instead of waiting forever."""
    before = threading.active_count()
    it = iter(PrefetchLoader(iter(range(1000)), depth=1))
    assert next(it) == 0
    it.close()
    assert threading.active_count() == before


def test_humanml_warns_and_takes_the_numpy_path(tmp_path_factory, capsys):
    from tests.test_torch_finetune import family_root

    root = family_root(tmp_path_factory, "humanml")
    loader = get_dataset_loader("humanml", 2, 196, data_root=root, native=True)
    assert type(loader) is DataLoader
    assert "covers the style datasets only" in capsys.readouterr().out


@pytest.fixture()
def fresh_build(tmp_path, monkeypatch):
    """A build into an empty directory, the loaded library forgotten (and
    restored afterwards)."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(ingest, "_lib", None)
    return tmp_path


def test_march_native_is_retried_without(fresh_build, monkeypatch):
    """A host whose compiler refuses the arch flag builds without it (the
    JAX build's retry); the flags that took are recorded."""
    monkeypatch.setattr(build, "ARCH_FLAG", "-mno-such-arch-flag")
    path, flags, secs = build.build()
    assert flags == build.BASE_FLAGS and secs > 0 and build.last_build["flags"] == flags
    assert path.startswith(str(fresh_build))
    assert ingest.lengths_to_mask([2], 3).ravel().tolist() == [1.0, 1.0, 0.0]
    assert build.build()[2] == 0.0  # built once: the next call loads the file


@pytest.mark.parametrize("fault", ["source", "compiler"])
def test_native_loader_raises_when_the_library_does_not_build(fault, fresh_build, xia_root,
                                                              monkeypatch):
    """No quiet fallback: --native_loader 1 raises with the reason where
    the JAX package warns and uses numpy."""
    if fault == "source":
        bad = fresh_build / "ingest.cc"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(build, "SRC", str(bad))
        match = r"building the native ingest library failed(.|\n)*error"
    else:
        monkeypatch.setattr(build, "CXX", "no-such-compiler-here")
        match = "needs no-such-compiler-here"
    with pytest.raises(RuntimeError, match=match):
        get_dataset_loader("stylexia_posrot", 2, 76, data_root=xia_root, native=True)
    assert not ingest.native_available()
    assert type(get_dataset_loader("stylexia_posrot", 2, 76, data_root=xia_root)) is DataLoader
