"""PyTorch port vs the JAX package: the T2M evaluation stack's host code
(metrics, word vectors, token embedding), its encoders and GRU, the
evaluator wrapper and the generated-motion loaders, on the CPU.

Weights come from numpy seeds and go into both packages (the port through
the flax-tree converters); the encoders are also held to the reference's
golden (tests/goldens/evaluators.npz) at tests/test_eval.py's bound.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionstyle.eval import evaluators as jev
from motionstyle.eval import metrics as jmetrics
from motionstyle.eval import motion_loaders as jml
from motionstyle_torch.eval import evaluators as tev
from motionstyle_torch.eval import metrics
from motionstyle_torch.eval import motion_loaders as tml

GOLDEN_ATOL = 2e-4  # tests/test_eval.py:60-80
JAX_ATOL = 2e-5  # the encoders against JAX on the same weights
GRU_ATOL = 1e-5  # tests/test_eval.py:125's bound on the GRU sequence
HOST_REL = 1e-9  # numpy code copied one for one


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests share the machine with other test workers: run torch's
    CPU kernels on one thread while they run, and restore the setting."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def eval_params(tree, seed: int):
    """Replace every leaf of a flax param tree with float32 numpy draws of
    its shape: dense and conv kernels and GRU weights scaled by their fan-in
    (well-conditioned, so both packages' fp32 rounding stays small), biases
    small, LayerNorm scales near 1, the learned GRU start state unit normal."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        r = rs.randn(*leaf.shape)
        if name == "kernel":
            r = r / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name.startswith("weight_"):
            r = r / np.sqrt(leaf.shape[1])
        elif name.startswith("bias"):
            r = 0.1 * r
        elif name == "scale":
            r = 1.0 + 0.1 * r
        return r.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(tree))


def abstract_flax_init(monkeypatch, *modules) -> None:
    """Make each flax module class's init abstract (jax.eval_shape: traced,
    not compiled or run): the tests replace every initialised leaf with
    numpy draws anyway, and a concrete full-width init (lax.scan GRUs, the
    CLIP tower) costs seconds of compiling. The tree it returns still gives
    the JAX layout, which assert_layout holds the port's trees to."""
    import functools

    for m in modules:
        orig = m.init
        monkeypatch.setattr(m, "init", lambda self, *a, _init=orig, **k: jax.eval_shape(
            functools.partial(_init, self, **k), *a))


def abstract_init(module, *args, **kw):
    """A flax module's param tree as shapes (jax.eval_shape of its init)."""
    import functools

    return jax.eval_shape(functools.partial(module.init, **kw), jax.random.PRNGKey(0), *args)


def assert_layout(tree, jax_tree) -> None:
    """The same keys and leaf shapes as the JAX package's tree."""
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), t)  # noqa: E731
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(jax_tree)
    assert shapes(tree) == shapes(jax_tree)


EVALUATOR_MODULES = (jev.MovementConvEncoder, jev.TextEncoderBiGRUCo, jev.MotionEncoderBiGRUCo)


def jax_evaluator(seed: int = 0, dataset: str = "humanml", dim_pose=None):
    """(JAX EvaluatorWrapper with numpy-made weights, the port's wrapper
    carrying the same weights): trees shaped by the port's converters, held
    to the JAX wrapper's layout (its init abstract: the trees replace it)."""
    tw = tev.EvaluatorWrapper(dataset, dim_pose=dim_pose, device="cpu")
    trees = [eval_params(tev.jax_from_state(spec, m.state_dict()), seed + i)
             for i, (spec, m) in enumerate(((tev.MOVEMENT_SPEC, tw.movement_enc),
                                            (tev.TEXT_SPEC, tw.text_enc),
                                            (tev.MOTION_SPEC, tw.motion_enc)))]
    tw.load_jax_params(*trees)
    with pytest.MonkeyPatch.context() as mp:
        abstract_flax_init(mp, *EVALUATOR_MODULES)
        jw = jev.EvaluatorWrapper(dataset, dim_pose=dim_pose)
    for tree, name in zip(trees, ("movement_params", "text_params", "motion_params")):
        assert_layout(tree, getattr(jw, name)["params"])
        setattr(jw, name, {"params": tree})
    return jw, tw


def text_batch(rs, lens):
    B, T = len(lens), max(max(lens), 1) + 2
    return (rs.randn(B, T, 300).astype(np.float32),
            rs.randn(B, T, 15).astype(np.float32), np.asarray(lens))


# ---------------------------------------------------------------------------
# metrics (host numpy), the mirror of tests/test_eval.py::TestMetrics, and
# equal to the JAX package's on the same inputs
# ---------------------------------------------------------------------------

class TestMetrics:
    def test_fid_zero_for_identical(self):
        act = np.random.RandomState(0).randn(256, 16)
        mu, cov = metrics.calculate_activation_statistics(act)
        assert abs(metrics.calculate_frechet_distance(mu, cov, mu, cov)) < 1e-6

    def test_fid_positive_for_shifted(self):
        a = np.random.RandomState(0).randn(256, 16)
        mu1, c1 = metrics.calculate_activation_statistics(a)
        mu2, c2 = metrics.calculate_activation_statistics(a + 3.0)
        assert abs(metrics.calculate_frechet_distance(mu1, c1, mu2, c2) - 9 * 16) < 1.0

    def test_r_precision_perfect_match(self):
        emb = np.random.RandomState(0).randn(32, 8)
        top = metrics.calculate_r_precision(emb, emb, top_k=3, sum_all=True)
        assert top[0] == 32 and (np.diff(top) >= 0).all()

    def test_matching_score(self):
        a, b = np.zeros((4, 3)), np.ones((4, 3))
        assert metrics.calculate_matching_score(a, b, sum_all=True) == pytest.approx(
            4 * np.sqrt(3))

    def test_euclidean_distance_matrix(self):
        a = np.array([[0.0, 0.0], [3.0, 4.0]])
        np.testing.assert_allclose(metrics.euclidean_distance_matrix(a, a), [[0, 5], [5, 0]],
                                   atol=1e-6)

    @pytest.mark.parametrize("name", ["r_precision", "matching", "fid", "diversity",
                                      "multimodality", "top_k"])
    def test_equal_to_jax(self, name):
        r = np.random.RandomState(3)
        a, b = r.randn(40, 24), r.randn(40, 24) + 0.3

        def run(m):
            if name == "r_precision":
                return m.calculate_r_precision(a, b, 3, sum_all=True)
            if name == "matching":
                return m.calculate_matching_score(a, b, sum_all=False)
            if name == "fid":
                s1, s2 = (m.calculate_activation_statistics(x) for x in (a, b))
                return m.calculate_frechet_distance(*s1, *s2)
            if name == "diversity":
                return m.calculate_diversity(a, 20, rng=np.random.RandomState(1))
            if name == "multimodality":
                return m.calculate_multimodality(a.reshape(4, 10, 24), 5,
                                                 rng=np.random.RandomState(1))
            return m.calculate_top_k(np.argsort(m.euclidean_distance_matrix(a, b), 1), 4)

        got, want = np.asarray(run(metrics), np.float64), np.asarray(run(jmetrics), np.float64)
        np.testing.assert_allclose(got, want, rtol=HOST_REL)

    def test_fid_on_a_scipy_without_sqrtm_disp(self, monkeypatch):
        """scipy 1.18 dropped sqrtm's `disp` (the card's machine has such a
        scipy): FID through a sqrtm without it equals the JAX package's."""
        import types

        from scipy import linalg

        r = np.random.RandomState(4)
        s1, s2 = (metrics.calculate_activation_statistics(r.randn(40, 12) + k) for k in (0, 1))
        want = jmetrics.calculate_frechet_distance(*s1, *s2)
        calls = []

        def sqrtm_new(a):  # the 1.18 signature: one argument, one array back
            calls.append(a.shape)
            return linalg.sqrtm(a, disp=False)[0]

        monkeypatch.setattr(metrics, "_SQRTM_DISP", False)
        monkeypatch.setattr(metrics, "linalg", types.SimpleNamespace(sqrtm=sqrtm_new,
                                                                     norm=linalg.norm))
        np.testing.assert_allclose(metrics.calculate_frechet_distance(*s1, *s2), want,
                                   rtol=HOST_REL)
        assert calls == [(12, 12)]


# ---------------------------------------------------------------------------
# word vectors and token embedding
# ---------------------------------------------------------------------------

class TestWordVectorizer:
    def test_fallback_deterministic_and_pos(self):
        wv = tev.WordVectorizer()
        v1, p1 = wv["walk/NOUN"]
        v2, _ = wv["walk/NOUN"]
        np.testing.assert_array_equal(v1, v2)
        assert p1[12] == 1  # 'walk' is an Act_VIP word: overrides the given POS
        assert wv["table/NOUN"][1][1] == 1
        assert wv["zzzz/XXX"][1][14] == 1

    @pytest.mark.parametrize("glove", [False, True])
    def test_equal_to_jax(self, glove, tmp_path):
        import pickle

        root = None
        if glove:
            root = str(tmp_path)
            words = ["walk", "person", "unk", "sos", "eos"]
            np.save(tmp_path / "our_vab_data.npy",
                    np.random.RandomState(0).randn(len(words), 300).astype(np.float32))
            pickle.dump(words, open(tmp_path / "our_vab_words.pkl", "wb"))
            pickle.dump({w: i for i, w in enumerate(words)}, open(tmp_path / "our_vab_idx.pkl",
                                                                  "wb"))
        tw, jw = tev.WordVectorizer(root), jev.WordVectorizer(root)
        for tok in ("walk/VERB", "person/NOUN", "angrily/ADV", "nothere/OTHER", "left", "x/Y"):
            for got, want in zip(tw[tok], jw[tok]):
                np.testing.assert_allclose(got, want, rtol=HOST_REL)

    def test_embed_texts_and_tokens_equal_jax(self):
        cond = {"y": {"text": ["a person walks", "someone jumps high"]}}
        texts = cond["y"]["text"]
        assert tml.tokens_or_fallback(cond, texts) == jml.tokens_or_fallback(cond, texts)
        cond_t = {"y": {"text": texts, "tokens": ["a/DET_person/NOUN", "run/VERB"]}}
        assert tml.tokens_or_fallback(cond_t, texts) == jml.tokens_or_fallback(cond_t, texts)
        toks = tml.tokens_or_fallback(cond, texts) + [["w/OTHER"] * 30]
        for got, want in zip(tml.embed_texts(tev.WordVectorizer(), toks),
                             jml.embed_texts(jev.WordVectorizer(), toks)):
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the encoders: against the reference golden and against JAX
# ---------------------------------------------------------------------------

def _golden_sd(g, prefix):
    return {k[len(prefix):]: torch.from_numpy(g[k]) for k in g.files if k.startswith(prefix)}


class TestEncodersGolden:
    """The port's modules load the reference state dicts as they are."""

    def test_movement_encoder(self, goldens):
        g = goldens["evaluators"]
        enc = tev.MovementConvEncoder(g["motions"].shape[-1] - 4)
        enc.load_state_dict(_golden_sd(g, "mv__"))
        with torch.no_grad():
            out = enc(torch.from_numpy(g["motions"][..., :-4])).numpy()
        np.testing.assert_allclose(out, g["movements"], atol=GOLDEN_ATOL)

    def test_motion_encoder_variable_lengths(self, goldens):
        g = goldens["evaluators"]
        enc = tev.MotionEncoderBiGRUCo()
        enc.load_state_dict(_golden_sd(g, "mo__"))
        with torch.no_grad():
            out = enc(torch.from_numpy(g["movements"]), g["m_lens"] // 4).numpy()
        np.testing.assert_allclose(out, g["motion_emb"], atol=GOLDEN_ATOL)

    def test_text_encoder_variable_lengths(self, goldens):
        g = goldens["evaluators"]
        enc = tev.TextEncoderBiGRUCo()
        enc.load_state_dict(_golden_sd(g, "tx__"))
        with torch.no_grad():
            out = enc(torch.from_numpy(g["word_embs"]), torch.from_numpy(g["pos_ohot"]),
                      g["cap_lens"]).numpy()
        np.testing.assert_allclose(out, g["text_emb"], atol=GOLDEN_ATOL)

    def test_converters_equal_jax(self, goldens):
        g = goldens["evaluators"]
        for prefix, has_pos in (("tx__", True), ("mo__", False)):
            sd = {k: v.numpy() for k, v in _golden_sd(g, prefix).items()}
            got = tev.convert_cogru_encoder(sd, has_pos)
            want = jev.convert_cogru_encoder(sd, has_pos)
            assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
            assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, got, want))
            back = tev.export_cogru_encoder(got, has_pos)
            assert set(back) == set(sd) and all(np.array_equal(back[k], sd[k]) for k in sd)
        sd = {k: v.numpy() for k, v in _golden_sd(g, "mv__").items()}
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(
            np.array_equal, tev.convert_movement_encoder(sd), jev.convert_movement_encoder(sd)))
        back = tev.export_movement_encoder(jev.convert_movement_encoder(sd))
        assert all(np.array_equal(back[k], sd[k]) for k in sd)


# one batch with every length case: unsorted rows, a row of length 0 (a
# clip shorter than 4 frames in m_lens // 4, or an empty caption), a row
# past T and a row of length 1
LENGTHS = [3, 0, 7, 5, 9, 1]


@pytest.fixture(scope="module")
def pair():
    """The JAX wrapper and the port's at full width with the same weights."""
    return jax_evaluator(1)


def small_pair(kind: str, seed: int):
    """(JAX module, its numpy-made params, the port's module with them) at
    narrow widths."""
    if kind == "motion":
        jm = jev.MotionEncoderBiGRUCo(input_size=24, hidden_size=32, output_size=16)
        args = (jnp.zeros((1, 2, 24)), jnp.asarray([2]))
        tm, spec = tev.MotionEncoderBiGRUCo(24, 32, 16), tev.MOTION_SPEC
    else:
        jm = jev.TextEncoderBiGRUCo(hidden_size=32, output_size=16)
        args = (jnp.zeros((1, 4, 300)), jnp.zeros((1, 4, 15)), jnp.asarray([4]))
        tm, spec = tev.TextEncoderBiGRUCo(hidden_size=32, output_size=16), tev.TEXT_SPEC
    params = eval_params(abstract_init(jm, *args), seed)
    tm.load_state_dict(tev.state_from_jax(spec, params["params"]))
    return jm, params, tm


class TestEncodersJax:
    @pytest.mark.parametrize("kind", ["motion", "text"])
    def test_encoder_matches_jax(self, kind):
        jm, params, tm = small_pair(kind, 1)
        rs = np.random.RandomState(2)
        if kind == "motion":
            args = (rs.randn(len(LENGTHS), 7, 24).astype(np.float32), np.asarray(LENGTHS))
        else:
            we, po, cl = text_batch(rs, LENGTHS)
            args = (we[:, :7], po[:, :7], cl)
        want = jm.apply(params, *map(jnp.asarray, args))
        with torch.no_grad():
            got = tm(*(torch.from_numpy(a) if a.dtype == np.float32 else a for a in args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JAX_ATOL)

    def test_wrapper_embeddings(self, pair):
        """The wrapper's motion and co-embeddings at full width (strip_fc on
        humanml's 263; m_lens // 4 with a clip under 4 frames and an empty
        caption)."""
        jw, tw = pair
        assert tw.strip_fc and jw.strip_fc
        rs = np.random.RandomState(4)
        motions = rs.randn(4, 24, 263).astype(np.float32)
        m_lens = np.asarray([24, 17, 3, 9])
        we, po, cl = text_batch(rs, [5, 0, 3, 4])
        for got, want in zip(tw.get_co_embeddings(we, po, cl, motions, m_lens),
                             jw.get_co_embeddings(we, po, cl, motions, m_lens)):
            np.testing.assert_allclose(got, np.asarray(want), atol=JAX_ATOL)

    @pytest.mark.parametrize("dataset,dim_pose,strip", [("humanml", None, True),
                                                        ("kit", None, True),
                                                        ("stylexia_posrot", 181, False),
                                                        ("bandai-2_posrot", 190, False)])
    def test_wrapper_layout(self, dataset, dim_pose, strip):
        """The JAX wrapper's dims: foot contacts stripped on the humanml/kit
        layouts only, the posrot layouts' full features in."""
        tw = tev.EvaluatorWrapper(dataset, dim_pose=dim_pose, device="cpu")
        assert tw.strip_fc == strip and tw.dim_pose == (dim_pose or (263 if dataset ==
                                                                     "humanml" else 251))
        in_dim = tw.movement_enc.main[0].in_channels
        assert in_dim == tw.dim_pose - 4 * strip
        emb = tw.get_motion_embeddings(np.zeros((2, 16, tw.dim_pose), np.float32), [16, 9])
        assert emb.shape == (2, 512) and np.isfinite(emb).all()


class TestGRU:
    @pytest.mark.parametrize("lens", [[7, 5, 3], [3, 0, 7, 5]], ids=["sorted", "zero_unsorted"])
    def test_return_sequence_matches_jax(self, lens):
        B, T, D, H = len(lens), 7, 5, 4
        rs = np.random.RandomState(0)
        x = rs.randn(B, T, D).astype(np.float32)
        h0 = rs.randn(2, B, H).astype(np.float32)
        gru = jev.TorchGRU(hidden_size=H, bidirectional=True, return_sequence=True)
        params = eval_params(abstract_init(gru, jnp.asarray(x), jnp.asarray(lens),
                                           jnp.asarray(h0)), 5)
        want_last, want_seq = gru.apply(params, jnp.asarray(x), jnp.asarray(lens),
                                        jnp.asarray(h0))
        tg = torch.nn.GRU(D, H, batch_first=True, bidirectional=True)
        tg.load_state_dict({k: torch.from_numpy(v) for k, v in params["params"].items()})
        with torch.no_grad():
            last, seq = tev.run_gru(tg, torch.from_numpy(x), np.asarray(lens),
                                    torch.from_numpy(h0), return_sequence=True)
        np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq), atol=GRU_ATOL)
        np.testing.assert_allclose(last.numpy(), np.asarray(want_last), atol=GRU_ATOL)
        if 0 in lens:  # a row of length 0 keeps h0 and outputs zeros
            i = lens.index(0)
            np.testing.assert_array_equal(last[i].numpy(), np.concatenate([h0[0, i], h0[1, i]]))
            assert not seq[i].any()


def test_true_fp32_scope_restores_the_settings():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        with tev.true_fp32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_wrapper_runs_on_its_device_and_is_seeded():
    a = tev.EvaluatorWrapper("humanml", seed=3, device="cpu")
    b = tev.EvaluatorWrapper("humanml", seed=3, device="cpu")
    m = np.random.RandomState(0).randn(2, 16, 263).astype(np.float32)
    np.testing.assert_array_equal(a.get_motion_embeddings(m, [16, 8]),
                                  b.get_motion_embeddings(m, [16, 8]))
    assert all(p.device.type == "cpu" and not p.requires_grad
               for p in a.motion_enc.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tev.EvaluatorWrapper("humanml", device="cuda")


@pytest.mark.parametrize("entry", ["EvaluatorWrapper", "MovementAETrainer",
                                   "TextMotionMatchTrainer", "LengthEstTrainer",
                                   "CompV6Generator", "load_t2m"])
def test_the_card_is_the_default_device(entry, tmp_path):
    """Built without a device, the evaluator, the trainers, the generator
    and load_t2m ask for the card, and raise where there is none; they
    never fall back to the CPU unasked."""
    from motionstyle_torch.cli.train_t2m_generator import load_t2m
    from motionstyle_torch.eval import t2m_generator as tgen
    from motionstyle_torch.eval import trainers as ttr

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    build = {
        "EvaluatorWrapper": lambda: tev.EvaluatorWrapper("humanml"),
        "MovementAETrainer": lambda: ttr.MovementAETrainer(dim_pose=67),
        "TextMotionMatchTrainer": lambda: ttr.TextMotionMatchTrainer(
            ttr.MovementAETrainer(dim_pose=67, device="cpu").enc.state_dict(), dim_pose=67),
        "LengthEstTrainer": lambda: tgen.LengthEstTrainer(output_size=6),
        "CompV6Generator": lambda: tgen.CompV6Generator(dim_pose=31, dim_z=8, hidden=32,
                                                        text_hidden=16),
    }
    if entry == "load_t2m":
        gen = tgen.CompV6Generator(dim_pose=31, dim_z=8, hidden=32, text_hidden=16,
                                   device="cpu")
        est = tgen.LengthEstTrainer(output_size=6, device="cpu")
        path = str(tmp_path / "t2m_generator.pkl")
        with open(path, "wb") as f:
            pickle.dump({"generator": gen.jax_params(), "length_estimator": est.jax_params(),
                         "dim_pose": 31, "dim_z": 8, "hidden": 32, "text_hidden": 16,
                         "len_output_size": 6}, f)
        build["load_t2m"] = lambda: load_t2m(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build[entry]()


# ---------------------------------------------------------------------------
# generated-motion loaders and the metric suite
# (the mirror of tests/test_motion_loaders.py)
# ---------------------------------------------------------------------------

class FakeLoader:
    """Mimics the DataLoader protocol with fixed synthetic batches."""

    def __init__(self, n_batches=3, batch_size=4, T=32, C=263):
        self.batch_size = batch_size
        self._batches = []
        r = np.random.RandomState(0)
        for i in range(n_batches):
            motion = r.randn(batch_size, C, 1, T).astype(np.float32)
            cond = {"y": {"text": [f"a person walks {i}_{b}" for b in range(batch_size)],
                          "lengths": np.full(batch_size, T - 4),
                          "tokens": ["a/DET_person/NOUN_walks/VERB"] * batch_size}}
            self._batches.append((motion, cond))
        self.dataset = type("DS", (), {})()

    def __len__(self):
        return len(self._batches)

    def __iter__(self):
        return iter(self._batches)


def _sample_fn(texts, lengths, shape, generator):
    return torch.randn(tuple(shape), generator=generator)


class TestGeneratedDataset:
    def test_generation_and_mm(self):
        ds = tml.GeneratedMotionDataset(_sample_fn, FakeLoader(), mm_num_samples=4,
                                        mm_num_repeats=3)
        assert len(ds) == 12
        caption, motion, length, tokens, cap_len = ds[0]
        assert motion.shape == (32, 263) and length == 28
        assert tokens == ["a/DET", "person/NOUN", "walks/VERB"] and cap_len == 3
        assert len(ds.mm_generated_motion) >= 4
        assert len(ds.mm_generated_motion[0]["mm_motions"]) == 3

    def test_num_samples_limit(self):
        ds = tml.GeneratedMotionDataset(_sample_fn, FakeLoader(n_batches=5),
                                        num_samples_limit=4)
        assert len(ds) <= 8  # one batch past the limit

    def test_mm_batches_and_order_equal_jax(self):
        """The same batches repeat, in the same order, as in the JAX dataset
        (the mm choice is np.random.RandomState(seed) in both)."""
        calls = {"port": [], "jax": []}

        def recorder(key):
            def fn(texts, lengths, shape, rng):
                calls[key].append(texts[0])
                return np.zeros(tuple(shape), np.float32)
            return fn

        t = tml.GeneratedMotionDataset(recorder("port"), FakeLoader(n_batches=5),
                                       mm_num_samples=5, mm_num_repeats=2, seed=7)
        j = jml.GeneratedMotionDataset(recorder("jax"), FakeLoader(n_batches=5),
                                       mm_num_samples=5, mm_num_repeats=2, seed=7)
        assert calls["port"] == calls["jax"]
        assert [e["caption"] for e in t.mm_generated_motion] == \
            [e["caption"] for e in j.mm_generated_motion]


class TestCompV6GeneratedDataset:
    def test_lengths_from_estimator_and_generation(self):
        from motionstyle_torch.eval.t2m_generator import CompV6Generator, LengthEstTrainer

        gen = CompV6Generator(dim_pose=31, dim_z=8, hidden=32, text_hidden=16, device="cpu")
        est = LengthEstTrainer(output_size=6, device="cpu")
        ds = tml.CompV6GeneratedDataset(gen, est, FakeLoader(n_batches=2, batch_size=2, C=31),
                                        tev.WordVectorizer(), mm_num_samples=2,
                                        mm_num_repeats=3, min_mov_length=1)
        assert len(ds) == 4
        caption, motion, length, tokens, cap_len = ds[0]
        # generated length is a unit_length multiple from the estimator
        assert length % gen.unit_length == 0 and 1 <= length <= 6 * gen.unit_length
        assert motion.shape == (length, 31) and np.isfinite(motion).all()
        assert len(ds.mm_generated_motion) == 2
        assert len(ds.mm_generated_motion[0]["mm_motions"]) == 3

    def test_sample_mov_length_redraws(self):
        # concentrated on a short bucket: after 3 draws the last draw is
        # kept even when below the minimum (the reference keeps it too)
        logits = torch.log(torch.tensor([0.999, 1e-4, 1e-4]))
        vals = {tml.sample_mov_length(logits, torch.Generator().manual_seed(i), 2)
                for i in range(20)}
        assert 0 in vals
        logits_hi = torch.log(torch.tensor([1e-4, 1e-4, 0.999]))
        assert tml.sample_mov_length(logits_hi, torch.Generator().manual_seed(0), 2) == 2


def _items(rs, n, shift, C=263, T=32):
    return [(f"cap {i}", (rs.randn(T, C) + shift).astype(np.float32), T - 4 - (i % 3),
             ["a/DET", "person/NOUN", "walks/VERB"][: 1 + i % 3]) for i in range(n)]


class TestEvalPipeline:
    def test_metric_suite_runs_and_discriminates(self):
        wv, ev = tev.WordVectorizer(), tev.EvaluatorWrapper("humanml", device="cpu")
        rs = np.random.RandomState(0)
        gt, same, far = _items(rs, 24, 0.0), _items(rs, 24, 0.0), _items(rs, 24, 3.0)
        m_same = tml.evaluate_matching_and_fid(ev, wv, gt, same, diversity_times=8)
        m_far = tml.evaluate_matching_and_fid(ev, wv, gt, far, diversity_times=8)
        assert np.isfinite(m_same["FID"]) and np.isfinite(m_far["FID"])
        assert m_far["FID"] > m_same["FID"]

    def test_metric_suite_equal_to_jax(self, pair):
        """The same weights and items: every key and value of the JAX suite
        (40 items: one 32-candidate pool and the rest dropped, as in JAX)."""
        jw, tw = pair
        wv = tev.WordVectorizer()
        rs = np.random.RandomState(1)
        gt, gen = _items(rs, 40, 0.0), _items(rs, 40, 0.5)
        got = tml.evaluate_matching_and_fid(tw, wv, gt, gen, diversity_times=16, seed=2)
        want = jml.evaluate_matching_and_fid(jw, jev.WordVectorizer(), gt, gen,
                                             diversity_times=16, seed=2)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)

    def test_multimodality_equal_to_jax(self, pair):
        jw, tw = pair
        r = np.random.RandomState(1)
        mm_items = [{"mm_motions": [{"motion": r.randn(24, 263).astype(np.float32),
                                     "length": 20 - k} for k in range(5)]} for _ in range(3)]
        got = tml.evaluate_multimodality(tw, mm_items, mm_num_times=4)
        assert np.isfinite(got) and got > 0
        np.testing.assert_allclose(got, jml.evaluate_multimodality(jw, mm_items, 4), rtol=1e-5)
