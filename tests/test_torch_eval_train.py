"""PyTorch port vs the JAX package: the evaluator's trainers, the CompV6
generator and its length estimator, the checkpoints crossing both ways
(finest.tar, t2m_generator.pkl) and the two training CLIs, on the CPU.

Weights come from numpy seeds into both packages (tests/test_torch_eval.py::
eval_params); the trainers run 3 steps on the same batches with the global
numpy stream seeded alike (the match trainer's negative shift, CompV6's
teacher-forcing coin), and CompV6's z noise is JAX's normals drawn from its
keys and handed to the port's generate/train_step.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from motionstyle.eval import evaluators as jev
from motionstyle.eval import t2m_generator as jgen
from motionstyle.eval import trainers as jtr
from motionstyle_torch.eval import evaluators as tev
from motionstyle_torch.eval import t2m_generator as tgen
from motionstyle_torch.eval import trainers as ttr
from tests.test_torch_eval import (
    EVALUATOR_MODULES, abstract_flax_init, abstract_init, assert_layout, eval_params)

LOSS_REL = 1e-4  # each step's losses against the JAX trainer's
EMB_ATOL = 2e-5  # embeddings of a checkpoint loaded in the other package
GEN_ATOL = 1e-5  # CompV6 outputs on the same weights and noise


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests share the machine with other test workers: run torch's
    CPU kernels on one thread while they run, and restore the setting."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def jax_trainer(monkeypatch, cls, modules, tree, *args, **kw):
    """A JAX trainer built around `tree` (numpy-made params shaped by the
    port's converters, held to the trainer's own layout; its init abstract,
    since the tree replaces it) with a fresh optimizer state on the tree."""
    with monkeypatch.context() as mp:
        abstract_flax_init(mp, *modules)
        tr = cls(*args, **kw)
    assert_layout(tree, tr.params)
    tr.params = tree
    tr.opt_state = tr.tx.init(tree)
    return tr


def assert_losses(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= LOSS_REL * abs(want[k]) + 1e-7, (k, got[k], want[k])


# ---------------------------------------------------------------------------
# the trainers (the mirror of tests/test_trainers_preprocess.py::TestTrainers)
# ---------------------------------------------------------------------------

class TestTrainers:
    def test_movement_ae_loss_decreases(self):
        tr = ttr.MovementAETrainer(dim_pose=67, device="cpu")
        batch = np.random.RandomState(0).randn(4, 16, 67).astype(np.float32)
        losses = [tr.update(batch)["loss"] for _ in range(15)]
        assert losses[-1] < losses[0]

    def test_contrastive_matching_trains(self):
        tr0 = ttr.MovementAETrainer(dim_pose=67, device="cpu")
        tr = ttr.TextMotionMatchTrainer(tr0.enc.state_dict(), dim_pose=67, device="cpu")
        r = np.random.RandomState(1)
        B = 8
        batch = dict(word_embs=r.randn(B, 6, 300).astype(np.float32),
                     pos_ohot=r.randn(B, 6, 15).astype(np.float32), cap_lens=np.full(B, 6),
                     motions=r.randn(B, 16, 67).astype(np.float32), m_lens=np.full(B, 16))
        losses = [tr.update(**batch)["loss"] for _ in range(10)]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]

    def test_contrastive_loss_semantics(self):
        a, b = torch.zeros(4, 8), torch.ones(4, 8) * 10
        # far negatives beyond the margin: zero loss; far positives: large
        assert float(ttr.contrastive_loss(a, b, torch.ones(4))) == 0.0
        assert float(ttr.contrastive_loss(a, b, torch.zeros(4))) > 100
        x, y, lab = (np.random.RandomState(2).randn(5, 8).astype(np.float32),
                     np.random.RandomState(3).randn(5, 8).astype(np.float32),
                     np.asarray([0, 1, 0, 1, 1], np.float32))
        np.testing.assert_allclose(
            float(ttr.contrastive_loss(*map(torch.from_numpy, (x, y, lab)))),
            float(jtr.contrastive_loss(jnp.asarray(x), jnp.asarray(y), jnp.asarray(lab))),
            rtol=1e-6)

    def test_movement_decoder_matches_jax(self):
        """flax ConvTranspose (SAME, k=4, s=2) against ConvTranspose1d(4, 2, 1)
        with the taps reversed."""
        dec = jtr.MovementConvDecoder(hidden_size=32, output_size=12)
        x = np.random.RandomState(4).randn(2, 5, 16).astype(np.float32)
        tdec = ttr.MovementConvDecoder(16, 32, 12)
        tree = eval_params(tev.jax_from_state(ttr.DECODER_SPEC, tdec.state_dict()), 7)
        tdec.load_state_dict(tev.state_from_jax(ttr.DECODER_SPEC, tree))
        with torch.no_grad():
            got = tdec(torch.from_numpy(x)).numpy()
        want = dec.apply({"params": tree}, jnp.asarray(x))
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
        back = tev.jax_from_state(ttr.DECODER_SPEC, tdec.state_dict())
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back, tree))

    @pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["under_the_clip", "clipped"])
    def test_clipped_adam_is_optax(self, scale):
        """clip_by_global_norm(0.5) + adam against optax on the same gradients."""
        rs = np.random.RandomState(5)
        w0 = {"a": rs.randn(3, 4).astype(np.float32), "b": rs.randn(4).astype(np.float32)}
        grads = [{k: (rs.randn(*v.shape) * scale).astype(np.float32) for k, v in w0.items()}
                 for _ in range(3)]
        tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-2))
        params, state = jax.tree_util.tree_map(jnp.asarray, w0), None
        state = tx.init(params)
        tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in w0.items()}
        opt = ttr.ClippedAdam(tp.values(), 1e-2)
        for g in grads:
            upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
            params = optax.apply_updates(params, upd)
            for k, p in tp.items():
                p.grad = torch.from_numpy(g[k])
            opt.step()
        for k in w0:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(params[k]), atol=1e-6)

    def test_movement_ae_matches_jax(self, monkeypatch):
        ta = ttr.MovementAETrainer(dim_pose=67, device="cpu")
        tree = eval_params({"enc": tev.jax_from_state(tev.MOVEMENT_SPEC, ta.enc.state_dict()),
                            "dec": tev.jax_from_state(ttr.DECODER_SPEC, ta.dec.state_dict())},
                           3)
        ja = jax_trainer(monkeypatch, jtr.MovementAETrainer,
                         (jev.MovementConvEncoder, jtr.MovementConvDecoder), tree, dim_pose=67)
        ta.load_jax_params(tree)
        batch = np.random.RandomState(6).randn(4, 16, 67).astype(np.float32)
        for _ in range(3):
            assert_losses(ta.update(batch), ja.update(batch))

    def test_text_motion_match_matches_jax(self, monkeypatch):
        """3 steps from carried weights, an empty caption and a clip under
        4 frames (lengths 0 in the GRUs), the shifts from np.random seeded
        alike."""
        move = eval_params(tev.jax_from_state(tev.MOVEMENT_SPEC,
                                              tev.MovementConvEncoder(67).state_dict()), 3)
        tm = ttr.TextMotionMatchTrainer(tev.state_from_jax(tev.MOVEMENT_SPEC, move), dim_pose=67,
                                        device="cpu")
        tree = eval_params({"text": tev.jax_from_state(tev.TEXT_SPEC, tm.text_enc.state_dict()),
                            "motion": tev.jax_from_state(tev.MOTION_SPEC,
                                                         tm.motion_enc.state_dict())}, 4)
        jm = jax_trainer(monkeypatch, jtr.TextMotionMatchTrainer, EVALUATOR_MODULES, tree, move,
                         dim_pose=67)
        tm.load_jax_params(tree)
        r = np.random.RandomState(7)
        batch = dict(word_embs=r.randn(5, 6, 300).astype(np.float32),
                     pos_ohot=r.randn(5, 6, 15).astype(np.float32),
                     cap_lens=np.asarray([6, 5, 4, 3, 0]),
                     motions=r.randn(5, 16, 67).astype(np.float32),
                     m_lens=np.asarray([16, 12, 8, 3, 16]))
        for step in range(3):
            np.random.seed(step)
            want = jm.update(**batch)
            np.random.seed(step)
            assert_losses(tm.update(**batch), want)


# ---------------------------------------------------------------------------
# finest.tar both ways
# ---------------------------------------------------------------------------

def jax_wrapper(path: str):
    """The JAX EvaluatorWrapper loading `path`, its seeded init (which the
    checkpoint replaces) abstract."""
    with pytest.MonkeyPatch.context() as mp:
        abstract_flax_init(mp, *EVALUATOR_MODULES)
        return jev.EvaluatorWrapper("humanml", checkpoint_path=path)


def _embed_inputs():
    rs = np.random.RandomState(8)
    motions = rs.randn(3, 20, 263).astype(np.float32)
    we, po = rs.randn(3, 7, 300).astype(np.float32), rs.randn(3, 7, 15).astype(np.float32)
    return we, po, np.asarray([7, 3, 5]), motions, np.asarray([20, 2, 13])


def test_finest_tar_written_by_the_port_loads_in_jax(tmp_path):
    tw = tev.EvaluatorWrapper("humanml", seed=4, device="cpu")
    trees = {k: eval_params(tev.jax_from_state(spec, getattr(tw, k).state_dict()), s)
             for k, spec, s in (("movement_enc", tev.MOVEMENT_SPEC, 1),
                                ("text_enc", tev.TEXT_SPEC, 2),
                                ("motion_enc", tev.MOTION_SPEC, 3))}
    for k, spec in (("movement_enc", tev.MOVEMENT_SPEC), ("text_enc", tev.TEXT_SPEC),
                    ("motion_enc", tev.MOTION_SPEC)):
        getattr(tw, k).load_state_dict(tev.state_from_jax(spec, trees[k]))
    path = ttr.save_evaluator(str(tmp_path / "finest.tar"), tw.movement_enc, tw.text_enc,
                              tw.motion_enc, epoch=5)
    jw = jax_wrapper(path)
    inputs = _embed_inputs()
    for got, want in zip(tev.EvaluatorWrapper("humanml", checkpoint_path=path, device="cpu")
                         .get_co_embeddings(*inputs), jw.get_co_embeddings(*inputs)):
        np.testing.assert_allclose(got, np.asarray(want), atol=EMB_ATOL)


def test_finest_tar_written_by_jax_loads_in_the_port(tmp_path):
    tw = tev.EvaluatorWrapper("humanml", device="cpu")
    trees = [eval_params(tev.jax_from_state(spec, m.state_dict()), s) for spec, m, s in
             ((tev.MOVEMENT_SPEC, tw.movement_enc, 1), (tev.TEXT_SPEC, tw.text_enc, 2),
              (tev.MOTION_SPEC, tw.motion_enc, 3))]
    path = jtr.save_evaluator(str(tmp_path / "finest.tar"), *trees, epoch=2)
    jw = jax_wrapper(path)
    tw = tev.EvaluatorWrapper("humanml", checkpoint_path=path, device="cpu")
    inputs = _embed_inputs()
    for got, want in zip(tw.get_co_embeddings(*inputs), jw.get_co_embeddings(*inputs)):
        np.testing.assert_allclose(got, np.asarray(want), atol=EMB_ATOL)


# ---------------------------------------------------------------------------
# CompV6 and the length estimator (the mirror of tests/test_arch_variants.py's
# T2M generator cases)
# ---------------------------------------------------------------------------

DIMS = dict(dim_pose=31, dim_z=8, hidden=32, text_hidden=16)


GEN_MODULES = (jgen.TextEncoderBiGRU, jgen.AttLayer, jgen.TextDecoder, jgen.TextVAEDecoder,
               jev.MovementConvEncoder, jtr.MovementConvDecoder)


@pytest.fixture(scope="module")
def gen_pair():
    """(JAX CompV6Generator with numpy-made params, the port's with them)."""
    tg = tgen.CompV6Generator(**DIMS, device="cpu")
    tree = eval_params(tg.jax_params(), 1)
    with pytest.MonkeyPatch.context() as mp:
        jg = jax_trainer(mp, jgen.CompV6Generator, GEN_MODULES, tree, **DIMS)
    return jg, tg.load_jax_params(tree)


def gen_batch():
    r = np.random.RandomState(0)
    B, T = 3, 8  # 2 movement steps
    return (r.randn(B, 6, 300).astype(np.float32), r.randn(B, 6, 15).astype(np.float32),
            np.asarray([6, 4, 3]), r.randn(B, T, 31).astype(np.float32), np.asarray([8, 6, 3]))


def jax_z(key, mov_len: int, B: int, per_step: int):
    """The normals JAX's generate (1 a step) or train step (prior, then
    posterior) draws from `key`: (mov_len, per_step, B, dim_z)."""
    out = []
    for _ in range(mov_len):
        step = []
        for _ in range(per_step):
            key, sub = jax.random.split(key)
            step.append(np.asarray(jax.random.normal(sub, (B, DIMS["dim_z"]))))
        out.append(np.stack(step))
    return torch.from_numpy(np.stack(out))


def _generate_both(jg, params, tg, key, mov_len=2):
    we, po, cl, _, m_lens = gen_batch()
    want = jg.generate(params, jnp.asarray(we), jnp.asarray(po), jnp.asarray(cl),
                       jnp.asarray(m_lens), mov_len, key)
    got = tg.generate(we, po, cl, m_lens, mov_len, z_noise=jax_z(key, mov_len, 3, 1)[:, 0])
    return got, want


class TestCompV6:
    def test_generate_matches_jax(self, gen_pair):
        jg, tg = gen_pair
        got, want = _generate_both(jg, jg.params, tg, jax.random.PRNGKey(9))
        assert got[0].shape == (3, 8, 31) and got[1].shape == (3, 2, 512)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GEN_ATOL)

    def test_train_step_matches_jax(self, gen_pair):
        """3 steps, teacher-forced and free-running (the global numpy coin),
        from carried weights, the z noise pinned."""
        import copy

        jg = copy.copy(gen_pair[0])  # a trainer of its own on the fixture's modules
        jg.params = eval_params(jg.params, 2)
        jg.opt_state = jg.tx.init(jg.params)
        tg = tgen.CompV6Generator(**DIMS, device="cpu").load_jax_params(jg.params)
        we, po, cl, motions, m_lens = gen_batch()
        coins = []
        for step in range(3):
            key = jax.random.PRNGKey(100 + step)
            np.random.seed(step)
            coins.append(np.random.rand() < 0.5)
            np.random.seed(step)
            want = jg.train_step(we, po, cl, motions, m_lens, key, tf_ratio=0.5)
            np.random.seed(step)
            got = tg.train_step(we, po, cl, motions, m_lens, tf_ratio=0.5,
                                noise=jax_z(key, 2, 3, 2))
            assert_losses(got, want)
        assert len(set(coins)) == 2  # both modes ran

    def test_generate_and_train(self):
        gen = tgen.CompV6Generator(**DIMS, device="cpu")
        r = np.random.RandomState(0)
        B, T = 2, 8  # mov_len = 2
        we, po = r.randn(B, 5, 300).astype(np.float32), r.randn(B, 5, 15).astype(np.float32)
        cap_lens, motions = np.asarray([5, 4]), r.randn(B, T, 31).astype(np.float32)
        m_lens = np.asarray([8, 8])
        gens = torch.Generator().manual_seed(0)
        losses = [gen.train_step(we, po, cap_lens, motions, m_lens, generator=gens,
                                 tf_ratio=1.0)["loss"] for _ in range(6)]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        fake, movs, mus = gen.generate(we, po, cap_lens, m_lens, 2, generator=gens)
        assert fake.shape == (B, 8, 31) and movs.shape == (B, 2, 512)
        assert mus.shape == (2 * B, 8)

    def test_length_estimator_matches_jax(self, monkeypatch):
        tl = tgen.LengthEstTrainer(output_size=6, lr=1e-3, device="cpu")
        tree = eval_params(tl.jax_params(), 3)
        jl = jax_trainer(monkeypatch, jgen.LengthEstTrainer, (jgen.MotionLenEstimatorBiGRU,),
                         tree, output_size=6, lr=1e-3)
        tl.load_jax_params(tree)
        we, po, cl, _, m_lens = gen_batch()
        for _ in range(3):
            assert_losses(tl.update(we, po, cl, m_lens), jl.update(we, po, cl, m_lens))

    def test_length_estimator_trains(self):
        tr = tgen.LengthEstTrainer(output_size=10, lr=1e-3, device="cpu")
        r = np.random.RandomState(0)
        we, po = r.randn(8, 6, 300).astype(np.float32), r.randn(8, 6, 15).astype(np.float32)
        m_lens = np.asarray([4, 8, 12, 16, 20, 24, 28, 32])
        losses = [tr.update(we, po, np.full(8, 6), m_lens)["loss"] for _ in range(10)]
        assert losses[-1] < losses[0]

    def test_kl_criterion(self):
        r = np.random.RandomState(1)
        a = [r.randn(4, 8).astype(np.float32) for _ in range(4)]
        np.testing.assert_allclose(float(tgen.kl_criterion(*map(torch.from_numpy, a))),
                                   float(jgen.kl_criterion(*map(jnp.asarray, a))), rtol=1e-5)
        mu = torch.zeros(4, 8)
        assert float(tgen.kl_criterion(mu, mu, mu, mu)) == pytest.approx(0.0)


@pytest.mark.parametrize("module", ["vae_decoder", "prior_decoder", "att", "text_encoder",
                                    "len_estimator"])
def test_t2m_module_matches_jax(module):
    """Each module's forward on carried weights (TextVAEDecoder with two GRU
    layers; the text encoder's word_hids with unsorted lengths)."""
    r = np.random.RandomState(2)
    if module == "vae_decoder":
        jm = jgen.TextVAEDecoder(input_size=32, output_size=16, hidden_size=24, n_layers=2)
        latent, x = r.randn(3, 512).astype(np.float32), r.randn(3, 32).astype(np.float32)
        p = np.asarray([0, 3, 7])
        params = eval_params(abstract_init(jm, jnp.asarray(latent), jnp.asarray(x),
                                           jnp.asarray(0), method=jgen.TextVAEDecoder.full_init),
                             1)
        hidden = jm.apply(params, jnp.asarray(latent), method=jgen.TextVAEDecoder.get_init_hidden)
        want = jm.apply(params, jnp.asarray(x), hidden, jnp.asarray(p))
        tm = tgen.TextVAEDecoder(512, 32, 16, 24, 2)
        tm.load_state_dict(tev.state_from_jax(tm.spec(), params["params"]))
        got = tm(torch.from_numpy(x), tm.get_init_hidden(torch.from_numpy(latent)),
                 torch.from_numpy(p))
        want = (want[0], *want[1])
        got = (got[0], *got[1])
    elif module == "prior_decoder":
        jm = jgen.TextDecoder(input_size=16, output_size=8, hidden_size=24)
        latent, x = r.randn(2, 512).astype(np.float32), r.randn(2, 16).astype(np.float32)
        key = jax.random.PRNGKey(2)
        params = eval_params(abstract_init(jm, jnp.asarray(latent), jnp.asarray(x),
                                           jnp.asarray(0), key,
                                           method=jgen.TextDecoder.full_init), 2)
        hidden = jm.apply(params, jnp.asarray(latent), method=jgen.TextDecoder.get_init_hidden)
        want = jm.apply(params, jnp.asarray(x), hidden, jnp.asarray(5), key)
        want = (*want[:3], *want[3])
        tm = tgen.TextDecoder(512, 16, 8, 24)
        tm.load_state_dict(tev.state_from_jax(tm.spec(), params["params"]))
        noise = torch.from_numpy(np.asarray(jax.random.normal(key, (2, 8))))
        got = tm(torch.from_numpy(x), tm.get_init_hidden(torch.from_numpy(latent)),
                 torch.tensor(5), noise)
        got = (*got[:3], *got[3])
    elif module == "att":
        jm = jgen.AttLayer(value_dim=16)
        q, k = r.randn(2, 8).astype(np.float32), r.randn(2, 5, 12).astype(np.float32)
        params = eval_params(abstract_init(jm, jnp.asarray(q), jnp.asarray(k)), 3)
        want = jm.apply(params, jnp.asarray(q), jnp.asarray(k))
        tm = tgen.AttLayer(8, 12, 16)
        tm.load_state_dict(tev.state_from_jax(tgen.AttLayer.SPEC, params["params"]))
        got = tm(torch.from_numpy(q), torch.from_numpy(k))
        np.testing.assert_allclose(got[1].sum(1).detach().numpy(), 1.0, atol=1e-5)
    else:
        lens = np.asarray([4, 6, 2])
        we, po = r.randn(3, 6, 300).astype(np.float32), r.randn(3, 6, 15).astype(np.float32)
        if module == "text_encoder":
            jm, tm = jgen.TextEncoderBiGRU(hidden_size=32), tgen.TextEncoderBiGRU(hidden_size=32)
            spec = tgen.TextEncoderBiGRU.SPEC
        else:
            jm = jgen.MotionLenEstimatorBiGRU(output_size=7)
            tm = tgen.MotionLenEstimatorBiGRU(output_size=7)
            spec = tgen.MotionLenEstimatorBiGRU.SPEC
        args = (jnp.asarray(we), jnp.asarray(po), jnp.asarray(lens))
        params = eval_params(abstract_init(jm, *args), 4)
        want = jm.apply(params, *args)
        tm.load_state_dict(tev.state_from_jax(spec, params["params"]))
        got = tm(torch.from_numpy(we), torch.from_numpy(po), lens)
        if module == "text_encoder":
            assert got[0].shape == (3, 6, 64) and got[1].shape == (3, 64)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=GEN_ATOL)


# ---------------------------------------------------------------------------
# t2m_generator.pkl both ways
# ---------------------------------------------------------------------------

def _pickle_args():
    return type("A", (), dict(dim_z=DIMS["dim_z"], hidden=DIMS["hidden"],
                              text_hidden=DIMS["text_hidden"]))()


def test_t2m_pickle_written_by_the_port_loads_in_jax(gen_pair, tmp_path):
    from motionstyle_torch.cli.train_t2m_generator import save_t2m

    jg, tg = gen_pair
    tl = tgen.LengthEstTrainer(output_size=5, seed=3, device="cpu")
    path = save_t2m(str(tmp_path / "t2m_generator.pkl"), tg, tl, _pickle_args(), 31, 5)
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    assert {k: ckpt[k] for k in ("dim_pose", "dim_z", "hidden", "text_hidden",
                                 "len_output_size")} == dict(DIMS, len_output_size=5)
    with pytest.MonkeyPatch.context() as mp:
        abstract_flax_init(mp, *GEN_MODULES, jgen.MotionLenEstimatorBiGRU)
        assert_layout(ckpt["generator"], jgen.CompV6Generator(**DIMS).params)
        assert_layout(ckpt["length_estimator"], jgen.LengthEstTrainer(output_size=5).params)
    got, want = _generate_both(jg, ckpt["generator"], tg, jax.random.PRNGKey(4))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GEN_ATOL)
    we, po, cl, _, _ = gen_batch()
    np.testing.assert_allclose(
        tl.logits(we, po, cl).numpy(),
        np.asarray(jgen.MotionLenEstimatorBiGRU(output_size=5).apply(
            {"params": ckpt["length_estimator"]}, jnp.asarray(we), jnp.asarray(po),
            jnp.asarray(cl))), atol=GEN_ATOL)


def test_t2m_pickle_written_by_jax_loads_in_the_port(gen_pair, tmp_path):
    from motionstyle_torch.cli.train_t2m_generator import load_t2m

    jg, _ = gen_pair
    len_tree = eval_params(tgen.LengthEstTrainer(output_size=5, device="cpu").jax_params(), 5)
    path = str(tmp_path / "t2m_generator.pkl")
    with open(path, "wb") as f:  # the JAX CLI's layout (train_t2m_generator.py:129-136)
        pickle.dump({"generator": jax.device_get(jg.params), "length_estimator": len_tree,
                     **DIMS, "len_output_size": 5}, f)
    tg, tl = load_t2m(path, device="cpu")
    got, want = _generate_both(jg, jg.params, tg, jax.random.PRNGKey(6))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GEN_ATOL)
    we, po, cl, _, _ = gen_batch()
    np.testing.assert_allclose(
        tl.logits(we, po, cl).numpy(),
        np.asarray(jgen.MotionLenEstimatorBiGRU(output_size=5).apply(
            {"params": len_tree}, jnp.asarray(we), jnp.asarray(po), jnp.asarray(cl))),
        atol=GEN_ATOL)


# ---------------------------------------------------------------------------
# the training CLIs end to end (the mirror of tests/test_train_evaluator.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def xia_root(tmp_path_factory):
    """tests/test_train_evaluator.py's tiny two-caption corpus."""
    root = tmp_path_factory.mktemp("style_xia_eval")
    (root / "new_joint_vecs").mkdir()
    r = np.random.RandomState(0)
    protos = {"walking": r.randn(181) * 0.8, "jumping": r.randn(181) * 0.8}
    idx = 600
    for content, proto in protos.items():
        for _ in range(6):
            t = np.linspace(0, 2 * np.pi, 48)[:, None]
            clip = proto[None] + 0.3 * np.sin(t + r.uniform(0, 6.28)) + 0.05 * r.randn(48, 181)
            np.save(root / "new_joint_vecs" / f"{idx:03d}neutral_{content}.npy",
                    clip.astype(np.float32))
            idx += 1
    clips = np.concatenate([np.load(root / "new_joint_vecs" / f)
                            for f in os.listdir(root / "new_joint_vecs")])
    np.save(root / "Mean.npy", clips.mean(0).astype(np.float32))
    np.save(root / "Std.npy", np.maximum(clips.std(0), 1e-3).astype(np.float32))
    return str(root)


def test_train_evaluator_cli(xia_root, tmp_path):
    """The port's CLI trains and writes finest.tar, which loads to finite,
    non-degenerate embeddings (the layout crosses to JAX above)."""
    from motionstyle_torch.cli.train_evaluator import main

    path = main(["--dataset", "stylexia_posrot", "--data_dir", xia_root, "--save_dir",
                 str(tmp_path / "ev"), "--batch_size", "4", "--num_frames", "48",
                 "--ae_steps", "3", "--match_steps", "3", "--log_interval", "2",
                 "--device", "cpu"])
    assert os.path.exists(path) and os.path.exists(tmp_path / "ev" / "args.json")
    m = np.random.RandomState(1).randn(4, 48, 181).astype(np.float32)
    lens = np.asarray([48, 48, 44, 40])
    emb = tev.EvaluatorWrapper("stylexia_posrot", checkpoint_path=path,
                               dim_pose=181, device="cpu").get_motion_embeddings(m, lens)
    assert emb.shape == (4, 512) and np.isfinite(emb).all() and np.std(emb) > 1e-4


@pytest.fixture(scope="module")
def hml_root(tmp_path_factory):
    from tests.test_torch_finetune import family_root

    return family_root(tmp_path_factory, "humanml")


def test_train_t2m_generator_cli(hml_root, tmp_path, capsys):
    """The length estimator and CompV6 train through the port's CLI, the
    pickle holds the JAX layout, and --run_eval prints finite metrics."""
    import json

    from motionstyle_torch.cli.train_t2m_generator import main

    path = main(["--dataset", "humanml", "--data_dir", hml_root, "--save_dir",
                 str(tmp_path / "gen"), "--batch_size", "4", "--num_frames", "16",
                 "--gen_steps", "3", "--len_steps", "3", "--hidden", "64", "--text_hidden",
                 "64", "--dim_z", "8", "--log_interval", "10", "--run_eval",
                 "--num_eval_samples", "4", "--device", "cpu"])
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    assert ckpt["dim_pose"] == 263 and ckpt["len_output_size"] == 5
    leaves = jax.tree_util.tree_leaves(ckpt["generator"])
    assert leaves and all(np.isfinite(leaf).all() for leaf in leaves)
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"FID", "matching_score", "diversity"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())


def test_posrot_layout_refused_as_in_jax(xia_root, tmp_path):
    from motionstyle.cli.train_t2m_generator import main as jmain
    from motionstyle_torch.cli.train_t2m_generator import main

    with pytest.raises(SystemExit) as want:
        jmain(["--dataset", "stylexia_posrot", "--data_dir", xia_root, "--save_dir",
               str(tmp_path / "j")])
    with pytest.raises(SystemExit) as got:
        main(["--dataset", "stylexia_posrot", "--data_dir", xia_root, "--save_dir",
              str(tmp_path / "t"), "--device", "cpu"])
    assert str(got.value) == str(want.value)
