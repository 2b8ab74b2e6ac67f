"""Generated-motion datasets for evaluation and the metric evaluation run.

Counterpart of motionstyle/eval/motion_loaders.py (parity:
data_loaders/humanml/motion_loaders/comp_v6_model_dataset.py
CompMDMGeneratedDataset :150-261 and CompV6GeneratedDataset :51-120,
model_motion_loaders.py get_mdm_loader :75, and the T2M evaluation loop
over utils/metrics.py). The noise comes from a torch.Generator where the
JAX package splits a key, and the length draw is torch.multinomial where it
is jax.random.categorical, so the draws differ from the JAX package's for
one seed; every np.random.RandomState(seed) of the JAX module is kept where
it is (the multimodality batch choice, the 32-candidate pools, diversity
and multimodality), so those choices are the same in both packages.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from motionstyle_torch.eval import metrics
from motionstyle_torch.eval.evaluators import EvaluatorWrapper, WordVectorizer


class GeneratedMotionDataset:
    """Sample the prior over a ground-truth loader; store generated clips.

    sample_batch_fn(texts, lengths, shape, generator) -> (B, C, 1, T)
    samples in the dataset's normalized space (a tensor on any device, or an
    array). `generator` is handed to every call (a torch.Generator on the
    sampler's device; a CPU one seeded with `seed` when none is given)."""

    def __init__(self, sample_batch_fn: Callable, ground_truth_loader, mm_num_samples: int = 0,
                 mm_num_repeats: int = 0, num_samples_limit: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        nbatch = len(ground_truth_loader)
        if num_samples_limit is not None:
            nbatch = min(nbatch, num_samples_limit // ground_truth_loader.batch_size + 1)
        if mm_num_samples > 0 and mm_num_repeats > 0:
            # clamped to the batches that exist; mm_num_repeats == 0 would
            # yield no repeats and drop the batch, so it means mm disabled
            n_mm = min(mm_num_samples // ground_truth_loader.batch_size + 1, nbatch)
            mm_idxs = np.sort(np.random.RandomState(seed).choice(nbatch, n_mm, replace=False))
        else:
            mm_idxs = []

        self.generated_motion = []
        self.mm_generated_motion = []
        self.dataset = ground_truth_loader.dataset

        for i, (motion, cond) in enumerate(ground_truth_loader):
            if num_samples_limit is not None and len(self.generated_motion) >= num_samples_limit:
                break
            texts = cond["y"]["text"]
            lengths = np.asarray(cond["y"]["lengths"])
            tokens = tokens_or_fallback(cond, texts)
            is_mm = i in mm_idxs
            mm_motions = []
            for r in range(mm_num_repeats if is_mm else 1):
                sample = sample_batch_fn(texts, lengths, motion.shape, generator)
                sample = (sample.float().cpu().numpy() if torch.is_tensor(sample)
                          else np.asarray(sample))
                entries = [{"motion": sample[b, :, 0, :].T,  # (T, C)
                            "length": int(lengths[b]), "caption": texts[b],
                            "tokens": tokens[b], "cap_len": len(tokens[b])}
                           for b in range(sample.shape[0])]
                if r == 0:
                    self.generated_motion += entries
                if is_mm:
                    mm_motions += entries
            if is_mm:
                B = sample.shape[0]
                self.mm_generated_motion += [
                    {"caption": texts[b], "tokens": tokens[b], "cap_len": len(tokens[b]),
                     "mm_motions": mm_motions[b::B]}
                    for b in range(B)]

    def __len__(self):
        return len(self.generated_motion)

    def __getitem__(self, item):
        d = self.generated_motion[item]
        motion = d["motion"]
        ds = self.dataset
        if hasattr(ds, "mean_for_eval"):
            # re-norm into the T2M evaluator's convention (:246-250)
            denormed = ds.t2m_dataset.inv_transform(motion)
            motion = (denormed - ds.mean_for_eval) / ds.std_for_eval
        return d["caption"], motion, d["length"], d["tokens"], d["cap_len"]


def sample_mov_length(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                      min_mov_length: int = 10, max_draws: int = 3) -> int:
    """Multinomial draw over the length estimator's softmax with up to two
    re-draws when the draw lands below min_mov_length; the final draw is kept
    either way. Parity: comp_v6_model_dataset.py:85-91. `generator` lives on
    the logits' device."""
    probs = torch.softmax(logits.float(), dim=-1)
    length = 0
    for _ in range(max_draws):
        length = int(torch.multinomial(probs, 1, generator=generator))
        if length >= min_mov_length:
            break
    return length


class CompV6GeneratedDataset:
    """Eval dataset for the T2M (CompV6) generator: per-caption lengths drawn
    from the length estimator, motions generated autoregressively at batch 1
    on the generator's device.

    Parity: comp_v6_model_dataset.py CompV6GeneratedDataset :51-120 — length
    distribution from MotionLenEstimatorBiGRU (softmax + multinomial with
    re-draws), m_lens = mov_length * unit_length, multimodality repeats. The
    length draws and the generator's z noise come from one torch.Generator
    on that device, seeded with `seed`."""

    def __init__(self, generator, len_estimator, ground_truth_loader,
                 word_vectorizer: WordVectorizer, mm_num_samples: int = 0,
                 mm_num_repeats: int = 0, min_mov_length: int = 10, seed: int = 0,
                 num_samples_limit: int = 0):
        device = generator.device
        rng = torch.Generator(device=device).manual_seed(seed)
        self.dataset = ground_truth_loader.dataset
        self.generated_motion = []
        self.mm_generated_motion = []

        items = []
        for motion, cond in ground_truth_loader:
            texts = cond["y"]["text"]
            tokens = tokens_or_fallback(cond, texts)
            items += [(texts[b], tokens[b]) for b in range(len(texts))]
            if num_samples_limit and len(items) >= num_samples_limit:
                break
        if num_samples_limit:
            # generation is a batch-1 autoregressive loop: generate only
            # what is consumed
            items = items[:num_samples_limit]
        mm_idxs = set(np.sort(np.random.RandomState(seed).choice(
            len(items), min(mm_num_samples, len(items)), replace=False)).tolist()) \
            if mm_num_samples > 0 else set()

        as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        for i, (caption, tokens) in enumerate(items):
            we, po, cl = embed_texts(word_vectorizer, [tokens])
            logits = len_estimator.logits(we, po, cl)[0]
            is_mm = i in mm_idxs
            mm_motions = []
            for r in range(mm_num_repeats if is_mm else 1):
                mov_length = max(1, sample_mov_length(logits, rng, min_mov_length))
                m_len = mov_length * generator.unit_length
                pred, _, _ = generator.generate(as_t(we), as_t(po), cl, np.asarray([m_len]),
                                                mov_length, generator=rng)
                entry = {"motion": pred[0].cpu().numpy(), "length": m_len,
                         "caption": caption, "tokens": tokens, "cap_len": int(cl[0])}
                if r == 0:
                    self.generated_motion.append(entry)
                if is_mm:
                    mm_motions.append({"motion": entry["motion"], "length": m_len})
            if is_mm:
                self.mm_generated_motion.append(
                    {"caption": caption, "tokens": tokens, "cap_len": int(cl[0]),
                     "mm_motions": mm_motions})

    def __len__(self):
        return len(self.generated_motion)

    def __getitem__(self, item):
        d = self.generated_motion[item]
        return d["caption"], d["motion"], d["length"], d["tokens"], d["cap_len"]


def tokens_or_fallback(cond, texts):
    """Per-batch 'word/POS' token lists: the dataset's tokens when present,
    else plain caption words with the OTHER class (one definition for the
    evaluator's training and the evaluation)."""
    toks = cond["y"].get("tokens")
    if toks is not None:
        return [t.split("_") if isinstance(t, str) else t for t in toks]
    return [[f"{w}/OTHER" for w in t.split(" ")] for t in texts]


def embed_texts(word_vectorizer: WordVectorizer, tokens_list, max_text_len: int = 20):
    """tokens ('word/POS' strings) -> (word_embs, pos_onehots, cap_lens), numpy."""
    B = len(tokens_list)
    embs = np.zeros((B, max_text_len + 2, 300), dtype=np.float32)
    pos = np.zeros((B, max_text_len + 2, 15), dtype=np.float32)
    lens = np.zeros((B,), dtype=np.int32)
    for i, tokens in enumerate(tokens_list):
        tokens = [t for t in tokens if t][: max_text_len]
        tokens = ["sos/OTHER"] + tokens + ["eos/OTHER"]
        lens[i] = len(tokens)
        for j, tok in enumerate(tokens):
            w, p = word_vectorizer[tok]
            embs[i, j] = w
            pos[i, j] = p
    return embs, pos, lens


def evaluate_matching_and_fid(evaluator: EvaluatorWrapper, word_vectorizer: WordVectorizer,
                              gt_items: list, gen_items: list, top_k: int = 3,
                              diversity_times: int = 300, seed: int = 0) -> OrderedDict:
    """The metric suite over (caption, motion (T, C), length, tokens) items:
    FID, R-precision top-1..k, matching score and diversity for the
    ground-truth and the generated sets (the reference's eval loop outputs)."""
    def co_embed(items):
        T = max(x[1].shape[0] for x in items)
        motions = np.stack([_pad_to(x[1], T) for x in items])
        lens = np.asarray([x[2] for x in items])
        order = np.argsort(lens)[::-1]
        motions, lens = motions[order], lens[order]
        tokens = [items[i][3] for i in order]
        we, po, cl = embed_texts(word_vectorizer, tokens)
        return evaluator.get_co_embeddings(we, po, cl, motions, lens)

    gt_text, gt_motion = co_embed(gt_items)
    gen_text, gen_motion = co_embed(gen_items)

    def pooled_rp_and_matching(text_emb, motion_emb, pool: int = 32):
        """T2M protocol: R-precision/matching within shuffled 32-candidate
        pools (chance level 1/32 regardless of the sample count)."""
        n = (len(text_emb) // pool) * pool
        if n == 0:
            n, pool = len(text_emb), len(text_emb)
        order = np.random.RandomState(seed).permutation(len(text_emb))[:n]
        # a pool smaller than top_k can only rank pool candidates; beyond
        # that the cumulative hit rate is saturated
        k_eff = min(top_k, pool)
        rp = np.zeros(top_k)
        match = 0.0
        for s in range(0, n, pool):
            sel = order[s: s + pool]
            rp_part = metrics.calculate_r_precision(text_emb[sel], motion_emb[sel], k_eff,
                                                    sum_all=True)
            rp += np.concatenate([rp_part, np.full(top_k - k_eff, rp_part[-1])])
            match += metrics.calculate_matching_score(text_emb[sel], motion_emb[sel],
                                                      sum_all=True)
        return rp / n, match / n

    out = OrderedDict()
    rp_gt, match_gt = pooled_rp_and_matching(gt_text, gt_motion)
    rp, match = pooled_rp_and_matching(gen_text, gen_motion)
    out["matching_score_gt"] = float(match_gt)
    out["matching_score"] = float(match)
    for k in range(top_k):
        out[f"R_precision_top_{k+1}_gt"] = float(rp_gt[k])
        out[f"R_precision_top_{k+1}"] = float(rp[k])
    mu_gt, cov_gt = metrics.calculate_activation_statistics(gt_motion)
    mu, cov = metrics.calculate_activation_statistics(gen_motion)
    out["FID"] = metrics.calculate_frechet_distance(mu_gt, cov_gt, mu, cov)
    dt = min(diversity_times, len(gen_items) - 1, len(gt_items) - 1)
    if dt <= 0:
        raise ValueError(f"diversity needs >= 2 items per set (gt {len(gt_items)}, "
                         f"gen {len(gen_items)})")
    out["diversity_gt"] = metrics.calculate_diversity(gt_motion, dt,
                                                      rng=np.random.RandomState(seed))
    out["diversity"] = metrics.calculate_diversity(gen_motion, dt,
                                                   rng=np.random.RandomState(seed))
    return out


def evaluate_multimodality(evaluator: EvaluatorWrapper, mm_items: list,
                           mm_num_times: int = 10) -> float:
    """Multimodality over per-caption repeat sets; parity: the eval loop and
    metrics.calculate_multimodality."""
    embs = []
    for entry in mm_items:
        T = max(m["motion"].shape[0] for m in entry["mm_motions"])
        motions = np.stack([_pad_to(m["motion"], T) for m in entry["mm_motions"]])
        lens = np.asarray([m["length"] for m in entry["mm_motions"]])
        embs.append(evaluator.get_motion_embeddings(motions, lens))
    act = np.stack(embs)  # (n_captions, n_repeats, 512)
    return metrics.calculate_multimodality(act, min(mm_num_times, act.shape[1] - 1),
                                           rng=np.random.RandomState(0))


def _pad_to(motion: np.ndarray, T: int) -> np.ndarray:
    if motion.shape[0] >= T:
        return motion[:T]
    return np.concatenate([motion, np.zeros((T - motion.shape[0], motion.shape[1]),
                                            motion.dtype)], axis=0)
