"""The plain reference agrees with the port at a tiny width on the CPU:
with the program computing in fp32 on its plain layers, every number a
cell's check compares reads rounding; the parts the reference works out
again (weights' layout, schedule, mask, batches) equal the program's."""
import os
import random

import numpy as np
import pytest
import torch

from portbench.harness import program, traffic, weights
from portbench.reference import diffusion as ref_diff
from portbench.reference import loader as ref_loader
from portbench.tests import tiny


@pytest.mark.parametrize("cell", ["humanml_generate", "xia_transfer", "humanml_transfer",
                                  "xia_pretrain"])
def test_fp32_program_meets_the_reference(cell):
    result, rows = tiny.run(cell, seed=2147483659, **tiny.FP32)
    values = tiny.checks(rows)
    assert values and all(v < 2e-5 for v in values.values()), values  # fp32 rounding
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("name", ["mdm_humanml", "mdm_xia"])
def test_the_weight_layout_is_the_programs(name):
    from motionstyle_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
    from motionstyle_torch.models.denoiser import StyleDiffusion

    from portbench.harness import registry

    cfg = registry.load("configs", name)
    with torch.device("meta"):
        model = StyleDiffusion(program.mdm_config(cfg))
        clip = ClipTextEncoder(ClipTextConfig())
    for module, layout in ((model, weights.style_diffusion_layout(cfg)),
                           (clip, weights.clip_layout(cfg["clip"]))):
        have = {k: tuple(p.shape) for k, p in module.named_parameters()}
        assert have == {k: tuple(s) for k, s, _ in layout}


def test_weights_repeat_for_a_seed_and_differ_across_seeds():
    layout = weights.style_diffusion_layout(dict(tiny.CONFIG, njoints=7, nfeats=1))
    a, b = weights.draw(layout, 11, "cpu"), weights.draw(layout, 11, "cpu")
    c = weights.draw(layout, 12, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["mdm.embed_text.weight"], c["mdm.embed_text.weight"])


@pytest.mark.parametrize("respacing", [None, "ddim20"])
def test_the_schedule_is_the_programs(respacing):
    from motionstyle_torch.diffusion.schedule import make_schedule

    p = make_schedule("cosine", 1000, respacing, device="cpu")
    r = ref_diff.Schedule(1000, respacing, "cpu")
    for mine, theirs in ((r.coef1, p.posterior_mean_coef1), (r.coef2, p.posterior_mean_coef2),
                         (r.log_var, p.posterior_log_variance_clipped),
                         (r.sqrt_ac, p.sqrt_alphas_cumprod), (r.ac_prev, p.alphas_cumprod_prev)):
        assert torch.equal(mine, theirs)
    assert torch.equal(r.tmap, p.timestep_map)


@pytest.mark.parametrize("dataset,channels", [("stylexia_posrot", 181), ("humanml", 263)])
def test_root_horizontal_is_the_programs(dataset, channels):
    from motionstyle_torch.data.masks import get_inpainting_mask

    want = get_inpainting_mask("root_horizontal", (1, channels, 1, 9), dataset=dataset)[0]
    assert np.array_equal(traffic.inpainting_mask("root_horizontal", channels, 9), want)


def test_the_batches_are_the_programs(tmp_path):
    from motionstyle_torch.data.collate import get_dataset_loader

    from portbench.harness import registry

    mix = {"corpus": {"layout": "humanml", "clips": 32, "captions_per_clip": 4,
                      "min_frames": 40, "max_frames": 196},
           "grammar": registry.load("traffic", "guided_ddpm_b32")["grammar"]}
    root = str(tmp_path / "data")
    traffic.write_humanml_corpus(root, 3, mix, 263)
    assert len(os.listdir(os.path.join(root, "texts"))) == 32
    random.seed(77)
    loader = get_dataset_loader("humanml", 8, 196, split="train", data_root=root)
    theirs = (b for _ in range(2) for b in loader)  # two passes, as the driver's loop
    mine = iter(ref_loader.Batches(root, 8, 77))
    for motion, cond in theirs:
        x, texts, mask = next(mine)
        assert np.array_equal(motion.astype(np.float32), x)
        assert list(cond["y"]["text"]) == texts
        assert np.array_equal(cond["y"]["mask"][:, :1, :1, :].astype(np.float32), mask)


def test_the_xia_split_is_the_programs(tmp_path):
    from motionstyle_torch.data.collate import get_dataset_loader
    from motionstyle_torch.data.datasets import STYLEXIA_TEST_LIST

    assert ref_loader.XIA_TEST == tuple(STYLEXIA_TEST_LIST)
    root = str(tmp_path / "data")
    mix = {"corpus": {"layout": "xia", "clips": 320, "min_frames": 20, "max_frames": 90}}
    traffic.write_xia_corpus(root, 4, mix, 181)  # clip 309 is 409proud_punching, held out
    random.seed(5)
    theirs = get_dataset_loader("stylexia_posrot", 16, 76, split="train", data_root=root)
    mine = ref_loader.Batches(root, 16, 5, 76, "xia")
    assert len(theirs.dataset) == len(mine.clips)
    for (motion, cond), (x, texts, mask) in zip(theirs, mine):
        assert np.array_equal(motion.astype(np.float32), x)
        assert list(cond["y"]["text"]) == texts
        assert np.array_equal(cond["y"]["mask"][:, :1, :1, :].astype(np.float32), mask)
