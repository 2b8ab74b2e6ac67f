"""The yardstick's counts."""
from portbench import counts

MDM = {"latent_dim": 512, "ff_size": 1024, "num_layers": 8, "njoints": 263, "nfeats": 1,
       "clip_dim": 512}


def test_inference_layer_at_b64_s197_is_57_97_gflop():
    assert round(counts.layer_flops(64, 197, 512, 1024) / 1e9, 2) == 57.97
    seconds, by, flops, _ = counts.layer_bound(64, 197, 512, 1024)
    assert by == "operations" and abs(seconds - flops / 989e12) < 1e-15
    assert abs(seconds * 1e6 - 58.61) < 0.01


def test_training_is_three_forwards_with_no_recompute():
    f = counts.layer_flops(64, 197, 512, 1024)
    assert counts.train_layer_flops(64, 197, 512, 1024) == 3 * f
    seconds, by, _, nbytes = counts.train_layer_bound(64, 197, 512, 1024)
    assert by == "operations" and nbytes > counts.layer_bytes(64, 197, 512, 1024)
    assert abs(seconds * 1e6 - 175.8) < 0.1


def test_a_guided_step_of_32_clips_is_about_471_gflop():
    step = counts.denoiser_flops(64, 196, MDM)
    assert 8 * counts.layer_flops(64, 197, 512, 1024) < step < 472e9
    assert round(step / 1e9) == 471
