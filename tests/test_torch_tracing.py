"""The port's span and counter recorder (motionstyle_torch/tracing.py) on the
CPU: nothing is recorded outside a profiler session; inside one, spans nest
under the span open on their thread and counters add up; a pretraining
step's four phases cover train.step; copy.h2d_bytes counts what the sampler
and the trainer copy to a CUDA device (the target faked at the helper).
Each test runs under its own time limit."""
import signal
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from motionstyle_torch import tracing
from motionstyle_torch.diffusion.ddpm import Inpainting
from motionstyle_torch.diffusion.schedule import make_schedule
from motionstyle_torch.models.denoiser import MDMConfig, StyleDiffusion
from motionstyle_torch.parallel.inference import Sampler
from motionstyle_torch.train.pretrain import PretrainConfig, PriorTrainer

PHASES = ("train.copy_in", "train.forward", "train.backward", "train.optimizer")
LIMITS = {"test_pretrain_phases_cover_the_step": 20.0,
          "test_h2d_bytes_of_the_sampler_and_the_trainer": 20.0}  # seconds; others 5


@pytest.fixture(autouse=True)
def time_limit(request):
    """Fails the test once it has run LIMITS[its name] seconds, else 5."""
    seconds = LIMITS.get(request.node.originalname, 5.0)

    def expire(signum, frame):
        raise TimeoutError(f"{request.node.name} ran over {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def fresh_recorder():
    tracing.reset()
    yield
    tracing.reset()


def _tiny_model() -> StyleDiffusion:
    torch.manual_seed(0)
    return StyleDiffusion(MDMConfig(njoints=12, nfeats=1, latent_dim=32, ff_size=64,
                                    num_layers=1, num_heads=2, clip_dim=16)).eval()


def _durations(snap, name: str) -> list:
    return [s.end_ns - s.start_ns for s in snap.spans if s.name == name]


def test_nothing_is_recorded_outside_a_profiler_session():
    assert tracing.span("a") is tracing.span("b")  # one shared object, nothing allocated
    with tracing.span("a"):
        tracing.count("c", 3)
        tracing.count_h2d(np.zeros(4, np.float32), torch.device("cuda"))
    assert tracing.snapshot() == ((), ())


def test_spans_nest_and_counters_add_up():
    seen = {}

    def other_thread():
        with tracing.span("thread"):
            pass
        seen["done"] = True

    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer"):
            with tracing.span("inner"):
                tracing.count("c", 2)
            with tracing.span("inner"):
                tracing.count("c", 5)
            t = threading.Thread(target=other_thread)
            t.start()
            t.join(timeout=5)
    assert not t.is_alive() and seen["done"]
    spans, counts = tracing.snapshot()
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
        assert s.start_ns <= s.end_ns
    outer, = by_name["outer"]
    assert outer.parent is None
    assert [s.parent for s in by_name["inner"]] == [outer.id, outer.id]
    assert all(outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns
               for s in by_name["inner"])
    assert by_name["thread"][0].parent is None  # another thread's stack
    assert sum(c.n for c in counts if c.name == "c") == 7
    with tracing.span("after"):  # the session has ended
        pass
    assert len(tracing.snapshot().spans) == len(spans)


def test_pretrain_phases_cover_the_step(tmp_path):
    model = _tiny_model()
    trainer = PriorTrainer(PretrainConfig(save_dir=str(tmp_path), log_interval=0, seed=3),
                           model, make_schedule("cosine", 20, device="cpu"))
    rs = np.random.RandomState(0)
    batch = {"x_start": rs.randn(4, 12, 1, 8).astype(np.float32),
             "enc_text": rs.randn(4, 16).astype(np.float32),
             "mask": np.ones((4, 1, 1, 8), np.float32)}
    trainer.run_step(batch)  # first-call set-up outside the measured steps
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            trainer.run_step(batch)
    snap = tracing.snapshot()
    steps = [s for s in snap.spans if s.name == "train.step"]
    assert len(steps) == 3
    ids = {s.id for s in steps}
    phases = [s for s in snap.spans if s.name in PHASES]
    assert {s.name for s in phases} == set(PHASES)
    # each phase lies directly under its step (train_step's under run_step's)
    assert all(s.parent in ids for s in phases)
    assert len(_durations(snap, "denoiser")) == 3
    step_ns = sum(_durations(snap, "train.step"))
    phase_ns = sum(s.end_ns - s.start_ns for s in phases)
    assert 0.95 * step_ns <= phase_ns <= step_ns


def test_h2d_bytes_arithmetic():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    a64 = np.zeros((3, 5), np.float64)
    assert tracing.h2d_bytes(a64, cuda, torch.float32) == 3 * 5 * 4  # converted on the host
    assert tracing.h2d_bytes(a64, cuda) == 3 * 5 * 8
    assert tracing.h2d_bytes(torch.zeros(2, 7, dtype=torch.bfloat16), "cuda") == 2 * 7 * 2
    assert tracing.h2d_bytes([[1.0, 2.0]], cuda, torch.float32) == 8
    assert tracing.h2d_bytes(a64, cpu, torch.float32) == 0
    assert tracing.h2d_bytes(None, cuda) == 0


def test_h2d_bytes_of_the_sampler_and_the_trainer(monkeypatch, tmp_path):
    """Every array a sampler call stages and every array of a training
    batch is counted once, at float32, with a CUDA target faked."""
    monkeypatch.setattr(tracing, "_cuda_target", lambda device: True)
    model = _tiny_model()
    sched = make_schedule("cosine", 20, "ddim4", device="cpu")
    sampler = Sampler(sched, lambda m: (lambda x, t, c: m(x, t, c["enc_text"])), model,
                      method="ddim", skip_timesteps=1, dump_all_xstart=True)
    rs = np.random.RandomState(1)
    content = rs.randn(3, 12, 1, 8).astype(np.float32)
    mask = np.zeros((3, 12, 1, 8), np.float64)  # converted to float32 before the copy
    enc = rs.randn(3, 16).astype(np.float32)
    batch = {"init_image": content, "cond": {"enc_text": enc},
             "inpainting": Inpainting(mask=mask, motion=content), "item_seeds": [1, 2, 3]}
    with profile(activities=[ProfilerActivity.CPU]):
        sampler(batch)
    snap = tracing.snapshot()
    want = content.nbytes * 2 + mask.size * 4 + enc.nbytes
    assert sum(c.n for c in snap.counts if c.name == "copy.h2d_bytes") == want
    assert len(_durations(snap, "sampler.inputs")) == 1
    assert len(_durations(snap, "sampler.item_noise")) == 1
    assert len(_durations(snap, "sampler.step")) == 3
    assert len(_durations(snap, "denoiser")) == 3

    tracing.reset()
    trainer = PriorTrainer(PretrainConfig(save_dir=str(tmp_path), log_interval=0, seed=3),
                           _tiny_model(), make_schedule("cosine", 20, device="cpu"))
    tb = {"x_start": content.astype(np.float64), "enc_text": enc,
          "mask": np.ones((3, 1, 1, 8), np.float32)}
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.run_step(tb)
    counted = [c.n for c in tracing.snapshot().counts if c.name == "copy.h2d_bytes"]
    assert sorted(counted) == sorted([content.nbytes, enc.nbytes, 3 * 8 * 4])
