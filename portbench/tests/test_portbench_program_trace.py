"""The readers of the program's own spans and counters (program_trace.py and
the metrics that use it): records outside the harness's traced stretch are
left out, an empty snapshot reads None, and a traced run of each cell on
the CPU reads every metric BENCHMARK.json gives it (copies counted as if
to a card)."""
import time
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from motionstyle_torch import tracing
from portbench import program_trace
from portbench.harness import registry
from portbench.tests import tiny

NEW = ["sampler_self_ms.gen", "sampler_self_ms.transfer", "inputs_ms.transfer",
       "h2d_mb.transfer", "item_noise_ms.transfer", "denoiser_host_ms.gen",
       "denoiser_host_ms.transfer", "text_ms.train", "memo_miss_pct.train", "copy_in_ms.train",
       "forward_ms.train", "backward_ms.train", "optim_ms.train"]


def view(intervals, work=None):
    spans = SimpleNamespace(intervals=intervals, count={"portbench.sampler": 1})
    return SimpleNamespace(spans=spans, work=work or {"steps": 1})


@pytest.fixture(autouse=True)
def fresh_recorder():
    tracing.reset()
    yield
    tracing.reset()


def test_records_outside_the_stretch_are_left_out():
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("train.step"):
            tracing.count("text.memo_hits", 7)
        lo = time.time_ns()
        with tracing.span("train.step"):
            with tracing.span("train.forward"):
                tracing.count("text.memo_hits", 1)
                tracing.count("text.memo_misses", 3)
        hi = time.time_ns()
        with tracing.span("train.step"):
            tracing.count("text.memo_misses", 100)
    r = program_trace.records(view([("portbench.step", lo, hi)]))
    assert r.n("train.step") == 1 and r.n("train.forward") == 1
    assert r.counted("text.memo_hits") == 1 and r.counted("text.memo_misses") == 3
    assert registry.metric("memo_miss_pct.train").read(
        view([("portbench.step", lo, hi)]), "train") == 75.0


@pytest.mark.parametrize("metric", NEW)
def test_an_empty_snapshot_reads_none(metric):
    t = time.time_ns()
    assert registry.metric(metric).read(view([("portbench.sampler", t - 10**9, t)]), "x") is None
    assert registry.metric(metric).read(view([]), "x") is None


@pytest.mark.parametrize("name", ["humanml_generate", "xia_transfer", "humanml_transfer",
                                  "xia_pretrain"])
def test_a_traced_run_reads_every_new_metric_of_its_cell(name, monkeypatch):
    monkeypatch.setattr(tracing, "_cuda_target", lambda device: True)  # copies are counted
    result, _ = tiny.run(name, seed=2147483659, trace=True)
    want = [m for m in registry.cell(name)["per_layer"] if m in NEW]
    assert want and all(m in result["metrics"] for m in want), result["metrics"]
    got = {m: result["metrics"][m]["value"] for m in want}
    assert all(v >= 0 for v in got.values()), got
    if name == "xia_pretrain":
        assert 0 < got["forward_ms.train"] and 0 < got["backward_ms.train"]
