"""Every part is found by its name, a new cell, configuration, mix or
metric needs new files and BENCHMARK.json entries only, and BENCHMARK.json
agrees with the cell files."""
import json
import os
import re
import shutil

import pytest

from portbench.harness import cell, registry

ROOT = os.path.dirname(registry.HOME)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", [w["name"] for w in bench()["workloads"]])
def test_each_cell_finds_its_parts(name):
    c, cfg, mix = cell.resolve(name)
    assert cfg["name"] == c["config"] and mix["name"] == c["traffic"]
    assert hasattr(registry.driver(c["driver"]), "Driver")
    for metric in c["per_layer"]:
        reader = registry.metric(metric)
        assert UNIT.match(reader.UNIT) and callable(reader.read)
    assert c["chips"] in (1, 4) and len(c["why"]) <= 200
    assert "setup_s" in c["end_to_end"] and len(c["end_to_end"]) >= 2 and c["per_layer"]
    assert set(registry.load("workloads", name)) == {"name", "driver", "check"}


@pytest.mark.parametrize("family", ["k1", "ktrain"])
def test_kernel_families_hold_patterns(family):
    pats = registry.kernel_patterns(family)
    assert pats and all(isinstance(p, str) and re.compile(p) for p in pats)


def test_benchmark_json_agrees_with_the_cell_files():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    per = {m["name"]: m for m in b["per_layer"]}
    for m in list(e2e.values()) + list(per.values()):
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
        assert set(m.get("workloads", [])) <= cells, m["name"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in per.values():
        assert m["workloads"] and m["unit"] == registry.metric(m["name"]).UNIT
        assert all(w in e2e[m["moves"]].get("workloads", [w]) for w in m["workloads"])
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"])) and c["reduced"] == []
        assert registry.load("configs", c["name"])["source"] == c["source"]
    assert {w["config"] for w in b["workloads"]} == {c["name"] for c in b["configs"]}


def test_a_new_cell_config_mix_and_metric_are_picked_up_as_files(tmp_path, monkeypatch):
    """Files and BENCHMARK.json entries only: no file that is there changes
    but BENCHMARK.json."""
    home = tmp_path / "portbench"
    shutil.copytree(registry.HOME, home, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    cfg = json.loads((home / "configs" / "mdm_xia.json").read_text())
    (home / "configs" / "mdm_xia_copy.json").write_text(json.dumps(cfg))
    b["configs"].append(dict(b["configs"][1], name="mdm_xia_copy",
                             file="portbench/configs/mdm_xia_copy.json"))
    mix = json.loads((home / "traffic" / "library_transfer_b64.json").read_text())
    (home / "traffic" / "library_transfer_b32.json").write_text(json.dumps(dict(mix, clips=32)))
    (home / "workloads" / "xia_transfer_b32.json").write_text(
        (home / "workloads" / "xia_transfer.json").read_text())
    b["workloads"].append({"name": "xia_transfer_b32", "config": "mdm_xia_copy",
                           "traffic": "library_transfer_b32", "chips": 1, "why": "a test"})
    (home / "metrics" / "calls_seen.transfer.py").write_text(
        'UNIT = "calls"\n\ndef read(m, variant):\n    return m.work.get("steps")\n')
    for m in b["end_to_end"] + b["per_layer"]:
        if "xia_transfer" in m.get("workloads", []):
            m["workloads"].append("xia_transfer_b32")
    b["per_layer"].append({"name": "calls_seen.transfer", "unit": "calls", "better": "higher",
                           "source": "program_counter", "layer": "sampler",
                           "moves": "transfer_clips_per_s", "workloads": ["xia_transfer_b32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(registry, "HOME", str(home))
    got, cfg2, mix2 = cell.resolve("xia_transfer_b32")
    assert cfg2["name"] == "mdm_xia_copy" and mix2["clips"] == 32
    assert got["end_to_end"] == ["transfer_clips_per_s", "setup_s"]
    assert got["per_layer"][-1] == "calls_seen.transfer"
    assert "calls_seen.transfer" not in cell.resolve("xia_transfer")[0]["per_layer"]
    reader = registry.metric("calls_seen.transfer")
    assert reader.UNIT == "calls" and reader.read(type("V", (), {"work": {"steps": 3}}), "") == 3
    assert registry.metric("idle_pct.anything").UNIT == "%"  # the family's reader
