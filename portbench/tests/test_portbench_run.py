"""run.py finds no card here: it exits non-zero and prints no result, and
so it does in a directory holding only BENCHMARK.json and portbench/."""
import os
import shutil
import subprocess
import sys

from portbench.harness import registry

ROOT = os.path.dirname(registry.HOME)
ARGS = ["--workload", "xia_transfer", "--seed", "2147483700", "--seconds", "1", "--trace", "0"]


def run_in(root: str):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=root,
                          capture_output=True, text=True, timeout=300)


def test_no_card_means_no_result():
    p = run_in(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_without_the_program_there_is_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(registry.HOME, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run_in(str(tmp_path))
    assert p.returncode != 0 and p.stdout.strip() == ""
