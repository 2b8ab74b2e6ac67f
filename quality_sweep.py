"""Run the port's quality protocol at tests/test_quality.py's budgets (latent
64, 2 layers, T=100, prior 1500 steps, finetune 250 at lr 1e-3, checkpoints
every 50, the ladder and the --auto_stop arm) once per corpus and setting,
in parallel processes, and print each run's gate clauses as one JSON line.

The corpus generator seeds from Python's hash() of strings (as the JAX
tool's does), so each PYTHONHASHSEED value writes its own corpus:
--hash_seeds names the corpora. A setting names the kernels the CLIs run:
  kernels        --fused_train 1 --fused 1 (chip_smoke.py's quality phase)
  train_kernels  --fused_train 1 --fused 0
  plain          --fused_train 0 --fused 0 (the plain PyTorch twins)

Run:  python quality_sweep.py [--hash_seeds 1,2,3,4] [--settings kernels,plain]
        [--jobs 4] [--device cuda] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SETTINGS = {"kernels": (True, True), "train_kernels": (True, False), "plain": (False, False)}
BUDGETS = dict(prior_steps=1500, finetune_steps=250, lr=1e-3, save_interval=50,
               ladder=True, auto_stop=True)


def summary(res: dict) -> dict:
    """The gate's clauses (quality_protocol.quality_gate) with the numbers
    they read: [ratio, content] at pre, every rung, every auto evaluation
    and the auto arm's demo."""
    from motionstyle_torch.eval.quality_protocol import quality_gate

    auto = res["auto"]
    clauses = quality_gate(res)
    pair = lambda r: [r["style_dist_ratio"], r["content_similarity"]]  # noqa: E731
    return dict(ok=all(clauses.values()), clauses=clauses, pre=pair(res["pre"]),
                ladder={s: pair(r) for s, r in sorted(res["ladder"].items())},
                trace={s: pair(r) for s, r in sorted(auto["trace"].items(),
                                                     key=lambda kv: int(kv[0]))},
                selected=auto.get("selected_step"),
                demo=auto.get("demo_report") and pair(auto["demo_report"]),
                seconds=res["seconds"])


def one(setting: str, device: str) -> None:
    """One protocol run in this process; its result on a line of its own."""
    import torch

    from motionstyle_torch.eval.quality_protocol import run_protocol

    torch.set_num_threads(1)
    fused_train, fused = SETTINGS[setting]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        res = run_protocol(os.path.join(work, "quality"), fused_train=fused_train, fused=fused,
                           device=device, **BUDGETS)
    out = dict(setting=setting, hash_seed=os.environ.get("PYTHONHASHSEED"),
               wall=time.perf_counter() - t0, **summary(res))
    print("RESULT " + json.dumps(out), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--hash_seeds", default="1,2,3,4")
    p.add_argument("--settings", default="kernels,plain")
    p.add_argument("--jobs", default=4, type=int)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="", help="also write every result to this JSON file")
    p.add_argument("--one", default="", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    if args.one:
        one(args.one, args.device)
        return 0
    settings = args.settings.split(",")
    if args.device == "cuda" and any(SETTINGS[s][0] or SETTINGS[s][1] for s in settings):
        from motionstyle_torch import _build  # build once, before the runs load the libraries

        for name in ("fused_encoder", "fused_encoder_train"):
            _build.build(name)
    runs = [(s, h) for h in args.hash_seeds.split(",") for s in settings]

    def launch(run):
        setting, seed = run
        env = dict(os.environ, PYTHONHASHSEED=seed, OMP_NUM_THREADS="1")
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", setting,
                               "--device", args.device], env=env, cwd=ROOT,
                              capture_output=True, text=True)
        lines = [ln[7:] for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            return dict(setting=setting, hash_seed=seed, ok=False, failed=proc.returncode,
                        stderr=proc.stderr[-2000:])
        return json.loads(lines[-1])

    with ThreadPoolExecutor(args.jobs) as pool:
        results = []
        for r in pool.map(launch, runs):
            results.append(r)
            print(json.dumps(r), flush=True)
    for s in settings:
        mine = [r for r in results if r["setting"] == s]
        print(f"{s}: gate met on {sum(r['ok'] for r in mine)} of {len(mine)} corpora "
              f"(PYTHONHASHSEED {[r['hash_seed'] for r in mine if r['ok']]} met)", flush=True)
    if args.out:
        with open(args.out, "w") as fw:
            json.dump(results, fw, indent=1)
    return 0 if all("failed" not in r for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
