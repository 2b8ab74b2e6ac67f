#!/usr/bin/env python3
"""Request latency of the port's HTTP serving on one NVIDIA GPU, at the
served model's full width (d=512, 8 layers, 4 heads, ff 1024; Xia clips of
76 frames; DDIM-20 from step 700, stopped at t=4), as a client sees it.

    python3 serve_bench.py [--requests N] [ROOT ...]
    python3 serve_bench.py --cpu        # a rehearsal at 1 layer, width 64

Each server is the serve CLI (build_engine behind MotionServer) in a process
of its own; the client is this process. A comparison starts its servers
together, gives each WARM_WAVES uncounted waves, then sends waves of 4
concurrent /v1/sample requests to each server in turn, wave by wave (the
first server of a wave alternates), so that a drift of the host's speed
falls on every server alike; N requests a server, p50 and p95 over all of
them. Request i of a wave series takes seed i. The prior is
tests/goldens/mdm_model.npz's; the style encoders are seeded.

Each ROOT is a checkout of the repository (default: the directory of this
script), e.g. a `git archive` of the parent commit unpacked into a
git-ignored directory, then this one. The comparisons:

- single style, every ROOT (--fused 1, then --quant_int8 1);
- in the last ROOT (named styles, /v1/stream and artifacts exist from that
  slice on), under --deterministic 1: one style against two named styles
  (--styles a=..,b=..; requests ask for a and b in turn); then
  STREAM_REQUESTS requests of a STREAM_FRAMES-frame clip (5 windows of 76
  at overlap 10) on /v1/stream of the two-style server, one at a time, each
  followed by /v1/sample of the same clip and seed (time to the first chunk,
  to the done line, and of the whole answer; the drained chunks must equal
  it); then cli.export_model --platforms cuda (--fused 1, then --quant_int8
  1; its seconds and size) and serve --artifact against live serving of the
  same checkpoint, the answers for the same seeds compared.

Every server reports the kernel 1 and kernel 2 launches of each of its
device batches and its engine's counters when it stops. Prints the card's
name and power limit first and last.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
WARM_WAVES = 2  # waves of 4 a server answers before any is counted
STREAM_FRAMES = 300
STREAM_REQUESTS = 16
FLAGS = ("--fused", "--quant_int8")
# a rehearsal on the CPU: the plain twins at 1 layer, width 64, ddim5
CPU_FLAGS = ["--layers", "1", "--latent_dim", "64", "--diffusion_steps", "40",
             "--skip_steps", "28", "--timestep_respacing", "ddim5"]


def card_name(cpu: bool) -> str:
    if cpu:
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def summary(lat) -> str:
    import numpy as np

    lat = np.asarray(lat, np.float64)
    return (f"{lat.size} requests: p50 {np.percentile(lat, 50):.4f} ms, p95 "
            f"{np.percentile(lat, 95):.4f} ms (min {lat.min():.4f}, max {lat.max():.4f})")


def post(base: str, path: str, payload: dict) -> tuple:
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        res = json.load(r)
    return res, (time.perf_counter() - t0) * 1e3


def contents_for(seed: int, frames: int = 76, n: int = 8) -> list:
    import numpy as np

    rng = np.random.RandomState(seed)
    return [rng.randn(frames, 181).astype(np.float32) * 0.5 for _ in range(n)]


# -- a server process --------------------------------------------------------

def serve_child(root: str, argv: list) -> None:
    """The serve CLI for argv in checkout `root`, warmed up; prints its port,
    answers until its standard input closes, then prints a RESULT line with
    each device batch's (kernel 1, kernel 2) launches and the engine's
    counters."""
    import numpy as np

    sys.path.insert(0, root)
    os.chdir(root)
    from motionstyle_torch.cli import serve
    from motionstyle_torch.ops import fused_encoder as fe
    from motionstyle_torch.serve.server import MotionServer

    built = serve.build_engine(serve.parse_args(argv))
    engine, decode, handle = built[:3]
    kw = {"stream": built[3]} if len(built) > 3 else {}
    engine.warmup(decode({"content": np.zeros((76, 181), np.float32)}), log=False)
    server = MotionServer(engine, port=0, decode=decode, handle=handle,
                          **kw).start_background()
    per_batch, run = [], engine._run

    def counted(items):
        n1, n2 = fe.fused_encoder_layer.launches, fe.fused_encoder_layer_int8.launches
        out = run(items)
        per_batch.append((fe.fused_encoder_layer.launches - n1,
                          fe.fused_encoder_layer_int8.launches - n2))
        return out

    engine._run = counted
    print(f"PORT {server.port}", flush=True)
    sys.stdin.read()
    server.close()
    print("RESULT " + json.dumps({"launches_per_batch": sorted(set(per_batch)),
                                  "batches": len(per_batch), "engine": engine.stats()}),
          flush=True)


class Server:
    """A serve_child process."""

    def __init__(self, label: str, root: str, argv: list, cpu: bool):
        self.label = label
        self.proc = subprocess.Popen(
            [sys.executable, __file__, *(["--cpu"] if cpu else []), "--serve", root, *argv],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.base = None

    def wait_ready(self) -> None:
        for line in self.proc.stdout:
            if line.startswith("PORT "):
                self.base = f"http://127.0.0.1:{int(line.split()[1])}"
                return
        raise RuntimeError(f"{self.label}: the server exited with {self.proc.wait()}")

    def stop(self) -> dict:
        """Close the server; its RESULT, or {} if it died."""
        if self.proc.poll() is None:
            self.proc.stdin.close()
        out = self.proc.stdout.read()
        self.proc.wait(timeout=120)
        for line in out.splitlines():
            if line.startswith("RESULT "):
                return json.loads(line[len("RESULT "):])
        return {}


def start(specs: list, cpu: bool) -> list:
    """Start every (label, root, argv) server together; wait until each
    serves. Stops them all if one fails."""
    servers = [Server(label, root, argv, cpu) for label, root, argv in specs]
    try:
        for s in servers:
            s.wait_ready()
    except BaseException:
        stop(servers)
        raise
    return servers


def stop(servers: list) -> dict:
    """Stop every server; print and return each one's RESULT."""
    out = {}
    for s in servers:
        try:
            out[s.label] = res = s.stop()
        except Exception:  # noqa: BLE001 — stop the others all the same
            s.proc.kill()
            raise
        eng = res.get("engine", {})
        print(f"  {s.label}: (kernel 1, kernel 2) launches per device batch "
              f"{res.get('launches_per_batch')} over {res.get('batches')} batches; engine "
              f"mean batch {eng.get('mean_batch_size', 0):.4f}, batch p50 "
              f"{eng.get('batch_p50_ms', 0):.4f} ms, latency p50 "
              f"{eng.get('latency_p50_ms', 0):.4f} ms (last {eng.get('window')})", flush=True)
    return out


# -- the client --------------------------------------------------------------

def wave(base: str, contents: list, first: int, styles: tuple, results: dict) -> list:
    """Requests first..first+3 at once; their latencies in ms."""
    import numpy as np

    lat, lock = [], threading.Lock()

    def client(i):
        payload = {"content": contents[i % len(contents)].tolist(),
                   "text": "a person walks angrily", "seed": i}
        if styles[i % len(styles)] is not None:
            payload["style"] = styles[i % len(styles)]
        res, ms = post(base, "/v1/sample", payload)
        with lock:
            results[i] = np.asarray(res["motion"], np.float32)
            lat.append(ms)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(first, first + 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads) or len(lat) != 4:
        raise RuntimeError(f"requests {first}..{first + 3} not all answered")
    return lat


def compare(servers: list, contents: list, n: int, styles: dict) -> dict:
    """WARM_WAVES uncounted waves each, then n requests each in waves of 4,
    the servers taking turns wave by wave. Returns {label: {seed: motion}}."""
    import numpy as np

    for s in servers:
        for w in range(WARM_WAVES):
            wave(s.base, contents, 4 * w, styles.get(s.label, (None,)), {})
    results = {s.label: {} for s in servers}
    lat = {s.label: [] for s in servers}
    busy = {s.label: 0.0 for s in servers}
    for w in range(n // 4):
        turn = servers if w % 2 == 0 else servers[::-1]
        for s in turn:
            t0 = time.perf_counter()
            lat[s.label] += wave(s.base, contents, 4 * w, styles.get(s.label, (None,)),
                                 results[s.label])
            busy[s.label] += time.perf_counter() - t0
    for s in servers:
        print(f"  {s.label}: {summary(lat[s.label])}; "
              f"{len(lat[s.label]) / busy[s.label]:.4f} clips/s", flush=True)
        for motion in results[s.label].values():
            if motion.shape != (181, 1, 76) or not np.isfinite(motion).all():
                raise RuntimeError(f"{s.label}: an answer of shape {motion.shape}, finite "
                                   f"{np.isfinite(motion).all()}")
    return results


def stream_against_sample(base: str) -> None:
    import numpy as np

    clip = contents_for(2, STREAM_FRAMES, 1)[0]
    firsts, wholes, samples = [], [], []
    for seed in range(STREAM_REQUESTS):
        payload = {"content": clip.tolist(), "text": "a person walks angrily", "seed": seed,
                   "style": "a"}
        req = urllib.request.Request(base + "/v1/stream", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        chunks, first, t0 = [], None, time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            for raw in r:
                obj = json.loads(raw)
                if "error" in obj:
                    raise RuntimeError(f"/v1/stream: {obj['error']}")
                if obj.get("done"):
                    break
                if first is None:
                    first = (time.perf_counter() - t0) * 1e3
                chunks.append(np.asarray(obj["motion"], np.float32))
        wholes.append((time.perf_counter() - t0) * 1e3)
        firsts.append(first)
        res, ms = post(base, "/v1/sample", payload)
        samples.append(ms)
        if not np.array_equal(np.concatenate(chunks, axis=-1),
                              np.asarray(res["motion"], np.float32)):
            raise RuntimeError("/v1/stream drained differs from /v1/sample")
    print(f"  /v1/stream of {STREAM_FRAMES} frames ({len(chunks)} chunks), first chunk: "
          f"{summary(firsts)}", flush=True)
    print(f"  /v1/stream, done line: {summary(wholes)}", flush=True)
    print(f"  /v1/sample of the same clip: {summary(samples)}", flush=True)
    print(f"  first chunk / done line, per request: median "
          f"{np.median(np.asarray(firsts) / np.asarray(wholes)):.4f}", flush=True)


def export_child(root: str, argv: list) -> None:
    sys.path.insert(0, root)
    os.chdir(root)
    from motionstyle_torch.cli import export_model

    t0 = time.perf_counter()
    export_model.main(argv)
    print("RESULT " + json.dumps({"seconds": time.perf_counter() - t0}), flush=True)


def export(root: str, argv: list, cpu: bool) -> float:
    """cli.export_model in a process of its own -> its seconds in main()."""
    run = subprocess.run([sys.executable, __file__, *(["--cpu"] if cpu else []), "--export",
                          root, *argv], capture_output=True, text=True)
    for line in run.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])["seconds"]
    raise RuntimeError(f"export failed: {run.stdout[-2000:]} {run.stderr[-4000:]}")


def style_checkpoints(root: str, tmp: str, width: int, layers: int) -> tuple:
    """Two seeded style encoders written as finetune checkpoints."""
    sys.path.insert(0, root)
    import torch

    from motionstyle_torch.models.denoiser import MDMConfig, StyleDiffusion
    from motionstyle_torch.models.params import export_style_encoder, seeded_init_

    paths = []
    for i, name in enumerate(("a", "b")):
        path = os.path.join(tmp, f"style_{name}", "model000000000.pt")
        os.makedirs(os.path.dirname(path))
        torch.save(export_style_encoder(seeded_init_(StyleDiffusion(MDMConfig(
            njoints=181, nfeats=1, latent_dim=width, num_layers=layers)), 11 + i)), path)
        paths.append(path)
    return tuple(paths)


def bench(roots: list, requests: int, cpu: bool, tmp: str) -> None:
    import numpy as np
    import torch

    device = "cpu" if cpu else "cuda"
    model = ["--dataset", "stylexia_posrot", "--device", device]
    if cpu:
        model += CPU_FLAGS
    else:
        g = np.load(os.path.join(HERE, "tests", "goldens", "mdm_model.npz"))
        mdm = os.path.join(tmp, "mdm_golden.pt")
        torch.save({k[len("sd__"):]: torch.as_tensor(g[k]) for k in g.files
                    if k.startswith("sd__")}, mdm)
        model += ["--mdm_path", mdm]
    server = model + ["--max_wait_ms", "20", "--port", "0"]
    label = {r: os.path.relpath(r) for r in roots}

    # single style: no style checkpoint ships with the repo, a seeded one
    seeded = ["--model_path", os.path.join(tmp, "model000000000.pt")]
    for flag in FLAGS:
        print(f"=== single style {flag} 1", flush=True)
        servers = start([(label[r], r, server + seeded + [flag, "1"]) for r in roots], cpu)
        try:
            compare(servers, contents_for(0), requests, {})
        finally:
            stop(servers)

    change = roots[-1]
    a, b = style_checkpoints(change, tmp, *((64, 1) if cpu else (512, 8)))
    det = server + ["--deterministic", "1", "--fused", "1", "--model_path", a]
    print("=== named styles and /v1/stream (--fused 1 --deterministic 1)", flush=True)
    servers = start([("one style", change, det),
                     ("two styles a, b", change, det + ["--styles", f"a={a},b={b}"])], cpu)
    try:
        compare(servers, contents_for(1), requests, {"two styles a, b": ("a", "b")})
        stream_against_sample(servers[1].base)
    finally:
        stop(servers)

    for flag, value in ((("--fused", "0"),) if cpu else ((f, "1") for f in FLAGS)):
        print(f"=== artifact against live ({flag} {value} --deterministic 1)", flush=True)
        path = os.path.join(tmp, f"artifact_{flag[2:]}")
        secs = export(change, model + ["--model_path", a, flag, value, "--platforms", device,
                                       "--output", path], cpu)
        size = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(path)
                   for f in fs)
        print(f"  export: {secs:.4f} s, {size / 1e6:.4f} MB", flush=True)
        live = server + ["--deterministic", "1", "--model_path", a, flag, value]
        art = server + ["--deterministic", "1", "--artifact", path]
        servers = start([("live", change, live), ("artifact", change, art)], cpu)
        try:
            got = compare(servers, contents_for(3), requests, {})
        finally:
            stop(servers)
        diff = max(float(np.abs(got["artifact"][k] - got["live"][k]).max())
                   for k in got["live"])
        print(f"  artifact against live, same seeds: max_abs {diff:.6g}", flush=True)


def main() -> int:
    argv = sys.argv[1:]
    cpu = "--cpu" in argv
    argv = [a for a in argv if a != "--cpu"]
    if argv[:1] == ["--serve"]:
        serve_child(argv[1], argv[2:])
        return 0
    if argv[:1] == ["--export"]:
        export_child(argv[1], argv[2:])
        return 0
    requests = 16 if cpu else 256
    if argv[:1] == ["--requests"]:
        requests, argv = int(argv[1]), argv[2:]
    roots = [os.path.abspath(r) for r in argv] or [HERE]
    print(card_name(cpu), flush=True)
    if not cpu:
        build = ("import sys; from concurrent.futures import ThreadPoolExecutor as Pool; "
                 "sys.path.insert(0, sys.argv[1]); from motionstyle_torch import _build; "
                 "list(Pool(2).map(_build.build, ('fused_encoder', 'fused_encoder_int8')))")
        procs = [subprocess.Popen([sys.executable, "-c", build, r]) for r in roots]
        if any(p.wait() != 0 for p in procs):
            return 1
    with tempfile.TemporaryDirectory() as tmp:
        bench(roots, requests, cpu, tmp)
    print(card_name(cpu), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
