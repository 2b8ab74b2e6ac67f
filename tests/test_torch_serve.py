"""The port's serving slice on the CPU: the batcher, the engine's
batching-invariance contract, the serving CLI over HTTP on localhost, and
the package's independence from JAX."""
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from motionstyle_torch.diffusion.schedule import make_schedule
from motionstyle_torch.models.denoiser import MDMConfig, StyleDiffusion
from motionstyle_torch.models.params import seeded_init_
from motionstyle_torch.parallel.inference import Sampler
from motionstyle_torch.serve.batcher import DynamicBatcher, bucket_for
from motionstyle_torch.serve.engine import Request, ServingEngine
from tests.test_torch_models import one_torch_thread  # noqa: F401

ITEM = (12, 1, 8)


@pytest.fixture(scope="module")
def engine():
    cfg = MDMConfig(njoints=12, nfeats=1, latent_dim=16, ff_size=32, num_layers=1,
                    num_heads=2, clip_dim=16)
    model = seeded_init_(StyleDiffusion(cfg), 0).eval()
    sched = make_schedule("cosine", 40, "ddim10", device="cpu")
    sampler = Sampler(sched, lambda m: (lambda x, t, c: m(x, t, c.get("enc_text"))), model,
                      method="ddim", skip_timesteps=3, stop_timesteps=2, dump_all_xstart=True)
    eng = ServingEngine(sampler, ITEM, max_batch=8, max_wait_ms=50, buckets=(1, 2, 4, 8))
    yield eng
    eng.close()


def _request(seed, rng_data=0):
    r = np.random.RandomState(rng_data)
    mask = np.zeros(ITEM, np.float32)
    mask[:3] = 1.0
    return Request({"enc_text": r.randn(16).astype(np.float32)},
                   init_image=r.randn(*ITEM).astype(np.float32),
                   inpainting_mask=mask, seed=seed)


class TestBatcher:
    def test_bucket_for(self):
        assert [bucket_for(n, (1, 2, 4, 8)) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 8]

    def test_coalesces_concurrent_requests(self):
        seen = []

        def run(items):
            seen.append(len(items))
            return [i * 2 for i in items]

        b = DynamicBatcher(run, max_batch=4, max_wait_ms=100)
        try:
            futs = [b.submit(i) for i in range(4)]
            assert [f.result(timeout=10) for f in futs] == [0, 2, 4, 6]
            assert seen == [4]
        finally:
            b.close()


class TestEngine:
    def test_same_bucket_invariance(self, engine):
        """A request agrees with itself in two batches of one bucket, with
        other companions at other positions."""
        a = [engine.submit(_request(s, rng_data=s)) for s in (3, 5, 9, 4)]
        b = [engine.submit(_request(s, rng_data=s)) for s in (6, 7, 3, 8)]
        ra = [f.result(timeout=60) for f in a]
        rb = [f.result(timeout=60) for f in b]
        np.testing.assert_array_equal(ra[0], rb[2])

    def test_batched_equals_solo(self, engine):
        solo = {s: engine.sample(_request(s, rng_data=s)) for s in (3, 5, 9)}
        futs = [engine.submit(_request(s, rng_data=s)) for s in (3, 5, 9)]
        for s, f in zip((3, 5, 9), futs):
            np.testing.assert_allclose(f.result(timeout=60), solo[s], rtol=2e-5, atol=1e-6)

    def test_deterministic_per_seed(self, engine):
        a = engine.sample(_request(7))
        np.testing.assert_array_equal(a, engine.sample(_request(7)))
        assert np.abs(a - engine.sample(_request(8))).max() > 1e-4

    def test_root_channels_preserved(self, engine):
        req = _request(11, rng_data=4)
        out = engine.sample(req)
        assert out.shape == ITEM and np.isfinite(out).all()
        np.testing.assert_array_equal(out[:3], req.init_image[:3])

    def test_item_noise_depends_only_on_seed(self, engine):
        n1, s1 = engine.sampler.item_noise([3, 4], ITEM)
        n2, _ = engine.sampler.item_noise([9, 3], ITEM)
        assert s1 is None  # DDIM eta=0 consumes no step noise
        torch.testing.assert_close(n1[0], n2[1], rtol=0, atol=0)
        assert not torch.equal(n1[0], n1[1])

    def test_bad_shapes_rejected(self, engine):
        req = _request(1)
        req.init_image = req.init_image[:, :, :5]
        with pytest.raises(ValueError, match="shape"):
            engine.submit(req)

    def test_unknown_style_rejected(self, engine):
        """As the JAX engine: a request naming a style that is not
        registered is refused, never served with the default model."""
        bad = _request(1)
        bad.style = "nope"
        with pytest.raises(ValueError, match="unknown style"):
            engine.submit(bad)
        assert _request(1).style is None


def _post(base, path, body: bytes):
    req = urllib.request.Request(base + path, data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


class TestServeCLI:
    def test_sample_round_trip(self, tmp_path):
        """cli/serve.py end to end on the CPU: a seeded tiny model behind
        MotionServer answers /healthz and /v1/sample through the fused
        layer's twin; root_horizontal channels of the content come back
        exactly; a batch of concurrent requests agrees with the same
        request sent alone in the same bucket."""
        from motionstyle_torch.cli import serve
        from motionstyle_torch.data.masks import get_inpainting_mask
        from motionstyle_torch.serve.server import MotionServer

        args = serve.parse_args([
            "--device", "cpu", "--model_path", str(tmp_path / "model000000001.pt"),
            "--layers", "1", "--latent_dim", "128", "--fused", "1",
            "--diffusion_steps", "40", "--skip_steps", "28", "--timestep_respacing",
            "ddim10", "--max_wait_ms", "200", "--deterministic", "1"])
        engine, decode, handle, _ = serve.build_engine(args)
        assert engine.buckets == (8,)
        server = MotionServer(engine, port=0, decode=decode, handle=handle).start_background()
        base = f"http://127.0.0.1:{server.port}"
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
                assert json.load(r) == {"status": "ok"}
            contents = [np.random.RandomState(i).randn(76, 181).astype(np.float32)
                        for i in range(3)]
            body = lambda i, seed: json.dumps({  # noqa: E731
                "content": contents[i].tolist(), "text": "a person walks angrily",
                "seed": seed}).encode()
            code, solo = _post(base, "/v1/sample", body(0, 9))
            assert code == 200 and solo["seed"] == 9
            motion = np.asarray(solo["motion"], np.float32)
            assert motion.shape == (181, 1, 76) and np.isfinite(motion).all()
            mask = np.asarray(get_inpainting_mask("root_horizontal", (1, 181, 1, 76),
                                                  dataset="stylexia_posrot"), np.float32)[0]
            init = contents[0].T[:, None, :]
            np.testing.assert_array_equal(motion * mask, init * mask)
            assert np.abs((motion - init) * (1 - mask)).max() > 1e-4

            results = {}

            def client(i, seed):
                results[i] = _post(base, "/v1/sample", body(i, seed))

            threads = [threading.Thread(target=client, args=(i, 9 + i)) for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            assert all(results[i][0] == 200 for i in range(3))
            np.testing.assert_array_equal(np.asarray(results[0][1]["motion"], np.float32),
                                          motion)

            import base64

            code, b64 = _post(base, "/v1/sample", json.dumps({
                "content_b64": base64.b64encode(contents[0].astype("<f4").tobytes()).decode(),
                "encoding": "b64", "text": "a person walks angrily", "seed": 9}).encode())
            assert code == 200 and b64["shape"] == [181, 1, 76]
            np.testing.assert_array_equal(
                np.frombuffer(base64.b64decode(b64["motion_b64"]), "<f4").reshape(181, 1, 76),
                motion)

            code, err = _post(base, "/v1/sample", json.dumps(
                {"content": contents[0][:10].tolist()}).encode())
            assert code == 500 and "content must be" in err["error"]
            code, _ = _post(base, "/v1/nope", b"{}")
            assert code == 404
            code, _ = _post(base, "/v1/sample", b"{not json")
            assert code == 400
        finally:
            server.close()

    def test_quant_int8_build_and_serve(self, tmp_path, monkeypatch):
        """--quant_int8 1 alone builds an int8 model (fused implied, bf16
        compute) and serves /v1/sample through the int8 layer's twin on the
        CPU, never through kernel 1's."""
        from motionstyle_torch.cli import serve
        from motionstyle_torch.ops import fused_encoder as fe
        from motionstyle_torch.serve.server import MotionServer

        calls = {"int8": 0, "bf16": 0}
        for name, key in (("fused_encoder_layer_int8_reference", "int8"),
                          ("fused_encoder_layer_reference", "bf16")):
            fn = getattr(fe, name)

            def counted(*a, _fn=fn, _key=key, **k):
                calls[_key] += 1
                return _fn(*a, **k)

            monkeypatch.setattr(fe, name, counted)
        args = serve.parse_args([
            "--device", "cpu", "--model_path", str(tmp_path / "model000000001.pt"),
            "--layers", "1", "--latent_dim", "128", "--quant_int8", "1",
            "--diffusion_steps", "40", "--skip_steps", "28", "--timestep_respacing",
            "ddim10", "--max_wait_ms", "50"])
        engine, decode, handle, _ = serve.build_engine(args)
        cfg = engine.sampler.params.cfg
        assert cfg.quant_int8 and cfg.fused and cfg.dtype == "bfloat16"
        server = MotionServer(engine, port=0, decode=decode, handle=handle).start_background()
        try:
            content = np.random.RandomState(5).randn(76, 181).astype(np.float32)
            code, res = _post(f"http://127.0.0.1:{server.port}", "/v1/sample", json.dumps(
                {"content": content.tolist(), "text": "a person walks", "seed": 3}).encode())
        finally:
            server.close()
        assert code == 200
        motion = np.asarray(res["motion"], np.float32)
        assert motion.shape == (181, 1, 76) and np.isfinite(motion).all()
        np.testing.assert_array_equal(motion[:3], content.T[:3, None, :])
        assert calls["int8"] > 0 and calls["bf16"] == 0

    def test_unknown_style_refused_over_http(self, tmp_path):
        """A payload's "style" reaches the engine: an unregistered name gets
        the JAX server's answer (500, "unknown style"), not a 200 with the
        default style's motion."""
        from motionstyle_torch.cli import serve
        from motionstyle_torch.serve.server import MotionServer

        args = serve.parse_args([
            "--device", "cpu", "--model_path", str(tmp_path / "model000000001.pt"),
            "--layers", "1", "--latent_dim", "64", "--diffusion_steps", "40",
            "--skip_steps", "28", "--timestep_respacing", "ddim10"])
        engine, decode, handle, _ = serve.build_engine(args)
        assert decode({"content": np.zeros((76, 181)), "style": "angry"}).style == "angry"
        server = MotionServer(engine, port=0, decode=decode, handle=handle).start_background()
        try:
            code, err = _post(f"http://127.0.0.1:{server.port}", "/v1/sample", json.dumps(
                {"content": np.zeros((76, 181)).tolist(), "text": "a person walks",
                 "style": "angry"}).encode())
        finally:
            server.close()
        assert code == 500 and "unknown style 'angry'" in err["error"]

    @pytest.mark.parametrize("flag, item", [
        (["--model_parallel", "2"], r"ROADMAP §1 item 11\b"),
        (["--arch", "trans_dec"], "arch='trans_enc' only"),
        (["--arch", "gru"], "arch='trans_enc' only"),
        (["--profile", "trace"], "a bounded hot loop that a server lacks"),
        (["--fused_train", "1"], "runs no training forward"),
        (["--fused_train_prng", "1"], "runs no training forward"),
        (["--fused_train_store", "1"], "runs no training forward")])
    def test_refuses_what_is_not_ported(self, flag, item):
        """Each flag of the shared option groups that the server does not run
        is refused before any work, naming its ROADMAP item where one covers
        it; at its default it parses."""
        from motionstyle_torch.cli import serve

        with pytest.raises(NotImplementedError, match=item):
            serve.parse_args(["--model_path", "m.pt", *flag])
        args = serve.parse_args(["--model_path", "m.pt"])
        assert (args.artifact, args.styles, args.style_strength, args.model_parallel) == (
            "", "", 1.0, 1)

    def test_cuda_default_raises_without_a_card(self, tmp_path, monkeypatch):
        from motionstyle_torch.cli import model_util

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model_util.resolve_device("cuda")
        assert model_util.resolve_device("cpu").type == "cpu"


def test_caption_memo_under_concurrent_requests():
    """The text-tower memo is shared by request threads: hammered by more
    threads than cores with a short switch interval, it stays bounded and
    every answer equals the tower's own output for that caption."""
    from motionstyle_torch.cli.model_util import ModelBundle
    from motionstyle_torch.models import clip_text

    tower = seeded_init_(clip_text.ClipTextEncoder(clip_text.ClipTextConfig(
        layers=1, width=32, heads=2, embed_dim=8)), 42).eval()
    bundle = ModelBundle(None, tower, None, torch.device("cpu"), memo_size=4)
    captions = [f"caption {i}" for i in range(6)]
    want = {c: clip_text.encode_text(tower, [c]).numpy()[0] for c in captions}
    errors = []

    def worker(k):
        try:
            for j in range(20):
                c = captions[(k + j) % len(captions)]
                np.testing.assert_array_equal(bundle.encode_text([c], "stylexia_posrot")[0],
                                              want[c])
        except Exception as ex:  # noqa: BLE001 — reported below
            errors.append(ex)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert len(bundle._memo) <= 4


def test_package_imports_no_jax():
    """Every module of motionstyle_torch imports without jax, flax, optax or
    the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import motionstyle_torch\n"
        "for m in pkgutil.walk_packages(motionstyle_torch.__path__, 'motionstyle_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'motionstyle'))\n"
        "print(len([n for n in sys.modules if n.startswith('motionstyle_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 20


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where torch
    sees no CUDA device, in the repository and standing alone."""
    import os
    import shutil

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(root, "chip_smoke.py"), alone)
    for script in (os.path.join(root, "chip_smoke.py"), str(alone)):
        proc = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


class TestServerHardening:
    """tests/test_serve.py::TestServerHardening against the port's
    MotionServer: size limits, per-request and per-chunk deadlines,
    malformed payloads, keep-alive reuse and /v1/stream's framing; every
    case leaves the server alive (healthz 200 after each)."""

    def _server(self, handle=None, stream=None, **kw):
        from motionstyle_torch.serve.server import MotionServer

        class _Eng:
            def stats(self):
                return {"ok": 1}

            def close(self):
                pass

        return MotionServer(_Eng(), port=0, decode=lambda p: p,
                            handle=handle or (lambda p: np.zeros((2, 2), np.float32)),
                            stream=stream, **kw).start_background()

    def _code(self, base, body: bytes, path="/v1/sample", timeout=30):
        req = urllib.request.Request(base + path, data=body,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status
        except urllib.error.HTTPError as e:
            e.read()
            return e.code

    def _alive(self, base):
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert r.status == 200

    def test_malformed_payloads_rejected_server_survives(self):
        srv = self._server(handle=lambda p: np.asarray(p["content"], np.float32) * 2)
        base = f"http://127.0.0.1:{srv.port}"
        try:
            for body, want in ((b"not json at all", 400), (b"{", 400),
                               (b"\xff\xfe\x00garbage", 400), (b"[1, 2, 3]", 400),
                               (b'"just a string"', 400), (b'{"content": "not a number"}', 500),
                               (b'{"wrong_key": 1}', 500), (b"", 500)):
                assert self._code(base, body) == want, body
                self._alive(base)
            assert self._code(base, json.dumps({"content": [[1.0, 2.0]]}).encode()) == 200
        finally:
            srv.close()

    def test_oversized_body_rejected_unread(self):
        import http.client
        import time

        srv = self._server(max_body_bytes=1024)
        base = f"http://127.0.0.1:{srv.port}"
        try:
            t0 = time.perf_counter()
            try:
                code = self._code(base, b" " * (8 << 20))
            except (urllib.error.URLError, ConnectionError, OSError):
                code = 413  # the reset reached a client still uploading
            assert code == 413 and time.perf_counter() - t0 < 10
            self._alive(base)
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
            conn.putrequest("POST", "/v1/sample")
            conn.putheader("Content-Type", "application/json")
            conn.putheader("Content-Length", str(8 << 20))
            conn.endheaders()
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 413
            conn.close()
        finally:
            srv.close()

    def test_missing_content_length_411(self):
        import http.client

        srv = self._server()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
            conn.putrequest("POST", "/v1/sample")
            conn.putheader("Content-Type", "application/json")
            conn.endheaders()
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 411
            conn.close()
        finally:
            srv.close()

    def test_request_timeout_returns_504(self):
        import time

        srv = self._server(handle=lambda p: time.sleep(30), request_timeout_s=0.3)
        base = f"http://127.0.0.1:{srv.port}"
        try:
            t0 = time.perf_counter()
            assert self._code(base, b"{}") == 504 and time.perf_counter() - t0 < 10
            self._alive(base)
        finally:
            srv.close()

    def test_stream_first_chunk_timeout_504(self):
        import time

        def stream(p):
            time.sleep(30)
            yield {"offset": 0}

        srv = self._server(stream=stream, request_timeout_s=0.3)
        base = f"http://127.0.0.1:{srv.port}"
        try:
            assert self._code(base, b"{}", path="/v1/stream") == 504
            self._alive(base)
        finally:
            srv.close()

    def test_stream_errors(self):
        """An error before the first chunk is a JSON 500; after it, a last
        {"error"} line; a later chunk past the deadline is an error line
        too; no stream configured is a 404."""
        import time

        def failing(p):
            if p.get("early"):
                raise ValueError("bad content")
            yield {"offset": 0}
            if p.get("slow"):
                time.sleep(30)
            raise RuntimeError("window 2 failed")

        srv = self._server(stream=failing, request_timeout_s=0.5)
        bare = self._server()
        base = f"http://127.0.0.1:{srv.port}"
        try:
            assert self._code(base, b'{"early": 1}', path="/v1/stream") == 500
            for body, want in ((b"{}", "RuntimeError: window 2 failed"),
                               (b'{"slow": 1}', "TimeoutError")):
                req = urllib.request.Request(base + "/v1/stream", data=body,
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30) as r:
                    lines = [json.loads(line) for line in r.read().splitlines()]
                assert lines[0] == {"offset": 0} and want in lines[-1]["error"]
            self._alive(base)
            assert self._code(f"http://127.0.0.1:{bare.port}", b"{}", path="/v1/stream") == 404
        finally:
            srv.close()
            bare.close()

    def test_keepalive_connection_reuse(self):
        import http.client

        srv = self._server()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
            for _ in range(3):
                conn.request("POST", "/v1/sample", body=b"{}",
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
                assert resp.status == 200 and resp.version == 11
            conn.close()
        finally:
            srv.close()

    def test_stream_closes_connection(self):
        def stream(p):
            yield {"offset": 0}

        srv = self._server(stream=stream)
        try:
            req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v1/stream", data=b"{}",
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.headers.get("Connection") == "close"
                lines = [json.loads(line) for line in r.read().splitlines()]
            assert lines[-1] == {"done": True, "chunks": 1, "seed": 0}
        finally:
            srv.close()


TINY = ["--dataset", "stylexia_posrot", "--layers", "1", "--latent_dim", "32",
        "--diffusion_steps", "40", "--skip_steps", "28", "--timestep_respacing", "ddim5",
        "--max_wait_ms", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def styled_server(tmp_path_factory):
    """The serve CLI on a tiny seeded model with a second named style
    ("fierce", another seed's encoder) behind MotionServer with /v1/stream."""
    from motionstyle_torch.cli import serve
    from motionstyle_torch.models.params import export_style_encoder
    from motionstyle_torch.serve.server import MotionServer

    root = tmp_path_factory.mktemp("styled_server")
    style2 = root / "style2.pt"
    torch.save(export_style_encoder(seeded_init_(StyleDiffusion(MDMConfig(
        latent_dim=32, num_layers=1)), 5)), style2)
    engine, decode, handle, stream = serve.build_engine(serve.parse_args(
        ["--model_path", str(root / "model000000001.pt"), "--styles", f"fierce={style2}",
         *TINY]))
    server = MotionServer(engine, port=0, decode=decode, handle=handle,
                          stream=stream).start_background()
    yield f"http://127.0.0.1:{server.port}", handle, stream
    server.close()


def _root_mask(frames, name="root_horizontal"):
    from motionstyle_torch.data.masks import get_inpainting_mask

    return np.asarray(get_inpainting_mask(name, (1, 181, 1, frames),
                                          dataset="stylexia_posrot"), np.float32)[0]


class TestServeLongform:
    def test_stream_equals_sample_over_http(self, styled_server):
        """A 180-frame clip: /v1/stream's chunks (3 windows) drained equal
        /v1/sample's answer, which keeps the content's root channels at
        every frame; 76 frames stream as one chunk."""
        base, _, _ = styled_server
        content = np.random.RandomState(3).randn(180, 181).astype(np.float32)
        body = {"content": content.tolist(), "text": "a person walks", "seed": 4}
        code, whole = _post(base, "/v1/sample", json.dumps(body).encode())
        assert code == 200
        whole = np.asarray(whole["motion"], np.float32)
        req = urllib.request.Request(base + "/v1/stream", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            lines = [json.loads(line) for line in r.read().splitlines()]
        assert [ln["offset"] for ln in lines[:-1]] == [0, 76, 142]
        assert lines[-1] == {"done": True, "chunks": 3, "seed": 4}
        drained = np.concatenate([np.asarray(ln["motion"], np.float32) for ln in lines[:-1]],
                                 axis=-1)
        np.testing.assert_array_equal(drained, whole)
        mask = _root_mask(180)
        np.testing.assert_array_equal(whole * mask, content.T[:, None, :] * mask)
        short = dict(body, content=content[:76].tolist())
        req = urllib.request.Request(base + "/v1/stream", data=json.dumps(short).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            lines = [json.loads(line) for line in r.read().splitlines()]
        assert len(lines) == 2 and lines[0]["offset"] == 0
        code, err = _post(base, "/v1/stream", json.dumps(dict(body, content=[[0.0] * 5]))
                          .encode())
        assert code == 500 and "channels=181" in err["error"]

    def test_style_rides_every_window(self, styled_server):
        """tests/test_serve.py::TestServeLongformStyle: a long request's style
        reaches every window, and streaming equals the batch path per style."""
        _, handle, stream = styled_server
        content = np.random.RandomState(11).randn(142, 181).astype(np.float32)
        payload = {"content": content.tolist(), "text": "a person walks angrily", "seed": 4}
        plain = np.asarray(handle(payload), np.float32)
        styled = np.asarray(handle({**payload, "style": "fierce"}), np.float32)
        mask = _root_mask(142)
        for out in (plain, styled):
            np.testing.assert_array_equal(out * mask, content.T[:, None, :] * mask)
        diff = np.abs((styled - plain) * (1 - mask))
        assert diff[..., :76].max() > 1e-4 and diff[..., 76:].max() > 1e-4
        chunks = [np.asarray(c["motion"], np.float32)
                  for c in stream({**payload, "style": "fierce"})]
        np.testing.assert_array_equal(np.concatenate(chunks, axis=-1), styled)

    def test_time_varying_mask_built_at_full_length(self, tmp_path):
        """tests/test_serve.py::TestServeLongformMask: --inpainting_mask prefix
        differs per frame, so the long mask is built at full length: the
        prefix frames kept, the rest resampled."""
        from motionstyle_torch.cli import serve

        engine, _, handle, _ = serve.build_engine(serve.parse_args(
            ["--model_path", str(tmp_path / "model000000001.pt"), "--inpainting_mask", "prefix",
             *TINY]))
        try:
            content = np.random.RandomState(11).randn(142, 181).astype(np.float32)
            out = np.asarray(handle({"content": content.tolist(), "text": "a person walks",
                                     "seed": 4}), np.float32)
        finally:
            engine.close()
        assert out.shape == (181, 1, 142)
        mask = _root_mask(142, "prefix")
        init = content.T[:, None, :]
        np.testing.assert_array_equal(out * mask, init * mask)
        assert np.abs((out - init) * (1 - mask)).max() > 1e-4

    def test_reference_client(self, styled_server):
        """examples/serve_client.py against the port's server: the b64 round
        trip, and stream() chunks concatenating to sample()'s answer."""
        from examples.serve_client import sample, stream

        base, _, _ = styled_server
        content = np.random.RandomState(2).randn(142, 181).astype(np.float32)
        motion = sample(base, content, "a person walks", seed=5)
        assert motion.shape == (181, 1, 142)
        chunks = list(stream(base, content, "a person walks", seed=5))
        assert [off for off, _ in chunks] == [0, 76]
        np.testing.assert_array_equal(np.concatenate([c for _, c in chunks], axis=-1), motion)
        fierce = sample(base, content[:76], "a person walks", seed=5, style="fierce")
        assert np.abs(fierce - motion[..., :76]).max() > 1e-4


@pytest.mark.parametrize("flag", [
    ["--batch_size", "8"], ["--cond_mask_prob", "0.2"], ["--lambda_fc", "1"],
    ["--lambda_rcxyz", "1"], ["--lambda_vel", "1"], ["--sigma_small", "0"],
    ["--unconstrained"], ["--arch", "trans_enc"], ["--emb_trans_dec", "0"]])
def test_jax_serve_flags_parse(flag):
    """The JAX serve CLI's shared option groups parse in the port's (the
    flags the server does not run are refused: test_refuses_what_is_not_ported)."""
    from motionstyle_torch.cli import serve

    args = serve.parse_args(["--model_path", "m.pt", *flag])
    assert args.model_path == "m.pt"


def test_cli_main_serves_long_content_and_styles(tmp_path):
    """The `python -m motionstyle_torch.cli.serve` process (tests/test_serve.py
    ::TestServeMain): warm-up before it announces itself, 76-frame and
    180-frame content with a named style on /v1/sample and /v1/stream, and a
    clean exit on SIGTERM."""
    import os
    import signal
    import socket
    import time

    from motionstyle_torch.models.params import export_style_encoder

    style2 = tmp_path / "style2.pt"
    torch.save(export_style_encoder(seeded_init_(StyleDiffusion(MDMConfig(
        latent_dim=32, num_layers=1)), 5)), style2)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "motionstyle_torch.cli.serve", "--model_path",
         str(tmp_path / "model000000001.pt"), "--styles", f"fierce={style2}",
         "--max_batch", "2", "--port", str(port), *TINY],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 240
        while True:
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
                    assert json.load(r) == {"status": "ok"}
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, "server died at startup"
                assert time.time() < deadline, "server never became healthy"
                time.sleep(0.5)
        content = np.random.RandomState(1).randn(180, 181).astype(np.float32)
        for frames in (76, 180):
            body = json.dumps({"content": content[:frames].tolist(), "text": "x", "seed": 1,
                               "style": "fierce"}).encode()
            code, res = _post(base, "/v1/sample", body)
            assert code == 200
            motion = np.asarray(res["motion"], np.float32)
            assert motion.shape == (181, 1, frames)
            req = urllib.request.Request(base + "/v1/stream", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                lines = [json.loads(line) for line in r.read().splitlines()]
            np.testing.assert_array_equal(
                np.concatenate([np.asarray(ln["motion"], np.float32) for ln in lines[:-1]],
                               axis=-1), motion)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out[-2000:]
        assert out.index("warmup: bucket") < out.index("serving "), out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
