"""HTTP serving frontend over the ServingEngine (stdlib only).

Counterpart of motionstyle/serve/server.py. Endpoints:
  POST /v1/sample   body: JSON request; returns {"motion": [[...]], ...}
  POST /v1/stream   same body; NDJSON response: one {"offset", "motion"}
                    line per completed long-form window (the first motion
                    after one window's latency), then a {"done": true} line
  GET  /healthz     liveness
  GET  /stats       batcher counters and a sliding window of latency
                    percentiles, device batch time and queue depth

The JSON contract is translated to engine Requests by a `decode` callable;
cli/serve.py wires the style-transfer default. One thread per connection;
all device work still funnels through the batcher's single worker, so
concurrency buys coalescing, not device-side parallelism.

Hardening as in the JAX server: bodies above `max_body_bytes` are rejected
413 before they are read; a POST without Content-Length is a 411; handle()
runs on a bounded pool with a `request_timeout_s` deadline (504); socket
reads carry an idle timeout; HTTP/1.1 keep-alive. Each /v1/stream chunk's
computation runs under the same deadline (a first chunk past it is a 504, a
later one an {"error"} line); /v1/stream responses send Connection: close,
since they have no length.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import numpy as np

from motionstyle_torch.serve.engine import Request, ServingEngine


def encode_motion(motion, payload: dict) -> dict:
    """Response motion fields: {"motion": nested lists} by default, or —
    when the request set "encoding": "b64" — {"motion_b64": base64 of raw
    little-endian float32 (C order), "shape": [...]}. The binary form skips
    JSON float serialization, which dominates a response's encode time at
    these payload sizes."""
    m = np.ascontiguousarray(np.asarray(motion, np.float32))
    if payload.get("encoding") == "b64":
        import base64

        return {"motion_b64": base64.b64encode(m.tobytes()).decode("ascii"),
                "shape": list(m.shape)}
    return {"motion": m.tolist()}


def default_decode(payload: dict) -> Request:
    """Generic JSON -> Request: 'cond' {name: nested list}, optional
    'init_image', 'inpainting_mask', 'seed'."""
    cond = {k: np.asarray(v, np.float32) for k, v in payload.get("cond", {}).items()}
    get = lambda k: (np.asarray(payload[k], np.float32)
                     if payload.get(k) is not None else None)
    return Request(cond, init_image=get("init_image"),
                   inpainting_mask=get("inpainting_mask"),
                   seed=payload.get("seed", 0))


class MotionServer:
    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 8500, decode: Callable = default_decode,
                 handle: Callable | None = None,
                 stream: Callable | None = None,
                 max_body_bytes: int = 64 << 20,
                 request_timeout_s: float | None = 120.0,
                 read_timeout_s: float = 30.0,
                 max_workers: int = 32):
        """handle(payload) -> np.ndarray overrides the default
        engine.sample(decode(payload)) (cli/serve.py's handler also serves
        long-form content). stream(payload) -> iterator of JSON-able dicts
        enables /v1/stream.

        max_body_bytes: request bodies above this are rejected 413 unread.
        request_timeout_s: deadline for one handle() or stream-chunk
        computation (None disables); expiry returns 504 and releases the
        client thread. max_workers bounds concurrently-running handlers
        (back-pressure above the batcher queue)."""
        self.engine = engine
        self.decode = decode
        self.handle = handle or (lambda payload: engine.sample(decode(payload)))
        self.stream = stream
        self.max_body_bytes = int(max_body_bytes)
        self.request_timeout_s = request_timeout_s
        self._pool = cf.ThreadPoolExecutor(max_workers=max_workers,
                                           thread_name_prefix="serve-handle")
        outer = self

        def run_bounded(fn, *args):
            """Run fn on the bounded pool under the request deadline."""
            if outer.request_timeout_s is None:
                return fn(*args)
            fut = outer._pool.submit(fn, *args)
            try:
                return fut.result(timeout=outer.request_timeout_s)
            except cf.TimeoutError:
                fut.cancel()
                raise TimeoutError(
                    f"request exceeded {outer.request_timeout_s:.0f}s")

        class Handler(BaseHTTPRequestHandler):
            # keep-alive: connection reuse amortizes TCP+thread setup across
            # a client's requests (every response sets Content-Length but
            # /v1/stream's, which closes the connection)
            protocol_version = "HTTP/1.1"
            timeout = read_timeout_s  # idle-socket read deadline

            def log_message(self, fmt, *args):  # quiet access log
                pass

            def handle_timeout(self):  # socket idle past read_timeout_s
                self.close_connection = True

            def _json(self, code: int, obj: dict, close: bool = False):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if close:
                    self.send_header("Connection", "close")
                    self.close_connection = True
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"status": "ok"})
                elif self.path == "/stats":
                    self._json(200, outer.engine.stats())
                else:
                    self._json(404, {"error": f"unknown path {self.path}"})

            def _read_payload(self) -> dict:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def _reject_body(self) -> bool:
                """Size-limit gate BEFORE reading: oversized or length-less
                POSTs are refused and the connection closed (the unread body
                makes the socket unusable for keep-alive)."""
                cl = self.headers.get("Content-Length")
                if cl is None:
                    self._json(411, {"error": "Content-Length required"},
                               close=True)
                    return True
                try:
                    n = int(cl)
                except ValueError:
                    self._json(400, {"error": f"bad Content-Length {cl!r}"},
                               close=True)
                    return True
                if n < 0:
                    self._json(400, {"error": f"bad Content-Length {n}"},
                               close=True)
                    return True
                if n > outer.max_body_bytes:
                    self._json(413, {
                        "error": f"body {n} bytes exceeds limit "
                                 f"{outer.max_body_bytes}"}, close=True)
                    return True
                return False

            def _stream(self, payload: dict):
                """NDJSON: chunk lines as windows complete, then a done line.
                An error before the first chunk gets a JSON 500 (504 past the
                deadline); after the headers are sent, an error becomes a
                last {"error"} line. Each chunk's computation runs under the
                request deadline."""
                sentinel = object()
                try:
                    gen = iter(outer.stream(payload))
                    first = run_bounded(next, gen, sentinel)
                except TimeoutError as ex:
                    self._json(504, {"error": str(ex)}, close=True)
                    return
                except Exception as ex:  # noqa: BLE001 — before the headers
                    self._json(500, {"error": f"{type(ex).__name__}: {ex}"})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                # NDJSON has no Content-Length: under HTTP/1.1 the close is
                # the delimiter
                self.send_header("Connection", "close")
                self.close_connection = True
                self.end_headers()

                def line(obj):
                    self.wfile.write((json.dumps(obj) + "\n").encode())
                    self.wfile.flush()

                try:
                    n_chunks = 0
                    if first is not sentinel:
                        line(first)
                        n_chunks = 1
                        while True:
                            obj = run_bounded(next, gen, sentinel)
                            if obj is sentinel:
                                break
                            line(obj)
                            n_chunks += 1
                    line({"done": True, "chunks": n_chunks,
                          "seed": payload.get("seed", 0)})
                except BrokenPipeError:
                    pass  # the client went away mid-stream
                except Exception as ex:  # noqa: BLE001 — mid-stream
                    try:
                        line({"error": f"{type(ex).__name__}: {ex}"})
                    except Exception:  # noqa: BLE001
                        pass

            def do_POST(self):
                if self._reject_body():
                    return
                # read the body FIRST, even on error paths: responding with
                # the request still unread in the socket buffer triggers a
                # TCP RST that can discard the response mid-upload
                try:
                    payload = self._read_payload()
                    if not isinstance(payload, dict):
                        raise TypeError(
                            f"payload must be a JSON object, got "
                            f"{type(payload).__name__}")
                except Exception as ex:  # noqa: BLE001 — malformed JSON/body
                    self._json(400, {"error": f"{type(ex).__name__}: {ex}"})
                    return
                if self.path == "/v1/stream":
                    if outer.stream is None:
                        self._json(404, {"error": "streaming not configured"})
                    else:
                        self._stream(payload)
                    return
                if self.path != "/v1/sample":
                    self._json(404, {"error": f"unknown path {self.path}"})
                    return
                responded = False
                try:
                    motion = run_bounded(outer.handle, payload)
                    body = json.dumps({**encode_motion(motion, payload),
                                       "seed": payload.get("seed", 0)}).encode()
                    responded = True  # body built: past here a failure is a
                    # WRITE failure — never start a second response on the
                    # same half-written/dead socket
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except TimeoutError as ex:
                    if not responded:
                        self._json(504, {"error": str(ex)}, close=True)
                except Exception as ex:  # surface as a JSON 500, keep serving
                    if not responded:
                        self._json(500, {"error": f"{type(ex).__name__}: {ex}"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None
        self._serving = False

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start_background(self):
        self._serving = True
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self._serving = True
        self.httpd.serve_forever()

    def close(self):
        if self._serving:
            # shutdown() waits on an event only a running serve_forever loop
            # sets — calling it on a never-started server deadlocks forever
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        self._pool.shutdown(wait=False, cancel_futures=True)
        self.engine.close()
