"""HTTP serving front-end over :class:`fdgan_tpu_torch.serve.InferenceEngine`.

The engine's docstring positions it as "a library engine that a server
wraps" — this module is that server, dependency-free (stdlib
``http.server``), with **cross-request batching**: concurrent ``POST``\\ s
land in one shared staging queue, and a single dispatcher thread feeds
them through ``InferenceEngine.stream(max_wait=...)`` so simultaneous
requests ride the batch ladder together (one batched forward instead of
many small ones), while ``max_wait`` bounds the latency a lone request
pays for batching. The dispatcher iterates the stream continuously, so
the ``max_wait`` bound genuinely holds (the consumer-must-iterate caveat
from ``serve.py`` is satisfied by construction).

Endpoints
---------
``POST /dehaze``   body = encoded image (PNG/JPEG/BMP — anything PIL
                   reads); response = dehazed PNG, min/max-normalised
                   like the reference's output path (demo.py:151).
                   ``?raw=1`` responds with the engine's native HWC bytes
                   instead — little-endian fp32 in [-1, 1], or uint8 in
                   [0, 255] for an ``output='uint8'`` engine (shape in
                   ``X-Image-Shape``, dtype in ``X-Image-Dtype``) — for
                   clients that want the un-normalised model output.
``GET /healthz``   liveness + device info.
``GET /stats``     engine counters (images, batches, reloads, padding
                   overhead, kernel launches) + queue depth + latency
                   percentiles.
``POST /reload``   zero-downtime weight hot-swap (enabled when
                   ``make_server`` is given a ``weight_loader``): body is
                   optional JSON ``{"path": "..."}``, defaulting to the
                   server's startup checkpoint path. The checkpoint is
                   loaded + uploaded off the serving path, validated
                   entry by entry, then swapped under the engine lock —
                   in-flight batches finish on the old weights, no
                   request is dropped. This is how a
                   ``--keepBest`` checkpoint from a live training run is
                   promoted into a running server.

Reference counterpart: none — ``demo.py:89-151`` is an offline loop over
an h5 file. This module is ``fdgan_tpu/serve_http.py`` around the port's
engine.
"""

from __future__ import annotations

import collections
import io
import itertools
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from fdgan_tpu_torch import trace

__all__ = ["BatchingFrontend", "make_server", "serve_forever"]


class BatchingFrontend:
    """Funnel concurrent ``submit()`` calls into one ``engine.stream()``.

    A single daemon dispatcher owns the stream; callers get a
    :class:`concurrent.futures.Future` resolved with the dehazed HWC array
    (engine output dtype). Because ``stream()`` yields strictly in input
    order, futures
    are matched FIFO — no per-item bookkeeping crosses the thread
    boundary beyond the queue itself. While a ``torch.profiler`` profile
    runs, each request records ``frontend.queue`` from ``submit`` until
    the engine's staging takes it (both queues: this one and the stream's
    own ahead of staging), under its index in the stream (``item``).
    """

    def __init__(self, engine, *, max_wait: float = 0.05, depth: int = 4):
        if max_wait <= 0:
            # without a staging deadline a lone request would wait forever
            # for a full ladder rung — meaningless for an online server
            raise ValueError("BatchingFrontend requires max_wait > 0")
        self._engine = engine
        self._max_wait = float(max_wait)
        self._depth = int(depth)
        self._q: queue.Queue = queue.Queue()
        self._futs: collections.deque = collections.deque()
        self._queued: dict = {}  # stream index -> submit stamp, while profiled
        self._stop = object()
        self._closed = False
        self._error: Optional[BaseException] = None
        # serialises the _closed/_error checks against _q.put: without it a
        # submit racing close() can enqueue AFTER the stop sentinel, and its
        # Future would never resolve (the HTTP thread then blocks for the
        # full request_timeout)
        self._lock = threading.Lock()
        # submit→result latency of the last 512 requests (staging wait +
        # device time + result fetch — what a client actually experiences
        # minus HTTP parse/encode); powers the /stats percentiles
        self._latencies: collections.deque = collections.deque(maxlen=512)
        self._thread = threading.Thread(
            target=self._run, name="fdgan-dispatch", daemon=True
        )
        self._thread.start()

    def _gen(self):
        for index in itertools.count():  # the request's index in the engine's stream
            item = self._q.get()
            if item is self._stop:
                return
            img, fut, t0, queued_ns = item
            self._futs.append((fut, t0))
            if queued_ns:
                self._queued[index] = queued_ns
            yield img

    def _taken(self, index: int) -> None:
        """The engine's staging took request ``index``: its queue wait ends."""
        queued_ns = self._queued.pop(index, 0)
        if queued_ns:
            trace.record("frontend.queue", queued_ns, time.time_ns(), item=index)

    def _run(self):
        try:
            results = self._engine.stream(
                self._gen(), depth=self._depth, max_wait=self._max_wait, taken=self._taken
            )
            for y in results:
                fut, t0 = self._futs.popleft()
                with self._lock:  # /stats snapshots this deque concurrently
                    self._latencies.append(time.monotonic() - t0)
                fut.set_result(y)
        except BaseException as e:
            with self._lock:
                self._error = e  # set under the lock: submit() checks it there
            while self._futs:
                self._futs.popleft()[0].set_exception(e)
            self._drain_queue(e)

    def _drain_queue(self, exc: BaseException) -> None:
        """Fail every (img, fut) still sitting in the staging queue.

        Items the dead dispatcher never pulled have no entry in _futs, so
        without this their Futures would hang for the caller's full
        request timeout. Runs after _error is published under the lock, so
        no new item can be enqueued once the drain starts."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not self._stop:
                item[1].set_exception(exc)

    @property
    def healthy(self) -> bool:
        """False once the dispatcher died (its error is in ``error``)."""
        return self._error is None and self._thread.is_alive()

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one HWC image (float [0,1] or uint8 [0,255] — both are
        valid for any engine); the Future resolves to an HWC array in the
        engine's output dtype (fp32 [-1,1] or uint8 [0,255]).

        Validation happens HERE (not in the stream) so one malformed
        request cannot poison the shared dispatcher."""
        img = np.asarray(image)
        if img.dtype != np.uint8:  # uint8 passes through untouched
            img = np.asarray(img, np.float32)
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"expected HWC RGB image, got shape {img.shape}")
        fut: Future = Future()
        with self._lock:
            if self._error is not None:
                raise RuntimeError("serving dispatcher died") from self._error
            if self._closed:
                raise RuntimeError("frontend is closed")
            self._q.put((img, fut, time.monotonic(), trace.stamp()))
        return fut

    @property
    def queue_depth(self) -> int:
        return self._q.qsize() + len(self._futs)

    def latency_stats(self) -> dict:
        """Percentiles (seconds) over the last 512 completed requests."""
        with self._lock:  # the dispatcher appends concurrently
            lat = sorted(self._latencies)
        if not lat:
            return {}
        pick = lambda q: lat[min(int(q * (len(lat) - 1) + 0.5), len(lat) - 1)]
        return {
            "latency_n": len(lat),
            "latency_p50_s": round(pick(0.50), 4),
            "latency_p90_s": round(pick(0.90), 4),
            "latency_p99_s": round(pick(0.99), 4),
            "latency_max_s": round(lat[-1], 4),
        }

    def close(self, timeout: float = 60.0) -> None:
        """Drain in-flight work and stop the dispatcher (idempotent)."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._q.put(self._stop)
        self._thread.join(timeout=timeout)
        if self._error is None and not self._thread.is_alive():
            # normal shutdown with stragglers racing the sentinel is
            # impossible now (the lock orders them), but a dispatcher that
            # died DURING close still leaves queue items to fail
            self._drain_queue(RuntimeError("frontend is closed"))


def _decode_request_image(body: bytes, as_uint8: bool = False) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(body)).convert("RGB")
    if as_uint8:
        # uint8-input engines take the decoder's bytes as-is: no host-side
        # float conversion, 4× smaller host→device upload, same numerics
        return np.asarray(img, np.uint8)
    return np.asarray(img, np.float32) / 255.0


def _encode_png(arr: np.ndarray) -> bytes:
    from PIL import Image

    from fdgan_tpu_torch.utils.images import normalize_to_uint8

    buf = io.BytesIO()
    Image.fromarray(normalize_to_uint8(arr)).save(buf, format="PNG")
    return buf.getvalue()


def make_server(
    engine,
    host: str = "127.0.0.1",
    port: int = 0,
    *,
    max_wait: float = 0.05,
    depth: int = 4,
    request_timeout: float = 900.0,
    max_body_bytes: int = 64 * 1024 * 1024,
    restart_limit: int = 1,
    weight_loader=None,
    weights_path: str = "",
) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server wrapping ``engine``.

    ``port=0`` binds an ephemeral port (read it back from
    ``server.server_address[1]``). ``max_body_bytes`` rejects oversized
    uploads with 413 before reading them (bounds per-request memory;
    decompression bombs are separately caught by PIL's pixel limit and
    surface as 400). ``request_timeout`` bounds how long a handler waits
    for its result, kernel build on the first request included.
    The returned server carries its
    :class:`BatchingFrontend` as ``server.frontend``; ``server.shutdown()``
    followed by ``server.frontend.close()`` is the clean stop sequence
    (``serve_forever`` below does both on KeyboardInterrupt).

    If the dispatcher dies (e.g. a CUDA error on a dispatch), the server
    recreates the frontend up to ``restart_limit`` times; once exhausted,
    ``GET /healthz`` reports ``ok: false`` with HTTP 503 so an
    orchestrator's liveness probe recycles the pod instead of routing to a
    zombie.

    ``weight_loader`` (a ``path -> params`` callable, e.g.
    ``cli._common.load_generator``) enables ``POST /reload`` —
    zero-downtime weight hot-swap via ``engine.reload``; ``weights_path``
    is the default checkpoint path when the request body names none.
    Reload is an admin operation: the server binds loopback by default,
    and the path in the request body is read server-side — expose
    non-loopback binds accordingly."""
    uint8_in = getattr(engine, "input", "float32") == "uint8"
    reload_lock = threading.Lock()  # serialise concurrent /reload requests

    class _FrontendState:
        """Current frontend + bounded restart budget, shared by handlers."""

        def __init__(self):
            self.lock = threading.Lock()
            self.frontend = BatchingFrontend(engine, max_wait=max_wait, depth=depth)
            self.restarts_left = int(restart_limit)

        def maybe_restart(self, dead) -> bool:
            """Replace ``dead`` with a fresh frontend if budget remains.

            Returns True when the caller should retry its submit. Under the
            lock so concurrent failing requests trigger ONE restart."""
            with self.lock:
                if self.frontend is not dead:
                    return True  # someone else already restarted
                if dead.closed:
                    # deliberate shutdown, not a crash: a restart here would
                    # resurrect a dispatcher AFTER serve_forever's drain and
                    # leak it past process teardown
                    return False
                if self.restarts_left <= 0 or dead.healthy:
                    return False
                self.restarts_left -= 1
                self.frontend = BatchingFrontend(
                    engine, max_wait=max_wait, depth=depth
                )
                return True

    state = _FrontendState()

    class Handler(BaseHTTPRequestHandler):
        # one TCP connection per request is fine for an inference API;
        # keep-alive would pin ThreadingHTTPServer threads on idle clients
        protocol_version = "HTTP/1.0"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                fe = state.frontend
                # a dead dispatcher with restart budget left is still
                # serviceable (the next POST restarts it); only a dead one
                # with no budget makes the pod a zombie → 503
                ok = fe.healthy or state.restarts_left > 0
                payload = {
                    "ok": ok,
                    "devices": [str(engine.device)],
                    "bn_mode": engine.bn_mode,
                    "bucket": engine.bucket,
                    "batch_sizes": list(engine.batch_sizes),
                    "dispatcher_alive": fe.healthy,
                    "restarts_left": state.restarts_left,
                    "weights_version": getattr(engine, "weights_version", 0),
                    "reload_enabled": weight_loader is not None,
                }
                if fe.error is not None:
                    payload["error"] = repr(fe.error)
                self._json(200 if ok else 503, payload)
            elif self.path == "/stats":
                with engine._lock:
                    stats = dict(engine.stats)
                fe = state.frontend
                stats["queue_depth"] = fe.queue_depth
                stats["weights_version"] = getattr(engine, "weights_version", 0)
                stats.update(fe.latency_stats())
                self._json(200, stats)
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def _submit_with_restart(self, img):
            """submit(), restarting the frontend once if its dispatcher died."""
            while True:
                fe = state.frontend
                try:
                    return fe.submit(img)
                except RuntimeError:
                    if not state.maybe_restart(fe):
                        raise

        def _do_reload(self):
            if weight_loader is None:
                self._json(404, {"error": "reload not enabled (server was "
                                          "built without a weight_loader)"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > max_body_bytes:
                    self._json(413, {"error": "reload body too large"})
                    return
                body = self.rfile.read(n) if n > 0 else b""
                req = json.loads(body) if body.strip() else {}
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
            except Exception as e:
                self._json(400, {"error": f"bad reload request: {e}"})
                return
            path = req.get("path") or weights_path
            if not path:
                self._json(400, {"error": "no checkpoint path: pass "
                                          '{"path": ...} or start the server '
                                          "with a default weights path"})
                return
            t0 = time.monotonic()
            with reload_lock:  # one load+swap at a time
                try:
                    params = weight_loader(path)
                except Exception as e:
                    self._json(400, {"error": f"loading {path!r} failed: {e}"})
                    return
                try:
                    version = engine.reload(params)
                except ValueError as e:
                    # structurally wrong checkpoint: the old weights stay live
                    self._json(409, {"error": str(e)})
                    return
                except Exception as e:
                    self._json(500, {"error": f"reload failed: {e}"})
                    return
            self._json(200, {
                "ok": True,
                "path": path,
                "weights_version": version,
                "elapsed_s": round(time.monotonic() - t0, 3),
            })

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path == "/reload":
                self._do_reload()
                return
            if path != "/dehaze":
                self._json(404, {"error": f"unknown path {path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n <= 0:
                    raise ValueError("empty body")
                if n > max_body_bytes:
                    # bound per-request memory BEFORE reading: a single
                    # oversized (or malicious) upload must not OOM the
                    # shared server (413, not 400 — the client can retry
                    # smaller)
                    self._json(
                        413,
                        {
                            "error": f"body {n} bytes exceeds the "
                            f"{max_body_bytes}-byte limit"
                        },
                    )
                    return
                body = self.rfile.read(n)
                img = _decode_request_image(body, as_uint8=uint8_in)
            except Exception as e:
                self._json(400, {"error": f"bad image: {e}"})
                return
            try:
                fut = self._submit_with_restart(img)
            except Exception as e:
                self._json(503, {"error": f"serving unavailable: {e}"})
                return
            try:
                out = fut.result(timeout=request_timeout)
            except Exception as e:
                self._json(500, {"error": f"inference failed: {e}"})
                return
            shape = "x".join(map(str, out.shape))
            if "raw=1" in query:
                # native engine dtype: <f4 in [-1,1], or u1 in [0,255] for
                # an output='uint8' engine (X-Image-Dtype disambiguates)
                dt = "u1" if out.dtype == np.uint8 else "<f4"
                payload = np.ascontiguousarray(out, dt).tobytes()
                ctype = "application/octet-stream"
            else:
                payload = _encode_png(out)
                ctype = "image/png"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("X-Image-Shape", shape)
            self.send_header(
                "X-Image-Dtype", "uint8" if out.dtype == np.uint8 else "float32"
            )
            self.end_headers()
            self.wfile.write(payload)

    class _Server(ThreadingHTTPServer):
        daemon_threads = True

        @property
        def frontend(self):  # always the CURRENT frontend (restarts swap it)
            return state.frontend

    server = _Server((host, port), Handler)
    server.frontend_state = state  # type: ignore[attr-defined]
    return server


def serve_forever(server: ThreadingHTTPServer) -> None:
    """Run until interrupted (SIGINT or SIGTERM), then drain the batching
    frontend cleanly — in-flight requests get their responses before exit
    (what an orchestrator's stop sequence expects)."""
    import signal
    import threading as _threading

    host, port = server.server_address[:2]
    if _threading.current_thread() is _threading.main_thread():
        # install BEFORE announcing the port (a supervisor may signal the
        # moment it sees the bind); shutdown() must not run on the
        # serve_forever thread, so the handler hands it to a helper
        signal.signal(
            signal.SIGTERM,
            lambda *_: _threading.Thread(target=server.shutdown, daemon=True).start(),
        )
    print(f"serving on http://{host}:{port}  (POST /dehaze, GET /healthz, /stats)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.frontend.close()  # type: ignore[attr-defined]
