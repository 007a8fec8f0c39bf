"""Async serving runtime — single-event-loop HTTP front end (aiohttp).

Same endpoints and semantics as :mod:`postgres_word2vec.server` (the
threaded front end); only the HTTP/concurrency machinery differs. On a
small host the threaded server spends most of its CPU *around* the engine:
one OS thread per connection, pure-Python request parsing
(BaseHTTPRequestHandler readline loops), and two condition-variable
handoffs per micro-batched item — measured as the dominant cost at 64
concurrent clients on a 1-core host.
This front end removes all three:

- aiohttp parses HTTP in C (llhttp) on ONE event loop — no per-connection
  threads, no per-request thread wakeups;
- /knn and /knn_in micro-batches coalesce directly on the loop (a plain
  list + one timer), with per-item asyncio futures instead of
  cross-thread Events;
- engine calls run in a single executor thread (jax dispatch + host-side
  waits release the GIL, so the loop keeps parsing while the device
  works) — which also serializes device access, the same discipline the
  threaded server enforces with its lock.

The engine-execution core (resolution, pow2-padded gathers, coalesced
batch runners) is shared: :class:`postgres_word2vec.server.EngineRunner`.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from postgres_word2vec.api import Freddy
from postgres_word2vec.server import EngineRunner, UnknownEndpoint


class _LoopBatcher:
    """Coalesce concurrent single-item requests ON the event loop.

    ``submit(item)`` appends to a plain list and awaits a future; a single
    drainer coroutine sleeps ``window_ms`` after the first arrival, then
    runs everything queued (in ``max_batch`` slices) through ``fn`` in the
    executor.

    Pipelined mode (``complete_fn`` given): ``fn`` is the DISPATCH phase —
    it resolves + gathers + enqueues the batch on the device and returns
    pending state in host time (jax dispatch is async) — and
    ``complete_fn(state)`` materializes + formats on the separate
    ``completer`` executor thread. Up to ``depth`` batches are in flight,
    so batch N+1's host work and device enqueue overlap batch N's device
    execution + fetch instead of idling behind it. Without the split, each
    coalesced /knn batch holds the engine thread for its device time plus
    the fetch, with the device idle between batches.
    """

    def __init__(self, fn, executor, *, max_batch: int = 64,
                 window_ms: float = 2.0, complete_fn=None, completer=None,
                 depth: int = 2):
        self._fn = fn
        self._executor = executor
        self._complete = complete_fn
        self._completer = completer
        self._depth = max(1, depth)
        self._max = max_batch
        self._win = window_ms / 1e3
        self._items: list = []
        self._futs: list = []
        self._wake: asyncio.Event | None = None
        self.batched_calls = 0
        self.items_done = 0
        self.busy_s = 0.0
        self.max_coalesced = 0
        self.batch_errors = 0
        self.last_error: str | None = None

    def start(self) -> None:
        """Create loop-bound state; call from inside the running loop."""
        self._wake = asyncio.Event()
        asyncio.ensure_future(self._drainer())

    async def submit(self, item):
        fut = asyncio.get_running_loop().create_future()
        self._items.append(item)
        self._futs.append(fut)
        self._wake.set()
        return await fut

    def _fail(self, cfuts, e: Exception) -> None:
        # surface server-side: items get per-request 400s, but an operator
        # (and the bench) must be able to see WHAT failed — a silent
        # converter turns a device failure into unexplained client errors.
        self.batch_errors += 1
        self.last_error = f"{type(e).__name__}: {e}"
        if self.batch_errors <= 3 or self.batch_errors % 100 == 0:
            import sys
            print(f"[batcher] batch failure #{self.batch_errors}: "
                  f"{self.last_error}", file=sys.stderr, flush=True)
        for f in cfuts:
            if not f.done():
                f.set_exception(e)

    def _deliver(self, cfuts, results, t0: float, n: int) -> None:
        self.busy_s += time.perf_counter() - t0
        self.batched_calls += 1
        self.items_done += n
        self.max_coalesced = max(self.max_coalesced, n)
        for f, r in zip(cfuts, results):
            if f.done():
                continue
            if isinstance(r, Exception):
                f.set_exception(r)
            else:
                f.set_result(r)

    async def _finish(self, loop, state, cfuts, t0: float, n: int) -> None:
        """Completion phase of one in-flight batch (pipelined mode only);
        never raises — a batch-level failure 400s its own items."""
        try:
            results = await loop.run_in_executor(
                self._completer, self._complete, state)
        except Exception as e:  # noqa: BLE001 — batch-level failure
            self._fail(cfuts, e)
            return
        self._deliver(cfuts, results, t0, n)

    async def _drainer(self):
        loop = asyncio.get_running_loop()
        from collections import deque
        inflight: deque = deque()
        while True:
            await self._wake.wait()
            if self._win > 0:
                await asyncio.sleep(self._win)   # coalescing window
            items, futs = self._items, self._futs
            self._items, self._futs = [], []
            self._wake.clear()
            for s in range(0, len(items), self._max):
                chunk = items[s:s + self._max]
                cfuts = futs[s:s + self._max]
                t0 = time.perf_counter()
                if self._complete is None:     # unsplit: dispatch+complete
                    try:
                        results = await loop.run_in_executor(
                            self._executor, self._fn, chunk)
                    except Exception as e:  # noqa: BLE001 — batch failure
                        self._fail(cfuts, e)
                        continue
                    self._deliver(cfuts, results, t0, len(chunk))
                    continue
                # pipelined: bound in-flight depth, dispatch, then hand the
                # pending state to the completion task and keep draining.
                while len(inflight) >= self._depth:
                    await inflight.popleft()
                t0 = time.perf_counter()
                try:
                    state = await loop.run_in_executor(
                        self._executor, self._fn, chunk)
                except Exception as e:  # noqa: BLE001 — dispatch failure
                    self._fail(cfuts, e)
                    continue
                inflight.append(loop.create_task(
                    self._finish(loop, state, cfuts, t0, len(chunk))))


class AsyncQueryServer:
    """aiohttp front end over a shared :class:`EngineRunner`.

    Same constructor/endpoints as :class:`QueryServer`; ``start()`` runs
    the event loop on a daemon thread so sync callers (tests, benches)
    drive it exactly like the threaded server.
    """

    DEFAULT_K = 5

    def __init__(self, engine: Freddy, host: str = "127.0.0.1",
                 port: int = 0, batch_window_ms: float = 2.0,
                 max_batch: int = 64, pipeline_depth: int = 2):
        self.engine = engine
        self.runner = EngineRunner(engine)
        self._host = host
        self._port0 = port
        self.port: int | None = None
        self._window_ms = batch_window_ms
        self._max_batch = max_batch
        # in-flight coalesced batches: 2 overlaps dispatch with the device
        # + fetch of the previous batch; 3 lets dispatch / device / fetch
        # run as three overlapping stages (fetch serializes on the one
        # completer thread either way).
        self._depth = pipeline_depth
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="engine")
        # completion pool for the pipelined paths: each worker blocks in
        # one batch's device_get, so concurrent fetches overlap — one worker
        # per in-flight batch. Safe: device execution is serialized by jax
        # regardless of which thread fetches, and each batch delivers to
        # its own per-item futures (no cross-batch ordering requirement).
        self._completer = ThreadPoolExecutor(
            max_workers=max(1, pipeline_depth),
            thread_name_prefix="complete")
        self._requests = 0
        self._started = time.time()
        self._thread: threading.Thread | None = None
        self._ready = threading.Event()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stop_ev: asyncio.Event | None = None
        self._knn_batcher: _LoopBatcher | None = None
        self._knn_in_batcher: _LoopBatcher | None = None

    # ------------------------------------------------------------- control
    def warmup(self, k: int | None = None) -> None:
        """Precompile every pow2 coalesced batch shape (see
        QueryServer.warmup)."""
        w0 = self.engine.store.words[0]
        kk = self.DEFAULT_K if k is None else k
        top = 1 << (self._max_batch - 1).bit_length()
        b = 1
        while b <= top:
            self.runner._run_knn_batch([(w0, kk)] * b)
            b *= 2

    def start(self) -> "AsyncQueryServer":
        self._thread = threading.Thread(target=self._run_loop, daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=60):
            raise RuntimeError("async server failed to start")
        return self

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._stop_ev.set)
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._executor.shutdown(wait=False)
        self._completer.shutdown(wait=False)

    def serve_forever(self) -> None:
        if self._thread is None:
            self.start()
        self._thread.join()

    def _run_loop(self) -> None:
        asyncio.run(self._main())

    async def _main(self) -> None:
        from aiohttp import web

        self._loop = asyncio.get_running_loop()
        self._stop_ev = asyncio.Event()
        self._knn_batcher = _LoopBatcher(
            self.runner.dispatch_knn_batch, self._executor,
            max_batch=self._max_batch, window_ms=self._window_ms,
            complete_fn=self.runner.complete_knn_batch,
            completer=self._completer, depth=self._depth)
        self._knn_in_batcher = _LoopBatcher(
            self.runner.dispatch_knn_in_batch, self._executor,
            max_batch=self._max_batch, window_ms=self._window_ms,
            complete_fn=self.runner.complete_knn_in_batch,
            completer=self._completer, depth=self._depth)
        self._knn_batcher.start()
        self._knn_in_batcher.start()

        app = web.Application()
        app.router.add_get("/health", self._get_health)
        app.router.add_post("/{tail:.*}", self._post)
        runner = web.AppRunner(app, access_log=None)
        await runner.setup()
        site = web.TCPSite(runner, self._host, self._port0)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]
        self._ready.set()
        await self._stop_ev.wait()
        await runner.cleanup()

    # ------------------------------------------------------------ handlers
    async def _get_health(self, request):
        from aiohttp import web

        import jax

        h = {
            "status": "ok",
            "vocab": self.engine.store.size,
            "dim": self.engine.store.dim,
            "indexes": {
                "pq": self.engine.pq is not None,
                "ivfadc": self.engine.ivfadc is not None,
                "ivpq": self.engine.ivpq is not None,
            },
            "device": str(jax.devices()[0]),
            "requests": self._requests,
            "knn_stage_s": {k: round(v, 3)
                            for k, v in self.runner.stage_s.items()},
            "uptime_s": round(time.time() - self._started, 1),
        }
        for name, b in (("knn", self._knn_batcher),
                        ("knn_in", self._knn_in_batcher)):
            h[f"{name}_batched_calls"] = b.batched_calls
            h[f"{name}_busy_s"] = round(b.busy_s, 3)
            h[f"{name}_items_done"] = b.items_done
            h[f"{name}_max_coalesced"] = b.max_coalesced
            h[f"{name}_batch_errors"] = b.batch_errors
            if b.last_error:
                h[f"{name}_last_error"] = b.last_error
        return web.json_response(h)

    async def _post(self, request):
        from aiohttp import web

        path = request.path
        self._requests += 1
        try:
            raw = await request.read()
            body = json.loads(raw) if raw else {}
            if path == "/knn":
                q = body.get("query")
                q = q if isinstance(q, str) else np.asarray(q, np.float32)
                result = await self._knn_batcher.submit(
                    (q, int(body.get("k", self.DEFAULT_K))))
            elif path == "/knn_in":
                q = body.get("query")
                q = q if isinstance(q, str) else np.asarray(q, np.float32)
                result = await self._knn_in_batcher.submit(
                    (q, int(body.get("k", 5)), tuple(body["targets"])))
            else:
                loop = asyncio.get_running_loop()
                result = await loop.run_in_executor(
                    self._executor, self._run_plain, path, body)
            return web.json_response({"result": result})
        except UnknownEndpoint as e:
            return web.json_response({"error": str(e)}, status=404)
        except Exception as e:  # noqa: BLE001 — serve errors as 400
            return web.json_response(
                {"error": f"{type(e).__name__}: {e}"}, status=400)

    def _run_plain(self, path: str, body: dict):
        """Non-micro-batched endpoints (runs on the engine executor
        thread — same routing table as the threaded server)."""
        eng = self.engine
        with self.runner._lock:
            if path == "/knn_batch":
                return eng.knn_batch(body["queries"], int(body.get("k", 5)))
            if path == "/knn_join":
                return eng.knn_join(body["queries"], int(body.get("k", 5)),
                                    body["targets"])
            if path == "/prepare_targets":
                ph = eng.prepare_targets(body["targets"], name=body["name"])
                return {"prepared": body["name"], "size": ph.size,
                        "build_s": round(ph.build_s, 4)}
            if path == "/analogy":
                return eng.analogy(body["w1"], body["w2"], body["w3"])
            if path == "/analogy_in":
                return eng.analogy_in(body["w1"], body["w2"], body["w3"],
                                      body["targets"])
            if path == "/groups":
                return eng.groups(body["tokens"], body["group_tokens"])
            if path == "/cluster":
                return eng.cluster(body["tokens"], int(body.get("k", 5)))
            if path == "/tokenize":
                fn = eng.tokenize_raw if body.get("raw") else eng.tokenize
                v = fn(body["text"])
                return None if v is None else v.tolist()
            if path == "/insert":
                return {"inserted": eng.insert_batch(body["terms"])}
            if path == "/statistics":
                eng.create_statistics(body["name"], body["domain"])
                return {"created": body["name"]}
            if path == "/config":
                applied = {}
                for key, val in body.items():
                    if not key.startswith("set_") or not hasattr(eng, key):
                        raise UnknownEndpoint(f"unknown setting {key!r}")
                    getattr(eng, key)(val)
                    applied[key] = val
                return {"applied": applied}
            raise UnknownEndpoint(f"unknown endpoint {path}")


def main() -> None:
    """CLI: ``python -m postgres_word2vec.server_async <engine_dir>
    [port]`` — serve a previously saved engine."""
    import sys

    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()
    if len(sys.argv) < 2:
        print(__doc__)
        raise SystemExit(1)
    engine = Freddy.load(sys.argv[1])
    engine.warmup()
    port = int(sys.argv[2]) if len(sys.argv) > 2 else 8765
    server = AsyncQueryServer(engine, port=port)
    server.warmup()
    server.start()
    print(f"serving {engine.store.size} vectors on :{server.port} (async)")
    server.serve_forever()


if __name__ == "__main__":
    main()
