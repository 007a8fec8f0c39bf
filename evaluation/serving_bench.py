#!/usr/bin/env python3
"""End-to-end serving throughput: concurrent /knn clients against the HTTP
runtime at 3M scale on the real chip, swept over the knn dispatch families.

The reference's serving layer is Postgres itself (concurrent backends, one
process per connection, SPI per query). This measures the standalone
equivalent (`postgres_word2vec.server`): a fleet of single-query HTTP
clients whose requests the server coalesces into one device batch per
~window (micro-batching), which is how a k-NN service actually gets device
batch throughput without clients changing their request shape.

Each family in ``--families`` (exact, pq, pq_pv, ivfadc, ivfadc_pv) is a
separate measured window with ``dispatch['knn']`` pointed at that family's
implementation — the serving twin of the reference's ``set_knn_function``
(sql:78-92) — so the accelerated index paths are exercised under live
concurrent traffic, not just the exact baseline.

MEASUREMENT CAVEAT (recorded in the report): this host exposes ONE CPU
core (`host_cpus`). The 128 client processes, the threaded HTTP server,
and jax's dispatch path all share it, so the bench's ceiling is host CPU
scheduling, not the device — run-to-run spread of 2-3x has been observed
on identical code (398 vs 129 QPS, round 2 vs round 3). ``--repeats``
runs each family several times; compare medians, not single runs.

Usage: python evaluation/serving_bench.py [--n 3072000] [--clients 64]
       [--seconds 20] [--families exact,pq_pv,ivfadc_pv] [--repeats 2]
       [--out chiprun_out/serving_3M.json]
"""

from __future__ import annotations

import argparse
import http.client
import json
import multiprocessing as mp
import os
import sys
import time
import urllib.request

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Module level stays JAX-free: the client processes are SPAWNED and import
# this module, and a child that touched JAX would reserve device memory
# (a forked child of a process that initialised CUDA cannot run at all).


def log(msg) -> None:
    print(msg, file=sys.stderr, flush=True)

#: dispatch['knn'] implementation per sweep family name
FAMILY_IMPL = {
    "exact": "k_nearest_neighbour",
    "pq": "k_nearest_neighbour_pq",
    "pq_pv": "k_nearest_neighbour_pq_pv",
    "ivfadc": "k_nearest_neighbour_ivfadc",
    "ivfadc_pv": "k_nearest_neighbour_ivfadc_pv",
}


def post(port, path, payload, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def client_proc(cid, port, n, k, seconds, q, ready_q=None, go_ev=None):
    """Single-query closed-loop client on a persistent keep-alive
    connection (separate PROCESS: in-process threads would share the
    server's GIL, and a fresh TCP connection per request measures socket
    churn, not the engine — observed 13 QPS from harness overhead).
    ``ready_q``/``go_ev``: ramp barrier — connect, report ready, then wait
    for the collective go before the timed window opens (forking 64
    processes on the 1-core host takes seconds; without the barrier that
    ramp sat INSIDE the measured window, wall_s 24.7 for a 20 s window)."""
    r = np.random.default_rng(cid)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    my_lat = []
    err = 0
    if ready_q is not None:
        ready_q.put(cid)
        go_ev.wait()
    stop_t = time.time() + seconds
    while time.time() < stop_t:
        w = f"w{int(r.integers(0, n))}"
        body = json.dumps({"query": w, "k": k})
        t0 = time.perf_counter()
        try:
            conn.request("POST", "/knn", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            if resp.status == 200:
                my_lat.append(time.perf_counter() - t0)
            else:
                err += 1
        except Exception:
            err += 1
            conn.close()
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=60)
    q.put((my_lat, err))


def client_proc_raw(cid, port, n, k, seconds, q, check=True,
                    ready_q=None, go_ev=None):
    """Minimal raw-socket closed-loop client: prebuilt request bytes and a
    content-length body reader instead of http.client's full response
    machinery. On the 1-core bench host the CLIENT fleet shares the
    server's core, so client-side parsing cost directly depresses the
    measured server QPS — this keeps the measurement about the server.
    Every 64th response is json-decoded and sanity-checked so correctness
    stays verified without paying decode per request."""
    import socket

    r = np.random.default_rng(cid)

    def connect():
        s = socket.create_connection(("127.0.0.1", port), timeout=60)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    sock = connect()
    buf = b""
    my_lat = []
    err = 0
    err_kinds: dict = {}
    i = 0
    if ready_q is not None:   # ramp barrier (see client_proc)
        ready_q.put(cid)
        go_ev.wait()
    stop_t = time.time() + seconds
    while time.time() < stop_t:
        w = f"w{int(r.integers(0, n))}"
        body = ('{"query": "%s", "k": %d}' % (w, k)).encode()
        req = (b"POST /knn HTTP/1.1\r\nHost: l\r\n"
               b"Content-Type: application/json\r\nContent-Length: "
               + str(len(body)).encode() + b"\r\n\r\n" + body)
        t0 = time.perf_counter()
        try:
            sock.sendall(req)
            while b"\r\n\r\n" not in buf:
                chunk = sock.recv(65536)
                if not chunk:
                    raise ConnectionError("closed")
                buf += chunk
            head, _, buf = buf.partition(b"\r\n\r\n")
            cl = int(head.lower().split(b"content-length:")[1]
                     .split(b"\r\n")[0])
            while len(buf) < cl:
                chunk = sock.recv(65536)
                if not chunk:
                    raise ConnectionError("closed")
                buf += chunk
            payload, buf = buf[:cl], buf[cl:]
            if head.startswith(b"HTTP/1.1 200"):
                my_lat.append(time.perf_counter() - t0)
                if check and i % 64 == 0:   # periodic correctness check
                    rows = json.loads(payload)["result"]
                    assert rows and rows[0][0] == w, rows[:1]
            else:
                err += 1
                # classify by status + first bytes of the error body —
                # without this, a server-side batch failure reads as
                # anonymous client errors
                kind = ("status:" + head.split(b" ", 2)[1].decode()
                        + ":" + payload[:80].decode(errors="replace"))
                err_kinds[kind] = err_kinds.get(kind, 0) + 1
        except Exception as e:
            err += 1
            kind = type(e).__name__
            err_kinds[kind] = err_kinds.get(kind, 0) + 1
            try:
                sock.close()
            except Exception:
                pass
            buf = b""
            try:
                sock = connect()
            except Exception:
                break
        i += 1
    q.put((my_lat, err, err_kinds))


def run_window(port, n, k, clients, seconds, client_kind="raw"):
    ctx = mp.get_context("spawn")
    outq = ctx.Queue()
    ready_q = ctx.Queue()
    go_ev = ctx.Event()
    if client_kind == "http":
        mk = [(client_proc, (i, port, n, k, seconds, outq, ready_q, go_ev))
              for i in range(clients)]
    else:
        check = client_kind != "raw_nocheck"
        mk = [(client_proc_raw,
               (i, port, n, k, seconds, outq, check, ready_q, go_ev))
              for i in range(clients)]
    procs = [ctx.Process(target=fn, args=a) for fn, a in mk]
    for p in procs:
        p.start()
    # ramp barrier: wait until every client has forked + connected, then
    # open the timed window for all of them at once.
    for _ in procs:
        ready_q.get(timeout=120)
    t0 = time.perf_counter()
    go_ev.set()
    lat: list[float] = []
    errors = 0
    err_kinds: dict = {}
    for _ in procs:
        try:
            got = outq.get(timeout=seconds + 180)
        except Exception:
            errors += 1   # a client died without reporting
            err_kinds["client_died"] = err_kinds.get("client_died", 0) + 1
            continue
        my_lat, err = got[0], got[1]
        for kk, vv in (got[2] if len(got) > 2 else {}).items():
            err_kinds[kk] = err_kinds.get(kk, 0) + vv
        lat.extend(my_lat)
        errors += err
    for p in procs:
        p.join()
    wall = time.perf_counter() - t0
    lat_ms = np.asarray(sorted(lat)) * 1e3

    def pct(p):
        return float(np.percentile(lat_ms, p)) if lat_ms.size else None

    out = {"completed": int(lat_ms.size), "errors": errors,
           "wall_s": wall, "qps": lat_ms.size / wall,
           "latency_ms": {"p50": pct(50), "p95": pct(95), "p99": pct(99)}}
    if err_kinds:
        out["error_kinds"] = err_kinds
    return out


def run_echo_floor(clients, seconds, k, client_kind):
    """Measure the harness/transport floor: the SAME client fleet against
    a canned-response aiohttp server (no engine, no device). The gap
    between this and the engine sweep is the serving runtime's true cost;
    the floor itself is what the host + HTTP transport can do at all."""
    import threading

    import asyncio
    from aiohttp import web

    canned = {"result": [[f"w{i}", 0.5] for i in range(k)]}
    payload = json.dumps(canned).encode()
    ready = threading.Event()
    port_box = {}
    stop_box = {}

    async def handler(request):
        await request.read()
        return web.Response(body=payload, content_type="application/json")

    async def main_srv():
        app = web.Application()
        app.router.add_post("/{tail:.*}", handler)
        runner = web.AppRunner(app, access_log=None)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port_box["port"] = site._server.sockets[0].getsockname()[1]
        stop_box["ev"] = asyncio.Event()
        stop_box["loop"] = asyncio.get_running_loop()
        ready.set()
        await stop_box["ev"].wait()
        await runner.cleanup()

    th = threading.Thread(target=lambda: asyncio.run(main_srv()),
                          daemon=True)
    th.start()
    ready.wait(30)
    # the echo payload has no per-word correctness; disable the raw
    # client's periodic check by using the http client check-free path
    w = run_window(port_box["port"], 10, k, clients, seconds,
                   client_kind="http" if client_kind == "http" else "raw_nocheck")
    stop_box["loop"].call_soon_threadsafe(stop_box["ev"].set)
    th.join(timeout=10)
    return w


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=3_072_000)
    ap.add_argument("--d", type=int, default=300)
    ap.add_argument("--clients", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=128)
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument("--depth", type=int, default=2,
                    help="async server pipeline depth (in-flight batches)")
    ap.add_argument("--families", default="exact,pq_pv,ivfadc_pv",
                    help="comma list of " + ",".join(FAMILY_IMPL))
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--server", choices=("threaded", "async"),
                    default="async")
    ap.add_argument("--client", choices=("raw", "http"), default="raw")
    ap.add_argument("--echo-floor", action="store_true",
                    help="also measure the no-engine transport floor")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "reports",
        "serving_3M.json"))
    args = ap.parse_args()
    families = [f.strip() for f in args.families.split(",") if f.strip()]
    unknown = [f for f in families if f not in FAMILY_IMPL]
    if unknown:
        raise SystemExit(f"unknown families {unknown}; "
                         f"one of {sorted(FAMILY_IMPL)}")

    from postgres_word2vec.utils.config import init_compile_cache
    init_compile_cache()
    import jax

    from postgres_word2vec import Freddy, VectorStore
    from postgres_word2vec.evaluation import synth
    from postgres_word2vec.server import QueryServer

    need_pq = any(f.startswith("pq") for f in families)
    need_ivf = any(f.startswith("ivfadc") for f in families)
    log(f"serving_bench: N={args.n} clients={args.clients} "
        f"families={families} devices={jax.devices()} cpus={os.cpu_count()}")
    t0 = time.perf_counter()
    V = synth.generate_wordlike(jax.random.PRNGKey(0), args.n, args.d)
    words = [f"w{i}" for i in range(args.n)]
    store = VectorStore.from_arrays(words, V)
    eng = Freddy.build(store, with_pq=need_pq, with_ivfadc=need_ivf,
                       with_ivpq=False, exact_dtype="bfloat16",
                       exact_approx=True)
    log(f"engine up in {time.perf_counter() - t0:.1f}s "
        f"(pq={need_pq} ivfadc={need_ivf})")

    if args.server == "async":
        from postgres_word2vec.server_async import AsyncQueryServer
        srv = AsyncQueryServer(eng, port=0, max_batch=args.max_batch,
                               batch_window_ms=args.window_ms,
                               pipeline_depth=args.depth)
    else:
        srv = QueryServer(eng, port=0, max_batch=args.max_batch,
                          batch_window_ms=args.window_ms)
    srv.start()
    log(f"{args.server} server on :{srv.port}")

    results = {
        "n": args.n, "clients": args.clients, "seconds": args.seconds,
        "k": args.k, "max_batch": args.max_batch,
        "window_ms": args.window_ms, "pipeline_depth": args.depth,
        "host_cpus": os.cpu_count(),
        "server": args.server, "client": args.client,
        "families": {},
        "note": "concurrent single-query /knn clients; server coalesces "
                "into device batches (micro-batching); one window per knn "
                "dispatch family. The client fleet and the server share "
                "the host's cores, so QPS can be host-CPU-bound — compare "
                "medians across repeats.",
    }

    if args.echo_floor:
        w = run_echo_floor(args.clients, args.seconds, args.k, args.client)
        results["echo_floor"] = w
        p50e = w["latency_ms"]["p50"]
        log(f"[echo-floor] qps={w['qps']:.0f} "
            f"p50={p50e if p50e is None else round(p50e, 1)}ms (no engine "
            f"— harness + transport ceiling on this host)")

    for fam in families:
        eng.dispatch["knn"] = FAMILY_IMPL[fam]
        # warm every pow2 batch shape this family's core can see; cold
        # compiles would otherwise poison the measured window.
        t0 = time.perf_counter()
        srv.warmup(k=args.k)
        post(srv.port, "/knn", {"query": "w0", "k": args.k}, timeout=600)
        log(f"[{fam}] warm in {time.perf_counter() - t0:.1f}s")
        trials = []
        fail_health = None
        for rep in range(args.repeats):
            w = run_window(srv.port, args.n, args.k, args.clients,
                           args.seconds, client_kind=args.client)
            trials.append(w)
            p50, p95 = (w["latency_ms"]["p50"], w["latency_ms"]["p95"])
            log(f"[{fam}] trial {rep}: qps={w['qps']:.0f} "
                f"p50={p50 if p50 is None else round(p50, 1)}ms "
                f"p95={p95 if p95 is None else round(p95, 1)}ms "
                f"errors={w['errors']}"
                + (f" kinds={w['error_kinds']}" if w.get("error_kinds")
                   else ""))
            if w["completed"] == 0:
                # server (or engine executor) is wedged — grab the health
                # counters for the post-mortem and stop hammering it
                try:
                    h = json.loads(urllib.request.urlopen(
                        f"http://127.0.0.1:{srv.port}/health",
                        timeout=10).read())
                    log(f"[{fam}] zero completions; health={h}")
                    fail_health = h
                except Exception as he:  # noqa: BLE001
                    log(f"[{fam}] zero completions; health probe failed: "
                        f"{he!r}")
                break
        results["families"][fam] = {
            "impl": FAMILY_IMPL[fam], "trials": trials,
            "qps_median": float(np.median([t["qps"] for t in trials])),
        }
        if fail_health is not None:
            results["families"][fam]["health_at_failure"] = fail_health

    health = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{srv.port}/health", timeout=10).read())
    results["health"] = health
    srv.stop()

    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
