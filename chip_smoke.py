#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``glint_word2vec_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's sources; imports
nothing of JAX. Phases, each of which fails the run on any error:

1. Device: the ``nvidia-smi`` name and power-limit line.
2. Build: every ``csrc/*.cu`` with ``nvcc`` for ``sm_90a``, one process
   per source, all started together.
3. Kernel against plain: ``gather_rows`` against ``gather_rows_reference``
   (bitwise) on fp32 and bf16 tables of 1,000,000 x 300 and an fp32 table
   of 10,000,000 x 300 (12 GB: row offsets past 2^31 elements), at
   N in {1, 64, 10,000} with duplicate ids and ids 0 and V-1; the
   kernel's, the plain version's and ``torch.index_select``'s median time
   beside the bound (bytes moved over 3.35 TB/s).
4. Serve: a planted 1,000,000 x 300 fp32 model (random rows, word pairs
   whose rows are near copies, one analogy quadruple), saved with the
   port, served by ``serve_model_dir`` on an ephemeral port and asked
   through every endpoint; the answers must be the planted ones, and the
   kernel's launch count must grow on that served path. Request latency
   with 1 and 16 clients (host clock), and the card's busy share under
   16 clients (``torch.profiler``).

It prints one JSON ``kernels`` line, the ``nvidia-smi`` line, and as its
last line ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes per second.
HBM_BYTES_PER_S = 3.35e12
V_SERVE, D = 1_000_000, 300
V_BIG = 10_000_000
GATHER_NS = (1, 64, 10_000)
TIMED_TRIALS = 25
#: Requests per latency sample: p95 of 200 has 10 samples beyond it.
SEQ_REQUESTS = 200


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


# ----------------------------------------------------------------------
# Phase 3: kernel against plain version
# ----------------------------------------------------------------------


def gather_ids(torch, n: int, v: int, gen):
    """``n`` int32 ids on the card with ids V-1 and 0, and duplicates."""
    ids = torch.randint(0, v, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    ids[0] = v - 1
    if n > 2:
        ids[1] = 0
        ids[2] = v - 1
    if n > 8:
        ids[3:8] = ids[8]
    return ids


def median_ms(torch, fn, flush) -> float:
    """Median device time of one ``fn()`` call over ``TIMED_TRIALS``
    calls, each after a write of ``flush`` that evicts the 50 MB L2, so
    the table rows come from device memory as a served query finds them.
    A ~1 ms device-side sleep ahead of the start event lets the host
    enqueue the whole call before the device reaches it, so the window
    holds device time only, not the wrapper's host time."""
    fn()
    times = []
    for _ in range(TIMED_TRIALS):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def check_gather(torch, rows_mod) -> dict:
    """Phase 3. Returns the per-case results, keyed by (dtype, V, N)."""
    gen = torch.Generator(device="cuda").manual_seed(20261016)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    results = {}
    cases = [(torch.float32, V_SERVE), (torch.bfloat16, V_SERVE),
             (torch.float32, V_BIG)]
    for dtype, v in cases:
        table = torch.randn((v, D), generator=gen, device="cuda").to(dtype)
        for n in GATHER_NS:
            ids = gather_ids(torch, n, v, gen)
            out = rows_mod.gather_rows(table, ids)
            torch.cuda.synchronize()
            ref = rows_mod.gather_rows_reference(table, ids)
            if out.shape != (n, D) or out.dtype != torch.float32:
                raise AssertionError(f"gather_rows gave {out.dtype} {tuple(out.shape)}")
            if not torch.equal(out, ref):
                raise AssertionError(
                    f"gather_rows differs from its plain version at "
                    f"{dtype} V={v} N={n}: max |diff| "
                    f"{(out - ref).abs().max().item()}"
                )
            err = (out - ref).abs().max().item()
            ms = median_ms(torch, lambda: rows_mod.gather_rows(table, ids), flush)
            plain = median_ms(
                torch, lambda: rows_mod.gather_rows_reference(table, ids), flush
            )
            library = median_ms(
                torch, lambda: torch.index_select(table, 0, ids), flush
            )
            # Bytes the gather must move: each distinct row read once, the
            # ids read, the fp32 rows written. No arithmetic to count.
            uniq = int(torch.unique(ids).numel())
            nbytes = uniq * D * table.element_size() + 4 * n + n * D * 4
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            name = "f32" if dtype == torch.float32 else "bf16"
            results[(name, v, n)] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "library_ms": library, "bound_ms": bound, "bytes": nbytes,
            }
            log(f"gather_rows {name} V={v} d={D} N={n}: bitwise equal; "
                f"kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"index_select {library:.4f} ms, bound {bound:.5f} ms "
                f"({nbytes} bytes at 3.35 TB/s)")
        del table
        torch.cuda.empty_cache()
    return results


# ----------------------------------------------------------------------
# Phase 4: serve a planted model end to end
# ----------------------------------------------------------------------


def planted_model(torch, np):
    """A 1,000,000 x 300 fp32 model on the card: random rows, 16 word
    pairs (2i, 2i+1) whose second row is the first plus 1% noise, and one
    analogy quadruple b2 = b1 - a1 + a2 + 1% noise."""
    from glint_word2vec_torch.convert import model_from_arrays
    from glint_word2vec_torch.utils.params import Word2VecParams

    gen = torch.Generator(device="cuda").manual_seed(300)
    syn0 = torch.randn((V_SERVE, D), generator=gen, device="cuda")
    noise = lambda: 0.01 * torch.randn((D,), generator=gen, device="cuda")
    for i in range(16):
        syn0[2 * i + 1] = syn0[2 * i] + noise()
    a1, a2, b1, b2 = 100, 101, 102, 103
    syn0[b2] = syn0[b1] - syn0[a1] + syn0[a2] + noise()
    syn1 = torch.zeros((V_SERVE, D), device="cuda")
    words = [f"w{i}" for i in range(V_SERVE)]
    counts = np.arange(V_SERVE, 0, -1, dtype=np.int64)
    model = model_from_arrays(
        words, syn0, syn1, counts, Word2VecParams(vector_size=D, min_count=1),
        device="cuda",
    )
    return model, syn0[:200].cpu().numpy(), (a1, a2, b1, b2)


def summary(ms) -> str:
    """Median and p95 of request times, with the sample count."""
    xs = sorted(ms)
    return (f"p50 {xs[len(xs) // 2]:.3f} ms, p95 "
            f"{xs[min(len(xs) - 1, int(0.95 * len(xs)))]:.3f} ms, n={len(xs)}")


def expect(cond, what) -> None:
    """Fail the run unless ``cond`` holds (kept under ``python -O``)."""
    if not cond:
        raise AssertionError(what)


def get_json(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def post(port: int, path: str, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def post_status(port: int, path: str, payload) -> int:
    try:
        post(port, path, payload)
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def closed_loop(port: int, clients: int, per_client: int, first_word: int):
    """``clients`` threads, each sending ``per_client`` ``/synonyms``
    requests back to back for words no earlier request asked for (cache
    misses). Returns every request's latency in ms and the wall seconds."""
    lat = [[] for _ in range(clients)]

    def client(c):
        for i in range(per_client):
            word = f"w{first_word + c * per_client + i}"
            t = time.perf_counter()
            post(port, "/synonyms", {"word": word, "num": 10})
            lat[c].append((time.perf_counter() - t) * 1e3)

    t = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    wall = time.perf_counter() - t
    xs = [x for c in lat for x in c]
    expect(len(xs) == clients * per_client, "a closed-loop client failed")
    return xs, wall


def closed_loop_in_child(port: int, clients: int, per_client: int,
                         first_word: int):
    """:func:`closed_loop` in a child process, so the clients' Python does
    not take the server's interpreter lock from it."""
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply(closed_loop, (port, clients, per_client, first_word))


def device_busy(torch, port: int) -> None:
    """Share of a 16-client ``/synonyms`` window in which the card was
    busy, from a ``torch.profiler`` trace of this process (the server's
    threads run here), and the kernels that took the most device time.
    A window of its own: the profiler slows the host side it traces."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        xs, wall = closed_loop_in_child(port, 16, 25, 300_000)
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:  # union of the device intervals, in microseconds
        if e > end:
            busy_us += e - max(s, end)
            end = e
    if not spans:
        log("device busy share: not measured (the profiler saw no device "
            "activity)")
        return
    log(f"device busy share, 16 clients (profiled, {len(xs)} requests in "
        f"{wall:.3f} s): {busy_us / (wall * 1e6):.4f}")
    top = sorted(prof.key_averages(), key=lambda a: -a.self_device_time_total)
    for a in top[:6]:
        log(f"  {a.self_device_time_total / 1e3:9.3f} ms  x{a.count:<6d} "
            f"{a.key[:90]}")


def time_layers(torch, model) -> None:
    """Where one single-word synonym query spends its time below HTTP:
    the device work alone (one-row gather, the 1,000,000 x 300 scoring
    product, the masked ``topk``; L2 flushed) against the same query
    through ``Word2VecModel.find_synonyms`` on the host clock."""
    eng = model.engine
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    ids = torch.zeros(1, dtype=torch.int32, device="cuda")
    inv, neg = eng._mask_terms()

    def device_work():
        q = eng._pull_rows(ids)
        torch.topk((eng.syn0 @ q.T).T * inv + neg, 16)

    dev = median_ms(torch, device_work, flush)
    xs = []
    for i in range(SEQ_REQUESTS):
        t = time.perf_counter()
        model.find_synonyms(f"w{3000 + i}", 10)
        xs.append((time.perf_counter() - t) * 1e3)
    log(f"find_synonyms in process: {summary(xs)}; its device work alone "
        f"{dev:.4f} ms")


def serve_end_to_end(torch, np, rows_mod) -> dict:
    """Phase 4. Returns the served-path counts and request times."""
    from glint_word2vec_torch.serving import serve_model_dir

    tmp = tempfile.mkdtemp(prefix="glint_chip_smoke_")
    try:
        t0 = time.perf_counter()
        model, rows, (a1, a2, b1, b2) = planted_model(torch, np)
        model_dir = os.path.join(tmp, "model")
        model.save(model_dir)
        log(f"planted model built and saved in {time.perf_counter() - t0:.1f} s")
        time_layers(torch, model)
        model.stop()
        del model
        torch.cuda.empty_cache()

        port_file = os.path.join(tmp, "port.json")
        failure = []

        def run():
            try:
                serve_model_dir(model_dir, port=0, port_file=port_file,
                                device="cuda")
            except BaseException as e:  # reported by the main thread
                failure.append(e)

        # The served path starts here: every launch from now on is one the
        # server made for its load, warmup or requests.
        rows_mod.gather_rows.launches = 0
        t0 = time.perf_counter()
        th = threading.Thread(target=run, name="serve_model_dir", daemon=True)
        th.start()
        while not os.path.exists(port_file):
            if failure or not th.is_alive():
                raise RuntimeError(f"serve_model_dir failed: {failure}")
            if time.perf_counter() - t0 > 600:
                raise RuntimeError("server not listening after 600 s")
            time.sleep(0.2)
        with open(port_file) as f:
            port = json.load(f)["port"]
        log(f"server loaded, warmed and listening in "
            f"{time.perf_counter() - t0:.1f} s (port {port})")

        health = get_json(port, "/healthz")
        expect(health["status"] == "ok", health)
        expect((health["vocab_size"], health["dim"]) == (V_SERVE, D), health)
        expect(health["device"] == torch.cuda.get_device_name(0), health)

        vec = np.asarray(post(port, "/vector", {"word": "w7"}), np.float32)
        expect(np.array_equal(vec, rows[7]), "/vector differs from the row")

        def unit(x):
            return x / np.linalg.norm(x)

        per_request = {}
        for i in range(16):
            a, b = f"w{2 * i}", f"w{2 * i + 1}"
            before = rows_mod.gather_rows.launches
            hits = post(port, "/synonyms", {"word": a, "num": 5})
            per_request.setdefault("/synonyms", rows_mod.gather_rows.launches - before)
            expect(len(hits) == 5 and hits[0][0] == b, (a, hits))
            cos = float(unit(rows[2 * i].astype(np.float64))
                        @ unit(rows[2 * i + 1].astype(np.float64)))
            expect(abs(hits[0][1] - cos) < 1e-5, (hits[0], cos))

        hits = post(port, "/synonyms_vector",
                    {"vector": rows[2].tolist(), "num": 3})
        expect([h[0] for h in hits[:2]] == ["w2", "w3"], hits)

        before = rows_mod.gather_rows.launches
        hits = post(port, "/analogy", {
            "positive": [f"w{b1}", f"w{a2}"], "negative": [f"w{a1}"], "num": 3,
        })
        per_request["/analogy"] = rows_mod.gather_rows.launches - before
        expect(hits[0][0] == f"w{b2}", hits)

        sents = [[f"w{a1}", f"w{a2}", f"w{b1}"], [f"w{b2}", "not_a_word"], []]
        before = rows_mod.gather_rows.launches
        means = np.asarray(post(port, "/transform", {"sentences": sents}))
        per_request["/transform"] = rows_mod.gather_rows.launches - before
        want = np.stack([
            rows[[a1, a2, b1]].astype(np.float64).mean(axis=0),
            rows[b2].astype(np.float64), np.zeros(D),
        ])
        expect(means.shape == (3, D) and np.isfinite(means).all(),
               f"/transform gave shape {means.shape}")
        # 1e-6 relative to the largest entry: an fp32 mean of three rows
        # rounds at that scale.
        err = np.abs(means - want).max()
        expect(err <= 1e-6 * max(1.0, np.abs(want).max()),
               f"/transform differs from the mean of the rows by {err}")

        expect(post_status(port, "/vector", {"word": "not_a_word"}) == 404,
               "an out-of-vocabulary /vector did not answer 404")
        expect(post_status(port, "/synonyms", {"word": "w1", "num": -1}) == 400,
               "/synonyms with num=-1 did not answer 400")

        # 16 concurrent /synonyms (new words, so no cache hits).
        results = [None] * 16

        def ask(i):
            results[i] = post(port, "/synonyms", {"word": f"w{2 * i + 1}", "num": 3})

        stats0 = get_json(port, "/healthz")["coalescer"]
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i, hits in enumerate(results):
            expect(hits is not None and hits[0][0] == f"w{2 * i}", (i, hits))
        stats = get_json(port, "/healthz")["coalescer"]
        log(f"16 concurrent /synonyms: {stats['requests'] - stats0['requests']}"
            f" requests in {stats['dispatches'] - stats0['dispatches']} "
            f"dispatches (largest batch so far {stats['largest_batch']})")

        # Request latency on the host clock, every request a cache miss:
        # one client in a closed loop, then 16 clients in a closed loop
        # from a child process.
        lat = {"/synonyms": [], "/transform": []}
        for i in range(SEQ_REQUESTS):
            t = time.perf_counter()
            post(port, "/synonyms", {"word": f"w{1000 + i}", "num": 10})
            lat["/synonyms"].append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            post(port, "/transform",
                 {"sentences": [[f"w{5000 + 8 * i + j}" for j in range(8)]]})
            lat["/transform"].append((time.perf_counter() - t) * 1e3)
        for path, xs in lat.items():
            log(f"{path}, 1 client: {summary(xs)}")
        stats = get_json(port, "/healthz")["coalescer"]
        xs, wall = closed_loop_in_child(port, 16, SEQ_REQUESTS // 2, 100_000)
        stats1 = get_json(port, "/healthz")["coalescer"]
        log(f"/synonyms, 16 clients: {summary(xs)}; {len(xs) / wall:.1f} "
            f"requests/s; {stats1['requests'] - stats['requests']} requests in "
            f"{stats1['dispatches'] - stats['dispatches']} dispatches")
        device_busy(torch, port)

        expect(post(port, "/shutdown", {}) == {"status": "shutting down"},
               "/shutdown was not acknowledged")
        th.join(timeout=120)
        if th.is_alive():
            raise RuntimeError("server did not stop after /shutdown")
        if failure:
            raise RuntimeError(f"serve_model_dir failed: {failure[0]!r}")
        launches = rows_mod.gather_rows.launches
        log(f"served path: gather_rows launched {launches} times; per "
            f"request {per_request}")
        if launches <= 0:
            raise AssertionError("the served path never launched gather_rows")
        return {"launches": launches, "per_request": per_request}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    import numpy as np

    from glint_word2vec_torch.kernels import build
    from glint_word2vec_torch.ops import rows as rows_mod

    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda}); "
        f"nvidia-smi: {smi}")

    secs = build.build()
    log(f"built {build.sources()} with nvcc in {secs:.1f} s")
    for name, text in sorted(build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    gathered = check_gather(torch, rows_mod)
    served = serve_end_to_end(torch, np, rows_mod)

    main_case = gathered[("f32", V_SERVE, 10_000)]
    kernels = {"kernels": [{
        "name": "gather_rows",
        "route": "cuda",
        "source": "glint_word2vec_torch/csrc/gather_rows.cu",
        "replaces": "glint_word2vec_tpu/ops/pallas_rows.py:75",
        "launches": served["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in gathered.values()),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_case["library_ms"],
        "checked": True,
        "shape": f"fp32 table {V_SERVE}x{D}, N=10000",
    }]}
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
