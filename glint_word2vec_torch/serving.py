"""Serving a saved model over HTTP (counterpart of
``glint_word2vec_tpu/serving.py``, single model).

Endpoints (JSON in and out, stdlib server), with the JAX package's request
and response shapes and status codes:

  GET  /healthz            -> {"status": "ok", "vocab_size": V, "dim": d, ...}
  POST /synonyms           {"word": w, "num": k[, "exact": true]}
  POST /synonyms_vector    {"vector": [...], "num": k[, "exact": true]}
  POST /analogy            {"positive": [...], "negative": [...], "num": k}
  POST /vector             {"word": w}            (OOV -> 404)
  POST /transform          {"sentences": [[w, ...], ...]}  (OOV dropped)
  POST /reload             {"dir": GEN_DIR} swaps that generation in; {}
                           polls the watched publish directory now
  POST /shutdown           stops the server

An out-of-vocabulary word answers 404 and a bad ``num`` 400. Device work
is serialised by one lock. Concurrent ``/synonyms`` and
``/synonyms_vector`` requests of a word-level model are coalesced:
whichever waiting thread takes the lock next answers every pending
request with one pull and one batched top-k per ``max_batch`` chunk.
Results of word queries are cached by ``(word, num)`` until the engine's
``table_version`` moves. A model family that overrides ``transform``,
``find_synonyms`` or ``find_synonyms_vector`` (fastText composes word
vectors from subwords, out-of-vocabulary words included) answers through
its own methods, one request at a time under the lock, as the JAX
server's ``can_batch`` rule does. The server runs every query shape once
(``warmup``) before it binds its port.

With ``ann=True`` a word-level model also serves ``/synonyms`` through the
engine's ANN index (``ops/ann.py``): built at start, warmed, then gated by
its measured recall@10 against the exact path. A failing gate keeps the
exact path serving; ``"exact": true`` on a request always takes it. Cache
keys carry the mode, and a drained batch dispatches each mode apart.
``/healthz`` reports ``ann_enabled``, ``ann_recall_gate_ok`` and an
``index`` block.

Hot swap: :meth:`ModelServer.watch` follows a streaming trainer's publish
directory (:class:`SnapshotWatcher` polls ``LATEST.json``), and
:meth:`ModelServer.reload_generation` swaps a committed generation in.
Staging (the manifest-checked read into new device tensors, the
vocabulary and, with ``ann=True``, the new generation's index and its
recall gate) runs with no lock held, beside live queries; the flip (tables,
vocabulary, index and the result cache) runs under the device lock, so no
response mixes two generations. Same-shape tables reuse every warmed
query shape. ``/healthz`` names the served ``generation``; the swap
counters are on ``ModelServer.metrics``.

Start from the CLI:  python -m glint_word2vec_torch.cli serve --model DIR
                     (or --watch-checkpoint PUBLISH_DIR)
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlparse

import numpy as np

from glint_word2vec_torch.device import DeviceLike, device_name
from glint_word2vec_torch.models.word2vec import MAX_QUERY_ROWS
from glint_word2vec_torch.utils import atomic_write_json, faults, next_pow2
from glint_word2vec_torch.utils.metrics import ServingMetrics

logger = logging.getLogger(__name__)

#: Name of the one model a server holds (the JAX server's default model).
DEFAULT_MODEL_ID = "default"

#: The warmed serving shapes: k buckets 16 and 32 (num < 16 rounds into
#: 16; num in [16, 31], fetching num+1, into 32) and the transform grid of
#: sentence rows x lengths, all powers of two as the model pads them.
WARM_KS = (16, 32)
WARM_SENTENCE_LENS = (1, 2, 4, 8, 16, 32, 64)
WARM_SENTENCE_ROWS = (1, 2, 4, 8, 16)

#: Seconds a coalescing leader waits for more requests of a burst before
#: it dispatches (only when it already drained two or more).
_BATCH_GRACE_S = 0.002


def _pull_coalesced(engine, idx: np.ndarray) -> np.ndarray:
    """Word rows for a coalesced batch, ``MAX_QUERY_ROWS`` at a time, each
    chunk padded with row 0 to its power-of-two bucket and sliced back."""
    out = np.empty((idx.shape[0], engine.dim), np.float32)
    for s in range(0, idx.shape[0], MAX_QUERY_ROWS):
        sub = idx[s : s + MAX_QUERY_ROWS]
        n = sub.shape[0]
        n_b = next_pow2(n)
        if n_b != n:
            sub = np.concatenate([sub, np.zeros(n_b - n, np.int32)])
        out[s : s + n] = engine.pull(sub).cpu().numpy()[:n]
    return out


class _SynonymCoalescer:
    """Leader-elected micro-batching for the synonym endpoints.

    Every request lands in a pending list; whichever thread next takes
    the device lock becomes leader, drains the list, answers all of it
    with one pull plus one batched top-k per ``max_batch`` chunk, and
    wakes the waiters. Exclusion semantics match ``find_synonyms``
    (fetch num+1, drop the query word, truncate)."""

    def __init__(self, model, device_lock, max_batch: int = 64,
                 cache_size: int = 65536):
        from glint_word2vec_torch.models.word2vec import Word2VecModel

        self.model = model
        self.device_lock = device_lock
        #: Whether the batched word path (one pull of the word rows, one
        #: batched top-k) gives the model's own answers: only for a family
        #: that keeps the word-level ``transform`` and synonym methods.
        cls = type(model)
        self.can_batch = (
            isinstance(model, Word2VecModel)
            and cls.find_synonyms is Word2VecModel.find_synonyms
            and cls.find_synonyms_vector is Word2VecModel.find_synonyms_vector
            and cls.transform is Word2VecModel.transform
        )
        #: Dispatch cap, a power of two so chunks fall on the Q buckets.
        self.max_batch = next_pow2(max(1, int(max_batch)))
        #: Bounded ``(word, num)`` -> result cache, emptied whenever the
        #: engine's ``table_version`` moves; FIFO eviction, 0 disables.
        self.cache_size = max(0, int(cache_size))
        self._cache: dict = {}
        self._cache_version = None
        self._mu = threading.Lock()
        self._pending: list = []
        #: Dispatch counts for ``/healthz``: batched dispatches, requests
        #: they answered, the largest batch, and cache hits.
        self.stats = {"dispatches": 0, "requests": 0, "largest_batch": 0,
                      "cache_hits": 0}
        #: Whether default requests take the approximate path (installed
        #: by the server once its index is built and gated); a request
        #: with ``exact=True`` never does.
        self.ann_active = lambda: False
        #: True while an index exists but the recall gate holds the
        #: approximate path back: those exact serves count as gate
        #: fallbacks.
        self.gate_failing = lambda: False
        #: The nprobe the approximate path runs at.
        self.ann_nprobe = 0
        #: Approximate queries answered, and exact ones served while an
        #: index exists, by reason (``requested`` or ``gate``).
        self.index_stats = {"ann_queries_total": 0,
                            "exact_fallbacks": {"requested": 0, "gate": 0}}

    def query(self, word=None, vector=None, num: int = 10,
              exact: bool = False):
        if not self.can_batch:
            with self.device_lock:
                if word is not None:
                    return self.model.find_synonyms(word, num)
                return self.model.find_synonyms_vector(vector, num)
        if num <= 0:
            # find_synonyms(w, num) looks the word up first (OOV -> 404),
            # then fetches num+1: num=0 with a known word is [], num<0 a
            # 400. The vector endpoint always refuses num <= 0.
            if word is not None:
                if word not in self.model.vocab.word_index:
                    raise KeyError(f"word {word!r} not in vocabulary")
                if num == 0:
                    return []
            raise ValueError("num must be > 0")
        # The mode is fixed at enqueue: a gate flip while the request waits
        # must not hand it a mode its cache key never saw.
        mode = "exact" if (exact or not self.ann_active()) else "ann"
        if word is not None and self.cache_size:
            with self._mu:
                self._cache_sync_locked()
                hit = self._cache.get((word, num, mode))
                if hit is not None:
                    self.stats["cache_hits"] += 1
                    return hit
        req = {"word": word, "vector": vector, "num": int(num),
               "event": threading.Event(), "result": None, "error": None,
               "mode": mode, "exact_requested": bool(exact)}
        with self._mu:
            self._pending.append(req)
        # A leader sets every event of its batch before it releases the
        # lock, so a request already answered does not queue behind the
        # next leader's dispatch.
        if not req["event"].is_set():
            with self.device_lock:
                if not req["event"].is_set():
                    with self._mu:
                        batch, self._pending = self._pending, []
                    if len(batch) > 1:
                        # Concurrency seen: absorb stragglers of the same
                        # burst until one quiet grace window or a full
                        # chunk, so they ride this dispatch.
                        for _ in range(8):
                            n0 = len(batch)
                            time.sleep(_BATCH_GRACE_S)
                            with self._mu:
                                batch += self._pending
                                self._pending = []
                            if len(batch) == n0 or len(batch) >= self.max_batch:
                                break
                    if batch:
                        self._process(batch)
        req["event"].wait()
        if req["error"] is not None:
            raise req["error"]
        return req["result"]

    def _cache_sync_locked(self) -> int:
        """Empty the cache if the tables moved since it was filled; the
        version it is now valid for. Caller holds ``self._mu``."""
        ver = self.model.engine.table_version
        if ver != self._cache_version:
            self._cache.clear()
            self._cache_version = ver
        return ver

    def _process(self, batch) -> None:
        m = self.model
        live = []
        for r in batch:
            # A bad request fails alone: an exception escaping here would
            # strand every co-batched waiter.
            try:
                if r["word"] is not None:
                    i = m.vocab.word_index.get(r["word"])
                    if i is None:
                        raise KeyError(f"word {r['word']!r} not in vocabulary")
                    r["idx"] = i
                else:
                    v = np.asarray(r["vector"], dtype=np.float32)
                    if v.shape != (m.vector_size,):
                        raise ValueError(
                            f"vector must have shape ({m.vector_size},), "
                            f"got {v.shape}"
                        )
                    r["vec"] = v
            except KeyError as e:
                r["error"] = e
                r["event"].set()
                continue
            except (TypeError, ValueError) as e:
                r["error"] = ValueError(f"bad vector: {e}")
                r["event"].set()
                continue
            live.append(r)
        try:
            # A batch can mix modes: each mode group is its own dispatch.
            for mode in ("ann", "exact"):
                group = [r for r in live if r["mode"] == mode]
                for s in range(0, len(group), self.max_batch):
                    self._dispatch(group[s : s + self.max_batch], mode)
        except Exception as e:
            logger.exception("synonym dispatch failed")
            for r in live:
                if r["error"] is None and r["result"] is None:
                    r["error"] = e
        finally:
            for r in live:
                r["event"].set()

    def _dispatch(self, chunk, mode: str = "exact") -> None:
        """Answer one <= max_batch slice with one pull and one batched
        top-k, exact or through the ANN index (``mode == "ann"``)."""
        m = self.model
        # Version before the reads: results of a dispatch that a table
        # mutation overtook must not enter the cache.
        ver = m.engine.table_version
        word_rows = [r for r in chunk if "idx" in r]
        if word_rows:
            pulled = _pull_coalesced(
                m.engine, np.asarray([r["idx"] for r in word_rows], np.int32)
            )
            for r, v in zip(word_rows, pulled):
                r["vec"] = v
        k = max(r["num"] + (1 if r["word"] is not None else 0) for r in chunk)
        hits = m.find_synonyms_batch(
            np.stack([r["vec"] for r in chunk]), min(k, m.vocab.size),
            approximate=(mode == "ann"),
        )
        for r, hs in zip(chunk, hits):
            if r["word"] is not None:
                hs = [(w, s) for w, s in hs if w != r["word"]]
            r["result"] = hs[: r["num"]]
        with self._mu:
            self.stats["dispatches"] += 1
            self.stats["requests"] += len(chunk)
            self.stats["largest_batch"] = max(
                self.stats["largest_batch"], len(chunk)
            )
            if mode == "ann":
                self.index_stats["ann_queries_total"] += len(chunk)
            elif self.ann_active() or self.gate_failing():
                # Per request: an explicit exact=true is "requested" even
                # while the gate fails; only defaults held back count as
                # "gate".
                fb = self.index_stats["exact_fallbacks"]
                n_req = sum(1 for r in chunk if r["exact_requested"])
                fb["requested"] += n_req
                if self.gate_failing():
                    fb["gate"] += len(chunk) - n_req
            if not self.cache_size or self._cache_sync_locked() != ver:
                return
            for r in chunk:
                if r["word"] is not None:
                    while len(self._cache) >= self.cache_size:
                        self._cache.pop(next(iter(self._cache)))
                    self._cache[(r["word"], r["num"], mode)] = r["result"]


class SnapshotWatcher:
    """Background poller that follows a publish directory's
    ``LATEST.json`` (``streaming/publish.py``) and hot-swaps each new
    generation into the server (``serving.py:609-800`` of the JAX
    package).

    The pointer flips only after a generation's atomic commit, so the
    watcher never sees a partial snapshot, and staging checks the
    matrix's manifest besides: a corrupt generation is a counted swap
    failure (the previous tables stay live) and is not retried until the
    pointer moves. Transient storage trouble is not failure: a pointer or
    generation read error backs off with a capped doubling delay and is
    retried on a later poll, counted in ``watch_errors``."""

    #: Transient-error backoff ceiling (seconds).
    BACKOFF_CAP = 30.0
    #: Consecutive polls a referenced generation directory may be
    #: invisible before it is marked failed: rename visibility can lag the
    #: pointer on a network filesystem, an operator's deletion lasts.
    MISSING_DIR_STRIKES = 2
    #: Consecutive transient staging read errors (``OSError`` inside an
    #: existing generation directory) before the generation is marked
    #: failed.
    STAGING_ERROR_STRIKES = 5

    def __init__(self, server: "ModelServer", watch_dir: str,
                 poll_seconds: float = 1.0):
        self.server = server
        self.watch_dir = watch_dir
        self.poll_seconds = max(0.05, float(poll_seconds))
        #: Current backoff (0 while healthy).
        self._backoff = 0.0
        #: ``time.monotonic()`` before which polls are skipped.
        self._retry_at = 0.0
        #: (generation, consecutive polls its directory was missing).
        self._missing = (None, 0)
        #: (generation, consecutive transient staging read errors).
        self._stage_errs = (None, 0)
        #: Generation served (``/reload`` reads it for "unchanged").
        self.current: Optional[str] = None
        #: Last generation that failed staging: not retried until the
        #: pointer names another.
        self._failed: Optional[str] = None
        #: Serialises polls of the watcher thread and ``/reload`` request
        #: threads, so one generation is never staged or adopted twice.
        self._poll_mu = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def metrics(self) -> ServingMetrics:
        return self.server.metrics

    def poll_once(self) -> Optional[str]:
        """One pointer check; returns the generation swapped in, else
        None. Never raises: failures are logged and counted."""
        with self._poll_mu:
            return self._poll_once_locked()

    def _poll_once_locked(self) -> Optional[str]:
        from glint_word2vec_torch.streaming.publish import read_latest

        if time.monotonic() < self._retry_at:
            return None  # backing off after a transient read error
        try:
            latest = read_latest(self.watch_dir, raise_errors=True)
        except (OSError, ValueError) as e:
            return self._watch_error_locked(f"unreadable pointer: {e}")
        if latest is None:
            self._backoff = 0.0
            return None
        gen = str(latest["generation"])
        if gen == self.current or gen == self._failed:
            self._backoff = 0.0
            return None
        gen_dir = os.path.join(self.watch_dir, gen)
        if not os.path.isdir(gen_dir):
            mgen, n = self._missing
            n = n + 1 if mgen == gen else 1
            self._missing = (gen, n)
            if n < self.MISSING_DIR_STRIKES:
                return self._watch_error_locked(
                    f"referenced generation {gen} not visible yet "
                    f"(miss {n}/{self.MISSING_DIR_STRIKES})"
                )
            logger.error("hot-swap of %s failed: generation directory "
                         "missing after %d polls", gen, n)
            self.metrics.record_swap(gen, ok=False)
            self._failed = gen
            return None
        self._missing = (None, 0)
        try:
            self.server.reload_generation(gen_dir, generation=gen)
        except OSError as e:
            # The directory exists but a read inside it failed: transient
            # storage trouble unless it lasts.
            sgen, n = self._stage_errs
            n = n + 1 if sgen == gen else 1
            self._stage_errs = (gen, n)
            if n >= self.STAGING_ERROR_STRIKES:
                logger.error("hot-swap of %s failed: %d consecutive staging "
                             "read errors (%s)", gen, n, e)
                self.metrics.record_swap(gen, ok=False)
                self._failed = gen
                return None
            return self._watch_error_locked(
                f"transient read error staging {gen}: {e} "
                f"(strike {n}/{self.STAGING_ERROR_STRIKES})"
            )
        except Exception as e:
            logger.error("hot-swap of %s failed: %s", gen, e)
            self.metrics.record_swap(gen, ok=False)
            self._failed = gen
            return None
        self.current = gen
        self._failed = None
        self._backoff = 0.0
        self._stage_errs = (None, 0)
        return gen

    def _watch_error_locked(self, msg: str) -> None:
        """Count one transient read failure and arm the capped doubling
        retry delay."""
        self._backoff = min(max(self.poll_seconds, self._backoff * 2),
                            self.BACKOFF_CAP)
        self._retry_at = time.monotonic() + self._backoff
        self.metrics.record_watch_error()
        logger.warning("snapshot watcher: %s (retrying in %.1fs)", msg,
                       self._backoff)
        return None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="glint-snapshot-watcher")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_seconds):
            self.poll_once()

    def stop(self) -> None:
        """Stop polling and wait for a swap in progress to end."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=300)


class ModelServer:
    """Holds one loaded model and serves its query surface over HTTP.

    ``max_batch`` caps the coalesced dispatch (rounded up to a power of
    two). ``warmup=True`` runs every query shape of the serving family
    (Q buckets up to ``max_batch``, the ``WARM_KS`` k buckets, the
    ``WARM_SENTENCE_ROWS`` x ``WARM_SENTENCE_LENS`` transform grid) before
    the port binds, so the first request pays no kernel build or library
    set-up. ``port=0`` binds an ephemeral port; ``self.port`` says which.

    ``ann=True`` (word-level families only) configures the engine's ANN
    index with ``ann_clusters``, ``ann_nprobe``, ``ann_iters`` and
    ``ann_sample``, builds it unless one is adopted, warms the approximate
    shapes with the exact ones, and then gates it: recall@10 against the
    exact path on ``ann_recall_sample`` rows must reach
    ``ann_recall_gate``, or the exact path keeps serving.
    """

    def __init__(
        self,
        model,
        host: str = "127.0.0.1",
        port: int = 8801,
        *,
        max_batch: int = 64,
        warmup: bool = True,
        cache_size: int = 65536,
        ann: bool = False,
        ann_clusters: int = -1,
        ann_nprobe: int = 8,
        ann_iters: int = 6,
        ann_sample: int = 65536,
        ann_recall_gate: float = 0.95,
        ann_recall_sample: int = 64,
    ):
        self.model = model
        self._lock = threading.Lock()
        #: Hot-swap counters and the served generation.
        self.metrics = ServingMetrics()
        #: The publish-directory watcher (:meth:`watch`), or None.
        self.watcher: Optional[SnapshotWatcher] = None
        #: Timings of the last swaps (:meth:`reload_generation`).
        self.swap_history: deque = deque(maxlen=64)
        self._coalescer = _SynonymCoalescer(
            model, self._lock, max_batch=max_batch, cache_size=cache_size
        )
        self.max_batch = self._coalescer.max_batch
        self.ann = bool(ann) and self._coalescer.can_batch
        self.ann_recall_gate = float(ann_recall_gate)
        self.ann_recall_sample = max(1, int(ann_recall_sample))
        #: Whether the gated index serves default requests (its last gate
        #: passed), and that gate's recall (None before any).
        self._ann_live = False
        self._ann_recall: Optional[float] = None
        if self.ann:
            eng = model.engine
            conf = eng.configure_ann(
                clusters=ann_clusters, nprobe=ann_nprobe, iters=ann_iters,
                sample=ann_sample,
            )
            self._coalescer.ann_nprobe = conf["nprobe"]
            if eng.ann_index is None:
                t0 = time.time()
                eng.adopt_ann(eng.ann_build())
                logger.info("ANN index built in %.1fs (%d clusters x %d slots)",
                            time.time() - t0, conf["clusters"], conf["slots"])
            self._coalescer.ann_active = lambda: self._ann_live
            self._coalescer.gate_failing = lambda: not self._ann_live
        if warmup:
            t0 = time.time()
            q_buckets = [1 << i for i in range(self.max_batch.bit_length())]
            n = model.engine.warmup(
                q_buckets,
                WARM_KS,
                sentence_lens=WARM_SENTENCE_LENS,
                sentence_rows=WARM_SENTENCE_ROWS,
            )
            qeng = model._query_engine()
            if qeng is not model.engine:
                # A family that queries composed vectors builds them now,
                # not on the first request.
                n += qeng.warmup((), WARM_KS)
            if self.ann:
                n += model.engine.warmup_ann(q_buckets=q_buckets,
                                             k_buckets=WARM_KS)
            logger.info("serving warmup: %d dispatches in %.1fs",
                        n, time.time() - t0)
        if self.ann:
            # The gate after the warmup: it rides the warmed shapes.
            self._gate_index()
        #: Query shapes first dispatched before the port binds; any later
        #: one is a miss of the warmed family (``post_warmup_compiles``).
        self.warmup_compiles = model.engine.query_compiles
        server = self

        class Handler(BaseHTTPRequestHandler):
            # Keep-alive, and no Nagle delay between the header and body
            # writes of a response.
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):
                logger.debug("serve: " + fmt, *args)

            def _send(self, code: int, obj, headers=None) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/healthz":
                    self._send(200, server.health())
                else:
                    self._send(404, {"error": f"no route {path}"})

            def do_POST(self):
                path = urlparse(self.path).path
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                except ValueError as e:
                    return self._send(400, {"error": f"bad request: {e}"})
                if not isinstance(req, dict):
                    return self._send(400, {"error": "bad request: not an object"})
                if path == "/shutdown":
                    with server._lock:  # let in-flight device work finish
                        self._send(200, {"status": "shutting down"})
                    threading.Thread(target=server.stop, daemon=True).start()
                    return
                if path == "/reload":
                    code, out = server._reload_request(req)
                    headers = {"Retry-After": "1"} if code == 503 else None
                    return self._send(code, out, headers)
                try:
                    out = server._dispatch(path, req)
                except KeyError as e:
                    return self._send(404, {"error": e.args[0] if e.args else str(e)})
                except (TypeError, ValueError) as e:
                    return self._send(400, {"error": str(e)})
                except Exception as e:
                    logger.exception("request to %s failed", path)
                    return self._send(500, {"error": f"internal error: {e}"})
                if out is None:
                    return self._send(404, {"error": f"no route {path}"})
                self._send(200, out)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def _gate_index(self) -> None:
        """Measure recall@10 of the approximate path against the exact
        path on the live tables and let the index serve only if it reaches
        ``ann_recall_gate``."""
        recall = self.model.engine.ann_recall_at_k(
            10, sample=self.ann_recall_sample, q_chunk=self.max_batch,
        )
        ok = recall >= self.ann_recall_gate
        self._ann_recall, self._ann_live = recall, ok
        if ok:
            logger.info("ANN recall gate ok: %.3f >= %.3f", recall,
                        self.ann_recall_gate)
        else:
            logger.warning("ANN recall gate FAILED (%.3f < %.3f): the exact "
                           "path keeps serving", recall, self.ann_recall_gate)

    # -- hot swap --------------------------------------------------------

    def watch(self, watch_dir: str, poll_seconds: float = 1.0,
              current: Optional[str] = None) -> SnapshotWatcher:
        """Follow a publish directory: each new committed generation is
        staged off the request path and flipped in. ``current`` names the
        generation already loaded, so the first poll does not load it
        again."""
        w = SnapshotWatcher(self, watch_dir, poll_seconds)
        w.current = current
        if current is not None:
            self.metrics.generation = current
        self.watcher = w
        w.start()
        logger.info("watching %s for published generations (poll %.2fs)",
                    watch_dir, poll_seconds)
        return w

    def reload_generation(self, gen_dir: str,
                          generation: Optional[str] = None) -> None:
        """Hot-swap the served tables to a committed generation directory
        (a model directory: ``matrix/``, ``words.txt``).

        Staging runs on the calling thread with no lock held, beside live
        queries: the manifest check and the read into new device tensors
        (``stage_tables``), the vocabulary, and with ``ann=True`` the new
        generation's index built from the staged table and its recall
        gate. The flip runs under the device lock, so dispatches in flight
        end first: the tables, the vocabulary, the index and its gate
        verdict, and an emptied result cache. Same-shape tables and index
        dispatch only warmed query shapes. Appends the swap's seconds by
        stage, and its start and end (unix time), to ``swap_history``."""
        from glint_word2vec_torch.corpus.vocab import saved_model_vocabulary
        from glint_word2vec_torch.models.word2vec import Word2VecModel

        faults.fire("serving.reload")
        if type(self.model) is not Word2VecModel:
            raise ValueError(
                "hot-swap supports the base word-level family only "
                f"(serving a {type(self.model).__name__})"
            )
        engine = self.model.engine
        start_unix = time.time()
        t0 = time.perf_counter()
        staged = engine.stage_tables(os.path.join(gen_dir, "matrix"))
        meta = staged["meta"]
        queryable = int(meta["vocab_size"]) + int(meta.get("extra_rows_assigned", 0))
        vocab = saved_model_vocabulary(
            gen_dir, np.load(os.path.join(gen_dir, "matrix", "counts.npy")),
            queryable,
        )
        t1 = time.perf_counter()
        staged_ann, recall, ok = None, None, False
        t2 = t1
        if self.ann:
            norms = engine._norms(staged["syn0"])
            staged_ann = engine.ann_build(staged["syn0"], norms, queryable)
            t2 = time.perf_counter()
            recall = engine.ann_recall_at_k(
                10, sample=self.ann_recall_sample, index=staged_ann,
                syn0=staged["syn0"], norms=norms, queryable=queryable,
                q_chunk=self.max_batch,
            )
            ok = recall >= self.ann_recall_gate
            if not ok:
                logger.warning("ANN recall gate FAILED (%.3f < %.3f) for %s: "
                               "the exact path serves it", recall,
                               self.ann_recall_gate, generation or gen_dir)
        t3 = time.perf_counter()
        with self._lock:
            t4 = time.perf_counter()
            engine.adopt_tables(staged)
            self.model.vocab = vocab
            if staged_ann is not None:
                engine.adopt_ann(staged_ann)
                self._ann_recall, self._ann_live = recall, ok
            with self._coalescer._mu:
                self._coalescer._cache.clear()
            t5 = time.perf_counter()
        self.metrics.record_swap(generation, ok=True)
        self.swap_history.append({
            "generation": generation, "start_unix": start_unix,
            "end_unix": start_unix + (t5 - t0),
            "stage_seconds": t1 - t0, "index_seconds": t2 - t1,
            "gate_seconds": t3 - t2, "lock_wait_seconds": t4 - t3,
            "flip_seconds": t5 - t4, "recall_at10": recall,
            "index": None if staged_ann is None else {
                **staged_ann.stats(),
                "build_parts": {k: round(v, 3)
                                for k, v in staged_ann.build_parts.items()}},
        })
        logger.info("hot-swapped to %s (%d words, table_version %d%s)",
                    generation or gen_dir, vocab.size, engine.table_version,
                    ", index refreshed" if staged_ann is not None else "")

    def _reload_request(self, req: dict):
        """``POST /reload`` (``serving.py:1490-1563`` of the JAX package):
        ``{"dir": ...}`` swaps that generation in, ``{}`` polls the watched
        directory now. Returns ``(status code, body)``: 503 for a
        transient read error inside an existing directory, 400 for a
        failed swap or no watcher."""
        w = self.watcher
        if "dir" in req:
            gen_dir = str(req["dir"])
            gen = req.get("generation") or os.path.basename(os.path.normpath(gen_dir))
            # Serialised with the watcher's polls: the same generation is
            # never staged twice.
            with (w._poll_mu if w is not None else contextlib.nullcontext()):
                try:
                    self.reload_generation(gen_dir, generation=gen)
                except OSError as e:
                    if os.path.isdir(gen_dir):
                        self.metrics.record_watch_error()
                        return 503, {"error": f"transient staging error: {e}"}
                    self.metrics.record_swap(gen, ok=False)
                    return 400, {"error": str(e)}
                except Exception as e:
                    self.metrics.record_swap(gen, ok=False)
                    return 400, {"error": str(e)}
                if w is not None:
                    w.current = gen
            return 200, {"status": "reloaded", "generation": gen,
                         "model": DEFAULT_MODEL_ID}
        if w is None:
            return 400, {"error": "no watched publish dir for model "
                                  f"{DEFAULT_MODEL_ID!r}; " + 'pass {"dir": ...}'}
        gen = w.poll_once()
        if gen is None:
            return 200, {"status": "unchanged", "generation": w.current,
                         "model": DEFAULT_MODEL_ID}
        return 200, {"status": "reloaded", "generation": gen,
                     "model": DEFAULT_MODEL_ID}

    def health(self) -> dict:
        m = self.model
        with self._coalescer._mu:
            stats = dict(self._coalescer.stats)
            index = {**self._coalescer.index_stats,
                     "exact_fallbacks": dict(
                         self._coalescer.index_stats["exact_fallbacks"])}
        index.update(m.engine.ann_stats() if self.ann else {"enabled": False})
        index.update(recall_at10=self._ann_recall,
                     recall_gate_threshold=self.ann_recall_gate)
        compiles = m.engine.query_compiles
        return {
            "status": "ok",
            "model": DEFAULT_MODEL_ID,
            "family": type(m).__name__,
            "vocab_size": m.vocab.size,
            "dim": m.vector_size,
            "max_batch": self.max_batch,
            "device": device_name(m.engine.device),
            "coalescer": stats,
            "compiles": compiles,
            "post_warmup_compiles": compiles - self.warmup_compiles,
            "ann_enabled": self._ann_live,
            "ann_recall_gate_ok": self._ann_live,
            "index": index,
            "generation": self.metrics.generation,
        }

    def _dispatch(self, path: str, req: dict):
        """The JSON answer of one POST endpoint, or None for no route."""
        m = self.model
        if path in ("/synonyms", "/synonyms_vector"):
            key = "word" if path == "/synonyms" else "vector"
            query = {key: req[key]}
            hits = self._coalescer.query(num=int(req.get("num", 10)),
                                         exact=bool(req.get("exact", False)),
                                         **query)
            return [[w, float(s)] for w, s in hits]
        with self._lock:
            if path == "/analogy":
                return [
                    [w, float(s)]
                    for w, s in m.analogy(
                        req.get("positive", []),
                        req.get("negative", []),
                        int(req.get("num", 10)),
                    )
                ]
            if path == "/vector":
                return [float(x) for x in m.transform(req["word"])]
            if path == "/transform":
                vecs = m.transform_sentences(req["sentences"])
                return [[float(x) for x in v] for v in vecs]
        return None

    def serve_forever(self) -> None:
        logger.info("serving model on %s:%d", self.host, self.port)
        self._httpd.serve_forever()

    def start_background(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self.watcher is not None:
            self.watcher.stop()
        self._httpd.shutdown()
        self._httpd.server_close()


def _boot_generation(watch_dir: str, watch_poll: float, device: DeviceLike):
    """``(model, generation directory)`` of the newest committed
    generation in ``watch_dir``, waiting for a first one. A generation
    that retention prunes while it loads is chased through the pointer; a
    load failure with the pointer unchanged and the directory present
    raises."""
    from glint_word2vec_torch.models import load_model
    from glint_word2vec_torch.streaming.publish import resolve_latest

    while True:
        gen_dir = resolve_latest(watch_dir)
        if gen_dir is None:
            logger.info("waiting for a first committed generation in %s",
                        watch_dir)
            time.sleep(max(0.05, watch_poll))
            continue
        try:
            return load_model(gen_dir, device=device), gen_dir
        except Exception as e:
            if resolve_latest(watch_dir) != gen_dir or not os.path.isdir(gen_dir):
                logger.warning("boot load of %s failed (%s): generation "
                               "pruned mid-read; chasing the pointer",
                               gen_dir, e)
                time.sleep(max(0.05, watch_poll))
                continue
            raise


def serve_model_dir(
    model_dir: Optional[str],
    host: str = "127.0.0.1",
    port: int = 8801,
    *,
    max_batch: int = 64,
    warmup: bool = True,
    cache_size: int = 65536,
    port_file: Optional[str] = None,
    device: DeviceLike = None,
    watch_dir: Optional[str] = None,
    watch_poll: float = 1.0,
    **ann_kw,
) -> None:
    """Load a saved model directory onto ``device`` and serve it until
    ``/shutdown`` or an interrupt, then free its tables. ``port_file``
    receives ``{"host", "port"}`` (atomically) once the server is warmed
    and listening: the readiness signal for ``port=0``. ``ann_kw`` are
    :class:`ModelServer`'s ``ann*`` arguments.

    ``watch_dir`` follows a streaming trainer's publish directory, polled
    every ``watch_poll`` seconds: with ``model_dir=None`` the server boots
    from its newest committed generation (waiting for the first), and
    every later generation is hot-swapped in."""
    from glint_word2vec_torch.models import load_model
    from glint_word2vec_torch.streaming.publish import _GEN_RE

    if model_dir is None:
        if watch_dir is None:
            raise ValueError("model_dir or watch_dir required")
        model, model_dir = _boot_generation(watch_dir, watch_poll, device)
    else:
        model = load_model(model_dir, device=device)
    # A generation directory names the generation served.
    base = os.path.basename(os.path.normpath(model_dir))
    current = base if _GEN_RE.match(base) else None
    try:
        server = ModelServer(
            model, host=host, port=port, max_batch=max_batch,
            warmup=warmup, cache_size=cache_size, **ann_kw,
        )
        if watch_dir is not None:
            # The watcher starts from the generation loaded, so its first
            # poll does not load it again.
            server.watch(watch_dir, poll_seconds=watch_poll, current=current)
        elif current is not None:
            server.metrics.generation = current
        if port_file:
            atomic_write_json(port_file, {"host": server.host, "port": server.port})
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.stop()
    finally:
        model.stop()
