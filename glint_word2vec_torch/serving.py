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

Start from the CLI:  python -m glint_word2vec_torch.cli serve --model DIR
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import urlparse

import numpy as np

from glint_word2vec_torch.device import DeviceLike, device_name
from glint_word2vec_torch.models.word2vec import MAX_QUERY_ROWS
from glint_word2vec_torch.utils import atomic_write_json, next_pow2

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

            def _send(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
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
        self._httpd.shutdown()
        self._httpd.server_close()


def serve_model_dir(
    model_dir: str,
    host: str = "127.0.0.1",
    port: int = 8801,
    *,
    max_batch: int = 64,
    warmup: bool = True,
    cache_size: int = 65536,
    port_file: Optional[str] = None,
    device: DeviceLike = None,
    **ann_kw,
) -> None:
    """Load a saved model directory onto ``device`` and serve it until
    ``/shutdown`` or an interrupt, then free its tables. ``port_file``
    receives ``{"host", "port"}`` (atomically) once the server is warmed
    and listening: the readiness signal for ``port=0``. ``ann_kw`` are
    :class:`ModelServer`'s ``ann*`` arguments."""
    from glint_word2vec_torch.models import load_model

    model = load_model(model_dir, device=device)
    try:
        server = ModelServer(
            model, host=host, port=port, max_batch=max_batch,
            warmup=warmup, cache_size=cache_size, **ann_kw,
        )
        if port_file:
            atomic_write_json(port_file, {"host": server.host, "port": server.port})
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.stop()
    finally:
        model.stop()
