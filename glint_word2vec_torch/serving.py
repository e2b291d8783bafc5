"""Serving saved models over HTTP (counterpart of
``glint_word2vec_tpu/serving.py``).

Endpoints (JSON in and out, stdlib server), with the JAX package's request
and response shapes and status codes. Each takes a model id, as a
``/m/<id>/`` path prefix or an ``X-Glint-Model`` header (the prefix wins);
neither routes to the default model, and an unknown id answers 404:

  GET  /healthz            -> {"status": "ok"|"degraded", "vocab_size": V,
                               "dim": d, ...}
  GET  /metrics            per-endpoint latency histograms (p50/p95/p99),
                           the coalesced-batch-size distribution, cache,
                           overload, hot-swap, index and SLO blocks
  GET  /metrics?format=prometheus
                           the same snapshot as Prometheus text
  GET  /trace?seconds=S    the last S seconds of the process's span ring
                           (kept request traces and dispatch spans) with
                           its clock anchor
  POST /synonyms           {"word": w, "num": k[, "exact": true]}
  POST /synonyms_vector    {"vector": [...], "num": k[, "exact": true]}
  POST /analogy            {"positive": [...], "negative": [...], "num": k}
  POST /vector             {"word": w}            (OOV -> 404)
  POST /transform          {"sentences": [[w, ...], ...]}  (OOV dropped)
  POST /reload             {"dir": GEN_DIR} swaps that generation in; {}
                           polls the watched publish directory now
  GET  /models             the catalog: each model's family, shape,
                           residency, pin and generation, and the
                           catalog counters
  POST /models/pin         {"model": id, "pinned": true|false} holds a
                           model resident (or lets it go)
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

Overload protection: the device endpoints are bounded by an admission
high-water mark (past ``max_inflight`` a request answers 429 with
``Retry-After: 1``), carry a deadline (``request_deadline``, tightened by
an ``X-Glint-Deadline-Ms`` header) answered 504 without taking a
dispatch slot, and while the device lock is held past ``degraded_after``
the server runs cache-only (hits served, the rest 429). Every POST
carries a request trace (``obs/events.py``): the ``X-Glint-Trace`` id is
adopted or minted, and the tail sampler keeps errors, sheds, slow
requests and 1 in ``GLINT_TRACE_SAMPLE`` of the rest. An SLO engine
(``obs/slo.py``) rides the metrics, and :meth:`ModelServer.enable_flight_recorder`
writes a postmortem bundle on a shed burst or an SLO fast burn.

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
counters are on ``/metrics`` (``hot_swap``).

The catalog: one process serves several models behind one port
(:class:`ModelCatalog`). Each model has its own result cache, metrics and
SLO engine, and watcher; the device lock and the admission layer are
shared, and a same-shape model adds no query shapes to the process
(``parallel/engine.query_program_builds``). Under a device-memory budget
the least recently used unpinned model is staged out to its committed
snapshot and staged back in on its next request, off the other models'
request path; requests that arrive meanwhile wait and are answered from
the new tables, never with a 5xx.

Start from the CLI:  python -m glint_word2vec_torch.cli serve --model DIR
                     [--add-model ID=DIR ...] [--model-memory-budget 6gb]
                     (or --watch-checkpoint PUBLISH_DIR)
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from glint_word2vec_torch.device import DeviceLike, device_name
from glint_word2vec_torch.models.word2vec import MAX_QUERY_ROWS
from glint_word2vec_torch.obs import events as obs_events
from glint_word2vec_torch.obs.prometheus import serving_to_prometheus
from glint_word2vec_torch.obs.slo import (
    FlightRecorder,
    ShedBurstDetector,
    SloEngine,
)
from glint_word2vec_torch.utils import atomic_write_json, faults, next_pow2
from glint_word2vec_torch.utils.metrics import ServingMetrics

logger = logging.getLogger(__name__)

#: Endpoints whose requests touch the device or wait on its lock: the
#: population the admission bound, the deadlines and degraded mode
#: govern. ``/healthz``, ``/metrics``, ``/trace``, ``/reload`` and
#: ``/shutdown`` stay exempt: an overloaded server must still be
#: probeable, swappable and stoppable.
_DEVICE_PATHS = frozenset(
    ("/synonyms", "/synonyms_vector", "/analogy", "/vector", "/transform")
)

#: The model a request without a model id routes to.
DEFAULT_MODEL_ID = "default"

#: The request header that names a model (a ``/m/<id>/`` prefix wins).
MODEL_HEADER = "X-Glint-Model"


def split_model_path(path: str, header: Optional[str] = None):
    """``(model_id, endpoint path)`` of one request (``serving.py:121`` of
    the JAX package): a ``/m/<id>/<endpoint>`` prefix wins, else the
    ``X-Glint-Model`` header names the model, else the id is None (the
    default model). Routing, the metrics keys and the admission bound see
    the endpoint path, so ``/m/a/synonyms`` and a header-addressed
    ``/synonyms`` land in the same histogram of model ``a``."""
    if path.startswith("/m/"):
        sep = path.find("/", 3)
        if sep < 0:
            return (path[3:] or None), "/"
        return (path[3:sep] or None), (path[sep:] or "/")
    return (header or None), path


def parse_memory_budget(value) -> Optional[int]:
    """``--model-memory-budget``: bytes, or a size with a k/kb, m/mb,
    g/gb or b suffix ("512mb", "1.5gb"). None, empty or 0 is no budget
    (every model stays resident)."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        n = int(value)
        return n if n > 0 else None
    s = str(value).strip().lower()
    if not s:
        return None
    mult = 1
    for suffix, m in (
        ("kb", 1 << 10), ("mb", 1 << 20), ("gb", 1 << 30),
        ("k", 1 << 10), ("m", 1 << 20), ("g", 1 << 30), ("b", 1),
    ):
        if s.endswith(suffix):
            s = s[: -len(suffix)]
            mult = m
            break
    n = int(float(s) * mult)
    return n if n > 0 else None

#: Seconds a coalescing leader waits for more requests of a burst before
#: it dispatches (only when it already drained two or more).
_BATCH_GRACE_S = 0.002


class _HTTPServer(ThreadingHTTPServer):
    """The stdlib threaded server with a listen backlog of 1,024 instead
    of 5: the connections of a burst must reach the handler, where the
    admission bound answers 429, instead of being reset by the kernel."""

    request_queue_size = 1024


class DeadlineExceeded(Exception):
    """A request's deadline passed before it could reach the device:
    answered 504, so the client's own budget, not the server's queue
    depth, bounds its wait."""


class _TrackedLock:
    """``threading.Lock`` that remembers when it was acquired, so the
    overload layer sees how long the device has been busy without
    instrumenting every dispatch site. Usable with ``with``; ``acquire``
    takes a timeout.

    Every dispatch inside it ends with a readback to the host (``.cpu()``),
    so the hold covers the device work, not only its launches."""

    __slots__ = ("_lock", "_held_since")

    def __init__(self):
        self._lock = threading.Lock()
        self._held_since: Optional[float] = None

    def acquire(self, timeout: Optional[float] = None) -> bool:
        if timeout is None:
            ok = self._lock.acquire()
        else:
            ok = self._lock.acquire(timeout=max(0.0, timeout))
        if ok:
            self._held_since = time.monotonic()
        return ok

    def release(self) -> None:
        self._held_since = None
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def held_for(self) -> float:
        """Seconds the lock has been held without a break; 0.0 when free.
        Reads one attribute, without a lock: a racing release reads as
        0.0."""
        hs = self._held_since
        return 0.0 if hs is None else time.monotonic() - hs


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
    (fetch num+1, drop the query word, truncate). A request with a
    deadline that passes before a leader reaches it leaves the pending
    list and raises :class:`DeadlineExceeded` without being dispatched."""

    def __init__(self, model, device_lock, max_batch: int = 64,
                 cache_size: int = 65536,
                 metrics: Optional[ServingMetrics] = None):
        from glint_word2vec_torch.models.word2vec import Word2VecModel

        self.model = model
        self.device_lock = device_lock
        self.metrics = metrics
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

    def _acquire_device(self, deadline: Optional[float]) -> bool:
        """Take the device lock, bounded by the request's deadline."""
        if deadline is None:
            return self.device_lock.acquire()
        return self.device_lock.acquire(timeout=deadline - time.monotonic())

    def cache_lookup(self, word, num, exact: bool = False):
        """The cached answer of a word query, or None, with no device work
        and without waiting for the device lock: degraded mode's read
        path."""
        if word is None or not self.cache_size:
            return None
        mode = "exact" if (exact or not self.ann_active()) else "ann"
        with self._mu:
            self._cache_sync_locked()
            return self._cache.get((word, int(num), mode))

    def query(self, word=None, vector=None, num: int = 10,
              deadline: Optional[float] = None, exact: bool = False,
              trace=None):
        tr = trace if trace is not None else obs_events.NULL_TRACE
        if not self.can_batch:
            with tr.phase("req.queue"):
                acquired = self._acquire_device(deadline)
            if not acquired:
                raise DeadlineExceeded("deadline waiting for device")
            try:
                with tr.phase("req.query", mode="exact"):
                    if word is not None:
                        return self.model.find_synonyms(word, num)
                    return self.model.find_synonyms_vector(vector, num)
            finally:
                self.device_lock.release()
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
            if self.metrics is not None:
                self.metrics.record_cache(hit is not None)
            if hit is not None:
                return hit
        req = {"word": word, "vector": vector, "num": int(num),
               "event": threading.Event(), "result": None, "error": None,
               "deadline": deadline, "abandoned": False,
               "mode": mode, "exact_requested": bool(exact),
               # The leader stamps the dispatch window's perf_counter()
               # pairs on the request; this waiter turns them into its
               # queue, query and readback phases below.
               "trace": tr.trace_id if trace is not None else None,
               "t_enq": time.perf_counter()}
        with self._mu:
            self._pending.append(req)
        # A leader sets every event of its batch before it releases the
        # lock, so a request already answered does not queue behind the
        # next leader's dispatch.
        if not req["event"].is_set() and self._acquire_device(deadline):
            try:
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
            finally:
                self.device_lock.release()
        if deadline is None:
            req["event"].wait()
        elif not req["event"].wait(deadline - time.monotonic()):
            # No leader answered in time: leave the pending list under the
            # lock (it must not grow while the device is wedged, and a
            # later leader must not spend work on a request already
            # answered 504). A result that landed in the race is served.
            with self._mu:
                if not req["event"].is_set():
                    req["abandoned"] = True
                    with contextlib.suppress(ValueError):
                        self._pending.remove(req)
            if req["abandoned"]:
                raise DeadlineExceeded("deadline waiting for dispatch")
            req["event"].wait()
        if req.get("t_dis0") is not None:
            tr.add_phase("req.queue", req["t_enq"], req["t_dis0"] - req["t_enq"])
            tr.add_phase("req.query", req["t_dis0"],
                         req["t_dis1"] - req["t_dis0"], mode=mode)
            tr.add_phase("req.readback", req["t_dis1"],
                         req["t_rb1"] - req["t_dis1"])
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
        now = time.monotonic()
        for r in batch:
            # An abandoned waiter already answered 504, and one whose
            # deadline passed in the queue is not dispatched either: its
            # waiter raises the recorded error.
            if r["abandoned"]:
                r["event"].set()
                continue
            if r["deadline"] is not None and now > r["deadline"]:
                r["error"] = DeadlineExceeded("deadline exceeded before dispatch")
                r["event"].set()
                continue
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
        top-k, exact or through the ANN index (``mode == "ann"``). Both
        read their results back to the host before they return."""
        faults.fire("serving.dispatch")
        m = self.model
        # Version before the reads: results of a dispatch that a table
        # mutation overtook must not enter the cache.
        ver = m.engine.table_version
        # One span per dispatch, recorded whatever the sampler keeps: a
        # kept request's trace always shows the batch it rode in.
        t_dis0 = time.perf_counter()
        with obs_events.phase_span(
            "req.dispatch", batch=len(chunk), mode=mode,
            traces=[r["trace"] for r in chunk if r["trace"]],
        ):
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
        t_dis1 = time.perf_counter()
        metrics = self.metrics
        if metrics is not None:
            metrics.record_batch(len(chunk))
            if mode == "ann":
                metrics.record_ann_query(len(chunk), self.ann_nprobe)
            elif self.ann_active() or self.gate_failing():
                # Per request: an explicit exact=true is "requested" even
                # while the gate fails; only defaults held back count as
                # "gate".
                n_req = sum(1 for r in chunk if r["exact_requested"])
                if n_req:
                    metrics.record_exact_fallback(n_req, "requested")
                if len(chunk) - n_req and self.gate_failing():
                    metrics.record_exact_fallback(len(chunk) - n_req, "gate")
        for r, hs in zip(chunk, hits):
            if r["word"] is not None:
                hs = [(w, s) for w, s in hs if w != r["word"]]
            r["result"] = hs[: r["num"]]
        t_rb1 = time.perf_counter()
        for r in chunk:
            # Each waiter turns these into its own phases (one writer per
            # trace: the waiter that owns it).
            r["t_dis0"], r["t_dis1"], r["t_rb1"] = t_dis0, t_dis1, t_rb1
        if not self.cache_size:
            return
        with self._mu:
            if self._cache_sync_locked() != ver:
                return
            for r in chunk:
                if r["word"] is not None:
                    while len(self._cache) >= self.cache_size:
                        self._cache.pop(next(iter(self._cache)))
                    self._cache[(r["word"], r["num"], mode)] = r["result"]


class SnapshotWatcher:
    """Background poller that follows a publish directory's
    ``LATEST.json`` (``streaming/publish.py``) and hot-swaps each new
    generation into one model of the server (``serving.py:609-800`` of the
    JAX package).

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
                 poll_seconds: float = 1.0,
                 model_id: Optional[str] = None):
        self.server = server
        self.watch_dir = watch_dir
        #: The catalog entry this watcher swaps (None: the default model):
        #: one model's pointer move swaps that model only, and its counters
        #: land on that model's metrics.
        self.model_id = model_id
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
        """The watched model's own metrics (a stand-in server without a
        catalog gives its ``metrics``)."""
        lookup = getattr(self.server, "_entry", None)
        if lookup is None:
            return self.server.metrics
        return lookup(self.model_id).metrics

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
            kwargs = {"generation": gen}
            if self.model_id is not None:
                kwargs["model_id"] = self.model_id
            self.server.reload_generation(gen_dir, **kwargs)
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
        suffix = f"-{self.model_id}" if self.model_id else ""
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"glint-snapshot-watcher{suffix}")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_seconds):
            self.poll_once()

    def stop(self) -> None:
        """Stop polling and wait for a swap in progress to end."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=300)


class ServedModel:
    """One catalog entry (``serving.py:805-868`` of the JAX package): a
    loaded model and what the server keeps per model, namely its result
    cache (the coalescer, so a cache hit of another model is impossible),
    its ``ServingMetrics`` with its SLO engine, its publish watcher, and
    its residency under the device-memory budget."""

    def __init__(self, model_id: str, model, coalescer, metrics,
                 source_dir: Optional[str] = None):
        self.model_id = model_id
        self.model = model
        self.coalescer = coalescer
        self.metrics = metrics
        #: The committed snapshot directory (a loadable model directory)
        #: an evicted entry stages back in from; a per-model hot swap
        #: moves it to the generation swapped in.
        self.source_dir = source_dir
        self.watcher: Optional[SnapshotWatcher] = None
        #: Pin count: a pinned entry is never staged out (the default
        #: model for good, a generation mid-swap, a fleet hold through
        #: ``POST /models/pin``).
        self.pins = 0
        #: LRU clock: the last request's ``time.monotonic()``.
        self.last_used = time.monotonic()
        #: Device bytes the tables cost while resident, kept across an
        #: eviction so the budget can plan the stage-in.
        self.cost_bytes = 0
        #: Serialises stage-in: the first request to a cold model stages,
        #: the others wait here (bounded by their deadlines) and are
        #: answered from the new tables.
        self.stage_mu = threading.Lock()
        self.stage_ins = 0
        self.evictions = 0
        #: Requests between their residency check and the end of their
        #: dispatch: an eviction waits for them to finish
        #: (:meth:`ModelCatalog.evict`), so no request reaches released
        #: tables.
        self.users = 0
        #: Requests inside :meth:`ModelCatalog.acquire` (waiting for a
        #: stage-in among them): an eviction lets them through first, so a
        #: model staged in serves the requests that waited for it.
        self.arriving = 0
        #: Set while an eviction of this entry is in progress: new
        #: requests wait for it to end and then stage the model in again.
        self.evicting = False

    @property
    def resident(self) -> bool:
        """Whether the tables are in device memory now (a model whose
        engine cannot release its tables always is)."""
        eng = getattr(self.model, "engine", None)
        return bool(getattr(eng, "tables_resident", True))

    @property
    def evictable(self) -> bool:
        """Only the base word-level family round-trips through
        ``release_tables`` and ``stage_tables``, and only with a committed
        snapshot to stage back in from."""
        from glint_word2vec_torch.models.word2vec import Word2VecModel

        return self.source_dir is not None and type(self.model) is Word2VecModel

    def resident_bytes(self) -> int:
        """Device bytes this entry holds now (0 when staged out)."""
        eng = getattr(self.model, "engine", None)
        fn = getattr(eng, "resident_bytes", None)
        if fn is None or not self.resident:
            return 0
        return int(fn())


class ModelCatalog:
    """Model id -> :class:`ServedModel`, and the device-memory budget
    (``serving.py:870-1116`` of the JAX package).

    The models share one device lock, one admission layer and the
    process's query shapes (``parallel/engine.query_program_builds``: a
    same-shape model adds none). With ``budget_bytes`` set, the least
    recently used unpinned model is staged out to its committed snapshot
    before another is staged in, and staged back in off the request path
    on its next request: ``stage_tables`` with no lock held (on a side
    stream on the card), ``adopt_tables`` under the device lock. Requests
    that arrive meanwhile wait, bounded by their deadlines, and are
    answered from the new tables, never with a 5xx. An eviction waits for
    the requests already past their residency check."""

    #: Read-mostly references guarded by insertion discipline rather
    #: than the catalog lock: ``entries`` is only ever grown (install
    #: holds ``_mu``; dict reads are atomic under the GIL and a racing
    #: reader sees the catalog before or after the install, equally
    #: correct), ``default_id`` is written at install time after its
    #: entry, and ``budget_bytes`` is a boot-time scalar.
    _ATOMIC_ATTRS = frozenset({"entries", "default_id", "budget_bytes"})

    def __init__(self, server: "ModelServer",
                 budget_bytes: Optional[int] = None):
        self._server = server
        self._mu = threading.Lock()
        #: Signalled when an entry's ``users`` reach 0 or its eviction ends.
        self._cv = threading.Condition(self._mu)
        #: One stage-in at a time: each plans its evictions against the
        #: residency the one before it left, so two never both fit
        #: themselves into the same room.
        self._stage_serial = threading.Lock()
        self.entries: "OrderedDict[str, ServedModel]" = OrderedDict()
        self.default_id: Optional[str] = None
        self.budget_bytes = budget_bytes
        self.evictions = 0
        self.stage_ins = 0
        self.stage_in_seconds = 0.0
        #: Requests that found their model staged out (each staged it in
        #: or waited for the stage-in).
        self.cold_hits = 0

    # -- membership ----------------------------------------------------

    def install(self, entry: ServedModel, default: bool = False) -> None:
        with self._mu:
            if entry.model_id in self.entries:
                raise ValueError(f"model id {entry.model_id!r} already served")
            self.entries[entry.model_id] = entry
            if default or self.default_id is None:
                self.default_id = entry.model_id

    @property
    def default(self) -> ServedModel:
        return self.entries[self.default_id]

    def get(self, model_id: Optional[str]) -> ServedModel:
        """The entry of a model id (None: the default); KeyError -> 404."""
        mid = model_id if model_id is not None else self.default_id
        entry = self.entries.get(mid)
        if entry is None:
            raise KeyError(f"unknown model {mid!r}")
        return entry

    def ids(self):
        return list(self.entries)

    # -- pins ----------------------------------------------------------

    def pin(self, model_id: Optional[str]) -> None:
        """Hold a model resident: a pinned entry is never staged out."""
        entry = self.get(model_id)
        with self._mu:
            entry.pins += 1

    def unpin(self, model_id: Optional[str]) -> None:
        entry = self.get(model_id)
        with self._mu:
            entry.pins = max(0, entry.pins - 1)

    # -- residency -----------------------------------------------------

    def touch(self, entry: ServedModel) -> None:
        """LRU bookkeeping of one request: the entry moves to the back of
        the eviction order."""
        with self._mu:
            entry.last_used = time.monotonic()
            if entry.model_id in self.entries:
                self.entries.move_to_end(entry.model_id)

    def resident_bytes(self) -> int:
        return sum(e.resident_bytes() for e in list(self.entries.values()))

    def ensure_resident(self, entry: ServedModel,
                        deadline: Optional[float] = None) -> None:
        """Return once the entry's tables are in device memory. The first
        request to a cold model stages it in (budget eviction first); the
        others wait, bounded by ``deadline`` (then
        :class:`DeadlineExceeded`). Pair with :meth:`acquire` and
        :meth:`release` around a dispatch that must not meet an
        eviction; this alone only makes the model resident."""
        self.acquire(entry, deadline)
        self.release(entry)

    def acquire(self, entry: ServedModel,
                deadline: Optional[float] = None) -> None:
        """:meth:`ensure_resident`, and count the caller among the entry's
        users until :meth:`release`: an eviction waits for it."""
        self.touch(entry)
        counted = False
        with self._mu:
            entry.arriving += 1
        try:
            while True:
                with self._mu:
                    while entry.evicting:
                        left = (None if deadline is None
                                else deadline - time.monotonic())
                        if left is not None and left <= 0:
                            raise DeadlineExceeded(
                                "deadline waiting for model eviction")
                        self._cv.wait(left)
                    if entry.resident:
                        entry.users += 1
                        return
                    if not counted:
                        self.cold_hits += 1
                        counted = True
                if deadline is None:
                    ok = entry.stage_mu.acquire()
                else:
                    ok = entry.stage_mu.acquire(
                        timeout=max(0.0, deadline - time.monotonic()))
                if not ok:
                    raise DeadlineExceeded("deadline waiting for model stage-in")
                try:
                    with self._mu:
                        staged_by_other = entry.resident or entry.evicting
                    if not staged_by_other:
                        self._stage_in(entry)
                finally:
                    entry.stage_mu.release()
        finally:
            with self._mu:
                entry.arriving -= 1
                self._cv.notify_all()

    def release(self, entry: ServedModel) -> None:
        """End one :meth:`acquire`."""
        with self._mu:
            entry.users -= 1
            if entry.users <= 0:
                entry.users = 0
                self._cv.notify_all()

    def _stage_in(self, entry: ServedModel) -> None:
        """Bring an evicted model's tables back from its committed
        snapshot. The caller holds ``entry.stage_mu``, not the device
        lock: the read and the copies to the card run while the other
        models serve."""
        src = entry.source_dir
        if src is None:
            raise ValueError(f"model {entry.model_id!r} has no committed "
                             "snapshot to stage in from")
        t0 = time.monotonic()
        engine = entry.model.engine
        with self._stage_serial:
            self._make_room(entry)
            staged = engine.stage_tables(os.path.join(src, "matrix"))
            with self._server._lock:
                engine.adopt_tables(staged)
        dt = time.monotonic() - t0
        with self._mu:
            entry.cost_bytes = entry.resident_bytes()
            entry.stage_ins += 1
            self.stage_ins += 1
            self.stage_in_seconds += dt
            self._cv.notify_all()
        logger.info("staged model %r back in from %s (%.2fs, %d bytes)",
                    entry.model_id, src, dt, entry.cost_bytes)

    def _make_room(self, entry: Optional[ServedModel]) -> None:
        """Evict least recently used unpinned models until ``entry`` (or,
        with None, the current residency) fits the budget. With nothing
        evictable left the catalog runs over budget rather than failing
        requests: the budget is a target, a pin a guarantee."""
        budget = self.budget_bytes
        if not budget:
            return
        need = max(0, entry.cost_bytes) if entry is not None else 0
        while True:
            with self._mu:
                used = sum(e.resident_bytes() for e in self.entries.values()
                           if not e.evicting)
                if used + need <= budget:
                    return
                victim = None
                for e in self.entries.values():  # least recently used first
                    if e is entry or not e.resident or e.evicting:
                        continue
                    if e.pins == 0 and e.evictable:
                        victim = e
                        break
            if victim is None:
                logger.warning(
                    "model-memory budget exceeded (%d resident + %d needed > "
                    "%d) with nothing evictable: running over budget",
                    used, need, budget)
                return
            self.evict(victim)

    def evict(self, entry: ServedModel) -> bool:
        """Stage one model's tables out of device memory, once the
        requests already past their residency check have finished. The
        bytes are safe on disk (the committed snapshot in ``source_dir``),
        so this is a release; pending asynchronous saves drain first
        (``release_tables``). False if the entry is pinned, not evictable,
        already staged out or being evicted."""
        with self._mu:
            if (entry.pins or not entry.evictable or not entry.resident
                    or entry.evicting):
                return False
            # The requests already on their way in (those that waited for
            # this model's stage-in among them) are served first; new ones
            # find the model resident and pass straight through, so this
            # ends.
            while entry.arriving > 0:
                self._cv.wait()
            if entry.pins or not entry.resident or entry.evicting:
                return False
            entry.evicting = True
            while entry.users > 0:
                self._cv.wait()
        try:
            engine = entry.model.engine
            with self._server._lock:
                with self._mu:
                    if entry.pins:  # pinned while its users drained
                        return False
                    entry.cost_bytes = entry.resident_bytes() or entry.cost_bytes
                engine.release_tables()
            with self._mu:
                entry.evictions += 1
                self.evictions += 1
        finally:
            with self._mu:
                entry.evicting = False
                self._cv.notify_all()
        logger.info("staged model %r out (%d bytes freed; snapshot %s)",
                    entry.model_id, entry.cost_bytes, entry.source_dir)
        return True

    def enforce_budget(self) -> None:
        """Bring the residency back within the budget after a load or a
        reload grew it."""
        self._make_room(None)

    # -- exposition ----------------------------------------------------

    def snapshot(self) -> dict:
        """The ``catalog`` block of ``/metrics``: membership, residency
        against the budget, the LRU counters, and the process's query
        shape builds against the shared hits."""
        from glint_word2vec_torch.parallel.engine import query_program_builds

        with self._mu:
            entries = list(self.entries.values())
            doc = {
                "models": len(entries),
                "default_model": self.default_id,
                "budget_bytes": self.budget_bytes,
                "evictions_total": self.evictions,
                "stage_ins_total": self.stage_ins,
                "stage_in_seconds_total": round(self.stage_in_seconds, 3),
                "cold_hits_total": self.cold_hits,
            }
        doc["resident_models"] = sum(1 for e in entries if e.resident)
        doc["resident_bytes"] = sum(e.resident_bytes() for e in entries)
        doc["query_program_builds"] = query_program_builds()
        doc["shared_program_hits"] = sum(
            int(getattr(getattr(e.model, "engine", None),
                        "shared_program_hits", 0) or 0)
            for e in entries)
        return doc


class ModelServer:
    """Serves the query surface of one or more loaded models over HTTP.

    The model given is the default one, pinned resident for good;
    :meth:`add_model` serves more from the same process (``/m/<id>/...``
    or the ``X-Glint-Model`` header), each with its own result cache,
    metrics and watcher, and ``catalog.budget_bytes`` bounds their
    combined device residency.

    ``max_batch`` caps the coalesced dispatch (rounded up to a power of
    two). ``warmup=True`` runs every query shape of the serving family
    (Q buckets up to ``max_batch``, the ``warm_ks`` top-k buckets, the
    ``warm_sentence_rows`` x ``warm_sentence_lens`` transform grid) before
    the port binds, so the first request pays no kernel build or library
    set-up; ``add_model`` warms every catalog model with the same
    shapes. ``port=0`` binds an ephemeral port; ``self.port`` says which.

    Overload protection of the device endpoints: past ``max_inflight``
    admitted requests a request answers 429 with ``Retry-After: 1``; one
    that cannot reach the device within ``request_deadline`` seconds
    answers 504; while the device lock has been held past
    ``degraded_after`` seconds the server answers from its result caches
    alone and sheds the rest with 429. 0 or None turns each off.

    ``ann=True`` (word-level families only, the default model) configures
    the engine's ANN index with ``ann_clusters``, ``ann_nprobe``,
    ``ann_iters`` and ``ann_sample``, builds it unless one is adopted,
    warms the approximate shapes with the exact ones, and then gates it:
    recall@10 against the exact path on ``ann_recall_sample`` rows must
    reach ``ann_recall_gate``, or the exact path keeps serving.
    """

    #: Lock-free by design: ``_ann_live`` is a single bool flag, written
    #: at boot (no request threads yet) and under the device lock on a
    #: hot swap, read by request threads where a stale read only routes
    #: one request to the other (equally correct) path.
    _ATOMIC_ATTRS = frozenset({"_ann_live"})

    def __init__(
        self,
        model,
        host: str = "127.0.0.1",
        port: int = 8801,
        *,
        max_batch: int = 64,
        warmup: bool = True,
        # k buckets 16 and 32: num < 16 rounds into the 16 bucket and num
        # in [16, 31] (fetching num+1) into the 32 bucket; each larger
        # power of two is dispatched for the first time on demand.
        warm_ks=(16, 32),
        warm_sentence_lens=(1, 2, 4, 8, 16, 32, 64),
        warm_sentence_rows=(1, 2, 4, 8, 16),
        cache_size: int = 65536,
        max_inflight: int = 256,
        request_deadline: Optional[float] = 30.0,
        degraded_after: Optional[float] = 5.0,
        ann: bool = False,
        ann_clusters: int = -1,
        ann_nprobe: int = 8,
        ann_iters: int = 6,
        ann_sample: int = 65536,
        ann_recall_gate: float = 0.95,
        ann_recall_sample: int = 64,
    ):
        self.model = model
        #: The switch interval :meth:`_tighten_gil_switch` replaced,
        #: restored by :meth:`stop`.
        self._prev_switch: Optional[float] = None
        #: The fleet launch generation (``GLINT_FLEET_GEN``), echoed on
        #: ``/healthz`` and in the port file, so a probe answered by a
        #: process of an earlier launch is told apart.
        self.fleet_generation = os.environ.get("GLINT_FLEET_GEN")
        self._lock = _TrackedLock()
        #: The default model's latency histograms, cache, overload,
        #: hot-swap and index counters, and its SLO engine over the device
        #: endpoints.
        self.metrics = ServingMetrics()
        self.metrics.slo = SloEngine.default_serving(_DEVICE_PATHS)
        self._shed_burst = ShedBurstDetector()
        #: The postmortem bundle writer (:meth:`enable_flight_recorder`),
        #: or None.
        self.flight: Optional[FlightRecorder] = None
        self.max_inflight = max(0, int(max_inflight))
        self.request_deadline = float(request_deadline) if request_deadline else None
        self.degraded_after = float(degraded_after) if degraded_after else None
        self._inflight = 0
        self._inflight_mu = threading.Lock()
        self._degraded_flag = False
        #: Timings of the last swaps (:meth:`reload_generation`).
        self.swap_history: deque = deque(maxlen=64)
        self._coalescer = _SynonymCoalescer(
            model, self._lock, max_batch=max_batch, cache_size=cache_size,
            metrics=self.metrics,
        )
        self.max_batch = self._coalescer.max_batch
        self.cache_size = self._coalescer.cache_size
        self._do_warmup = bool(warmup)
        self._warm_params = (tuple(warm_ks), tuple(warm_sentence_lens),
                             tuple(warm_sentence_rows))
        self.catalog = ModelCatalog(self)
        default_entry = ServedModel(DEFAULT_MODEL_ID, model, self._coalescer,
                                    self.metrics)
        # Pinned for good: the single-model surface never stages out.
        default_entry.pins = 1
        self.catalog.install(default_entry, default=True)
        self.ann = bool(ann) and self._coalescer.can_batch
        self.ann_recall_gate = float(ann_recall_gate)
        self.ann_recall_sample = max(1, int(ann_recall_sample))
        #: Whether the gated index serves default requests (its last gate
        #: passed).
        self._ann_live = False
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
            self._warmup(model, ann=self.ann)
        if self.ann:
            # The gate after the warmup: it rides the warmed shapes.
            self._gate_index()
        #: Query shapes first dispatched before the port binds; any later
        #: one is a miss of the warmed family (``post_warmup_compiles``).
        self.metrics.warmup_compiles = self._query_compiles(default_entry)
        self._mark_warm()
        server = self

        class Handler(BaseHTTPRequestHandler):
            # Keep-alive, and no Nagle delay between the header and body
            # writes of a response.
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True
            # Buffered writes: a response's last bytes leave when its
            # handler returns, after the request is counted, so a client
            # that reads an answer and then asks /metrics finds it there.
            wbufsize = -1

            def log_message(self, fmt, *args):
                logger.debug("serve: " + fmt, *args)

            def _send(self, code: int, obj, headers=None) -> None:
                tr = getattr(self, "_trace", None) or obs_events.NULL_TRACE
                with tr.phase("req.serialize"):
                    body = json.dumps(obj).encode()
                    self._status = code
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    for k, v in (headers or {}).items():
                        self.send_header(k, v)
                    self.end_headers()
                    self.wfile.write(body)

            def _send_text(self, code: int, text: str) -> None:
                body = text.encode()
                self._status = code
                self.send_response(code)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                t0 = time.perf_counter()
                self._status = 500
                # No request trace on probes and scrapes, and none left
                # over from an earlier POST on this keep-alive connection.
                self._trace = None
                url = urlparse(self.path)
                mid, path = split_model_path(
                    url.path, self.headers.get(MODEL_HEADER))
                try:
                    entry = server._entry(mid)
                except KeyError:
                    self._send(404, {"error": f"unknown model {mid!r}"})
                    server._observe_request(server.catalog.default, path,
                                            time.perf_counter() - t0, 404)
                    return
                try:
                    if path == "/healthz":
                        self._send(200, server.health(mid))
                    elif path == "/metrics":
                        # /m/<id>/metrics is one model's block; the bare
                        # path keeps the default model's at the root with
                        # every model's and the catalog's folded in.
                        doc = (server._entry_snapshot(entry) if mid is not None
                               else server._metrics_doc())
                        if parse_qs(url.query).get("format", ["json"])[0] == "prometheus":
                            self._send_text(200, serving_to_prometheus(doc))
                        else:
                            self._send(200, doc)
                    elif path == "/models":
                        self._send(200, server._models_doc())
                    elif path == "/trace":
                        try:
                            secs = float(parse_qs(url.query).get("seconds", ["30"])[0])
                        except ValueError:
                            secs = 30.0
                        self._send(200, server._flight_spans(secs))
                    else:
                        self._send(404, {"error": f"no route {path}"})
                finally:
                    server._observe_request(entry, path,
                                            time.perf_counter() - t0,
                                            self._status)

            def do_POST(self):
                t0 = time.perf_counter()
                self._status = 500
                mid, path = split_model_path(
                    urlparse(self.path).path, self.headers.get(MODEL_HEADER))
                # Adopt the propagated trace id or mint one. The phases
                # buffer on the trace and reach the ring only if the tail
                # sampler keeps the request.
                tr = obs_events.request_trace(
                    self.headers.get(obs_events.TRACE_HEADER))
                self._trace = tr
                try:
                    entry = server._entry(mid)
                except KeyError:
                    self._send(404, {"error": f"unknown model {mid!r}"})
                    tr.finish(404)
                    server._observe_request(server.catalog.default, path,
                                            time.perf_counter() - t0, 404)
                    return
                try:
                    with tr.phase("req.accept", path=path):
                        self._handle_post(path, entry)
                finally:
                    kept = tr.finish(self._status)
                    server._observe_request(
                        entry, path, time.perf_counter() - t0, self._status,
                        trace_id=tr.trace_id if kept else None,
                    )

            def _handle_post(self, path, entry):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                except ValueError as e:
                    return self._send(400, {"error": f"bad request: {e}"})
                if not isinstance(req, dict):
                    return self._send(400, {"error": "bad request: not an object"})
                if path in _DEVICE_PATHS:
                    # Past the high-water mark a request sheds now: cheaper
                    # for everyone than a queue longer than any client's
                    # timeout.
                    with self._trace.phase("req.admission") as adm:
                        admitted = server._admit()
                        adm.update(admitted=admitted)
                    if not admitted:
                        server._record_shed("admission", entry)
                        return self._send(
                            429, {"error": "server overloaded (admission queue full)"},
                            headers={"Retry-After": "1"},
                        )
                    try:
                        return self._handle_device(path, req, entry)
                    finally:
                        server._release_slot()
                if path == "/shutdown":
                    # The spans kept so far reach the trace log's file before
                    # the answer: whoever asked may end this process next.
                    rec = obs_events.get_recorder()
                    if rec is not None:
                        rec.flush()
                    with server._lock:  # let in-flight device work finish
                        self._send(200, {"status": "shutting down"})
                    # Out before the stop begins: the process may end once
                    # the server has stopped.
                    self.wfile.flush()
                    threading.Thread(target=server.stop, daemon=True).start()
                    return
                if path == "/reload":
                    code, out = server._reload_request(req, entry)
                    headers = {"Retry-After": "1"} if code == 503 else None
                    return self._send(code, out, headers)
                if path == "/models/pin":
                    # The fleet's rollout pins the model it rolls, so the
                    # LRU never stages out a held generation.
                    target = req.get("model", entry.model_id)
                    try:
                        if bool(req.get("pinned", True)):
                            server.catalog.pin(target)
                        else:
                            server.catalog.unpin(target)
                        pins = server.catalog.get(target).pins
                    except KeyError:
                        return self._send(404, {"error": f"unknown model {target!r}"})
                    return self._send(200, {"model": target or DEFAULT_MODEL_ID,
                                            "pins": pins})
                self._send(404, {"error": f"no route {path}"})

            def _deadline(self) -> Optional[float]:
                """The request's monotonic deadline: the server's, or
                sooner when ``X-Glint-Deadline-Ms`` (a balancer's
                remaining budget) says so; the header never extends it."""
                deadline = (time.monotonic() + server.request_deadline
                            if server.request_deadline else None)
                hdr = self.headers.get("X-Glint-Deadline-Ms")
                if hdr is not None:
                    try:
                        remote = time.monotonic() + max(0.0, float(hdr)) / 1e3
                    except (TypeError, ValueError):
                        return deadline
                    deadline = remote if deadline is None else min(deadline, remote)
                return deadline

            def _handle_device(self, path, req, entry):
                """One admitted device request: the degraded-mode gate, the
                deadline, the model's residency (the stage-in rendezvous),
                then the dispatch."""
                if server._degraded():
                    # Cache-only mode: the device is wedged. Serve what
                    # needs no dispatch and shed the rest with 429 (load,
                    # not failure: the client should back off).
                    if path == "/synonyms":
                        try:
                            num = int(req.get("num", 10))
                        except (TypeError, ValueError) as e:
                            return self._send(400, {"error": f"bad num: {e}"})
                        hit = entry.coalescer.cache_lookup(
                            req.get("word"), num, exact=bool(req.get("exact", False)))
                        if hit is not None:
                            entry.metrics.record_cache(True)
                            return self._send(200, [[w, float(s)] for w, s in hit])
                    server._record_shed("degraded", entry)
                    return self._send(
                        429, {"error": "degraded cache-only mode (device busy)"},
                        headers={"Retry-After": "1"},
                    )
                deadline = self._deadline()
                try:
                    # A cold model stages in first, off the request path of
                    # the others; an eviction waits until this request is
                    # answered.
                    server.catalog.acquire(entry, deadline=deadline)
                    try:
                        out = self._dispatch_device(path, req, entry, deadline)
                    finally:
                        server.catalog.release(entry)
                except DeadlineExceeded as e:
                    entry.metrics.record_deadline()
                    return self._send(504, {"error": str(e)})
                except KeyError as e:
                    return self._send(404, {"error": e.args[0] if e.args else str(e)})
                except (TypeError, ValueError) as e:
                    return self._send(400, {"error": str(e)})
                except Exception as e:
                    logger.exception("request to %s failed", path)
                    return self._send(500, {"error": f"internal error: {e}"})
                self._send(200, out)

            def _dispatch_device(self, path, req, entry, deadline):
                if path in ("/synonyms", "/synonyms_vector"):
                    key = "word" if path == "/synonyms" else "vector"
                    hits = entry.coalescer.query(
                        num=int(req.get("num", 10)), deadline=deadline,
                        exact=bool(req.get("exact", False)),
                        trace=self._trace, **{key: req[key]},
                    )
                    return [[w, float(s)] for w, s in hits]
                with self._trace.phase("req.queue"):
                    acquired = server._lock.acquire(
                        None if deadline is None else deadline - time.monotonic())
                if not acquired:
                    raise DeadlineExceeded("deadline waiting for device")
                try:
                    with self._trace.phase("req.query", mode="exact"):
                        return server._dispatch(path, req, entry.model)
                finally:
                    server._lock.release()

        self._httpd = _HTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # -- the model catalog -----------------------------------------------

    @property
    def watcher(self) -> Optional[SnapshotWatcher]:
        """The default model's publish watcher (:meth:`watch`), or None."""
        return self.catalog.default.watcher

    @watcher.setter
    def watcher(self, w: Optional[SnapshotWatcher]) -> None:
        self.catalog.default.watcher = w

    def _entry(self, model_id: Optional[str]) -> ServedModel:
        """The catalog entry of a request's model id (None: the default);
        KeyError -> the handler's 404."""
        return self.catalog.get(model_id)

    def add_model(self, model_id: str, model=None,
                  model_dir: Optional[str] = None, *,
                  warmup: Optional[bool] = None,
                  generation: Optional[str] = None,
                  device: DeviceLike = None) -> ServedModel:
        """Serve another model from this process (``serving.py:1741`` of
        the JAX package): a loaded ``model``, or the directory
        ``model_dir`` loaded onto ``device`` (default: the default model's
        device). The entry has its own result cache, metrics and SLO
        engine, and shares the device lock and the admission layer. Its
        warmup walks the default model's query shapes, so a model of the
        same shape adds no query shape builds to the process. The ANN
        index stays the default model's; catalog models serve exactly.
        A ``model_dir`` entry can be staged out under the budget."""
        from glint_word2vec_torch.models import load_model
        from glint_word2vec_torch.streaming.publish import _GEN_RE

        if "/" in str(model_id) or not model_id:
            raise ValueError(f"model id must be non-empty and /-free: {model_id!r}")
        if model is None:
            if model_dir is None:
                raise ValueError("add_model needs model or model_dir")
            model = load_model(model_dir, device=(
                device if device is not None else self.model.engine.device))
        metrics = ServingMetrics()
        metrics.slo = SloEngine.default_serving(_DEVICE_PATHS)
        coalescer = _SynonymCoalescer(
            model, self._lock, max_batch=self.max_batch,
            cache_size=self.cache_size, metrics=metrics,
        )
        entry = ServedModel(model_id, model, coalescer, metrics,
                            source_dir=model_dir)
        if generation is None and model_dir is not None:
            base = os.path.basename(os.path.normpath(model_dir))
            if _GEN_RE.match(base):
                generation = base
        if generation is not None:
            metrics.generation = generation
        self.catalog.install(entry)
        if (self._do_warmup if warmup is None else bool(warmup)):
            self._warmup(model)
            self._mark_warm()
        metrics.warmup_compiles = self._query_compiles(entry)
        self.catalog.enforce_budget()
        logger.info("added model %r (%d words, dim %d, resident %s)",
                    model_id, model.vocab.size, model.vector_size,
                    entry.resident)
        return entry

    def _warmup(self, model, ann: bool = False) -> int:
        """Run the serving query shapes of one model before it serves:
        the Q buckets up to ``max_batch``, the k buckets and the transform
        grid, the composed query engine of a subword family, and with
        ``ann`` the approximate shapes."""
        t0 = time.time()
        q_buckets = [1 << i for i in range(self.max_batch.bit_length())]
        warm_ks, warm_lens, warm_rows = self._warm_params
        n = model.engine.warmup(
            q_buckets, warm_ks,
            sentence_lens=warm_lens, sentence_rows=warm_rows,
        )
        qeng = model._query_engine()
        if qeng is not model.engine:
            # A family that queries composed vectors builds them now, not
            # on the first request.
            n += qeng.warmup((), warm_ks)
        if ann:
            n += model.engine.warmup_ann(q_buckets=q_buckets, k_buckets=warm_ks)
        logger.info("serving warmup: %d dispatches in %.1fs",
                    n, time.time() - t0)
        return n

    def _mark_warm(self) -> None:
        """Record the process's kernel launch counts once a warmup ended:
        ``/metrics`` reports them beside the current counts, so launches
        since can be held against the dispatches served."""
        from glint_word2vec_torch.kernels import launch_counts

        self._launches_warm = launch_counts()

    def _models_summary(self) -> dict:
        """Per-model overview for ``/healthz`` and ``GET /models``."""
        out = {}
        for mid, e in list(self.catalog.entries.items()):
            out[mid] = {
                "family": type(e.model).__name__,
                "vocab_size": e.model.vocab.size,
                "dim": e.model.vector_size,
                "resident": e.resident,
                "pinned": e.pins > 0,
                "generation": e.metrics.generation,
                "post_warmup_compiles": (self._query_compiles(e)
                                         - e.metrics.warmup_compiles),
            }
        return out

    def _models_doc(self) -> dict:
        """``GET /models``: the default id, the per-model overview and
        the catalog block."""
        return {
            "default": self.catalog.default_id,
            "models": self._models_summary(),
            "catalog": self.catalog.snapshot(),
        }

    def _entry_snapshot(self, entry: ServedModel) -> dict:
        """One model's metrics snapshot with its residency."""
        eng = entry.model.engine
        idx = eng.ann_index if entry is self.catalog.default else None
        snap = entry.metrics.snapshot(
            self._query_compiles(entry), checkpoint=self._checkpoint_stats(entry),
            index_staleness=(None if idx is None
                             else max(0, eng.table_version - idx.table_version)),
        )
        snap["model_id"] = entry.model_id
        snap["resident"] = entry.resident
        # The integer twin of "resident", which a merged fleet view sums
        # into the replicas a model is resident on.
        snap["resident_replicas"] = 1 if entry.resident else 0
        snap["pinned"] = entry.pins > 0
        snap["resident_bytes"] = entry.resident_bytes()
        snap["stage_ins_total"] = entry.stage_ins
        snap["evictions_total"] = entry.evictions
        return snap

    def _metrics_doc(self) -> dict:
        """The ``/metrics`` document: the default model's snapshot at the
        root, every model's under ``models``, the ``catalog`` block, and
        this process's kernel launch counts under ``kernel_launches``, with
        those at the end of the last warmup under
        ``kernel_launches_warmup`` (blocks the JAX server does not have: a
        fleet's replicas are processes of their own, and this is where
        their counts are read)."""
        from glint_word2vec_torch.kernels import launch_counts

        doc = self._entry_snapshot(self.catalog.default)
        doc["models"] = {mid: self._entry_snapshot(e)
                         for mid, e in list(self.catalog.entries.items())}
        doc["catalog"] = self.catalog.snapshot()
        doc["kernel_launches"] = launch_counts()
        doc["kernel_launches_warmup"] = dict(self._launches_warm)
        return doc

    def _query_compiles(self, entry: Optional[ServedModel] = None) -> int:
        """First-dispatched query shapes across one model's engines (the
        engine, and a subword family's composed query engine once built):
        per engine, so a shape another model dispatched first still
        counts here; the process-level count is on the catalog block."""
        model = (entry or self.catalog.default).model
        engines = [getattr(model, "engine", None), getattr(model, "_qeng", None)]
        return sum(int(getattr(e, "query_compiles", 0) or 0)
                   for e in engines if e is not None)

    def _gate_index(self) -> None:
        """Measure recall@10 of the approximate path against the exact
        path on the live tables, let the index serve only if it reaches
        ``ann_recall_gate``, and record the refresh on ``/metrics``."""
        eng = self.model.engine
        recall = eng.ann_recall_at_k(
            10, sample=self.ann_recall_sample, q_chunk=self.max_batch,
        )
        ok = recall >= self.ann_recall_gate
        self._ann_live = ok
        self.metrics.record_index_refresh(
            eng.ann_stats(), recall, ok, self.ann_recall_gate,
            self._coalescer.ann_nprobe,
        )
        if ok:
            logger.info("ANN recall gate ok: %.3f >= %.3f", recall,
                        self.ann_recall_gate)
        else:
            logger.warning("ANN recall gate FAILED (%.3f < %.3f): the exact "
                           "path keeps serving", recall, self.ann_recall_gate)

    # -- overload protection ---------------------------------------------

    def _admit(self) -> bool:
        """Claim an in-flight slot for a device request; False past the
        high-water mark (shed with 429)."""
        if not self.max_inflight:
            return True
        with self._inflight_mu:
            if self._inflight >= self.max_inflight:
                return False
            self._inflight += 1
            self.metrics.record_inflight(self._inflight)
            return True

    def _release_slot(self) -> None:
        if not self.max_inflight:
            return
        with self._inflight_mu:
            self._inflight -= 1

    def _degraded(self) -> bool:
        """Whether the server runs cache-only: the device lock has been
        held past ``degraded_after``. Counts each entry into the mode; the
        mode ends the moment the lock frees."""
        if self.degraded_after is None:
            return False
        d = self._lock.held_for() > self.degraded_after
        with self._inflight_mu:
            if d and not self._degraded_flag:
                self._degraded_flag = True
                self.metrics.record_degraded_entered()
                logger.warning("entering degraded cache-only mode: device "
                               "lock held > %.1fs", self.degraded_after)
            elif not d:
                self._degraded_flag = False
        return d

    # -- metrics, SLOs and the flight recorder ---------------------------

    def _observe_request(self, entry: ServedModel, path: str, seconds: float,
                         status: int, trace_id: Optional[str] = None) -> None:
        """Every request's accounting, on its model's metrics: the latency
        histogram and the SLO observation (with the trace id as exemplar
        when the sampler kept the trace), then the flight recorder on an
        SLO fast-burn edge."""
        entry.metrics.observe(path, seconds, status=status, trace_id=trace_id)
        fl, slo = self.flight, entry.metrics.slo
        if fl is not None and slo is not None:
            for ep in slo.fast_burn_transitions():
                fl.trigger("slo_fast_burn", endpoint=ep)

    def _record_shed(self, reason: str,
                     entry: Optional[ServedModel] = None) -> None:
        """Count one shed on the request's model and fire the flight
        recorder on a burst's edge (one bundle a burst)."""
        (entry or self.catalog.default).metrics.record_shed(reason)
        if self._shed_burst.note() and self.flight is not None:
            self.flight.trigger("shed_burst", shed_reason=reason)

    def enable_flight_recorder(
        self, out_dir: str, *, window_seconds: float = 30.0,
        min_interval_seconds: float = 60.0,
    ) -> FlightRecorder:
        """Install the anomaly flight recorder: on a shed burst or an SLO
        fast-burn edge it writes this process's recent spans and the full
        metrics snapshot into a bundle under ``out_dir``."""
        fl = FlightRecorder(out_dir, window_seconds=window_seconds,
                            min_interval_seconds=min_interval_seconds)
        fl.add_source("spans", self._flight_spans)
        fl.add_source("metrics", self._flight_metrics)
        self.flight = fl
        return fl

    def _flight_spans(self, window_seconds: float) -> dict:
        """The span ring's last ``window_seconds`` and its clock anchor
        (what ``GET /trace`` answers)."""
        rec = obs_events.get_recorder()
        if rec is None:
            return {"events": [], "anchor": None}
        return {
            "events": rec.recent_events(window_seconds),
            "anchor": {"wall_t0": rec.wall_t0, "mono_t0": rec.mono_t0},
        }

    def _flight_metrics(self, window_seconds: float) -> dict:
        return self._metrics_doc()

    def _checkpoint_stats(self, entry: Optional[ServedModel] = None) -> dict:
        """A served engine's checkpoint telemetry (``{}`` for a loaded
        model); never raises, so ``/metrics`` stays up."""
        model = (entry or self.catalog.default).model
        stats = getattr(getattr(model, "engine", None), "checkpoint_stats", None)
        if stats is None:
            return {}
        try:
            return stats()
        except Exception:
            return {}

    # -- hot swap --------------------------------------------------------

    def watch(self, watch_dir: str, poll_seconds: float = 1.0,
              current: Optional[str] = None,
              model_id: Optional[str] = None) -> SnapshotWatcher:
        """Follow a publish directory for one model (None: the default):
        each new committed generation is staged off the request path and
        flipped into that model only. ``current`` names the generation
        already loaded, so the first poll does not load it again."""
        entry = self._entry(model_id)
        w = SnapshotWatcher(self, watch_dir, poll_seconds, model_id=model_id)
        w.current = current
        if current is not None:
            entry.metrics.generation = current
        entry.watcher = w
        w.start()
        logger.info("watching %s for published generations of model %r "
                    "(poll %.2fs)", watch_dir, entry.model_id, poll_seconds)
        return w

    def reload_generation(self, gen_dir: str,
                          generation: Optional[str] = None,
                          model_id: Optional[str] = None) -> None:
        """Hot-swap one model's tables (None: the default model) to a
        committed generation directory (a model directory: ``matrix/``,
        ``words.txt``); the other models are untouched.

        Staging runs on the calling thread with no lock held, beside live
        queries: the manifest check and the read into new device tensors
        (``stage_tables``), the vocabulary, and for the default model with
        ``ann=True`` the new generation's index built from the staged
        table and its recall gate. The flip runs under the device lock,
        so dispatches in flight end first: the tables, the vocabulary, the
        index and its gate verdict, and an emptied result cache. The model
        is pinned meanwhile, so the budget never stages out the generation
        being swapped in, and it stages back in from ``gen_dir`` after a
        later eviction. Same-shape tables and index dispatch only warmed
        query shapes. Appends the swap's seconds by stage, and its start
        and end (unix time), to ``swap_history``."""
        from glint_word2vec_torch.corpus.vocab import saved_model_vocabulary
        from glint_word2vec_torch.models.word2vec import Word2VecModel

        entry = self._entry(model_id)
        faults.fire("serving.reload")
        if type(entry.model) is not Word2VecModel:
            raise ValueError(
                "hot-swap supports the base word-level family only "
                f"(serving a {type(entry.model).__name__})"
            )
        self.catalog.pin(model_id)
        try:
            engine = entry.model.engine
            start_unix = time.time()
            t0 = time.perf_counter()
            staged = engine.stage_tables(os.path.join(gen_dir, "matrix"))
            meta = staged["meta"]
            queryable = (int(meta["vocab_size"])
                         + int(meta.get("extra_rows_assigned", 0)))
            vocab = saved_model_vocabulary(
                gen_dir, np.load(os.path.join(gen_dir, "matrix", "counts.npy")),
                queryable,
            )
            t1 = time.perf_counter()
            staged_ann, recall, ok = None, None, False
            t2 = t1
            if self.ann and entry is self.catalog.default:
                norms = engine._norms(staged["syn0"])
                staged_ann = engine.ann_build(staged["syn0"], norms, queryable)
                t2 = time.perf_counter()
                recall = engine.ann_recall_at_k(
                    10, sample=self.ann_recall_sample, index=staged_ann,
                    syn0=staged["syn0"], norms=norms, queryable=queryable,
                    q_chunk=self.max_batch,
                )
                ok = recall >= self.ann_recall_gate
                self.metrics.record_index_refresh(
                    {**staged_ann.stats(), "enabled": True}, recall, ok,
                    self.ann_recall_gate, self._coalescer.ann_nprobe,
                )
                if not ok:
                    logger.warning("ANN recall gate FAILED (%.3f < %.3f) for "
                                   "%s: the exact path serves it", recall,
                                   self.ann_recall_gate, generation or gen_dir)
            t3 = time.perf_counter()
            with self._lock:
                t4 = time.perf_counter()
                engine.adopt_tables(staged)
                entry.model.vocab = vocab
                if staged_ann is not None:
                    engine.adopt_ann(staged_ann)
                    self._ann_live = ok
                with entry.coalescer._mu:
                    entry.coalescer._cache.clear()
                t5 = time.perf_counter()
            entry.metrics.record_swap(generation, ok=True)
            entry.source_dir = gen_dir
        finally:
            self.catalog.unpin(model_id)
        self.catalog.enforce_budget()
        self.swap_history.append({
            "model": entry.model_id,
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
        logger.info("hot-swapped %r to %s (%d words, table_version %d%s)",
                    entry.model_id, generation or gen_dir, vocab.size,
                    engine.table_version,
                    ", index refreshed" if staged_ann is not None else "")

    def _reload_request(self, req: dict, entry: Optional[ServedModel] = None):
        """``POST /reload`` of one model (``serving.py:1490-1563`` of the
        JAX package): ``{"dir": ...}`` swaps that generation in, ``{}``
        polls the model's watched directory now. Returns ``(status code,
        body)``: 503 for a transient read error inside an existing
        directory, 400 for a failed swap or no watcher."""
        entry = entry or self.catalog.default
        w = entry.watcher
        mid = entry.model_id
        if "dir" in req:
            gen_dir = str(req["dir"])
            gen = req.get("generation") or os.path.basename(os.path.normpath(gen_dir))
            # Serialised with the watcher's polls: the same generation is
            # never staged twice.
            with (w._poll_mu if w is not None else contextlib.nullcontext()):
                try:
                    self.reload_generation(gen_dir, generation=gen, model_id=mid)
                except OSError as e:
                    if os.path.isdir(gen_dir):
                        entry.metrics.record_watch_error()
                        return 503, {"error": f"transient staging error: {e}"}
                    entry.metrics.record_swap(gen, ok=False)
                    return 400, {"error": str(e)}
                except Exception as e:
                    entry.metrics.record_swap(gen, ok=False)
                    return 400, {"error": str(e)}
                if w is not None:
                    w.current = gen
            return 200, {"status": "reloaded", "generation": gen, "model": mid}
        if w is None:
            return 400, {"error": f"no watched publish dir for model {mid!r}; "
                                  'pass {"dir": ...}'}
        gen = w.poll_once()
        if gen is None:
            return 200, {"status": "unchanged", "generation": w.current,
                         "model": mid}
        return 200, {"status": "reloaded", "generation": gen, "model": mid}

    def health(self, model_id: Optional[str] = None) -> dict:
        """The ``/healthz`` document of one model (None: the default, with
        the per-model overview when the catalog holds more than one)."""
        entry = self._entry(model_id)
        m = entry.model
        snap = self._entry_snapshot(entry)
        sizes = {int(k): v for k, v in snap["coalesced_batch_sizes"].items()}
        is_default = entry is self.catalog.default
        index = {**snap["index"],
                 **(m.engine.ann_stats() if self.ann and is_default
                    else {"enabled": False}),
                 "recall_gate_threshold": self.ann_recall_gate}
        index["exact_fallbacks"] = {"requested": 0, "gate": 0,
                                    **index["exact_fallbacks"]}
        doc = {
            # Degraded is alive but impaired: 200 with the flag, so a
            # balancer does not pull a server that sheds as designed.
            "status": "degraded" if self._degraded() else "ok",
            "model": entry.model_id,
            "family": type(m).__name__,
            "vocab_size": m.vocab.size,
            "dim": m.vector_size,
            "max_batch": self.max_batch,
            "device": device_name(m.engine.device),
            # The coalesced dispatches so far, from the batch sizes.
            "coalescer": {
                "dispatches": sum(sizes.values()),
                "requests": sum(k * n for k, n in sizes.items()),
                "largest_batch": max(sizes, default=0),
                "cache_hits": snap["synonym_cache"]["hits"],
            },
            "compiles": snap["compiles"]["total"],
            "post_warmup_compiles": snap["compiles"]["post_warmup"],
            "max_inflight": self.max_inflight,
            "request_deadline_seconds": self.request_deadline,
            "degraded_after_seconds": self.degraded_after,
            "ann_enabled": self._ann_live,
            "ann_recall_gate_ok": self._ann_live,
            "index": index,
            "generation": entry.metrics.generation,
            "fleet_generation": self.fleet_generation,
            "resident": entry.resident,
        }
        if model_id is None and len(self.catalog.entries) > 1:
            doc["models"] = self._models_summary()
        return doc

    def _dispatch(self, path: str, req: dict, model=None):
        """The JSON answer of ``/analogy``, ``/vector`` or ``/transform``
        of ``model`` (default: the default model), computed under the
        device lock, which the caller holds."""
        faults.fire("serving.dispatch")
        m = model if model is not None else self.model
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
        vecs = m.transform_sentences(req["sentences"])
        return [[float(x) for x in v] for v in vecs]

    def _tighten_gil_switch(self) -> None:
        """A serving process is a convoy of short sections that hold the
        interpreter lock (HTTP parsing, JSON, event wake-ups), one thread
        a connection; at the default 5 ms switch interval a round of N
        coalesced answers can wait N quanta. 1 ms keeps the hand-off
        tight, but costs whatever else runs in the process (a trainer
        beside the server runs at half its speed). Process-wide, so set
        only where the server owns the process and restored by
        :meth:`stop`."""
        if self._prev_switch is None:
            self._prev_switch = sys.getswitchinterval()
            sys.setswitchinterval(0.001)

    def serve_forever(self) -> None:
        """Serve on the calling thread: the server owns the process (the
        CLI), so the switch interval is tightened."""
        logger.info("serving model on %s:%d", self.host, self.port)
        self._tighten_gil_switch()
        self._httpd.serve_forever()

    def start_background(self) -> None:
        """Serve on a thread of its own, embedded beside other work: the
        switch interval stays as it is."""
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        for e in list(self.catalog.entries.values()):
            if e.watcher is not None:
                e.watcher.stop()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._prev_switch is not None:
            sys.setswitchinterval(self._prev_switch)
            self._prev_switch = None


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


@contextlib.contextmanager
def _installed_trace_log(path: Optional[str]):
    """A process-wide event recorder with a JSONL sink at ``path`` for the
    block's duration (none when ``path`` is empty); the recorder before it
    comes back after."""
    if not path:
        yield
        return
    prev = obs_events.get_recorder()
    rec = obs_events.set_recorder(obs_events.EventRecorder(jsonl_path=path))
    try:
        yield
    finally:
        obs_events.set_recorder(prev)
        rec.close()


def _watch_catalog(server: ModelServer, root: str, watch_poll: float,
                   device: DeviceLike) -> None:
    """``watch_models``: every ``<root>/<id>/LATEST.json`` publish
    directory gets a watcher of its own for model ``id``, which is loaded
    from its newest generation first when the catalog does not hold it
    (``default`` names the default model)."""
    from glint_word2vec_torch.streaming.publish import (
        discover_model_publish_dirs,
        resolve_latest,
    )

    for mid, pub in sorted(discover_model_publish_dirs(root).items()):
        if mid == DEFAULT_MODEL_ID:
            w_mid = None
        elif mid in server.catalog.entries:
            w_mid = mid
        else:
            gen_dir = resolve_latest(pub)
            if gen_dir is None:
                logger.info("watch-models: %r has a pointer but no committed "
                            "generation: skipped", mid)
                continue
            server.add_model(mid, model_dir=gen_dir, device=device)
            w_mid = mid
        entry = server._entry(w_mid)
        if entry.watcher is not None:
            continue  # --watch-checkpoint already follows it
        # Start from the generation loaded, so the first poll does not
        # stage it again.
        cur = None
        src = entry.source_dir
        if src is not None and (os.path.dirname(os.path.abspath(src))
                                == os.path.abspath(pub)):
            cur = os.path.basename(os.path.normpath(src))
        server.watch(pub, poll_seconds=watch_poll, current=cur, model_id=w_mid)


def serve_model_dir(
    model_dir: Optional[str],
    host: str = "127.0.0.1",
    port: int = 8801,
    *,
    max_batch: int = 64,
    warmup: bool = True,
    cache_size: int = 65536,
    max_inflight: int = 256,
    request_deadline: Optional[float] = 30.0,
    degraded_after: Optional[float] = 5.0,
    port_file: Optional[str] = None,
    device: DeviceLike = None,
    watch_dir: Optional[str] = None,
    watch_poll: float = 1.0,
    ann: bool = False,
    ann_clusters: int = -1,
    ann_nprobe: int = 8,
    ann_iters: int = 6,
    ann_sample: int = 65536,
    ann_recall_gate: float = 0.95,
    ann_recall_sample: int = 64,
    trace_log: Optional[str] = None,
    flight_dir: Optional[str] = None,
    models: Optional[dict] = None,
    model_memory_budget=None,
    watch_models: Optional[str] = None,
) -> None:
    """Load a saved model directory onto ``device`` and serve it until
    ``/shutdown`` or an interrupt, then free its tables. ``port_file``
    receives ``{"host", "port", "fleet_generation"}`` (atomically) once
    the server is warmed and listening: the readiness signal for
    ``port=0``. ``max_inflight``, ``request_deadline`` and
    ``degraded_after`` are the overload bounds, and ``ann`` to
    ``ann_recall_sample`` the index's settings, of :class:`ModelServer`.

    ``watch_dir`` follows a streaming trainer's publish directory, polled
    every ``watch_poll`` seconds: with ``model_dir=None`` the server boots
    from its newest committed generation (waiting for the first), and
    every later generation is hot-swapped in. ``trace_log`` installs a
    process-wide event recorder with a size-rotated JSONL sink (the kept
    request traces and the dispatch spans, also on ``GET /trace``) for
    as long as the server runs; ``flight_dir`` arms the anomaly flight
    recorder.

    The catalog: ``models`` maps more model ids to model directories
    served from the same process; ``model_memory_budget`` ("512mb",
    "2gb" or bytes) bounds their combined device residency with LRU
    stage-out; ``watch_models`` names a root whose ``<id>/LATEST.json``
    subdirectories each get a model and a watcher of their own."""
    from glint_word2vec_torch.models import load_model
    from glint_word2vec_torch.streaming.publish import _GEN_RE

    with _installed_trace_log(trace_log):
        if model_dir is None:
            if watch_dir is None:
                raise ValueError("model_dir or watch_dir required")
            model, model_dir = _boot_generation(watch_dir, watch_poll, device)
        else:
            model = load_model(model_dir, device=device)
        # A generation directory names the generation served.
        base = os.path.basename(os.path.normpath(model_dir))
        current = base if _GEN_RE.match(base) else None
        server = None
        try:
            server = ModelServer(
                model, host=host, port=port, max_batch=max_batch,
                warmup=warmup, cache_size=cache_size, max_inflight=max_inflight,
                request_deadline=request_deadline, degraded_after=degraded_after,
                ann=ann, ann_clusters=ann_clusters, ann_nprobe=ann_nprobe,
                ann_iters=ann_iters, ann_sample=ann_sample,
                ann_recall_gate=ann_recall_gate,
                ann_recall_sample=ann_recall_sample,
            )
            if flight_dir:
                server.enable_flight_recorder(flight_dir)
            if model_memory_budget is not None:
                server.catalog.budget_bytes = parse_memory_budget(model_memory_budget)
            # The default model's snapshot, for a stage-in were it ever
            # unpinned.
            server.catalog.default.source_dir = model_dir
            for mid in sorted(models or {}):
                server.add_model(mid, model_dir=models[mid], device=device)
            if watch_dir is not None:
                # The watcher starts from the generation loaded, so its first
                # poll does not load it again.
                server.watch(watch_dir, poll_seconds=watch_poll, current=current)
            elif current is not None:
                server.metrics.generation = current
            if watch_models:
                _watch_catalog(server, watch_models, watch_poll, device)
            if port_file:
                atomic_write_json(port_file, {
                    "host": server.host, "port": server.port,
                    "fleet_generation": server.fleet_generation,
                })
            try:
                server.serve_forever()
            except KeyboardInterrupt:
                server.stop()
        finally:
            if server is not None:
                for e in list(server.catalog.entries.values()):
                    if e.model is not model:
                        e.model.stop()
            model.stop()
