"""Resumable bulk embedding (the port's copy of
``glint_word2vec_tpu/batch/transform.py``): stream a sentence file through
the model's tables and write vector shards.

The reference system's product is DataFrame ``transform``: embed a whole
corpus offline through the server-side ``pullAverage``. This module is
that pipeline:

- a producer thread reads, tokenizes, encodes and packs sentences into
  fixed ``(rows, len)`` power-of-two batches
  (:func:`corpus.batching.pack_query_block`), buffered ahead by
  :func:`utils.prefetch.prefetch`, so the device does not wait on the host;
- the ``pull_average`` shapes are dispatched once before the stream
  starts (``Model.bulk_warmup``), and steady state must meet no new query
  shape (``engine.query_compiles``), as in serving;
- output is fixed-size ``.npy`` vector shards with per-shard sidecar
  manifests and an atomically committed progress record, so a kill at any
  point resumes bitwise from the last committed shard;
- ranks split the input into contiguous spans
  (:func:`parallel.distributed.shard_span`), each writing its own shard
  directory.

Output row ``i`` of the concatenated shards is the embedding of input line
``start + i``: blank and all-OOV lines become zero vectors, never dropped.
Every device dispatch goes through the model's ``transform_packed``, so
the word-level and subword families share one pipeline.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Iterator, List, Optional, Sequence

import numpy as np

from glint_word2vec_torch.corpus.batching import pack_query_block
from glint_word2vec_torch.utils import (
    atomic_write_json,
    atomic_write_npy,
)
from glint_word2vec_torch.utils import faults
from glint_word2vec_torch.utils.integrity import (
    CheckpointCorruptError,
    build_shard_manifest,
    verify_shard,
    write_shard_manifest,
)
from glint_word2vec_torch.utils.prefetch import prefetch

logger = logging.getLogger(__name__)

PROGRESS_NAME = "progress.json"
SHARD_PATTERN = "shard-{:06d}.npy"


def count_lines(path: str) -> int:
    """Line count of a text file (a trailing line without a newline
    counts). One buffered binary pass — the bulk pipeline's sizing scan,
    run before any device work."""
    n = 0
    last = b"\n"
    with open(path, "rb") as f:
        while True:
            buf = f.read(1 << 20)
            if not buf:
                break
            n += buf.count(b"\n")
            last = buf[-1:]
    if last != b"\n":
        n += 1
    return n


def iter_sentence_lines(
    path: str,
    *,
    start: int = 0,
    end: Optional[int] = None,
    lowercase: bool = False,
) -> Iterator[List[str]]:
    """Tokenized sentences from line span ``[start, end)``. Unlike
    :func:`corpus.vocab.iter_text_file` this PRESERVES blank lines (as
    empty token lists -> zero vectors downstream): the bulk transform's
    contract is one output row per input line, so row ``i`` of the
    vector shards always aligns with line ``start + i`` of the input."""
    with open(path, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            if i < start:
                continue
            if end is not None and i >= end:
                break
            yield (line.lower() if lowercase else line).split()


def _ckpt_fsync() -> bool:
    return os.environ.get("GLINT_CKPT_NO_FSYNC", "0") != "1"


class ShardWriter:
    """Fixed-size ``.npy`` vector shards + integrity sidecars + an
    atomically committed progress record.

    Each full buffer commits as ``shard-NNNNNN.npy`` (atomic temp +
    ``os.replace``) with a ``<shard>.manifest.json`` sidecar
    (:func:`utils.integrity.write_shard_manifest`, the checkpoint
    shards' contract), then the progress record is replaced.
    The resume scan — not the progress record — is the source of truth:
    a kill between a shard commit and the progress write leaves a valid
    shard the record does not mention, and recomputing it would only
    rewrite identical bytes. The record cross-checks the run geometry
    (input name, span, shard size, dim): a mismatch raises instead of
    silently mixing incompatible shards."""

    def __init__(
        self,
        out_dir: str,
        *,
        shard_size: int,
        dim: int,
        meta: dict,
        fsync: Optional[bool] = None,
    ):
        if shard_size < 1:
            raise ValueError("shard_size must be >= 1")
        self.out_dir = out_dir
        self.shard_size = int(shard_size)
        self.dim = int(dim)
        self.meta = dict(meta)
        self.fsync = _ckpt_fsync() if fsync is None else bool(fsync)
        os.makedirs(out_dir, exist_ok=True)
        self._buf = np.zeros((self.shard_size, self.dim), np.float32)
        self._fill = 0
        self.shard_index = 0
        self.sentences_done = 0
        self.committed = 0
        self.skipped = 0
        self.shard_commit_seconds = 0.0

    # -- resume ---------------------------------------------------------

    def _progress_path(self) -> str:
        return os.path.join(self.out_dir, PROGRESS_NAME)

    def resume_scan(self, total_sentences: int, *, deep: bool = True) -> int:
        """Longest valid committed-shard prefix; returns the sentence
        count it covers (0 = fresh start). Every prefix shard is
        verified against its sidecar manifest (``deep=True`` re-hashes
        payloads — bit rot or a torn write ends the prefix, and the
        deterministic pipeline simply recomputes identical bytes from
        there). A partial (short) shard only counts when it is the
        final shard of a COMPLETED span; anywhere else it marks the
        kill point and is recomputed."""
        prog = None
        if os.path.exists(self._progress_path()):
            try:
                with open(self._progress_path()) as f:
                    prog = json.load(f)
            except (ValueError, OSError) as e:
                logger.warning(
                    "unreadable %s (%s); falling back to the shard scan",
                    self._progress_path(), e,
                )
        if prog is not None:
            for key, want in self.meta.items():
                got = prog.get(key)
                if got != want:
                    raise CheckpointCorruptError(
                        f"{self.out_dir}: progress record {key}={got!r} "
                        f"does not match this run's {key}={want!r} — "
                        "refusing to mix shards from a different "
                        "transform (point --out at a fresh directory)"
                    )
        done = 0
        k = 0
        while done < total_sentences:
            fname = SHARD_PATTERN.format(k)
            path = os.path.join(self.out_dir, fname)
            if not os.path.exists(path):
                break
            try:
                verify_shard(self.out_dir, fname, deep=deep)
            except CheckpointCorruptError as e:
                logger.warning(
                    "resume scan stops at %s: %s (recomputing from "
                    "sentence %d)", fname, e, done,
                )
                break
            rows = int(np.load(path, mmap_mode="r").shape[0])
            if rows < self.shard_size and done + rows < total_sentences:
                logger.warning(
                    "resume scan stops at short shard %s (%d rows "
                    "mid-span): recomputing from sentence %d",
                    fname, rows, done,
                )
                break
            done += rows
            k += 1
        self.shard_index = k
        self.skipped = k
        self.sentences_done = done
        return done

    # -- writing --------------------------------------------------------

    def append(self, vecs: np.ndarray) -> None:
        pos = 0
        while pos < len(vecs):
            take = min(self.shard_size - self._fill, len(vecs) - pos)
            self._buf[self._fill : self._fill + take] = vecs[pos : pos + take]
            self._fill += take
            pos += take
            if self._fill == self.shard_size:
                self._commit()

    def finish(self) -> None:
        if self._fill:
            self._commit()
        self._write_progress(final=True)

    def _commit(self) -> None:
        t0 = time.perf_counter()
        fname = SHARD_PATTERN.format(self.shard_index)
        path = os.path.join(self.out_dir, fname)
        atomic_write_npy(path, self._buf[: self._fill])
        write_shard_manifest(
            self.out_dir, fname, build_shard_manifest(self.out_dir, fname),
            fsync=self.fsync,
        )
        # Fault point AFTER the shard + sidecar are durable but BEFORE
        # the progress record: a kill here leaves a committed shard the
        # record does not mention — exactly the window the resume scan
        # (not the record) is the source of truth for.
        faults.fire("transform.shard_commit")
        self.sentences_done += self._fill
        self.shard_index += 1
        self.committed += 1
        self._fill = 0
        self.shard_commit_seconds += time.perf_counter() - t0
        self._write_progress()

    def _write_progress(self, final: bool = False) -> None:
        atomic_write_json(
            self._progress_path(),
            {
                **self.meta,
                "shards": self.shard_index,
                "sentences_done": self.sentences_done,
                "complete": bool(final),
            },
        )


def _packed_batches(
    model,
    input_path: str,
    *,
    rows: int,
    max_len: int,
    start: int,
    end: int,
    lowercase: bool,
    stats: dict,
):
    """Producer generator: encode and pack ``rows``-sentence blocks into
    power-of-two ``(idx, mask, n)`` batches. Runs on the prefetch thread;
    the ``stats`` dict is shared with the consumer (int and float slot
    updates; the consumer reads them for telemetry only)."""
    vocab = model.vocab
    buf: List[np.ndarray] = []

    def _pack(block: Sequence[np.ndarray]):
        t0 = time.perf_counter()
        idx, mask, n = pack_query_block(block, rows=rows)
        faults.fire("transform.producer")
        stats["producer_seconds"] += time.perf_counter() - t0
        stats["batches"] += 1
        if idx is not None:
            stats["fill_tokens"] += int(sum(len(x) for x in block))
            stats["fill_capacity"] += int(idx.size)
        return idx, mask, n

    for toks in iter_sentence_lines(
        input_path, start=start, end=end, lowercase=lowercase
    ):
        enc = vocab.encode(toks)
        if len(enc) > max_len:
            enc = enc[:max_len]
            stats["truncated_sentences"] += 1
        buf.append(enc)
        if len(buf) == rows:
            yield _pack(buf)
            buf = []
    if buf:
        yield _pack(buf)


def transform_file(
    model,
    input_path: str,
    out_dir: str,
    *,
    rows: int = 1024,
    max_len: int = 256,
    shard_size: int = 8192,
    start: int = 0,
    end: Optional[int] = None,
    lowercase: bool = False,
    prefetch_depth: int = 2,
    deep_verify: bool = True,
    warmup: bool = True,
    obs_run=None,
) -> dict:
    """Embed line span ``[start, end)`` of ``input_path`` into vector
    shards under ``out_dir``; returns the run's stats document.

    ``shard_size`` is rounded up to a multiple of ``rows`` so shard
    boundaries always fall on batch boundaries — resumes then re-form
    byte-identical batches without leaning on the padding-exactness
    argument alone. ``end=None`` means end-of-file. ``obs_run`` (an
    ``ObsRun`` or the null run) receives ``update_transform`` gauge
    updates on the batch cadence."""
    if rows < 1:
        raise ValueError("rows must be >= 1")
    if max_len < 1:
        raise ValueError("max_len must be >= 1")
    if start < 0:
        raise ValueError("start must be >= 0")
    shard_size = max(rows, (int(shard_size) + rows - 1) // rows * rows)
    if end is None:
        end = count_lines(input_path)
    if end < start:
        raise ValueError(f"span [{start}, {end}) is empty or inverted")
    total = end - start
    dim = int(model.vector_size)

    meta = {
        "version": 1,
        "input": os.path.basename(input_path),
        "span": [int(start), int(end)],
        "rows": int(rows),
        "max_len": int(max_len),
        "shard_size": int(shard_size),
        "dim": dim,
        "lowercase": bool(lowercase),
    }
    writer = ShardWriter(
        out_dir, shard_size=shard_size, dim=dim, meta=meta
    )
    resumed = writer.resume_scan(total, deep=deep_verify)
    if resumed:
        logger.info(
            "resuming from %d committed shard(s): %d/%d sentences "
            "already on disk", writer.skipped, resumed, total,
        )

    warmup_compiles = 0
    if warmup:
        t0 = time.perf_counter()
        warmup_compiles = model.bulk_warmup(rows, max_len)
        logger.info(
            "bulk warmup: %d new query shape(s) in %.1fs",
            warmup_compiles, time.perf_counter() - t0,
        )
    compiles_after_warmup = model.engine.query_compiles

    stats = {
        "producer_seconds": 0.0,
        "truncated_sentences": 0,
        "batches": 0,
        "fill_tokens": 0,
        "fill_capacity": 0,
    }
    producer_wait = 0.0
    dispatch_seconds = 0.0
    done = resumed
    t_start = time.perf_counter()
    it = prefetch(
        _packed_batches(
            model, input_path, rows=rows, max_len=max_len,
            start=start + resumed, end=end, lowercase=lowercase,
            stats=stats,
        ),
        depth=prefetch_depth,
    )

    def _fill() -> Optional[float]:
        cap = stats["fill_capacity"]
        return stats["fill_tokens"] / cap if cap else None

    def _obs(final: bool = False) -> None:
        if obs_run is None:
            return
        elapsed = max(time.perf_counter() - t_start, 1e-9)
        obs_run.update_transform(
            sentences_done=done,
            input_sentences=total,
            sentences_per_sec=(done - resumed) / elapsed,
            shards_committed=writer.committed,
            shards_skipped=writer.skipped,
            bucket_fill=_fill(),
            producer_wait_seconds=producer_wait,
            dispatch_seconds=dispatch_seconds,
            post_warmup_compiles=(
                model.engine.query_compiles - compiles_after_warmup
            ),
        )

    _obs()
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        producer_wait += time.perf_counter() - t0
        if batch is None:
            break
        idx, mask, n = batch
        t0 = time.perf_counter()
        if idx is None:
            vecs = np.zeros((n, dim), np.float32)
        else:
            vecs = model.transform_packed(idx, mask)[:n]
        dispatch_seconds += time.perf_counter() - t0
        writer.append(vecs)
        done += n
        _obs()
    writer.finish()
    _obs(final=True)

    wall = time.perf_counter() - t_start
    post_warmup = model.engine.query_compiles - compiles_after_warmup
    if post_warmup:
        logger.warning(
            "%d query shape(s) first met after the warmup: the warmed "
            "family missed a shape", post_warmup,
        )
    fill = _fill()
    return {
        "input": input_path,
        "out_dir": out_dir,
        "span": [int(start), int(end)],
        "sentences": total,
        "sentences_done": done,
        "resumed_sentences": resumed,
        "shards_committed": writer.committed,
        "shards_skipped": writer.skipped,
        "shard_commit_seconds": round(writer.shard_commit_seconds, 4),
        "wall_seconds": round(wall, 4),
        "sentences_per_sec": round((done - resumed) / max(wall, 1e-9), 1),
        "bucket_fill": round(fill, 4) if fill is not None else None,
        "producer_wait_seconds": round(producer_wait, 4),
        "producer_seconds": round(stats["producer_seconds"], 4),
        "dispatch_seconds": round(dispatch_seconds, 4),
        "host_stall_frac": round(producer_wait / max(wall, 1e-9), 4),
        "truncated_sentences": stats["truncated_sentences"],
        "batches": stats["batches"],
        "warmup_compiles": warmup_compiles,
        "post_warmup_compiles": post_warmup,
        "rows": int(rows),
        "max_len": int(max_len),
        "shard_size": int(shard_size),
        "dim": dim,
    }


def load_transform_output(out_dir: str) -> np.ndarray:
    """Concatenate a transform run's committed shards, in order, into
    one ``(sentences, d)`` array — the verification/consumption helper
    (bench drills sha-compare this against an uninterrupted run)."""
    parts = []
    k = 0
    while True:
        path = os.path.join(out_dir, SHARD_PATTERN.format(k))
        if not os.path.exists(path):
            break
        parts.append(np.load(path))
        k += 1
    if not parts:
        return np.zeros((0, 0), np.float32)
    return np.concatenate(parts, axis=0)


# ----------------------------------------------------------------------
# ANN-powered batch jobs (the index's batch amortization regime)
# ----------------------------------------------------------------------


def synonyms_dump(
    model,
    out_path: Optional[str],
    *,
    num: int = 10,
    block: int = 1024,
    approximate: bool = False,
    graph_prefix: Optional[str] = None,
    start: int = 0,
    end: Optional[int] = None,
) -> dict:
    """All-vocab top-``num`` neighbor dump: JSONL at ``out_path`` (one
    ``{"word", "synonyms": [[word, sim], ...]}`` object per vocab word,
    self-match excluded) and/or a k-NN graph (``graph_prefix`` writes
    ``<prefix>.ids.npy`` int32 ``(V, num)`` neighbor ids, ``-1`` padded,
    ``<prefix>.sims.npy`` float32 sims, and a ``<prefix>.json`` meta
    document). One pass over the table either way: vocab vectors stream
    ``block`` rows at a time through the query engine and
    ``find_synonyms_batch`` — whole-table batch top-k being the ANN
    index's best amortization regime (build cost over V queries).
    ``approximate=True`` rides an adopted index, with
    ``find_synonyms_batch``'s capacity escape to exact. Outputs are
    written temp + ``os.replace`` (atomic, resume-by-rerun)."""
    if num < 1:
        raise ValueError("num must be >= 1")
    if block < 1:
        raise ValueError("block must be >= 1")
    vocab_size = model.vocab.size
    words = model.vocab.words
    end = vocab_size if end is None else min(int(end), vocab_size)
    start = max(0, int(start))
    if end < start:
        raise ValueError(f"vocab span [{start}, {end}) is inverted")
    qeng = model._query_engine()
    n_words = end - start
    want_graph = graph_prefix is not None
    ids_out = (
        np.full((n_words, num), -1, np.int32) if want_graph else None
    )
    sims_out = (
        np.zeros((n_words, num), np.float32) if want_graph else None
    )

    t0 = time.perf_counter()
    f = tmp = None
    if out_path is not None:
        tmp = f"{out_path}.tmp.{os.getpid()}"
        f = open(tmp, "w", encoding="utf-8")
    try:
        for s in range(start, end, block):
            ids = np.arange(s, min(s + block, end), dtype=np.int32)
            vecs = qeng.pull(ids).cpu().numpy()
            # num + 1 so the word itself can be dropped, the
            # find_synonyms contract applied vocab-wide.
            hits = model.find_synonyms_batch(
                vecs, num + 1, approximate=approximate
            )
            for wid, row in zip(ids, hits):
                word = words[int(wid)]
                kept = [(w, sim) for w, sim in row if w != word][:num]
                if f is not None:
                    f.write(json.dumps({
                        "word": word,
                        "synonyms": [
                            [w, round(float(sim), 6)] for w, sim in kept
                        ],
                    }) + "\n")
                if want_graph:
                    r = int(wid) - start
                    widx = model.vocab.word_index
                    for j, (w, sim) in enumerate(kept):
                        ids_out[r, j] = widx[w]
                        sims_out[r, j] = sim
        if f is not None:
            f.close()
            f = None
            os.replace(tmp, out_path)
            tmp = None
    finally:
        if f is not None:
            f.close()
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)

    seconds = time.perf_counter() - t0
    out = {
        "words": n_words,
        "num": int(num),
        "block": int(block),
        "approximate": bool(approximate),
        "seconds": round(seconds, 4),
        "words_per_sec": round(n_words / max(seconds, 1e-9), 1),
    }
    if out_path is not None:
        out["out"] = out_path
    if want_graph:
        atomic_write_npy(f"{graph_prefix}.ids.npy", ids_out)
        atomic_write_npy(f"{graph_prefix}.sims.npy", sims_out)
        atomic_write_json(
            f"{graph_prefix}.json",
            {**out, "ids": f"{graph_prefix}.ids.npy",
             "sims": f"{graph_prefix}.sims.npy",
             "pad_id": -1},
        )
        out["graph_prefix"] = graph_prefix
    return out
