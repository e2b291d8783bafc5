"""Generation publish protocol (own copy of
``glint_word2vec_tpu/streaming/publish.py``): how a streaming trainer hands
model snapshots to servers it never talks to directly.

Layout of a publish directory::

    publish_dir/
      gen-000001/           # one committed generation = a loadable
        matrix/             #   model dir (engine shards + manifest,
        words.txt           #   grown word list, params metadata)
        params.json
      gen-000002/
      LATEST.json           # the pointer: {"generation": "gen-000002",
                            #  "seq": 2, "published_unix": ..., ...}

Commit protocol (the checkpoints' temp+rename discipline, one level up):

1. Everything lands in ``gen-NNNNNN.tmp-<pid>`` first. The matrix goes
   through the engine's own fsync'd temp+rename save (so it carries the
   integrity manifest); ``words.txt``/``params.json`` are atomic
   writes.
2. ONE ``os.replace`` renames the temp directory to ``gen-NNNNNN`` —
   the generation now exists, complete by construction.
3. ``LATEST.json`` is atomically replaced to reference it.

A watcher trusts ONLY ``LATEST.json``: a trainer SIGKILLed before step
2 leaves an ignored ``*.tmp-*`` orphan (pruned on the next trainer
start); killed between 2 and 3 leaves a complete-but-unreferenced
generation the next trainer run simply numbers past. Fault points
``publish.pre_commit`` / ``publish.pre_pointer`` (utils/faults.py) sit
exactly on those two windows so the crash cases are drills, not hopes.

Retention keeps the last ``keep`` committed generations: a replica may
still be staging generation N-1 off the request path while N commits,
so the floor is 2.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import time
from collections import deque
from typing import Optional

from glint_word2vec_torch.utils import atomic_write_json, atomic_write_text, faults

logger = logging.getLogger(__name__)

LATEST_NAME = "LATEST.json"

_GEN_RE = re.compile(r"^gen-(\d{6,})$")


def generation_name(seq: int) -> str:
    """``gen-000042`` for seq 42 — zero-padded so lexical order is
    publication order."""
    return f"gen-{int(seq):06d}"


def read_latest(publish_dir: str,
                raise_errors: bool = False) -> Optional[dict]:
    """The ``LATEST.json`` pointer dict, or None when absent/unreadable.
    The pointer is atomically replaced, so a local reader can never see
    a torn write — an unparseable file means a foreign artifact, logged
    once per distinct error and treated as absent.

    ``raise_errors=True`` surfaces read/parse failures as the
    ``OSError``/``ValueError`` they are instead of folding them into
    "absent": on network filesystems a pointer read CAN fail or tear
    transiently (mid-rename visibility, NFS attribute-cache hiccups),
    and a caller with retry machinery (the serving
    ``SnapshotWatcher``) wants to count and back off rather than silently treat the hiccup as "no publish
    yet". A genuinely missing pointer (``FileNotFoundError``) is the
    normal no-publish-yet state and stays None in both modes."""
    path = os.path.join(publish_dir, LATEST_NAME)
    try:
        with open(path) as f:
            latest = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        if raise_errors:
            raise
        logger.warning("unreadable %s: %s", path, e)
        return None
    if not isinstance(latest, dict) or "generation" not in latest:
        if raise_errors:
            raise ValueError(f"malformed {path}: {latest!r}")
        logger.warning("malformed %s: %r", path, latest)
        return None
    return latest


def resolve_latest(publish_dir: str) -> Optional[str]:
    """Absolute path of the generation ``LATEST.json`` references, or
    None when there is no committed generation. The pointer flips only
    after the generation's atomic rename, so a referenced directory
    exists and is complete; a missing one means an operator deleted it
    — surfaced as absent, never an exception."""
    latest = read_latest(publish_dir)
    if latest is None:
        return None
    gen_dir = os.path.join(publish_dir, str(latest["generation"]))
    if not os.path.isdir(gen_dir):
        logger.warning(
            "%s references missing generation %r", LATEST_NAME,
            latest["generation"],
        )
        return None
    return gen_dir


def discover_model_publish_dirs(root: str) -> dict:
    """Model id -> publish directory under a catalog root
    (``publish.py:116`` of the JAX package): each immediate subdirectory
    of ``root`` with a ``LATEST.json`` pointer is one model's publish
    directory, named by its model id. A subdirectory without a pointer yet
    (its trainer has not committed a first generation) is skipped."""
    out: dict = {}
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return out
    for name in names:
        d = os.path.join(root, name)
        if os.path.isfile(os.path.join(d, LATEST_NAME)):
            out[name] = d
    return out


def next_generation_seq(publish_dir: str) -> int:
    """1 + the highest committed generation number on disk (orphaned
    post-crash generations included, so a restarted trainer never
    reuses — and thereby never clobbers — a directory a replica might
    be reading)."""
    top = 0
    try:
        entries = os.listdir(publish_dir)
    except FileNotFoundError:
        return 1
    for entry in entries:
        m = _GEN_RE.match(entry)
        if m:
            top = max(top, int(m.group(1)))
    return top + 1


def prune_orphan_tmp(publish_dir: str) -> int:
    """Remove ``*.tmp-*`` directories a crashed publish left behind
    (they were never referenced; a concurrent live publisher uses its
    own pid suffix). Returns the count removed."""
    n = 0
    try:
        entries = os.listdir(publish_dir)
    except FileNotFoundError:
        return 0
    for entry in entries:
        if ".tmp-" in entry:
            shutil.rmtree(
                os.path.join(publish_dir, entry), ignore_errors=True
            )
            n += 1
    return n


class SnapshotPublisher:
    """Publishes committed model generations from a live engine.

    ``publish()`` snapshots the tables on the calling thread (the same
    device->host copy ``save_async`` charges the trainer) and runs the
    serialization + the whole commit sequence on the engine's single
    checkpoint writer thread, so the trainer returns to dispatching
    immediately. Commits are strictly ordered through that writer —
    ``LATEST.json`` can never flip backwards. ``history`` keeps each
    committed publish's ``snapshot_seconds`` (the trainer's stall) and
    ``write_seconds`` (the writer thread's)."""

    def __init__(self, publish_dir: str, engine, params, *,
                 keep: int = 3):
        self.publish_dir = publish_dir
        self.engine = engine
        self.params = params
        self.keep = max(2, int(keep))
        os.makedirs(publish_dir, exist_ok=True)
        prune_orphan_tmp(publish_dir)
        self._seq = next_generation_seq(publish_dir)
        #: Committed generations this publisher has flipped LATEST to.
        self.published = 0
        #: time.time() of the most recent LATEST flip (None before any).
        self.last_publish_time: Optional[float] = None
        #: One dict a committed publish: generation, snapshot and write
        #: seconds (the last 256).
        self.history: deque = deque(maxlen=256)

    def publish(self, vocab) -> str:
        """Publish the engine's current tables + the given (grown)
        vocabulary as the next generation; returns its name. The commit
        (rename + pointer flip) happens on the writer thread strictly
        after the matrix snapshot lands — call
        ``engine.wait_pending_saves()`` to barrier on it."""
        gen = generation_name(self._seq)
        self._seq += 1
        tmp = os.path.join(self.publish_dir, f"{gen}.tmp-{os.getpid()}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        words = list(vocab.words)
        table_version = self.engine.table_version
        timing = {"generation": gen}

        def commit() -> None:
            # _write_snapshot's own time, set just before it commits.
            timing["write_seconds"] = self.engine._ckpt_last_write_s
            self._commit(gen, tmp, words, table_version)
            self.history.append(timing)

        t0 = time.perf_counter()
        self.engine.save_async(os.path.join(tmp, "matrix"), on_commit=commit)
        timing["snapshot_seconds"] = time.perf_counter() - t0
        return gen

    def _commit(self, gen: str, tmp: str, words, table_version) -> None:
        """Writer-thread tail of one publish: metadata files into the
        temp dir, the atomic generation rename, the pointer flip, then
        retention. A crash anywhere leaves LATEST on the previous
        committed generation."""
        atomic_write_text(
            os.path.join(tmp, "words.txt"),
            "".join(w + "\n" for w in words),
        )
        atomic_write_json(
            os.path.join(tmp, "params.json"),
            json.loads(self.params.to_json()),
        )
        faults.fire("publish.pre_commit")
        final = os.path.join(self.publish_dir, gen)
        os.replace(tmp, final)
        self._fsync_dir(self.publish_dir)
        faults.fire("publish.pre_pointer")
        atomic_write_json(
            os.path.join(self.publish_dir, LATEST_NAME),
            {
                "generation": gen,
                "seq": int(gen.split("-")[1]),
                "published_unix": time.time(),
                "table_version": int(table_version),
                "vocab_size": len(words),
            },
        )
        self.published += 1
        self.last_publish_time = time.time()
        self._prune(keep_floor=gen)
        logger.info("published %s (%d words)", gen, len(words))

    @staticmethod
    def _fsync_dir(path: str) -> None:
        if os.environ.get("GLINT_CKPT_NO_FSYNC", "0") == "1":
            return
        try:
            fd = os.open(path, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _prune(self, keep_floor: str) -> None:
        """Drop committed generations older than the newest ``keep``
        (never the one just published — a replica may be staging the
        one before it, which the keep >= 2 floor protects)."""
        gens = sorted(
            (e for e in os.listdir(self.publish_dir) if _GEN_RE.match(e)),
            key=lambda e: int(_GEN_RE.match(e).group(1)),
        )
        for entry in gens[: max(0, len(gens) - self.keep)]:
            if entry == keep_floor:
                continue
            shutil.rmtree(
                os.path.join(self.publish_dir, entry), ignore_errors=True
            )
