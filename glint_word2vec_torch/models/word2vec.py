"""The word2vec estimator and fitted model of the port (counterpart of
``glint_word2vec_tpu/models/word2vec.py``).

:class:`Word2Vec` trains on one device by one of two routes, chosen as
the JAX package chooses them (``models/word2vec.py:422-559``):

- the corpus-resident path, when the model family allows it and the
  corpus fits the device budget: build the vocabulary and the flat
  corpus on the host, upload the corpus once, then per epoch subsample
  and compact it on the device and run groups of dense packed steps
  (``EmbeddingEngine.train_steps_corpus_packed``) or, with
  ``batch_packing="grid"``, of grid steps assembled on the device
  (``EmbeddingEngine.train_steps_corpus``);
- the host batcher otherwise (a corpus past the budget, or a family such
  as fastText whose centers need host-side expansion): the host windows
  the corpus into grid batches on a producer thread
  (``corpus/batching.SkipGramBatcher``, ``utils/prefetch.py``) and the
  engine runs groups of composed steps
  (``EmbeddingEngine.train_steps_grouped``).

Both anneal the learning rate linearly and checkpoint at epoch ends (the
packed path also mid-epoch, under the JAX package's
``GLINT_PACKED_STOP_AFTER_GROUPS`` drill), and both train per-pair
negatives or the shared negative pool (``shared_negatives > 0``). Both
loops keep the card fed: a group is read back while the next one is
queued, a checkpoint stalls the loop only for the copy of the tables to
host memory (a writer thread writes and commits it), and the next
epoch's compaction is dispatched during the current epoch's tail. An
``obs.ObsConfig`` (``obs=`` or :meth:`Word2Vec.set_observability`) adds
the event log, the heartbeat and status file, the divergence canary and
the step-time ledger.

With ``exchange="sparse"|"dense"`` in a gang of processes
(``parallel/distributed.initialize``) each process trains its own replica
on its shard of the corpus through the resident route, and the replicas
reconcile the rows they touched after every dispatch group
(``parallel/exchange.py``, :meth:`Word2Vec._fit_replica_exchange`); one
process runs the same protocol with the wire short-circuited. What the
JAX package trains on an SPMD mesh (``num_partitions``/``num_shards``
above 1, the ``dims`` layout, a gang with ``exchange="none"``) raises
``ValueError``: that is the port's mesh slice, still to come.

:class:`Word2VecModel` is the query surface over an
:class:`~glint_word2vec_torch.parallel.engine.EmbeddingEngine`, and
:class:`LocalWord2VecModel` the host-only numpy model.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import shutil
import time
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from glint_word2vec_torch.corpus.batching import (
    BatchGroup,
    SkipGramBatcher,
    chunk_sentences,
    context_width,
    encode_sentences,
    group_batches,
    pack_query_block,
    packed_pair_batch,
)
from glint_word2vec_torch.corpus.vocab import (
    Vocabulary,
    build_vocab,
    saved_model_vocabulary,
    scan_and_encode_file,
    scan_and_encode_stream,
)
from glint_word2vec_torch.device import DeviceLike, resolve_device
from glint_word2vec_torch.obs import TrainingDiverged, start_run
from glint_word2vec_torch.parallel import distributed as dist
from glint_word2vec_torch.parallel.engine import DeferredReadback, deferred_readback
from glint_word2vec_torch.ops import random as rnd
from glint_word2vec_torch.ops.device_batching import (
    corpus_words_done,
    corpus_words_done_compacted,
)
from glint_word2vec_torch.utils import (
    atomic_write_json,
    atomic_write_npy,
    atomic_write_text,
    next_pow2,
)
from glint_word2vec_torch.utils.integrity import resolve_train_state
from glint_word2vec_torch.utils.metrics import TrainingMetrics
from glint_word2vec_torch.utils.params import Word2VecParams
from glint_word2vec_torch.utils.prefetch import prefetch

logger = logging.getLogger(__name__)

#: Rows one query dispatch may pull (the JAX package's bound on a
#: request's device-memory spike).
MAX_QUERY_ROWS = 10_000

#: Device bytes a corpus word takes at its peak: its int32 id alone, or,
#: with subsampling, the id and the epoch's compaction pass (the int64
#: keep draws and prefix sums, the compacted copy). ``chip_smoke.py``
#: measures the compaction's peak on the card against the second.
CORPUS_BYTES_PER_WORD = 4
SUBSAMPLED_CORPUS_BYTES_PER_WORD = 64
#: What a word adds while the next epoch's pass is prefetched: the active
#: epoch's compacted copy lives beside the pass until the next epoch
#: adopts it. ``chip_smoke.py`` measures that peak too.
PREFETCHED_CORPUS_BYTES_PER_WORD = 4

#: Share of the device's free memory that the tables, the step's working
#: set and the corpus may take together.
DEVICE_MEMORY_FRACTION = 0.9


def _free_device_bytes(device: torch.device) -> int:
    """Memory a fit can still allocate on ``device``: the card's free
    memory plus what PyTorch's allocator holds unused, or the host's
    available memory for the CPU."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        idle = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        return int(free + idle)
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _multiprocess_barrier(tag: str) -> None:
    """All-rank rendezvous before a gang's checkpoint commits: no rank may
    flip ``train_state.json`` while a peer is still writing its row block
    (the flip would commit a snapshot whose shard manifests do not all
    exist yet). A no-op on one process."""
    dist.barrier("ckpt_" + tag)


def _flip_checkpoint_state(
    checkpoint_dir: str, state_path: str, ck_name: str, *,
    epochs_completed: int, step: int, words_done: int,
    extra: Optional[dict] = None,
) -> None:
    """Atomically point ``train_state.json`` at a finished table snapshot
    and prune older snapshot directories. The tables are on disk before
    the flip, so a crash never leaves a state that names partial tables.
    The previous committed record rides along under ``"prev"`` and its
    directory survives the prune (keep-last-2), as a fallback for a
    snapshot that later fails verification. Same keys as the JAX
    package's (``models/word2vec.py:59-115``)."""
    prev = None
    if os.path.exists(state_path):
        try:
            with open(state_path) as f:
                prev = json.load(f)
            prev.pop("prev", None)  # keep exactly two, not a chain
        except (OSError, ValueError):
            prev = None
    if prev is not None and ("ckpt" not in prev or prev["ckpt"] == ck_name):
        prev = None
    atomic_write_json(state_path, {
        "epochs_completed": epochs_completed,
        "step": step,
        "words_done": words_done,
        "ckpt": ck_name,
        **(extra or {}),
        **({"prev": prev} if prev else {}),
    })
    keep = {ck_name}
    if prev:
        keep.add(prev["ckpt"])
    for entry in os.listdir(checkpoint_dir):
        if entry.startswith("ckpt-") and entry not in keep:
            shutil.rmtree(os.path.join(checkpoint_dir, entry), ignore_errors=True)


def _ckpt_wait_timeout() -> Optional[float]:
    """Seconds fit exit waits for a checkpoint write in flight before it
    fails the run naming the write (``GLINT_CKPT_WAIT_TIMEOUT``, default
    900; 0 waits without bound)."""
    raw = os.environ.get("GLINT_CKPT_WAIT_TIMEOUT", "900")
    try:
        t = float(raw)
    except ValueError:
        logger.warning("GLINT_CKPT_WAIT_TIMEOUT=%r is not a number; using 900",
                       raw)
        t = 900.0
    return t if t > 0 else None


def _checkpoint_tables(engine, obs_run, metrics, ck_path: str, ck_name: str,
                       commit) -> None:
    """Write one checkpoint with the least stall of the fit loop.

    By default (``engine.save_async``) the loop waits only for the copy
    of the tables to host memory (the ``ckpt_snapshot`` span); the write,
    its fsyncs, the directory's commit and then ``commit`` (the
    ``train_state.json`` flip) run in that order on the engine's writer
    thread, so a crash at any point leaves the previous checkpoint
    authoritative. ``GLINT_SYNC_CKPT=1``, and a gang's save split, write
    and commit here (``checkpoint_save``): in a gang every rank writes its
    row block, all meet at a barrier, and rank 0 alone flips the shared
    state file. Either way the wait is charged to
    ``device_stall_seconds``."""
    t0 = time.time()
    if engine.async_saves_enabled():
        with obs_run.span("ckpt_snapshot", ckpt=ck_name):
            engine.save_async(ck_path, on_commit=commit)
    else:
        with obs_run.span("checkpoint_save", ckpt=ck_name):
            engine.save(ck_path)
            _multiprocess_barrier(ck_name)
            if dist.process_index() == 0:
                commit()
    metrics.record_stall(time.time() - t0)


def _save_diverged_snapshot(engine, checkpoint_dir: Optional[str],
                            obs_run) -> None:
    """The canary abort's tail in both loops: a final ``ckpt-diverged``
    snapshot for the post-mortem, without flipping ``train_state.json``,
    so a resume restarts from the last healthy checkpoint."""
    if not checkpoint_dir:
        return
    ck = os.path.join(checkpoint_dir, "ckpt-diverged")
    with obs_run.span("checkpoint_save", ckpt="ckpt-diverged"):
        engine.save(ck)
    logger.error("canary abort: diverged tables saved to %s", ck)


class Word2Vec:
    """Skip-gram negative-sampling estimator on one device.

    Construct with a :class:`Word2VecParams`, keyword overrides, or the
    fluent setters::

        model = (Word2Vec(device="cpu")
                 .set_vector_size(100)
                 .set_window_size(5)
                 .set_seed(1)
                 .fit(sentences))

    ``device=None`` trains on the CUDA card and raises without one;
    ``"cpu"`` runs the kernels' plain versions.
    """

    def __init__(self, params: Optional[Word2VecParams] = None,
                 device: DeviceLike = None, obs=None, **overrides):
        self.params = (params or Word2VecParams()).replace(**overrides)
        self.device = device
        #: Optional ``obs.ObsConfig``: the run's event log, heartbeat,
        #: status file, canary and step-time file. Run config, never part
        #: of the params or the saved model.
        self.obs = obs

    def _set(self, **kw) -> "Word2Vec":
        self.params = self.params.replace(**kw)
        return self

    def set_vector_size(self, v: int) -> "Word2Vec":
        return self._set(vector_size=v)

    def set_window_size(self, v: int) -> "Word2Vec":
        return self._set(window=v)

    def set_step_size(self, v: float) -> "Word2Vec":
        return self._set(step_size=v)

    def set_batch_size(self, v: int) -> "Word2Vec":
        return self._set(batch_size=v)

    def set_num_negatives(self, v: int) -> "Word2Vec":
        """Negative samples per positive pair (the reference's ``n``)."""
        return self._set(num_negatives=v)

    def set_subsample_ratio(self, v: float) -> "Word2Vec":
        return self._set(subsample_ratio=v)

    def set_min_count(self, v: int) -> "Word2Vec":
        return self._set(min_count=v)

    def set_num_iterations(self, v: int) -> "Word2Vec":
        return self._set(num_iterations=v)

    def set_max_sentence_length(self, v: int) -> "Word2Vec":
        return self._set(max_sentence_length=v)

    def set_seed(self, v: int) -> "Word2Vec":
        return self._set(seed=v)

    def set_num_partitions(self, v: int) -> "Word2Vec":
        """Data-parallel axis size (only 1 trains in the port so far)."""
        return self._set(num_partitions=v)

    def set_num_shards(self, v: int) -> "Word2Vec":
        """Model-parallel axis size (only 1 trains in the port so far)."""
        return self._set(num_shards=v)

    def set_dtype(self, v: str) -> "Word2Vec":
        return self._set(dtype=v)

    def set_compute_dtype(self, v: str) -> "Word2Vec":
        """Operand dtype of the composed step's contractions (the host
        batcher route). The fused step of the resident route computes in
        fp32 whatever this says, as in the JAX package."""
        return self._set(compute_dtype=v)

    def set_layout(self, v: str) -> "Word2Vec":
        return self._set(layout=v)

    def set_steps_per_call(self, v: int) -> "Word2Vec":
        """Packed steps between two readbacks to the host."""
        return self._set(steps_per_call=v)

    def set_shared_negatives(self, v: int) -> "Word2Vec":
        """Size S of the negative pool drawn once a step and shared by
        the whole batch, each pool word weighted ``n / S``; 0 draws ``n``
        negatives per pair."""
        return self._set(shared_negatives=v)

    def set_batch_packing(self, v: str) -> "Word2Vec":
        return self._set(batch_packing=v)

    def set_observability(self, obs) -> "Word2Vec":
        """Attach an ``obs.ObsConfig`` for later fits (event log,
        heartbeat, status file, divergence canary, step-time file)."""
        self.obs = obs
        return self

    # ------------------------------------------------------------------

    def _check_supported(self) -> None:
        """Raise ``ValueError`` for settings the port does not train yet,
        naming the later slice that brings them: everything of the SPMD
        mesh (one program across several cards)."""
        p = self.params
        later = []
        if p.num_partitions > 1 or p.num_shards > 1:
            later.append("num_partitions/num_shards > 1 (multi-device "
                         "training: the SPMD mesh slice)")
        if p.layout != "rows":
            later.append(f"layout={p.layout!r} (the dims layout, with the "
                         "SPMD mesh slice)")
        if p.exchange == "none" and dist.process_count() > 1:
            later.append("a gang of processes with exchange='none' (the "
                         "mesh gang, with the SPMD mesh slice; train a "
                         "gang with exchange='sparse' or 'dense')")
        if later:
            raise ValueError(
                "not ported yet, a later slice of the PyTorch port: "
                + "; ".join(later)
            )

    def fit(
        self,
        sentences: Iterable[Sequence[str]],
        checkpoint_dir: Optional[str] = None,
        checkpoint_every_epochs: int = 1,
        stop_after_epochs: Optional[int] = None,
    ) -> "Word2VecModel":
        """Train on tokenized sentences: vocabulary scan, encode and chunk,
        then the route :meth:`_fit_flat` chooses.

        A list is scanned twice (:func:`build_vocab`, then the encode); any
        other iterable is read once (``scan_and_encode_stream``), with the
        same vocabulary and encoding. The host batcher's batches of the
        flat corpus equal those the JAX package's list route draws from
        the sentence list. ``checkpoint_dir`` enables
        epoch-granular checkpoints every ``checkpoint_every_epochs``
        epochs, and a rerun with the same directory resumes after the last
        one; ``stop_after_epochs`` ends this invocation early (the learning
        rate follows global progress, so it is unaffected)."""
        p = self.params
        self._check_supported()
        if isinstance(sentences, list):
            vocab = build_vocab(sentences, min_count=p.min_count)
            encoded = chunk_sentences(
                encode_sentences(sentences, vocab), p.max_sentence_length
            )
            lens = np.array([s.size for s in encoded], dtype=np.int64)
            ids = (
                np.concatenate(encoded).astype(np.int32, copy=False)
                if encoded else np.zeros(0, np.int32)
            )
            offsets = np.zeros(len(lens) + 1, np.int64)
            np.cumsum(lens, out=offsets[1:])
        else:
            vocab, ids, offsets = scan_and_encode_stream(
                sentences, min_count=p.min_count,
                max_sentence_length=p.max_sentence_length,
            )
        return self._fit_flat(
            vocab, ids, offsets, checkpoint_dir, checkpoint_every_epochs,
            stop_after_epochs,
        )

    def fit_file(
        self,
        path: str,
        lowercase: bool = False,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every_epochs: int = 1,
        stop_after_epochs: Optional[int] = None,
    ) -> "Word2VecModel":
        """Train from a text file, one sentence per line: a vocabulary pass
        and a flat int32 encode pass over the file, never a list of
        Python sentences."""
        p = self.params
        self._check_supported()
        vocab, ids, offsets = scan_and_encode_file(
            path, min_count=p.min_count,
            max_sentence_length=p.max_sentence_length, lowercase=lowercase,
        )
        return self._fit_flat(
            vocab, ids, offsets, checkpoint_dir, checkpoint_every_epochs,
            stop_after_epochs,
        )

    def fit_stream(self, sentences: Iterable[Sequence[str]],
                   publish_dir: Optional[str] = None,
                   **stream_kw) -> "Word2VecModel":
        """Incremental training on an unbounded sentence stream (the ISGNS
        construction, arXiv:1704.03956): one look at each sentence, the
        noise and subsample distributions refreshed from live counts,
        vocabulary growth onto the engine's spare extra rows and, with
        ``publish_dir``, committed generations for a server to hot-swap
        (``streaming/publish.py``). Returns the fitted model when the
        stream ends or a ``max_words``/``max_seconds`` bound trips. The
        cadence and capacity knobs go to
        :class:`~glint_word2vec_torch.streaming.trainer.StreamTrainer`."""
        from glint_word2vec_torch.streaming.trainer import StreamTrainer

        return StreamTrainer(self, publish_dir=publish_dir, **stream_kw).run(sentences)

    def _fit_flat(self, vocab: Vocabulary, ids: np.ndarray,
                  offsets: np.ndarray, checkpoint_dir: Optional[str],
                  checkpoint_every_epochs: int,
                  stop_after_epochs: Optional[int]) -> "Word2VecModel":
        """Train from the flat encoded corpus: the device-resident path
        when the family allows it and the corpus fits on the device (the
        tables, a step's working set and the corpus within
        ``DEVICE_MEMORY_FRACTION`` of the free memory), else the host
        batcher. In a gang with an exchange, :meth:`_fit_replica_exchange`."""
        p = self.params
        if p.exchange != "none" and dist.process_count() > 1:
            return self._fit_replica_exchange(
                vocab, ids, offsets, checkpoint_dir,
                checkpoint_every_epochs, stop_after_epochs,
            )
        if self._device_corpus_eligible() and int(ids.size) < 2**31:
            need = self._device_bytes_needed(
                vocab.size, int(ids.size), offsets.size
            )
            free = _free_device_bytes(resolve_device(self.device))
            if need <= DEVICE_MEMORY_FRACTION * free:
                return self._fit_corpus_resident(
                    vocab, ids, offsets, checkpoint_dir,
                    checkpoint_every_epochs, stop_after_epochs,
                )
            logger.info(
                "a corpus of %d words needs about %d bytes of device memory "
                "with the tables and %d are free: host batcher",
                int(ids.size), need, free,
            )
        batcher = SkipGramBatcher.from_flat(
            ids, offsets, vocab, batch_size=p.batch_size, window=p.window,
            subsample_ratio=p.subsample_ratio, seed=p.seed,
        )
        return self._fit_with_batcher(
            vocab, batcher, checkpoint_dir, checkpoint_every_epochs,
            stop_after_epochs,
        )

    def _fit_replica_exchange(self, vocab: Vocabulary, ids: np.ndarray,
                              offsets: np.ndarray,
                              checkpoint_dir: Optional[str],
                              checkpoint_every_epochs: int,
                              stop_after_epochs: Optional[int]) -> "Word2VecModel":
        """The gang's fit (``models/word2vec.py:561`` of the JAX package):
        every process takes its shard of the corpus (round-robin, or by
        locality with ``exchange_shard="locality"``), trains it on its own
        card through the resident route, and reconciles the touched rows
        with its peers after every dispatch group (``parallel/
        exchange.py``); no collective crosses processes inside a step.
        The engines' seed gives every replica the same initial tables,
        and each round leaves them equal again. The shard must fit the
        card: there is no host-batcher gang."""
        if self.params.exchange_shard == "locality":
            ids, offsets = dist.shard_flat_locality(ids, offsets)
        else:
            ids, offsets = dist.shard_flat_for_process(ids, offsets)
        device = resolve_device(self.device)
        need = self._device_bytes_needed(vocab.size, int(ids.size), offsets.size)
        free = _free_device_bytes(device)
        if (not self._device_corpus_eligible() or int(ids.size) >= 2**31
                or need > DEVICE_MEMORY_FRACTION * free):
            raise ValueError(
                "replica-exchange training needs the device-resident corpus "
                f"path: this process's shard of {int(ids.size)} words needs "
                f"about {need} bytes of device memory with the tables and the "
                f"exchange's buffers, {free} are free on {device}, or the "
                "model family builds its centers on the host"
            )
        return self._fit_corpus_resident(
            vocab, ids, offsets, checkpoint_dir, checkpoint_every_epochs,
            stop_after_epochs,
        )

    def _device_corpus_eligible(self) -> bool:
        """Whether the family's centers are words, which the packed path
        assembles on the device (the fastText family says no: its centers
        are subword groups built on the host)."""
        return True

    def _device_bytes_needed(self, vocab_size: int, n_words: int,
                             n_offsets: int) -> int:
        """Device memory the resident fit takes at its peak: syn0 and
        syn1 in storage dtype with the noise and keep tables, a step's
        working set (the fp32 ``h`` and ``d_center`` rows, and the
        packing, draw and sort buffers with room to spare; with a shared
        pool of S, also the pool's fp32 rows and ``d_pool``, and the
        forward kernel's ``(P, S)`` fp32 ``c_pool``, partial losses and
        second K chunk of ``d_center`` and ``d_pool``; under grid
        packing, also the composed step's fp32 context and negative rows
        and their gradients), and the corpus at its peak bytes a word,
        with its offsets (three copies with subsampling: uploaded,
        compacted, and the pass's prefix sums; a fourth, the active
        epoch's compacted copy, while the next epoch's pass is
        prefetched). A checkpoint takes no device memory: its snapshot
        copies the tables straight to host memory. An exchange adds its
        base snapshot of both tables, the two fp32 diffs, the fp32
        accumulator of the apply and, on the int8 wire, the two fp32
        error-feedback carries."""
        p = self.params
        s = 2 if p.dtype == "bfloat16" else 4
        P = packed_pair_batch(p.batch_size, p.window)
        S = p.shared_negatives
        tables = vocab_size * (2 * p.vector_size * s + 16)
        step = 2 * P * p.vector_size * 4 + 1024 * P * (1 + p.num_negatives)
        if p.batch_packing == "grid":
            # The composed step's fp32 context and negative rows and their
            # gradients, for B rows of C lanes.
            lanes = p.batch_size * context_width(p.window)
            step += 3 * lanes * (1 + p.num_negatives) * p.vector_size * 4
            step += 1024 * lanes * (1 + p.num_negatives)
        if S:
            step += (2 * S * p.vector_size * 4 + P * S * 4
                     + P * (S // 64 + 1) * 4 + (P + S) * p.vector_size * 4
                     + 1024 * S)
        if p.subsample_ratio > 0:
            corpus = n_words * SUBSAMPLED_CORPUS_BYTES_PER_WORD + 24 * n_offsets
            if (p.num_iterations > 1
                    and os.environ.get("GLINT_NO_COMPACT_PREFETCH", "0") != "1"):
                # The active compacted view beside the prefetched pass.
                corpus += (n_words * PREFETCHED_CORPUS_BYTES_PER_WORD
                           + 8 * n_offsets)
        else:
            corpus = n_words * CORPUS_BYTES_PER_WORD + 8 * n_offsets
        if p.exchange != "none":
            per_row = 2 * p.vector_size * s + 3 * p.vector_size * 4
            if p.exchange_wire == "int8":
                per_row += 2 * p.vector_size * 4
            tables += vocab_size * per_row
        return tables + step + corpus

    def _make_engine(self, vocab: Vocabulary):
        from glint_word2vec_torch.parallel.engine import EmbeddingEngine

        p = self.params
        return EmbeddingEngine(
            vocab.size, p.vector_size, vocab.counts,
            num_negatives=p.num_negatives,
            unigram_power=p.unigram_power,
            unigram_table_size=p.unigram_table_size,
            seed=p.seed,
            dtype=p.dtype,
            shared_negatives=p.shared_negatives,
            compute_dtype=p.compute_dtype,
            device=self.device,
        )

    def _train_batches(self, engine, group: BatchGroup, base_key: int,
                       step0: int, alphas: np.ndarray):
        """Dispatch one :class:`BatchGroup` as ``len(group)`` composed
        steps; returns the ``(K,)`` losses as a device tensor (the family
        hook of ``models/word2vec.py:1636`` of the JAX package)."""
        return engine.train_steps(
            group.centers, group.contexts, group.mask, base_key, alphas,
            step0,
        )

    def _make_model(self, vocab: Vocabulary, engine) -> "Word2VecModel":
        return Word2VecModel(vocab, engine, self.params)

    def _fit_with_batcher(
        self,
        vocab: Vocabulary,
        batcher: SkipGramBatcher,
        checkpoint_dir: Optional[str],
        checkpoint_every_epochs: int,
        stop_after_epochs: Optional[int],
    ) -> "Word2VecModel":
        """The host-batcher training loop, one device (the JAX package's
        ``_fit_with_batcher``, ``models/word2vec.py:1291-1613``, trimmed).

        Per epoch a producer thread windows the corpus and stacks groups
        of ``steps_per_call`` grid batches (``group_batches`` under
        ``prefetch``, depth 2); each group is one call of
        :meth:`_train_batches`. Alpha follows the batcher's
        pre-subsampling ``words_done``: ``max(step_size * (1 - wd /
        total_words), step_size * 1e-4)``. Step ``s`` draws its negatives
        under ``fold_in(seed_key, s)``, and the step counter advances by
        ``steps_per_call`` a group, pad steps included, so a resumed run
        equals an uninterrupted one. A group's losses are read back after
        the next group is dispatched, and the metrics, the status and the
        canary see the group then. Checkpoints keep the JAX package's
        ``train_state.json`` keys (no ``position`` or ``gstep`` on this
        route) and are written by :func:`_checkpoint_tables`."""
        p = self.params
        if p.batch_packing == "dense":
            logger.info(
                "host-batcher route: training with grid-shaped batches "
                "(dense pair packing applies to the device-resident corpus "
                "path only)"
            )
        logger.info("vocab: %d words, %d train words", vocab.size,
                    vocab.train_words_count)
        engine = self._make_engine(vocab)
        twc = vocab.train_words_count
        obs_run = start_run(
            self.obs, pipeline="host", total_epochs=p.num_iterations,
            total_words=p.num_iterations * twc, engine=engine,
        )
        try:
            total_words = p.num_iterations * twc + 1
            base_key = rnd.seed_key(p.seed)
            spc = p.steps_per_call
            step = start_epoch = 0
            state_path = (
                os.path.join(checkpoint_dir, "train_state.json")
                if checkpoint_dir else None
            )
            state = resolve_train_state(checkpoint_dir) if state_path else None
            if state is not None:
                with obs_run.span("checkpoint_restore", ckpt=state["ckpt"]):
                    engine.load_tables(os.path.join(checkpoint_dir, state["ckpt"]))
                start_epoch = int(state["epochs_completed"])
                step = int(state["step"])
                batcher.words_done = int(state["words_done"])
                logger.info("resuming after epoch %d (step %d)", start_epoch, step)
            metrics = TrainingMetrics(base_words=batcher.words_done)
            obs_run.attach_metrics(metrics)

            for epoch in range(start_epoch, p.num_iterations):
                obs_run.update(epoch=epoch)
                it = prefetch(group_batches(batcher.epoch(epoch), spc), depth=2)
                pending = None
                g = 0
                while True:
                    # The wait for the producer is a stall of the loop.
                    with metrics.timing("host"), metrics.stall_timing(), \
                            obs_run.span("host_batch", epoch=epoch, group=g):
                        grp = next(it, None)
                    if grp is None:
                        break
                    wds = list(grp.words_done)
                    alphas = [
                        max(p.step_size * (1 - wd / total_words),
                            p.step_size * 1e-4)
                        for wd in wds
                    ]
                    with metrics.timing("step"), obs_run.span(
                            "device_steps", step0=step, n=grp.n_real):
                        losses = deferred_readback(self._train_batches(
                            engine, grp, base_key, step,
                            np.asarray(alphas, np.float32),
                        ))
                    new_pend = (losses, wds, alphas, grp.n_real, step)
                    step += spc  # pad steps consumed keys too
                    if pending is not None:
                        self._harvest(metrics, obs_run, *pending)
                    pending = new_pend
                    g += 1
                if pending is not None:
                    self._harvest(metrics, obs_run, *pending)
                stopping = (
                    stop_after_epochs is not None
                    and (epoch + 1 - start_epoch) >= stop_after_epochs
                )
                if state_path and (
                    stopping or (epoch + 1) % max(checkpoint_every_epochs, 1) == 0
                ):
                    ck_name = f"ckpt-{epoch + 1}"
                    _checkpoint_tables(
                        engine, obs_run, metrics,
                        os.path.join(checkpoint_dir, ck_name), ck_name,
                        functools.partial(
                            _flip_checkpoint_state, checkpoint_dir,
                            state_path, ck_name, epochs_completed=epoch + 1,
                            step=step, words_done=batcher.words_done,
                        ),
                    )
                if stopping:
                    logger.info("stopping early after epoch %d", epoch + 1)
                    break
            # Fit exit waits for the write in flight: a failed write
            # raises here, a hung one after GLINT_CKPT_WAIT_TIMEOUT.
            engine.wait_pending_saves(timeout=_ckpt_wait_timeout())
        except TrainingDiverged:
            engine.wait_pending_saves(reraise=False, timeout=_ckpt_wait_timeout())
            _save_diverged_snapshot(engine, checkpoint_dir, obs_run)
            raise
        except BaseException:
            engine.wait_pending_saves(reraise=False, timeout=_ckpt_wait_timeout())
            obs_run.close(failed=True)
            raise
        finally:
            obs_run.close()
        model = self._make_model(vocab, engine)
        model.training_metrics = {**metrics.summary(), "pipeline": "host"}
        steptime = obs_run.steptime_totals()
        if steptime:
            model.training_metrics["steptime"] = steptime
        logger.info("training done: %s", model.training_metrics)
        return model

    def _fit_corpus_resident(
        self,
        vocab: Vocabulary,
        ids: np.ndarray,
        offsets: np.ndarray,
        checkpoint_dir: Optional[str],
        checkpoint_every_epochs: int,
        stop_after_epochs: Optional[int],
    ) -> "Word2VecModel":
        """The device-resident training loop, one device (the JAX package's
        ``_fit_corpus_resident``, :628-1240, trimmed): dense pair packing
        (``engine.train_steps_corpus_packed``) or, with
        ``batch_packing="grid"``, grid batches assembled on the device
        (``engine.train_steps_corpus``).

        Key schedule, kept exactly so that a resumed run equals an
        uninterrupted one: step ``s`` draws its negatives (or its shared
        pool) under ``fold_in(seed_key, s)``, and the step counter advances by
        ``steps_per_call`` per group, tail no-ops included; the shrink
        draws follow the grid-equivalent counter ``gstep`` (the grid
        path's own step counter), which advances by ``groups *
        steps_per_call`` per epoch; the subsample draws are keyed by the
        epoch alone.

        Deferred readbacks: a packed group's dispatch chains on the
        previous group's end position as a device scalar, and the previous
        group is read back (``readback_harvest``) while this one is
        queued, so the host never waits for the card between groups; the
        metrics, status and canary run one group behind. The dispatch
        arguments are the synchronous loop's, except for at most one
        zero-pair phantom group an epoch, dispatched past the stream's end
        before the previous group's end was read: it records no step,
        advances no counter, and its keys are dropped at the epoch's end,
        so the tables are bitwise those of the synchronous loop
        (``GLINT_SYNC_READBACK=1``). The grid loop also reads each group
        back one group late. While an epoch's last group is still queued,
        the next epoch's compaction is dispatched ahead
        (``subsample_prefetch``) and adopted by the next
        ``compact_corpus``, bitwise the pass it replaces
        (``GLINT_NO_COMPACT_PREFETCH=1`` turns it off).

        Checkpoints at epoch ends carry ``position`` 0, ``gstep`` and the
        ``batch_packing`` that wrote them, and resume under either packing;
        :func:`_checkpoint_tables` writes them.
        ``GLINT_PACKED_STOP_AFTER_GROUPS=N`` (the JAX package's drill hook)
        stops the packed path after N dispatch groups, read back one at a
        time, with a mid-epoch checkpoint: the consumed ``position`` in
        the epoch's stream (compacted when subsampling), ``step``, the
        epoch's ``gstep`` base and ``words_done``. A resume starts the
        epoch's first group at ``position``, so every later dispatch is
        the uninterrupted run's; a mid-epoch state resumes only under the
        packing that wrote it."""
        p = self.params
        subsampling = p.subsample_ratio > 0
        packed = p.batch_packing == "dense"
        logger.info(
            "vocab: %d words, %d train words (device-resident corpus, %s "
            "packing%s)", vocab.size, vocab.train_words_count,
            p.batch_packing, ", on-device subsampling" if subsampling else "",
        )
        engine = self._make_engine(vocab)
        twc = vocab.train_words_count
        obs_run = start_run(
            self.obs, pipeline="device_corpus", total_epochs=p.num_iterations,
            total_words=p.num_iterations * twc, engine=engine,
        )
        try:
            with obs_run.span("upload_corpus", words=int(ids.shape[0])):
                engine.upload_corpus(ids, offsets)
            if subsampling:
                engine.set_keep_probs(
                    vocab.device_keep_probabilities(p.subsample_ratio))
            N = int(ids.shape[0])
            B, spc = p.batch_size, p.steps_per_call
            total_words = p.num_iterations * twc + 1
            base_key = rnd.seed_key(p.seed)
            pair_batch = packed_pair_batch(B, p.window)
            step = gstep = start_epoch = resume_position = 0
            packed_groups = packed_pairs = packed_slots = 0
            stop_after_groups = os.environ.get("GLINT_PACKED_STOP_AFTER_GROUPS")
            stop_after_groups = int(stop_after_groups) if stop_after_groups else None
            # The drill decides on each group's end before the next
            # dispatch, so it reads every group back at once.
            defer = (stop_after_groups is None
                     and os.environ.get("GLINT_SYNC_READBACK", "0") != "1")

            state_path = (
                os.path.join(checkpoint_dir, "train_state.json")
                if checkpoint_dir else None
            )
            resume_words = None
            state = resolve_train_state(checkpoint_dir) if state_path else None
            if state is not None:
                # A mid-epoch state resumes only under the packing that
                # wrote it: the other would misread its position and train
                # the epoch's consumed prefix again.
                state_packing = state.get("batch_packing", "grid")
                if (int(state.get("position", 0)) > 0
                        and state_packing != p.batch_packing):
                    raise ValueError(
                        f"mid-epoch checkpoint at {checkpoint_dir} was written "
                        f"with batch_packing={state_packing!r} (position "
                        f"{state['position']}); resume with the same packing "
                        "mode, or restart from an epoch-boundary checkpoint"
                    )
                with obs_run.span("checkpoint_restore", ckpt=state["ckpt"]):
                    engine.load_tables(os.path.join(checkpoint_dir, state["ckpt"]))
                start_epoch = int(state["epochs_completed"])
                step = int(state["step"])
                resume_position = int(state.get("position", 0))
                gstep = int(state.get("gstep", step))
                resume_words = int(state.get("words_done", start_epoch * twc))
                logger.info("resuming after epoch %d (step %d, position %d)",
                            start_epoch, step, resume_position)
            metrics = TrainingMetrics(
                base_words=resume_words if resume_words is not None
                else start_epoch * twc
            )
            obs_run.attach_metrics(metrics)
            # The replica exchange, built after any resume so that its base
            # snapshots the restored tables. A gang folds the rank into the
            # draw stream (table initialisation stays the seed's on every
            # rank: reconciliation depends on it) and splits its saves.
            exchanger = None
            if p.exchange != "none":
                from glint_word2vec_torch.parallel import exchange as exmod

                if dist.process_count() > 1:
                    if stop_after_groups is not None:
                        raise ValueError(
                            "GLINT_PACKED_STOP_AFTER_GROUPS is not supported "
                            "with multi-process replica exchange (the peers "
                            "would wait in the exchange collective forever)"
                        )
                    transport = exmod.ProcessTransport()
                    engine.set_save_split(transport.rank, transport.world)
                    base_key = rnd.fold_in(base_key, transport.rank)
                else:
                    transport = exmod.NullTransport()
                    logger.info(
                        "replica exchange on one process: the protocol runs "
                        "with its wire short-circuited")
                exchanger = exmod.ReplicaExchanger(
                    engine, mode=p.exchange,
                    capacity=p.exchange_capacity or None,
                    transport=transport,
                    pair_batch=pair_batch if packed else B,
                    steps_per_call=spc, wire=p.exchange_wire,
                    every=p.exchange_every, topology=p.exchange_topology,
                )
                # Rounds are reconciliation barriers: each group is read
                # back before its round, as in the JAX loop.
                defer = False

            def exchange_round(live: bool, done: bool, **span_args) -> bool:
                with metrics.timing("step"), obs_run.span("exchange_sync",
                                                          **span_args):
                    return exchanger.group_end(live=live, done=done)

            def drain_exchange(gang_live: bool) -> None:
                # Lockstep fillers: a drained rank answers the gang's
                # rounds with empty payloads until every rank is done.
                while gang_live:
                    gang_live = exchange_round(False, True, filler=True)
                exchanger.epoch_reset()

            def checkpoint(ck_name: str, **fields) -> None:
                _checkpoint_tables(
                    engine, obs_run, metrics,
                    os.path.join(checkpoint_dir, ck_name), ck_name,
                    functools.partial(_flip_checkpoint_state, checkpoint_dir,
                                      state_path, ck_name, **fields),
                )

            def prefetch_compact(next_epoch: int) -> None:
                # Enqueue the next epoch's compaction behind the queued
                # groups; skipped when this run will not train that epoch.
                if not subsampling or next_epoch >= p.num_iterations:
                    return
                if (stop_after_epochs is not None
                        and next_epoch - start_epoch >= stop_after_epochs):
                    return
                if os.environ.get("GLINT_NO_COMPACT_PREFETCH", "0") == "1":
                    return
                with obs_run.span("subsample_prefetch", epoch=next_epoch):
                    engine.prefetch_compact_corpus(rnd.fold_in(base_key, next_epoch))

            # Read by the closures below (bound to this scope).
            n_pos, offsets_c, epoch, epoch_wd = N, None, start_epoch, 0

            def words_done(end_pos: int) -> int:
                if subsampling:
                    return epoch * twc + corpus_words_done_compacted(
                        offsets, offsets_c, end_pos, n_pos)
                return epoch * twc + corpus_words_done(offsets, end_pos)

            def harvest_packed(group, start: int) -> int:
                # Read one dispatched packed group back and record its
                # live steps; returns its end position. A group that
                # started past the stream's end (the phantom) records
                # nothing and advances no counter.
                nonlocal step, epoch_wd, packed_pairs, packed_slots, packed_groups
                with metrics.timing("step"), obs_run.span(
                        "readback_harvest", packed=True) as hspan:
                    losses, pair_counts, pos_ends, alphas = engine.packed_readback(group)
                    # Live steps form a prefix: the first start past the
                    # stream's end makes every later step a no-op.
                    starts = np.concatenate(([start], pos_ends[:-1]))
                    n_real = int((starts < n_pos).sum())
                    hspan.update(n=n_real)
                    for i in range(n_real):
                        epoch_wd = words_done(int(min(pos_ends[i], n_pos)))
                        metrics.record_step(epoch_wd, loss=losses[i],
                                            alpha=alphas[i])
                    obs_run.observe_losses(step, losses, n_real)
                if n_real:
                    obs_run.update(step=step + n_real, words_done=epoch_wd,
                                   alpha=float(alphas[n_real - 1]))
                    step += spc  # tail no-ops consumed keys
                    packed_pairs += int(pair_counts[:n_real].sum())
                    packed_slots += n_real * pair_batch
                    packed_groups += 1
                return int(pos_ends[-1])

            for epoch in range(start_epoch, p.num_iterations):
                obs_run.update(epoch=epoch)
                if subsampling:
                    # n_kept is read back here; with the pass prefetched
                    # during the last epoch's tail the wait is short.
                    with metrics.timing("step"), metrics.stall_timing(), \
                            obs_run.span("subsample_compact", epoch=epoch):
                        n_pos = engine.compact_corpus(rnd.fold_in(base_key, epoch))
                    offsets_c = engine.compacted_offsets()
                else:
                    n_pos, offsets_c = N, None

                steps_per_epoch = max(1, -(-n_pos // B))
                groups = max(1, -(-steps_per_epoch // spc))
                if packed:
                    pos, resume_position = resume_position, 0
                    epoch_wd = epoch * twc
                    stopped = False
                    pending = None
                    next_start = pos  # a host int, then the device chain
                    dstep = step  # dispatch-time step0, one group ahead
                    gang_live = (exchanger is not None
                                 and exchanger.transport.world > 1)
                    while pos < n_pos:
                        with metrics.timing("step"), obs_run.span(
                                "device_steps", step0=dstep, n=spc, packed=True):
                            group = engine.train_steps_corpus_packed(
                                next_start, pair_batch, p.window, B, base_key,
                                spc, step0=dstep, grid_step0=gstep,
                                step_size=p.step_size, total_words=total_words,
                                words_base=epoch * twc, readback=False,
                            )
                        dstep += spc
                        next_start = group.out[2, spc - 1]
                        new_pend = [group, pos]
                        if pending is not None:
                            # Read group g-1 back while group g is queued;
                            # its end is group g's true start.
                            pos = harvest_packed(*pending)
                            new_pend[1] = pos
                        pending = new_pend
                        if not defer:
                            pos = harvest_packed(*pending)
                            pending = None
                            next_start = pos
                            if exchanger is not None:
                                gang_live = exchange_round(
                                    True, pos >= n_pos, packed=True)
                            if (stop_after_groups is not None
                                    and packed_groups >= stop_after_groups):
                                stopped = True
                                break
                    if not stopped:
                        # Behind the last group in the queue, ahead of the
                        # drain.
                        prefetch_compact(epoch + 1)
                    if pending is not None:
                        pos = harvest_packed(*pending)
                        pending = None
                    if exchanger is not None and not stopped:
                        drain_exchange(gang_live)
                    # dstep is dropped here with a phantom group's keys:
                    # the next epoch dispatches from ``step``.
                    if stopped:
                        if state_path:
                            checkpoint(f"ckpt-e{epoch}-p{pos}",
                                       epochs_completed=epoch, step=step,
                                       words_done=epoch_wd,
                                       extra={"position": pos, "gstep": gstep,
                                              "batch_packing": "dense"})
                        logger.info("stopping mid-epoch %d at position %d "
                                    "(GLINT_PACKED_STOP_AFTER_GROUPS)", epoch, pos)
                        break
                    gstep += groups * spc
                else:
                    pending = None
                    gang_live = (exchanger is not None
                                 and exchanger.transport.world > 1)
                    for g in range(groups):
                        start_pos = g * spc * B
                        with metrics.timing("host"), obs_run.span(
                                "host_batch", epoch=epoch, group=g):
                            wds = [words_done(min(start_pos + (j + 1) * B, n_pos))
                                   for j in range(spc)]
                            alphas = np.maximum(
                                p.step_size * (1 - np.asarray(wds) / total_words),
                                p.step_size * 1e-4,
                            ).astype(np.float32)
                        # An epoch subsampled to nothing dispatches its
                        # one no-op group but records no steps.
                        n_real = min(spc, max(0, -(-(n_pos - start_pos) // B)))
                        with metrics.timing("step"), obs_run.span(
                                "device_steps", step0=step, n=n_real):
                            losses = deferred_readback(engine.train_steps_corpus(
                                start_pos, B, p.window, base_key, alphas, step,
                            ))
                        new_pend = (losses, wds, alphas, n_real, step)
                        step += spc  # tail no-ops consumed keys
                        if pending is not None:
                            self._harvest(metrics, obs_run, *pending)
                        pending = new_pend
                        if exchanger is not None:
                            # Read the group back before its round, as
                            # the JAX loop records a group's steps first.
                            self._harvest(metrics, obs_run, *pending)
                            pending = None
                            gang_live = exchange_round(True, g == groups - 1)
                    if exchanger is not None:
                        drain_exchange(gang_live)
                    gstep = step
                    prefetch_compact(epoch + 1)
                    if pending is not None:
                        self._harvest(metrics, obs_run, *pending)
                stopping = (
                    stop_after_epochs is not None
                    and (epoch + 1 - start_epoch) >= stop_after_epochs
                )
                if state_path and (
                    stopping or (epoch + 1) % max(checkpoint_every_epochs, 1) == 0
                ):
                    if exchanger is not None:
                        # Drain the int8 error-feedback carry through one
                        # exact round (the same decision on every rank), so
                        # a resume from this checkpoint replays bitwise.
                        with obs_run.span("exchange_flush"):
                            exchanger.flush()
                    checkpoint(f"ckpt-{epoch + 1}", epochs_completed=epoch + 1,
                               step=step, words_done=(epoch + 1) * twc,
                               extra={
                                   "position": 0, "gstep": gstep,
                                   "batch_packing": p.batch_packing,
                                   "exchange_wire": p.exchange_wire,
                                   "exchange_every": p.exchange_every,
                               })
                if stopping:
                    logger.info("stopping early after epoch %d", epoch + 1)
                    break
            engine.wait_pending_saves(timeout=_ckpt_wait_timeout())
        except TrainingDiverged:
            engine.wait_pending_saves(reraise=False, timeout=_ckpt_wait_timeout())
            _save_diverged_snapshot(engine, checkpoint_dir, obs_run)
            raise
        except BaseException:
            engine.wait_pending_saves(reraise=False, timeout=_ckpt_wait_timeout())
            obs_run.close(failed=True)
            raise
        finally:
            obs_run.close()

        model = self._make_model(vocab, engine)
        model.training_metrics = {
            **metrics.summary(),
            "pipeline": "device_corpus",
            "batch_packing": p.batch_packing,
        }
        steptime = obs_run.steptime_totals()
        if steptime:
            model.training_metrics["steptime"] = steptime
        if exchanger is not None:
            model.training_metrics.update(
                exchange_mode=p.exchange, exchange_wire=p.exchange_wire,
                exchange_every=p.exchange_every,
                exchange_topology=p.exchange_topology,
                exchange=engine.exchange_stats(),
                rank=exchanger.transport.rank, world=exchanger.transport.world,
                host_memory=exchanger.host_memory(),
            )
        if packed_slots:
            # Live pairs over dispatched pair slots: the packed steps'
            # effective mask density.
            model.training_metrics.update(
                packed_pairs=packed_pairs,
                packed_mask_density=round(packed_pairs / packed_slots, 4),
            )
        logger.info("training done: %s", model.training_metrics)
        return model

    @staticmethod
    def _harvest(metrics: TrainingMetrics, obs_run, losses: DeferredReadback,
                 wds, alphas, n_real: int, step0: int) -> None:
        """Read one group of grid steps' ``(K,)`` losses back and record its
        ``n_real`` live steps, which start at step ``step0``; the canary
        and the status see them here (the grid loops read a group back
        after the next one is dispatched, waiting for that group alone)."""
        if not n_real:
            return
        with metrics.timing("step"), obs_run.span(
                "readback_harvest", step0=step0, n=n_real):
            host = losses.wait()
            for i in range(n_real):
                metrics.record_step(wds[i], loss=host[i], alpha=alphas[i])
            obs_run.observe_losses(step0, host, n_real)
        obs_run.update(step=step0 + n_real, words_done=int(wds[n_real - 1]),
                       alpha=float(alphas[n_real - 1]))


class Word2VecModel:
    """Fitted model: query and serving surface over the engine's tables."""

    def __init__(self, vocab: Vocabulary, engine, params: Word2VecParams):
        self.vocab = vocab
        self.engine = engine
        self.params = params
        #: What the fit measured (``Word2Vec`` fills it; None when loaded).
        self.training_metrics: Optional[dict] = None

    @property
    def vector_size(self) -> int:
        return self.engine.cols

    # ------------------------------------------------------------------
    # transform
    # ------------------------------------------------------------------

    def transform(self, word: str) -> np.ndarray:
        """Single word -> vector. Raises KeyError on OOV."""
        idx = self.vocab.word_index.get(word)
        if idx is None:
            raise KeyError(f"word {word!r} not in vocabulary")
        return self.engine.pull(np.array([idx], np.int32)).cpu().numpy()[0]

    def transform_words(self, words: Sequence[str]) -> np.ndarray:
        """Batch of words -> ``(N, d)``. Raises on OOV; pulls
        ``MAX_QUERY_ROWS`` at a time."""
        idx = self.vocab.encode_strict(words)
        out = np.empty((len(idx), self.vector_size), np.float32)
        for s in range(0, len(idx), MAX_QUERY_ROWS):
            out[s : s + MAX_QUERY_ROWS] = (
                self.engine.pull(idx[s : s + MAX_QUERY_ROWS]).cpu().numpy()
            )
        return out

    def transform_sentences(
        self, sentences: Iterable[Sequence[str]]
    ) -> np.ndarray:
        """Sentences -> ``(S, d)`` mean vectors, computed on the device.

        OOV words are dropped; empty or all-OOV sentences give zero
        vectors. Sentences go ``MAX_QUERY_ROWS`` at a time, each block
        padded to power-of-two rows and length with mask-0 entries, which
        add exact zeros to every masked mean."""
        sents = [self.vocab.encode(s) for s in sentences]
        out = np.zeros((len(sents), self.vector_size), np.float32)
        for s in range(0, len(sents), MAX_QUERY_ROWS):
            idx, m, n = pack_query_block(sents[s : s + MAX_QUERY_ROWS])
            if idx is not None:
                out[s : s + n] = self.transform_packed(idx, m)[:n]
        return out

    def transform_packed(self, idx: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """One packed power-of-two ``(rows, len)`` block with its mask ->
        ``(rows, d)`` host means: the ``pull_average`` of
        :meth:`transform_sentences` with the packing done by the caller
        (``corpus.batching.pack_query_block``), the bulk transform's
        dispatch. Subword families override it."""
        return self.engine.pull_average(idx, mask).cpu().numpy()

    def bulk_warmup(self, rows: int, max_len: int) -> int:
        """Dispatch every shape the bulk transform will: one
        ``pull_average`` per power-of-two length up to
        ``next_pow2(max_len)`` at the fixed ``rows`` bucket, so the stream
        itself meets no new shape. Returns the shapes dispatched for the
        first time (0 = already warm)."""
        before = self.engine.query_compiles
        lens, L = [], 1
        while L <= next_pow2(max_len):
            lens.append(L)
            L *= 2
        self.engine.warmup(q_buckets=(), k_buckets=(),
                           sentence_lens=tuple(lens), sentence_rows=(rows,))
        return self.engine.query_compiles - before

    # ------------------------------------------------------------------
    # Similarity and analogy
    # ------------------------------------------------------------------

    def find_synonyms(self, word: str, num: int) -> List[Tuple[str, float]]:
        """Top-``num`` most similar words, the query word excluded (fetch
        num+1, drop the word itself)."""
        vec = self.transform(word)
        results = self.find_synonyms_vector(vec, num + 1)
        return [(w, s) for w, s in results if w != word][:num]

    def _query_engine(self):
        """The engine whose syn0 answers similarity queries: the training
        table here; the fastText family composes its word vectors into a
        second engine."""
        return self.engine

    def _decode_hits(self, sims, idx) -> List[Tuple[str, float]]:
        # Masked rows score -inf and are filler, never results: the exact
        # path's ride ids past the vocabulary, but the ANN path's empty
        # member slots carry id 0, a real word, so the score is the filter.
        return [
            (self.vocab.words[int(i)], float(s))
            for s, i in zip(sims, idx)
            if int(i) < self.vocab.size and np.isfinite(s)
        ]

    def find_synonyms_vector(
        self, vector: np.ndarray, num: int
    ) -> List[Tuple[str, float]]:
        """Top-``num`` words by cosine similarity to an arbitrary vector."""
        if num <= 0:
            raise ValueError("num must be > 0")
        num = min(num, self.vocab.size)
        sims, idx = self._query_engine().top_k_cosine(
            np.asarray(vector, np.float32), num
        )
        return self._decode_hits(sims, idx)

    def find_synonyms_batch(
        self, vectors: np.ndarray, num: int, *, approximate: bool = False
    ) -> List[List[Tuple[str, float]]]:
        """Top-``num`` neighbours for a whole ``(Q, d)`` query batch in one
        matrix product and one ``topk`` (the exact path), or with
        ``approximate=True`` through the engine's adopted ANN index. A
        ``num`` past the index's probe capacity (nprobe x member slots)
        takes the exact path."""
        if num <= 0:
            raise ValueError("num must be > 0")
        num = min(num, self.vocab.size)
        eng = self._query_engine()
        if approximate:
            idx_obj = eng.ann_index
            conf = eng._ann_conf or {}
            cap = conf.get("nprobe", 0) * idx_obj.slots if idx_obj is not None else 0
            approximate = num <= cap
        search = eng.ann_top_k_batch if approximate else eng.top_k_cosine_batch
        sims, idx = search(np.asarray(vectors, np.float32), num)
        return [self._decode_hits(s, i) for s, i in zip(sims, idx)]

    def analogy(
        self, positive: Sequence[str], negative: Sequence[str], num: int
    ) -> List[Tuple[str, float]]:
        """king - man + woman style queries: sum(positive) - sum(negative),
        the query words excluded from the results."""
        vec = np.zeros(self.vector_size, np.float32)
        for w in positive:
            vec += self.transform(w)
        for w in negative:
            vec -= self.transform(w)
        exclude = set(positive) | set(negative)
        res = self.find_synonyms_vector(vec, num + len(exclude))
        return [(w, s) for w, s in res if w not in exclude][:num]

    # ------------------------------------------------------------------
    # Export
    # ------------------------------------------------------------------

    def get_vectors(self) -> Iterator[Tuple[str, np.ndarray]]:
        """Stream (word, vector) pairs, pulled ``MAX_QUERY_ROWS`` at a
        time."""
        for s in range(0, self.vocab.size, MAX_QUERY_ROWS):
            idx = np.arange(s, min(s + MAX_QUERY_ROWS, self.vocab.size), dtype=np.int32)
            rows = self.engine.pull(idx).cpu().numpy()
            for i, r in zip(idx, rows):
                yield self.vocab.words[int(i)], r

    def to_local(self) -> "LocalWord2VecModel":
        """Materialise a host-side numpy model."""
        vecs = np.empty((self.vocab.size, self.vector_size), np.float32)
        for s in range(0, self.vocab.size, MAX_QUERY_ROWS):
            idx = np.arange(s, min(s + MAX_QUERY_ROWS, self.vocab.size), dtype=np.int32)
            vecs[s : s + len(idx)] = self.engine.pull(idx).cpu().numpy()
        return LocalWord2VecModel(list(self.vocab.words), vecs)

    # ------------------------------------------------------------------
    # Persistence and lifecycle
    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        """Matrix (``matrix/``), ``words.txt`` and ``params.json``: the JAX
        package's model directory. Every file lands through
        write-temp-then-rename."""
        for w in self.vocab.words:
            if "\n" in w or "\r" in w:
                raise ValueError(
                    f"vocab word {w!r} contains a newline and cannot be "
                    "saved to the line-oriented words file"
                )
        os.makedirs(path, exist_ok=True)
        self.engine.save(os.path.join(path, "matrix"))
        atomic_write_text(
            os.path.join(path, "words.txt"),
            "".join(w + "\n" for w in self.vocab.words),
        )
        atomic_write_json(
            os.path.join(path, "params.json"),
            json.loads(self.params.to_json()),
        )

    #: Params class :meth:`load` reads; model families override it.
    _PARAMS_CLS = Word2VecParams

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "Word2VecModel":
        """Rebuild from a model directory saved by either package; the
        family's own tail is :meth:`_from_loaded`."""
        from glint_word2vec_torch.parallel.engine import EmbeddingEngine

        with open(os.path.join(path, "params.json")) as f:
            try:
                params = cls._PARAMS_CLS.from_json(f.read())
            except TypeError as e:
                raise ValueError(
                    f"params.json at {path} does not describe a "
                    f"{cls._PARAMS_CLS.__name__} model: {e}"
                )
        engine = EmbeddingEngine.load(os.path.join(path, "matrix"), device)
        vocab = saved_model_vocabulary(
            path, engine._counts,
            engine.vocab_size + engine.extra_rows_assigned,
        )
        return cls._from_loaded(vocab, engine, params)

    @classmethod
    def _from_loaded(cls, vocab, engine, params) -> "Word2VecModel":
        return cls(vocab, engine, params)

    def stop(self) -> None:
        """Release the tables' device memory."""
        self.engine.destroy()


class LocalWord2VecModel:
    """Host-only numpy model: the ``to_local`` result. Same query surface,
    no device."""

    def __init__(self, words: List[str], vectors: np.ndarray):
        if vectors.shape[0] != len(words):
            raise ValueError("words/vectors length mismatch")
        self.words = words
        self.vectors = vectors.astype(np.float32)
        self.word_index = {w: i for i, w in enumerate(words)}
        self._norms = np.linalg.norm(self.vectors, axis=1)

    @property
    def vector_size(self) -> int:
        return self.vectors.shape[1]

    def transform(self, word: str) -> np.ndarray:
        idx = self.word_index.get(word)
        if idx is None:
            raise KeyError(f"word {word!r} not in vocabulary")
        return self.vectors[idx]

    def find_synonyms_vector(self, vector, num: int) -> List[Tuple[str, float]]:
        v = np.asarray(vector, np.float32)
        nv = np.linalg.norm(v)
        if nv > 0:
            v = v / nv
        safe = np.where(self._norms > 0, self._norms, 1.0)
        cos = np.where(self._norms > 0, (self.vectors @ v) / safe, 0.0)
        top = np.argsort(-cos)[:num]
        return [(self.words[i], float(cos[i])) for i in top]

    def find_synonyms(self, word: str, num: int) -> List[Tuple[str, float]]:
        res = self.find_synonyms_vector(self.transform(word), num + 1)
        return [(w, s) for w, s in res if w != word][:num]

    def get_vectors(self) -> Dict[str, np.ndarray]:
        return {w: self.vectors[i] for i, w in enumerate(self.words)}

    def save(self, path: str) -> None:
        """``vectors.npy`` and ``words.txt``, each through
        write-temp-then-rename."""
        os.makedirs(path, exist_ok=True)
        atomic_write_npy(os.path.join(path, "vectors.npy"), self.vectors)
        atomic_write_text(
            os.path.join(path, "words.txt"),
            "".join(w + "\n" for w in self.words),
        )

    @classmethod
    def load(cls, path: str) -> "LocalWord2VecModel":
        vectors = np.load(os.path.join(path, "vectors.npy"))
        with open(os.path.join(path, "words.txt"), encoding="utf-8") as f:
            words = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        return cls(words, vectors)
