"""The ``fit_stream`` loop (counterpart of
``glint_word2vec_tpu/streaming/trainer.py``): incremental ISGNS over an
unbounded sentence stream (arXiv:1704.03956), handing its generations to
servers through the publish protocol.

The stream is consumed in bounded **mini-epochs** through one
fixed-capacity buffer. Each round fills the buffer on the host (counting
through the online vocabulary, subsampling with the current keep
probabilities), uploads it with the real fill as the ``n_valid`` prefix
bound, and drains it through the engine's packed pair path, whose kernels
(``pair_forward``, ``scatter_add_rank1_hbm``, ``scatter_add_rows_f32``)
take every row of the table, promoted rows included. Every round has the
same buffer, offsets and pair-batch shapes; a refresh installs new alias
tables of the same shape, and a promotion widens the serving top-k mask
by a value.

Differences from batch ``fit``, all inherent to one look at a stream:

- subsampling runs on the host while filling (the device compaction pass
  needs the whole buffer; ``compact_corpus`` refuses an ``n_valid``-bounded
  view), drawn from ``np.random.default_rng(seed)`` as in the JAX package,
  so both packages fill the same buffers;
- the learning rate is constant at ``step_size`` unless ``anneal_words``
  sets a linear decay horizon: a stream has no ``total_words``;
- promoted words join mid-run on spare extra rows with a fresh init and
  are never negatives (the noise table spans the bootstrap vocabulary).
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from glint_word2vec_torch.corpus.stream_vocab import (
    StreamVocab,
    bootstrap_stream_vocab,
)
from glint_word2vec_torch.obs import start_run
from glint_word2vec_torch.streaming.publish import SnapshotPublisher
from glint_word2vec_torch.utils import faults
from glint_word2vec_torch.utils.metrics import TrainingMetrics

logger = logging.getLogger(__name__)

#: Learning-rate denominator standing in for "unbounded": alpha stays
#: within one part in about 1e12 of step_size for any real stream.
_NO_ANNEAL_WORDS = 1 << 50


class StreamTrainer:
    """One long-lived streaming fit over a ``Word2Vec`` estimator's
    parameters and device.

    Cadence knobs (all optional):

    - ``bootstrap_words``: stream prefix scanned batch-style (exact
      counts, frequency-ranked base vocabulary) before the engine is
      built; the bootstrap window is then trained first.
    - ``buffer_words`` / ``buffer_sentences``: the mini-epoch buffer's
      capacity, the unit of training and accounting.
    - ``extra_rows``: spare table rows reserved for vocabulary growth
      (the promotion budget of the whole run).
    - ``refresh_words``: kept-word cadence of the noise and subsample
      refreshes from live counts.
    - ``publish_seconds`` / ``publish_words``: publish cadence (whichever
      fires first); needs ``publish_dir``.
    - ``max_words`` / ``max_seconds``: optional stop bounds; None runs
      until the stream ends.
    """

    def __init__(
        self,
        w2v,
        *,
        publish_dir: Optional[str] = None,
        bootstrap_words: int = 10_000,
        buffer_words: int = 65_536,
        buffer_sentences: Optional[int] = None,
        extra_rows: int = 1024,
        refresh_words: Optional[int] = None,
        publish_seconds: float = 30.0,
        publish_words: Optional[int] = None,
        publish_keep: int = 3,
        promote_min_count: Optional[int] = None,
        sketch_capacity: int = 65_536,
        anneal_words: Optional[int] = None,
        max_words: Optional[int] = None,
        max_seconds: Optional[float] = None,
    ):
        if buffer_words < 256:
            raise ValueError("buffer_words must be >= 256")
        if extra_rows < 0:
            raise ValueError("extra_rows must be >= 0")
        self.w2v = w2v
        self.publish_dir = publish_dir
        self.bootstrap_words = bootstrap_words
        self.buffer_words = buffer_words
        self.buffer_sentences = buffer_sentences or max(16, buffer_words // 8)
        self.extra_rows = extra_rows
        self.refresh_words = refresh_words or buffer_words
        self.publish_seconds = publish_seconds
        self.publish_words = publish_words
        self.publish_keep = publish_keep
        self.promote_min_count = promote_min_count
        self.sketch_capacity = sketch_capacity
        self.anneal_words = anneal_words
        self.max_words = max_words
        self.max_seconds = max_seconds
        # Run state, read by tests and the final metrics.
        self.engine = None
        self.vocab: Optional[StreamVocab] = None
        self.publisher: Optional[SnapshotPublisher] = None
        self.rounds = 0
        self.steps = 0
        self.words_trained = 0
        self.sentences_streamed = 0
        self.stream_lag_seconds = 0.0
        self.noise_drift_l1 = 0.0
        #: Host seconds spent filling buffers, summed over the rounds.
        self.fill_seconds = 0.0

    # -- stream plumbing -----------------------------------------------

    def _chunked(self, sentences: Iterable[Sequence[str]]) -> Iterator[List[str]]:
        """Sentences cut into ``max_sentence_length`` pieces, the batch
        paths' chunking. Empty sentences pass through: an idle source
        yields ``[]`` heartbeats so the loop can check its stop bounds and
        publish cadence instead of blocking."""
        msl = self.w2v.params.max_sentence_length
        for s in sentences:
            s = list(s)
            if len(s) <= msl:
                yield s
                continue
            for i in range(0, len(s), msl):
                piece = s[i : i + msl]
                if piece:
                    yield piece

    def _bootstrap(self, it: Iterator[List[str]], t_start: float) -> List[List[str]]:
        """The bootstrap window: sentences covering ``bootstrap_words`` raw
        words, or the whole stream, or what ``max_seconds`` allows."""
        window: List[List[str]] = []
        seen = 0
        for s in it:
            if not s:
                # A quiet source must not hold a bounded run here.
                if self.max_seconds and time.time() - t_start >= self.max_seconds:
                    break
                continue
            window.append(s)
            seen += len(s)
            if seen >= self.bootstrap_words:
                break
        if not window:
            raise ValueError("empty stream: nothing to bootstrap from")
        return window

    def _make_engine(self, mesh=None):
        from glint_word2vec_torch.parallel.engine import EmbeddingEngine

        p = self.w2v.params
        return EmbeddingEngine(
            self.vocab.base_size,
            p.vector_size,
            self.vocab.noise_counts(),
            num_negatives=p.num_negatives,
            unigram_power=p.unigram_power,
            unigram_table_size=p.unigram_table_size,
            seed=p.seed,
            dtype=p.dtype,
            extra_rows=self.extra_rows,
            shared_negatives=p.shared_negatives,
            compute_dtype=p.compute_dtype,
            device=None if mesh is not None else self.w2v.device,
            mesh=mesh,
            layout=p.layout,
        )

    # -- the loop -------------------------------------------------------

    def run(self, sentences: Iterable[Sequence[str]]):
        """Consume the stream; returns the fitted ``Word2VecModel`` (grown
        vocabulary included) when the stream ends or a stop bound trips."""
        from glint_word2vec_torch.corpus.batching import packed_pair_batch
        from glint_word2vec_torch.models.word2vec import (
            Word2VecModel,
            _ckpt_wait_timeout,
        )
        from glint_word2vec_torch.ops import random as rnd

        p = self.w2v.params
        if self.buffer_words < p.max_sentence_length:
            # A piece that can never fit the buffer would spin the carry.
            raise ValueError(
                f"buffer_words ({self.buffer_words}) must be >= "
                f"max_sentence_length ({p.max_sentence_length}) so "
                "every sentence piece fits the mini-epoch buffer"
            )
        t_start = time.time()
        it = self._chunked(sentences)
        window = self._bootstrap(it, t_start)
        self.vocab = bootstrap_stream_vocab(
            window, min_count=p.min_count,
            sketch_capacity=self.sketch_capacity, max_size=None,
        )
        sv = self.vocab
        # The mesh's data axis splits every pair batch
        # (``streaming/trainer.py:228-261`` of the JAX package).
        mesh = self.w2v._make_mesh()
        self.w2v._check_batch_split(mesh)
        engine = self.engine = self._make_engine(mesh)
        logger.info("stream bootstrap: %d words vocab, %d spare rows, "
                    "buffer %d words", sv.base_size, self.extra_rows,
                    self.buffer_words)
        if self.publish_dir:
            self.publisher = SnapshotPublisher(
                self.publish_dir, engine, p, keep=self.publish_keep,
            )
        obs_run = start_run(
            self.w2v.obs, pipeline="stream", total_epochs=0,
            total_words=0, engine=engine,
        )
        metrics = TrainingMetrics()
        obs_run.attach_metrics(metrics)
        min_count = (self.promote_min_count
                     if self.promote_min_count is not None else p.min_count)
        total_words = (self.anneal_words + 1 if self.anneal_words
                       else _NO_ANNEAL_WORDS)
        B, W, spc = p.batch_size, p.window, p.steps_per_call
        pair_batch = packed_pair_batch(B, W, engine.num_data)
        base_key = rnd.seed_key(p.seed)
        keep = sv.keep_probabilities(p.subsample_ratio)
        rng = np.random.default_rng(p.seed)
        prev_noise = sv.noise_weights(p.unigram_power)
        words_at_refresh = 0
        words_at_publish = 0
        last_publish_t = time.time()

        def publish_now(fill_gauge: int) -> None:
            # The snapshot copy stalls the loop; the write does not.
            nonlocal last_publish_t, words_at_publish
            with obs_run.span("publish", round=self.rounds), \
                    metrics.stall_timing():
                self.publisher.publish(sv.snapshot_vocabulary())
            last_publish_t = time.time()
            words_at_publish = self.words_trained
            self._update_stream_gauges(obs_run, fill_gauge)

        # The bootstrap window is the first training data. Its occurrences
        # are already counted (exactly, by the bootstrap scan), so it is
        # replayed encode-only.
        stream = itertools.chain(window, it)
        bootstrap_left = len(window)
        carry: Optional[List[int]] = None
        exhausted = False
        try:
            while not exhausted:
                if self.max_words and self.words_trained >= self.max_words:
                    break
                if self.max_seconds and time.time() - t_start >= self.max_seconds:
                    break
                # -- fill one mini-epoch buffer on the host ------------
                t_fill0 = time.time()
                ids_buf = np.zeros(self.buffer_words, np.int32)
                offsets = [0]
                fill = 0
                with obs_run.span("stream_fill", round=self.rounds):
                    while (fill < self.buffer_words
                           and len(offsets) <= self.buffer_sentences):
                        # Re-check the bounds and the publish cadence
                        # between pulls (an idle source yields []), and
                        # train the partial buffer when a deadline fires.
                        if (self.max_seconds
                                and time.time() - t_start >= self.max_seconds):
                            break
                        if (self.publisher is not None
                                and time.time() - last_publish_t
                                >= self.publish_seconds
                                and (fill or self.words_trained > words_at_publish)):
                            # fill > 0: train the partial buffer so the due
                            # publish carries it; fill == 0 with unpublished
                            # words: the idle branch below publishes.
                            break
                        if carry is not None:
                            # Stashed after last round's subsample draw:
                            # drawing again would thin it to p^2.
                            enc, carry = carry, None
                            from_carry = True
                        else:
                            from_carry = False
                            sent = next(stream, None)
                            if sent is None:
                                exhausted = True
                                break
                            if not sent:
                                continue  # idle heartbeat
                            # Count and encode through the online vocabulary
                            # (OOV feeds the sketch).
                            if bootstrap_left > 0:
                                bootstrap_left -= 1
                                enc = sv.encode(sent)
                            else:
                                enc = sv.observe(sent)
                            self.sentences_streamed += 1
                        if not enc:
                            continue
                        if p.subsample_ratio > 0 and not from_carry:
                            arr = np.asarray(enc, np.int32)
                            enc = arr[rng.random(arr.shape[0]) < keep[arr]].tolist()
                            if not enc:
                                continue
                        if fill + len(enc) > self.buffer_words:
                            carry = enc
                            break
                        ids_buf[fill : fill + len(enc)] = enc
                        fill += len(enc)
                        offsets.append(fill)
                self.fill_seconds += time.time() - t_fill0
                if fill == 0:
                    if exhausted:
                        break
                    # An idle stream must not starve the publish cadence.
                    if (self.publisher is not None
                            and self.words_trained > words_at_publish
                            and time.time() - last_publish_t
                            >= self.publish_seconds):
                        publish_now(0)
                    continue
                # -- grow: promote candidates onto spare rows ----------
                promoted_round = 0
                while engine.extra_rows_free > 0:
                    cands = sv.promotable(min_count, limit=engine.extra_rows_free)
                    if not cands:
                        break
                    # One batched mutation a burst.
                    rows = engine.assign_extra_rows([word for word, _ in cands])
                    for row, (word, est) in zip(rows, cands):
                        idx = sv.promote(word, est)
                        if row != idx:
                            raise AssertionError(
                                f"row/vocab drift: engine row {row} != "
                                f"vocab index {idx} for {word!r}"
                            )
                    promoted_round += len(cands)
                # -- adapt: refresh the noise and subsample tables ------
                if (promoted_round
                        or sv.train_words_count - words_at_refresh
                        >= self.refresh_words):
                    words_at_refresh = sv.train_words_count
                    engine.set_noise_counts(sv.noise_counts())
                    keep = sv.keep_probabilities(p.subsample_ratio)
                    cur = sv.noise_weights(p.unigram_power)
                    self.noise_drift_l1 = float(np.abs(cur - prev_noise).sum())
                    prev_noise = cur
                # -- train: one bounded mini-epoch ---------------------
                # +2: up to buffer_sentences real boundaries after the
                # leading 0, plus the final pad boundary, which must not
                # overwrite the last real one of a full sentence buffer.
                offsets_arr = np.full(self.buffer_sentences + 2, fill, np.int64)
                offsets_arr[: len(offsets)] = offsets
                # The padding is a sentence of its own (its positions sit
                # at or past n_valid, and no real window reaches into it).
                offsets_arr[-1] = self.buffer_words
                with obs_run.span("upload_corpus", words=fill):
                    engine.upload_corpus(ids_buf, offsets_arr, n_valid=fill)
                pos = 0
                while pos < fill:
                    faults.fire("worker.step")
                    with metrics.timing("step"), obs_run.span(
                            "device_steps", step0=self.steps, n=spc, packed=True):
                        group = engine.train_steps_corpus_packed(
                            pos, pair_batch, W, B, base_key, spc,
                            step0=self.steps, grid_step0=self.steps,
                            step_size=p.step_size, total_words=total_words,
                            words_base=self.words_trained, readback=False,
                        )
                    pos = self._harvest(metrics, obs_run, group, pos, fill)
                self.words_trained += fill
                self.rounds += 1
                self.stream_lag_seconds = time.time() - t_fill0
                obs_run.update(epoch=self.rounds, step=self.steps,
                               words_done=self.words_trained)
                self._update_stream_gauges(obs_run, fill)
                # -- publish on cadence --------------------------------
                if self.publisher is not None:
                    due_t = time.time() - last_publish_t >= self.publish_seconds
                    due_w = (self.publish_words is not None
                             and self.words_trained - words_at_publish
                             >= self.publish_words)
                    if due_t or due_w:
                        publish_now(fill)
            # Final publish: the stream's last words reach the servers even
            # when the cadence did not fire.
            if self.publisher is not None and self.words_trained:
                with metrics.stall_timing():
                    self.publisher.publish(sv.snapshot_vocabulary())
            engine.wait_pending_saves(timeout=_ckpt_wait_timeout())
            self._update_stream_gauges(obs_run, 0)
        except BaseException:
            engine.wait_pending_saves(reraise=False, timeout=_ckpt_wait_timeout())
            obs_run.close(failed=True)
            raise
        finally:
            obs_run.close()
        logger.info("stream done: %d rounds, %d words trained, %d promoted, "
                    "%d generations", self.rounds, self.words_trained,
                    sv.promoted, self.publisher.published if self.publisher else 0)
        model = Word2VecModel(sv.snapshot_vocabulary(), engine, p)
        model.training_metrics = {
            **metrics.summary(),
            "pipeline": "stream",
            # The packed path's kernels on the card, their plain versions
            # on the CPU.
            "kernel_route": "cuda" if engine.device.type == "cuda" else "plain",
            "rounds": self.rounds,
            "words_trained": self.words_trained,
            "vocab_size": sv.size,
            "promoted_words": sv.promoted,
            "oov_words_seen": sv.oov_words_seen,
            "generations_published": (
                self.publisher.published if self.publisher else 0),
            "fill_seconds": round(self.fill_seconds, 3),
            # Each committed publish's snapshot (the loop's stall) and
            # write (the writer thread's) seconds.
            "publishes": list(self.publisher.history) if self.publisher else [],
        }
        return model

    def _harvest(self, metrics, obs_run, group, start: int, n_valid: int) -> int:
        """Wait for one dispatched group, record its steps and return the
        consumed position. Synchronous, as the JAX loop is: the next group
        starts where this one ended, and the buffer is already uploaded,
        so the host has nothing to do meanwhile."""
        with metrics.timing("step"), obs_run.span(
                "readback_harvest", packed=True) as span:
            losses, _, pos_ends, alphas = self.engine.packed_readback(group)
            starts = np.concatenate(([start], pos_ends[:-1]))
            n_real = int((starts < n_valid).sum())
            span.update(n=n_real)
            for i in range(n_real):
                self.steps += 1
                metrics.record_step(
                    self.words_trained + int(min(pos_ends[i], n_valid)),
                    loss=losses[i], alpha=float(alphas[i]),
                )
            obs_run.observe_losses(self.steps - n_real, losses, n_real)
            self.steps += losses.shape[0] - n_real  # tail keys consumed
        return int(pos_ends[-1])

    def _update_stream_gauges(self, obs_run, fill: int) -> None:
        sv, engine = self.vocab, self.engine
        pub = self.publisher
        obs_run.update_streaming(
            words_streamed=sv.train_words_count,
            sentences_streamed=self.sentences_streamed,
            oov_words=sv.oov_words_seen,
            vocab_size=sv.size,
            promoted_words=sv.promoted,
            extra_rows_free=engine.extra_rows_free,
            sketch_fill=len(sv.sketch) / max(sv.sketch.capacity, 1),
            noise_drift_l1=self.noise_drift_l1,
            stream_lag_seconds=self.stream_lag_seconds,
            generations_published=pub.published if pub else 0,
            last_publish_unix=pub.last_publish_time if pub else None,
            buffer_fill=fill / max(self.buffer_words, 1),
        )
