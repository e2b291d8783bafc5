"""Frozen copy of the resident fit's dense-packing schedule
(``Word2Vec._fit_corpus_resident`` of ``glint_word2vec_torch``, the packed
branch), cut so that a window can stop it.

Each epoch compacts the subsampled corpus on the device (adopting the pass
prefetched during the previous epoch's tail), then dispatches groups of
``steps_per_call`` packed steps, each chained on the previous group's end
position as a device scalar, and reads group ``g - 1`` back while group
``g`` is queued; past the stream's end one zero-pair group is dispatched
before the end is read, as in the fit. Behind the epoch's last group the
next epoch's compaction is enqueued. The key schedule is the fit's: step
``s`` draws under ``fold_in(seed_key, s)``, the step counter advances by
``steps_per_call`` a group, the shrink draws follow ``grid_step0``, which
advances by the epoch's grid groups, and the subsample draws are keyed by
the epoch. When the planned epochs run out, a fresh fit starts on the
trained tables: the anneal, the counters and the epoch keys start over.

The first group after the first epoch boundary is kept for the check: a
copy of both tables is enqueued just before its dispatch and just after
it (``boundary``). Every other call into the program is one the fit
makes; the harness adds its ``pb.*`` spans around them and a host clock
around each dispatch.
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
from torch.profiler import record_function


class Group:
    """What one harvested group did."""

    __slots__ = ("epoch", "start", "step0", "grid_step0", "losses",
                 "pairs", "pos_ends", "n_real")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class Boundary(NamedTuple):
    """The first group after the first epoch boundary: both tables as the
    group found them and as it left them, and the group once harvested."""

    before: tuple
    after: tuple
    group: Optional[Group]


class PackedSchedule:
    def __init__(self, engine, *, batch_size: int, window: int,
                 steps_per_call: int, step_size: float, epochs: int,
                 seed: int, offsets: np.ndarray, words_per_epoch: int,
                 subsampling: bool):
        from glint_word2vec_torch.corpus.batching import packed_pair_batch
        from glint_word2vec_torch.ops import random as rnd
        from glint_word2vec_torch.ops.device_batching import (
            corpus_words_done, corpus_words_done_compacted)

        self._rnd = rnd
        self._wd = corpus_words_done
        self._wd_c = corpus_words_done_compacted
        self.engine = engine
        self.B, self.W, self.spc = batch_size, window, steps_per_call
        self.step_size = step_size
        self.epochs = epochs
        self.base_key = rnd.seed_key(seed)
        self.offsets = offsets
        self.n_words = int(offsets[-1])
        self.twc = words_per_epoch
        self.total_words = epochs * words_per_epoch + 1
        self.subsampling = subsampling
        self.pair_batch = packed_pair_batch(batch_size, window, engine.num_data)
        self.epoch = 0
        self.step = 0
        self.gstep = 0
        self.n_pos = 0
        self.offsets_c = None
        self.pos = 0
        self.next_start = 0
        self.dstep = 0
        self.pending = None
        self.groups_in_epoch = 0
        #: Cumulative corpus words done (every epoch), and the harvested
        #: groups' live steps and pairs.
        self.words = 0
        self.fit_words = 0
        self.steps_done = 0
        self.pairs_done = 0
        #: Live steps whose loss came back non-finite.
        self.bad_steps = 0
        self.dispatch_ms: List[float] = []
        self.record: Optional[List[Group]] = None
        self.boundary: Optional[Boundary] = None
        self._capture = False

    # -- the fit's epoch head and tail ---------------------------------

    def begin_epoch(self) -> None:
        with record_function("pb.compact"):
            if self.subsampling:
                self.n_pos = self.engine.compact_corpus(
                    self._rnd.fold_in(self.base_key, self.epoch))
                self.offsets_c = self.engine.compacted_offsets()
            else:
                self.n_pos, self.offsets_c = self.n_words, None
        steps = max(1, -(-self.n_pos // self.B))
        self.groups_in_epoch = max(1, -(-steps // self.spc))
        self.pos = self.next_start = 0
        self.dstep = self.step
        self.pending = None
        self._capture = self.boundary is None and self.epoch > 0

    def end_epoch(self) -> None:
        """Behind the last group, enqueue the next epoch's compaction, then
        drain the group still pending and move to the next epoch."""
        nxt = self.epoch + 1
        if self.subsampling and nxt < self.epochs:
            with record_function("pb.prefetch_compact"):
                self.engine.prefetch_compact_corpus(
                    self._rnd.fold_in(self.base_key, nxt))
        self.drain()
        self.gstep += self.groups_in_epoch * self.spc
        self.epoch = nxt

    def restart(self) -> None:
        """A fresh fit on the trained tables, once the planned epochs ran
        out: its anneal, step counters and epoch keys start over."""
        self.fit_words += self.epochs * self.twc
        self.epoch = self.step = self.gstep = 0

    # -- groups --------------------------------------------------------

    def words_done(self, end_pos: int) -> int:
        if self.subsampling:
            done = self._wd_c(self.offsets, self.offsets_c, end_pos, self.n_pos)
        else:
            done = self._wd(self.offsets, end_pos)
        return self.fit_words + self.epoch * self.twc + done

    def _tables(self) -> tuple:
        return self.engine.syn0.clone(), self.engine.syn1.clone()

    def dispatch(self):
        before = self._tables() if self._capture else None
        t = time.perf_counter()
        with record_function("pb.dispatch"):
            group = self.engine.train_steps_corpus_packed(
                self.next_start, self.pair_batch, self.W, self.B,
                self.base_key, self.spc, step0=self.dstep,
                grid_step0=self.gstep, step_size=self.step_size,
                total_words=self.total_words,
                words_base=self.epoch * self.twc, readback=False,
            )
        self.dispatch_ms.append((time.perf_counter() - t) * 1e3)
        meta = (self.dstep, self.gstep, before is not None)
        if before is not None:
            self._capture = False
            self.boundary = Boundary(before, self._tables(), None)
        self.dstep += self.spc
        self.next_start = group.out[2, self.spc - 1]
        return group, meta

    def harvest(self, group, start: int, meta) -> int:
        """Read a group back and count its live steps; returns its end
        position (the fit's ``harvest_packed``)."""
        with record_function("pb.harvest"):
            losses, pairs, pos_ends, _ = self.engine.packed_readback(group)
        starts = np.concatenate(([start], pos_ends[:-1]))
        n_real = int((starts < self.n_pos).sum())
        if n_real:
            self.words = self.words_done(int(min(pos_ends[n_real - 1], self.n_pos)))
            self.step += self.spc
            self.steps_done += n_real
            self.pairs_done += int(pairs[:n_real].sum())
            self.bad_steps += int((~np.isfinite(losses[:n_real])).sum())
            g = Group(epoch=self.epoch, start=start, step0=meta[0],
                      grid_step0=meta[1], losses=losses, pairs=pairs,
                      pos_ends=pos_ends, n_real=n_real)
            if self.record is not None:
                self.record.append(g)
            if meta[2]:
                self.boundary = self.boundary._replace(group=g)
        return int(pos_ends[-1])

    def advance(self) -> None:
        """One turn of the fit's loop: dispatch a group, harvest the one
        before it."""
        group, meta = self.dispatch()
        new = [group, self.pos, meta]
        if self.pending is not None:
            self.pos = self.harvest(*self.pending)
            new[1] = self.pos
        self.pending = new

    def drain(self) -> None:
        if self.pending is not None:
            self.pos = self.harvest(*self.pending)
            self.pending = None
            self.next_start = self.pos

    @property
    def epoch_open(self) -> bool:
        return self.pos < self.n_pos

    def run(self, until: Callable[[], bool]) -> None:
        """Train, epoch after epoch, until ``until()`` holds after a
        dispatch. The group still pending is read back before returning."""
        while True:
            while self.epoch_open:
                self.advance()
                if until():
                    self.drain()
                    return
            self.end_epoch()
            if self.epoch >= self.epochs:
                self.restart()
            self.begin_epoch()
