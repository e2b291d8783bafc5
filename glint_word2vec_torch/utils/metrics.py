"""Training throughput counters (trimmed copy of
``glint_word2vec_tpu/utils/metrics.py:27-123``): words done, words per
second, the host/step time split, and loss and alpha per step."""

from __future__ import annotations

import contextlib
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

logger = logging.getLogger(__name__)


@dataclass
class TrainingMetrics:
    """Accumulates per-run training statistics; cheap enough for every step."""

    log_every: int = 200
    #: Global words_done at construction (nonzero after a checkpoint
    #: resume); rates count only words processed by this invocation.
    base_words: int = 0
    steps: int = 0
    words_done: int = 0
    host_time: float = 0.0  # seconds spent preparing work on the host
    step_time: float = 0.0  # seconds spent dispatching and reading back steps
    #: Seconds the dispatch loop stood still: blocking checkpoint saves
    #: and the epoch-boundary compaction readback.
    stall_time: float = 0.0
    last_loss: Optional[float] = None
    last_alpha: Optional[float] = None
    _t_start: float = field(default_factory=time.time)
    _t_window: float = field(default_factory=time.time)
    _words_window: int = -1
    history: List[dict] = field(default_factory=list)
    #: Bound on retained history entries (one lands every ``log_every``
    #: steps); the oldest drop first and ``history_dropped`` counts them.
    history_max: int = 4096
    history_dropped: int = 0

    def __post_init__(self) -> None:
        self.words_done = self.base_words
        self._words_window = self.base_words
        self.history = deque(self.history, maxlen=max(1, self.history_max))

    def record_step(self, words_done: int, loss: Optional[float] = None,
                    alpha: Optional[float] = None) -> None:
        """One finished step. ``loss`` and ``alpha`` are host floats: the
        training loop reads a group's values back in one transfer."""
        self.steps += 1
        self.words_done = words_done
        if loss is not None:
            self.last_loss = float(loss)
        if alpha is not None:
            self.last_alpha = float(alpha)
        if self.steps % self.log_every == 0:
            now = time.time()
            wps = (words_done - self._words_window) / max(now - self._t_window, 1e-9)
            entry = {
                "step": self.steps,
                "words_done": words_done,
                "words_per_sec": round(wps, 1),
                "alpha": self.last_alpha,
                "loss": self.last_loss,
                "host_frac": round(
                    self.host_time / max(self.host_time + self.step_time, 1e-9), 3
                ),
            }
            if len(self.history) == self.history.maxlen:
                self.history_dropped += 1
            self.history.append(entry)
            logger.info(
                "step %d: %.0f words/s alpha=%s loss=%s host_frac=%s",
                self.steps, wps, self.last_alpha, self.last_loss,
                entry["host_frac"],
            )
            self._t_window, self._words_window = now, words_done

    @contextlib.contextmanager
    def timing(self, kind: str):
        """Charge the wrapped block to ``host_time`` (``kind="host"``) or
        to ``step_time`` (anything else)."""
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            if kind == "host":
                self.host_time += dt
            else:
                self.step_time += dt

    @contextlib.contextmanager
    def stall_timing(self):
        """Charge the wrapped block to ``stall_time`` (composable with
        :meth:`timing`; the buckets are independent)."""
        t0 = time.time()
        try:
            yield
        finally:
            self.stall_time += time.time() - t0

    def summary(self) -> dict:
        wall = max(time.time() - self._t_start, 1e-9)
        return {
            "steps": self.steps,
            "words_done": self.words_done,
            "wall_seconds": round(wall, 2),
            "words_per_sec": round((self.words_done - self.base_words) / wall, 1),
            "host_time": round(self.host_time, 2),
            "step_time": round(self.step_time, 2),
            "device_stall_seconds": round(self.stall_time, 3),
            "final_loss": self.last_loss,
            "final_alpha": self.last_alpha,
        }
