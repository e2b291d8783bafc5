"""Streaming training (counterpart of ``glint_word2vec_tpu/streaming``):
incremental training on an unbounded sentence stream, publishing model
generations that a server hot-swaps under live traffic.

- :mod:`glint_word2vec_torch.corpus.stream_vocab`: the online
  vocabulary (exact live counts, a space-saving candidate sketch, and
  promotion onto the engine's spare extra rows, arXiv:1704.03956).
- :mod:`glint_word2vec_torch.streaming.publish`: the generation commit
  protocol: ``gen-NNNNNN`` model directories committed by one atomic
  rename and referenced by an atomically replaced ``LATEST.json``, so a
  watcher never sees a partial snapshot.
- :mod:`glint_word2vec_torch.streaming.trainer`: the long-lived
  ``fit_stream`` loop: bounded mini-epochs through the engine's packed
  device-corpus path, adaptive noise and subsample refreshes, online
  vocabulary growth, publishing on a cadence, and the stream gauges.

The serving half (the snapshot watcher, ``/reload`` and the table flip
under the device lock) is in :mod:`glint_word2vec_torch.serving`.
"""

from glint_word2vec_torch.streaming.publish import (
    LATEST_NAME,
    SnapshotPublisher,
    generation_name,
    next_generation_seq,
    read_latest,
    resolve_latest,
)
from glint_word2vec_torch.streaming.trainer import StreamTrainer

__all__ = [
    "LATEST_NAME",
    "SnapshotPublisher",
    "StreamTrainer",
    "generation_name",
    "next_generation_seq",
    "read_latest",
    "resolve_latest",
]
