"""Vocabulary of a saved model (own copy of ``glint_word2vec_tpu/corpus/vocab.py``,
trimmed to the lookup surface serving needs; the corpus scan arrives with
the training slice).

Index == frequency rank, most frequent word first, as the JAX package
builds it; a saved model directory lists the words in that order in
``words.txt``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np


@dataclass
class Vocabulary:
    """Words, their counts and the word -> row map."""

    words: List[str]
    counts: np.ndarray
    word_index: Dict[str, int] = field(repr=False)
    train_words_count: int

    @property
    def size(self) -> int:
        return len(self.words)

    @classmethod
    def from_sorted(cls, words: List[str], counts: np.ndarray) -> "Vocabulary":
        """Assemble a Vocabulary from an already-sorted word/count listing.
        Raises ValueError on an empty vocab."""
        if not words:
            raise ValueError("The vocabulary size should be > 0.")
        counts = np.asarray(counts, dtype=np.int64)
        return cls(
            words=list(words),
            counts=counts,
            word_index={w: i for i, w in enumerate(words)},
            train_words_count=int(counts.sum()),
        )

    def __contains__(self, word: str) -> bool:
        return word in self.word_index

    def encode(self, sentence: Sequence[str]) -> np.ndarray:
        """Map words to indices, silently dropping OOV words."""
        ids = [self.word_index[w] for w in sentence if w in self.word_index]
        return np.asarray(ids, dtype=np.int32)

    def encode_strict(self, words: Sequence[str]) -> np.ndarray:
        """Map words to indices, raising KeyError on OOV."""
        try:
            return np.asarray([self.word_index[w] for w in words], dtype=np.int32)
        except KeyError as e:
            raise KeyError(f"word {e.args[0]!r} not in vocabulary") from None


def saved_model_vocabulary(
    model_dir: str, counts: np.ndarray, expected_rows: int
) -> Vocabulary:
    """Vocabulary for a saved model directory: read ``words.txt``, check
    its entry count against the matrix's queryable rows, and zero-pad the
    counts for words promoted onto extra rows."""
    with open(os.path.join(model_dir, "words.txt"), encoding="utf-8") as f:
        words = [line.rstrip("\n") for line in f if line.rstrip("\n")]
    if len(words) != expected_rows:
        raise ValueError(
            f"corrupt model dir at {model_dir}: words.txt has "
            f"{len(words)} entries, the matrix claims {expected_rows} "
            "queryable rows"
        )
    counts = np.asarray(counts, dtype=np.int64)
    if len(words) > counts.shape[0]:
        counts = np.concatenate(
            [counts, np.zeros(len(words) - counts.shape[0], np.int64)]
        )
    return Vocabulary(
        words=words,
        counts=counts[: len(words)],
        word_index={w: i for i, w in enumerate(words)},
        train_words_count=int(counts.sum()),
    )
