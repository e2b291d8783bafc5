"""Embedding quality: analogy accuracy and synonym gates (copy of
``glint_word2vec_tpu/eval/analogy.py``; numpy and the model's query
surface only).

Batched a:b :: c:? accuracy over question files in the Google
analogy-set format that word2vec ships, and the reference's synonym gate
as a reusable check. Each batch of queries is scored on the model's
device by one ``find_synonyms_batch`` call.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class AnalogyResult:
    """Accuracy of one evaluation run, per section and overall."""

    total: int = 0
    correct: int = 0
    skipped: int = 0  # questions with any OOV word
    sections: Dict[str, Tuple[int, int]] = field(default_factory=dict)

    @property
    def accuracy(self) -> float:
        return self.correct / self.total if self.total else 0.0

    def to_dict(self) -> dict:
        return {
            "total": self.total,
            "correct": self.correct,
            "skipped_oov": self.skipped,
            "accuracy": round(self.accuracy, 4),
            "sections": {
                k: {"correct": c, "total": t, "accuracy": round(c / t, 4) if t else 0.0}
                for k, (c, t) in self.sections.items()
            },
        }


def parse_analogy_file(path: str, lowercase: bool = True):
    """Parse the standard analogy question-file format: ``: section`` header
    lines followed by ``a b c d`` rows (d is the expected answer to
    a:b :: c:?)."""
    sections: List[Tuple[str, List[Tuple[str, str, str, str]]]] = []
    current: List[Tuple[str, str, str, str]] = []
    name = "default"
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(":"):
                if current:
                    sections.append((name, current))
                name = line[1:].strip() or "default"
                current = []
                continue
            parts = line.lower().split() if lowercase else line.split()
            if len(parts) == 4:
                current.append(tuple(parts))
    if current:
        sections.append((name, current))
    return sections


def evaluate_analogies(
    model,
    questions,
    top_k: int = 1,
    batch_size: int = 1024,
) -> AnalogyResult:
    """Accuracy on a:b :: c:? questions (``questions`` as returned by
    :func:`parse_analogy_file`, or a flat list of 4-tuples).

    A question counts as correct when the expected word appears in the
    ``top_k`` nearest neighbors of ``b - a + c`` (query words excluded,
    word2vec convention). Queries are scored in batches of
    ``batch_size``, one ``find_synonyms_batch`` call (one matrix product
    and one top-k on the device) a batch. OOV questions are skipped and
    counted (gensim/word2vec convention).
    """
    questions = list(questions)
    if questions and len(questions[0]) == 4 and all(
        isinstance(x, str) for x in questions[0]
    ):
        flat = [("default", questions)]  # flat list of (a, b, c, d)
    else:
        flat = [(name, list(qs)) for name, qs in questions]

    res = AnalogyResult()
    vocab = model.vocab
    for name, qs in flat:
        sec_correct = sec_total = 0
        # Resolve words; skip OOV questions.
        resolved = []
        for a, b, c, d in qs:
            ia, ib = vocab.word_index.get(a), vocab.word_index.get(b)
            ic, id_ = vocab.word_index.get(c), vocab.word_index.get(d)
            if None in (ia, ib, ic, id_):
                res.skipped += 1
                continue
            resolved.append((a, b, c, d))
        for s in range(0, len(resolved), batch_size):
            chunk = resolved[s : s + batch_size]
            # One vector fetch for all of a, b, c across the chunk, then one
            # batched top-k; chunks are zero-padded to batch_size so the
            # device sees one query shape.
            abc = model.transform_words(
                [q[0] for q in chunk]
                + [q[1] for q in chunk]
                + [q[2] for q in chunk]
            )
            n = len(chunk)
            A, B, C = abc[:n], abc[n : 2 * n], abc[2 * n :]
            queries = B - A + C
            if len(chunk) < batch_size:
                queries = np.pad(
                    queries, ((0, batch_size - len(chunk)), (0, 0))
                )
            hits = model.find_synonyms_batch(queries, top_k + 3)
            for i, (a, b, c, d) in enumerate(chunk):
                exclude = {a, b, c}
                answers = [
                    w for w, _ in hits[i] if w not in exclude
                ][:top_k]
                sec_correct += int(d in answers)
                sec_total += 1
        prev_c, prev_t = res.sections.get(name, (0, 0))
        res.sections[name] = (prev_c + sec_correct, prev_t + sec_total)
        res.correct += sec_correct
        res.total += sec_total
    return res


def evaluate_synonym_gate(
    model,
    word: str,
    expected: str,
    top: int = 10,
    min_similarity: Optional[float] = None,
) -> Tuple[bool, Optional[float]]:
    """The reference's synonym quality gate as a reusable check: does
    ``expected`` appear in the ``top`` synonyms of ``word`` (optionally with
    cosine >= ``min_similarity``)? Returns (passed, similarity-or-None)."""
    for w, s in model.find_synonyms(word, top):
        if w == expected:
            if min_similarity is not None and s < min_similarity:
                return False, s
            return True, s
    return False, None
