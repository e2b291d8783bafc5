"""Embedding-quality evaluation of the port (counterpart of
``glint_word2vec_tpu/eval``)."""

from glint_word2vec_torch.eval.analogy import (
    AnalogyResult,
    evaluate_analogies,
    evaluate_synonym_gate,
    parse_analogy_file,
)

__all__ = [
    "AnalogyResult",
    "evaluate_analogies",
    "evaluate_synonym_gate",
    "parse_analogy_file",
]
