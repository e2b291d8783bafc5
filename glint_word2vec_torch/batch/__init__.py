"""Resumable bulk embedding of the port (counterpart of
``glint_word2vec_tpu/batch``): see :mod:`glint_word2vec_torch.batch.transform`."""

from glint_word2vec_torch.batch.transform import (  # noqa: F401
    ShardWriter,
    count_lines,
    iter_sentence_lines,
    load_transform_output,
    synonyms_dump,
    transform_file,
)
