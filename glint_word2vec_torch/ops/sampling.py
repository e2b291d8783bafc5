"""Negative sampling from the unigram^0.75 alias table (counterpart of
``glint_word2vec_tpu/ops/sampling.py``), with the counter-based words of
``ops/random.py`` in place of threefry.

A draw takes ``k`` uniform over the vocabulary (64 random bits, so no
modulo bias shows even at V = 10^7) and ``u ~ U[0, 1)``, and returns
``k`` if ``u < prob[k]`` else ``alias[k]``: exact for the table's
distribution and O(1) per draw.
"""

from __future__ import annotations

import torch

from glint_word2vec_torch.ops import random as rnd


def sample_negatives(key, prob: torch.Tensor, alias: torch.Tensor,
                     shape: tuple) -> torch.Tensor:
    """``shape`` int32 draws from the alias table, keyed by ``key`` (an
    int or an int64 tensor broadcast against ``shape``); draw ``j`` of
    the flattened shape uses ``fold_in(key, j)``."""
    numel = 1
    for s in shape:
        numel *= int(s)
    j = torch.arange(numel, dtype=torch.int64, device=prob.device)
    if isinstance(key, torch.Tensor):
        key = key.reshape(*key.shape, 1)
    keys = rnd.fold_in(key, j)
    k = rnd.below(keys, prob.shape[0])
    u = rnd.uniform(keys)
    out = torch.where(u < prob[k], k, alias[k].long())
    return out.to(torch.int32).reshape(*out.shape[:-1], *shape)


def sample_negatives_per_row(key, prob: torch.Tensor, alias: torch.Tensor,
                             rows: torch.Tensor,
                             shape_per_row: tuple) -> torch.Tensor:
    """``(B, *shape_per_row)`` int32 draws where row ``i`` depends only on
    ``(key, rows[i])``: its key is ``fold_in(fold_in(key, NEGS_FOLD),
    rows[i])``, so a row draws the same wherever it lands in a batch."""
    base = rnd.fold_in(key, rnd.NEGS_FOLD)
    row_keys = rnd.fold_in(base, rows.to(torch.int64))
    return sample_negatives(row_keys, prob, alias, tuple(shape_per_row))
