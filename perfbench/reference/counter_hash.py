"""Frozen copy of the counter hash and of the draws made from it.

The training path draws every random number as a pure function of a
32-bit key and a counter: ``lowbias32`` (C. Wellons' integer hash
prospector, two multiply-xorshift rounds) mixes the words, ``fold_in``
derives a key from a key and a datum, and the word of a key becomes a
float in ``[0, 1)`` or an integer below ``n``. The reference needs the
very same draws as the program it judges (the subsample keep draws, the
window shrinks, the negatives and the shared pool), so it carries its own
copy of that definition, written here once and never edited. It imports
nothing of the program.

The arithmetic runs on int64 tensors holding values in ``[0, 2^32)``;
each multiplier is taken as the signed 32-bit value with the same low
bits, so every product stays inside int64. The functions take Python
ints or int64 tensors (broadcast).
"""

from __future__ import annotations

import numpy as np
import torch

WINDOW_FOLD = 0x77696E64  # "wind"
SUBSAMPLE_FOLD = 0x73756273  # "subs"
NEGS_FOLD = 0x6E656773  # "negs"

M32 = 0xFFFFFFFF
_SEED_SALT = 0x9E3779B9
_DATA_SALT = 0x85EBCA6B
_MUL_A = 0x7FEB352D
_MUL_B = 0x846CA68B - (1 << 32)
_WORD_SALTS = (0x5BD1E995, 0x27D4EB2F, 0x165667B1)


def mix32(x):
    x = x ^ (x >> 16)
    x = (x * _MUL_A) & M32
    x = x ^ (x >> 15)
    x = (x * _MUL_B) & M32
    return x ^ (x >> 16)


def seed_key(seed: int) -> int:
    return mix32((int(seed) ^ _SEED_SALT) & M32)


def fold_in(key, data):
    return mix32(key ^ mix32(data ^ _DATA_SALT))


def word(key, i: int):
    return mix32(key ^ _WORD_SALTS[i])


def uniform(key) -> torch.Tensor:
    """float32 in [0, 1) from the top 24 bits of word 0."""
    return (word(key, 0) >> 8).to(torch.float32) * (1.0 / (1 << 24))


def below(key, n: int):
    """int64 in [0, n): the top 32 bits of n times the 64-bit number that
    words 1 and 2 make."""
    hi, lo = word(key, 1), word(key, 2)
    return (hi * n + ((lo * n) >> 32)) >> 32


# ----------------------------------------------------------------------
# The noise table: Walker's alias method, built by the two-stack loop.
# ----------------------------------------------------------------------


def alias_table(counts: np.ndarray, power: float = 0.75):
    """``(prob float32, alias int32)`` over ``count^power``: the columns
    scaled to mean 1 (the total summed in index order), then the loop that
    pairs the top of the small stack with the top of the large one. An
    alias table is not unique; the draws agree with the program's only
    if this loop is the one the program's table was built by."""
    w = np.power(np.asarray(counts, dtype=np.float64), power)
    n = w.size
    total = float(np.cumsum(w)[-1])
    scaled = (w * (n / total)).tolist()
    prob = [1.0] * n
    alias = list(range(n))
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    pop_s, pop_l, push_s, push_l = small.pop, large.pop, small.append, large.append
    while small and large:
        s, l = pop_s(), pop_l()
        prob[s] = scaled[s]
        alias[s] = l
        r = (scaled[l] + scaled[s]) - 1.0
        scaled[l] = r
        if r < 1.0:
            push_s(l)
        else:
            push_l(l)
    return np.asarray(prob, np.float32), np.asarray(alias, np.int32)


def alias_draw(keys: torch.Tensor, prob: torch.Tensor,
               alias: torch.Tensor) -> torch.Tensor:
    """One draw a key: ``k`` uniform over the columns, kept if ``u <
    prob[k]``, else ``alias[k]``. int64."""
    k = below(keys, prob.shape[0])
    u = uniform(keys)
    return torch.where(u < prob[k], k, alias[k].long())


def negatives(base_key: int, step: int, rows: torch.Tensor, n: int,
              prob: torch.Tensor, alias: torch.Tensor) -> torch.Tensor:
    """``(len(rows), n)`` negatives of pair rows ``rows`` in step ``step``:
    row ``r`` draws under ``fold_in(fold_in(fold_in(base, step), NEGS),
    r)``, draw ``j`` of it under a further ``fold_in`` of ``j``."""
    key = fold_in(fold_in(base_key, int(step) & M32), NEGS_FOLD)
    row_keys = fold_in(key, rows.long())[:, None]
    j = torch.arange(n, dtype=torch.int64, device=rows.device)[None, :]
    return alias_draw(fold_in(row_keys, j), prob, alias)


def pool(base_key: int, step: int, size: int, prob: torch.Tensor,
         alias: torch.Tensor) -> torch.Tensor:
    """The ``(size,)`` shared pool of step ``step``: draw ``j`` under
    ``fold_in(fold_in(base, step), j)``."""
    key = fold_in(base_key, int(step) & M32)
    j = torch.arange(size, dtype=torch.int64, device=prob.device)
    return alias_draw(fold_in(key, j), prob, alias)


def shrink(base_key: int, positions: torch.Tensor, grid_batch: int,
           grid_step0: int, window: int) -> torch.Tensor:
    """The window shrink ``b`` in ``[0, window)`` of each position of an
    epoch's stream: position ``p`` draws under ``fold_in(fold_in(fold_in(
    base, grid_step0 + p // B), WINDOW), p % B)``."""
    p = positions.long()
    k = fold_in(base_key, (p // grid_batch + grid_step0) & M32)
    k = fold_in(fold_in(k, WINDOW_FOLD), p % grid_batch)
    return below(k, window)


def keep_draws(base_key: int, epoch: int, n: int, device) -> torch.Tensor:
    """The subsample draw ``u_t`` of every corpus position ``t`` in an
    epoch: ``uniform(fold_in(fold_in(fold_in(base, epoch), SUBS), t))``."""
    key = fold_in(fold_in(base_key, epoch), SUBSAMPLE_FOLD)
    t = torch.arange(n, dtype=torch.int64, device=device)
    return uniform(fold_in(key, t))
