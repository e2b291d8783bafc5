"""Unigram noise distribution as a Walker/Vose alias table (own copy of
``glint_word2vec_tpu/corpus/alias.py:30-121``, with its native builder).

The table is two vocabulary-length arrays, ``prob`` (float32 acceptance
probabilities) and ``alias`` (int32 fallback columns): draw ``k`` uniform
over the vocabulary and ``u ~ U[0, 1)``, and take ``k`` if ``u < prob[k]``
else ``alias[k]`` (``ops/sampling.py``). The construction is the JAX
package's two-stack loop, step for step, so both packages build the same
table from the same counts. The native builder (``native/host_ops.cpp``,
milliseconds where the Python loop takes minutes at a 10M vocabulary)
runs whenever it is built, as in the JAX package, and the Python loop
otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class AliasTable:
    """Walker alias table over ``{0..n-1}`` with probabilities ``weights/sum``."""

    prob: np.ndarray  # float32 (n,)
    alias: np.ndarray  # int32 (n,)

    @property
    def size(self) -> int:
        return int(self.prob.shape[0])

    def sample(self, rng: np.random.Generator, shape) -> np.ndarray:
        """Host-side draws of ``shape`` from ``rng``, as the JAX package's
        ``AliasTable.sample``: the same generator gives the same ids."""
        k = rng.integers(0, self.size, size=shape, dtype=np.int64)
        u = rng.random(size=shape)
        return np.where(u < self.prob[k], k, self.alias[k]).astype(np.int32)


def build_alias(weights: np.ndarray) -> AliasTable:
    """Alias table for a nonnegative weight vector: the native builder
    when it is available, else the Python loop.

    The Python loop sums the column total in index order (a running
    sum), as the native builder does it, so the scaled columns, and with
    them every ``prob`` and ``alias`` entry, come out the same."""
    w = np.asarray(weights, dtype=np.float64)
    if w.ndim != 1 or w.size == 0:
        raise ValueError("weights must be a nonempty 1-D array")
    if np.any(w < 0) or not np.all(np.isfinite(w)):
        raise ValueError("weights must be finite and nonnegative")
    total = float(np.cumsum(w)[-1])
    if total <= 0:
        raise ValueError("weights must sum to > 0")

    from glint_word2vec_torch.native import alias_build_native

    native = alias_build_native(w)
    if native is not None:
        return AliasTable(prob=native[0], alias=native[1])

    n = w.size
    scaled = (w * (n / total)).tolist()  # mean 1.0
    prob = np.ones(n, dtype=np.float64)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        if scaled[l] < 1.0:
            small.append(l)
        else:
            large.append(l)
    # Columns left on either stack keep prob 1.0 (numerical leftovers).
    return AliasTable(prob=prob.astype(np.float32), alias=alias.astype(np.int32))


def unigram_weights(counts: np.ndarray, power: float = 0.75) -> np.ndarray:
    """``count^power`` noise weights (word2vec standard, power 3/4)."""
    return np.power(counts.astype(np.float64), power)


def build_unigram_alias(
    counts: np.ndarray,
    power: float = 0.75,
    table_size: int | None = None,
) -> AliasTable:
    """Alias table over the unigram^power noise distribution.

    ``table_size`` (the reference's ``unigramTableSize``) quantizes each
    word's weight to its whole number of slots in a table of that size,
    dropping words that round to zero slots; ``None`` uses the exact
    weights."""
    w = unigram_weights(counts, power)
    if table_size is not None:
        if table_size < counts.size:
            raise ValueError(
                f"table_size ({table_size}) must be >= vocab size ({counts.size})"
            )
        w = np.floor(w / w.sum() * table_size)
        if w.sum() <= 0:
            raise ValueError("table_size too small: all words quantized away")
    return build_alias(w)
