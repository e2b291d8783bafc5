"""The benchmark's inputs, made from ``--seed``: the training corpus with
its vocabulary counts, and the tables. The same seed gives the same
inputs; the program and the reference are handed the same ones.

The corpus is a plain Zipf corpus: word ``r`` (its vocabulary rank, most
frequent first) occurs ``floor(C / (r + 1))`` times, but never fewer than
``min_count`` times, with ``C`` the largest constant whose counts fit in
``tokens`` and the few tokens left over given one each to the most
frequent words. So every word survives a ``min_count`` of that, and the
counts are the same for every seed: the seed only shuffles the tokens (on
the device, one ``randperm``), which are then cut into sentences of
``sentence_length`` words. Word ids are the ranks; word ``r`` is ``w<r>``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Corpus(NamedTuple):
    ids: np.ndarray  # (tokens,) int32 vocabulary ranks
    offsets: np.ndarray  # (sentences + 1,) int64 sentence starts
    counts: np.ndarray  # (V,) int64, most frequent first


def zipf_counts(vocab_size: int, tokens: int, min_count: int) -> np.ndarray:
    """Each word's count, most frequent first, summing to ``tokens``."""
    V, N = int(vocab_size), int(tokens)
    if N < V * min_count:
        raise ValueError(f"tokens ({N}) must hold every word {min_count} times")
    r = np.arange(1, V + 1, dtype=np.float64)

    def counts(c: float) -> np.ndarray:
        return np.maximum(np.floor(c / r), min_count).astype(np.int64)

    lo, hi = 0.0, float(N)
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if counts(mid).sum() <= N:
            lo = mid
        else:
            hi = mid
    out = counts(lo)
    rest = N - int(out.sum())
    if not 0 <= rest <= V:
        raise ValueError(f"no Zipf counts of {V} words sum to {N}")
    out[:rest] += 1
    return out


def corpus(seed: int, vocab_size: int, tokens: int, min_count: int,
           sentence_length: int, device="cpu") -> Corpus:
    if tokens % sentence_length:
        raise ValueError(f"tokens ({tokens}) must be a multiple of the "
                         f"sentence length ({sentence_length})")
    counts = zipf_counts(vocab_size, tokens, min_count)
    ranks = torch.arange(vocab_size, dtype=torch.int32, device=device)
    ids = torch.repeat_interleave(ranks, torch.from_numpy(counts).to(device))
    perm = torch.randperm(tokens, generator=_generator(seed, device),
                          device=device)
    return Corpus(
        ids=ids[perm].cpu().numpy(),
        offsets=np.arange(0, tokens + 1, sentence_length, dtype=np.int64),
        counts=counts,
    )


def words(vocab_size: int) -> list:
    """The vocabulary's words, ``w<r>`` for rank ``r``."""
    return [f"w{r}" for r in range(vocab_size)]


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))


def initial_syn0(seed: int, vocab_size: int, dim: int, device) -> torch.Tensor:
    """word2vec's initial ``syn0`` on ``device``: uniform in ``[-0.5/d,
    0.5/d)``, float32 (its ``syn1`` starts at zero)."""
    syn0 = torch.rand((vocab_size, dim), generator=_generator(seed, device),
                      device=device)
    return syn0.sub_(0.5).div_(dim)


def planted_table(seed: int, vocab_size: int, dim: int, device) -> torch.Tensor:
    """A served table on ``device``: standard normal rows, float32."""
    return torch.randn((vocab_size, dim), generator=_generator(seed, device),
                       device=device)
