"""Plain reference of the packed skip-gram training steps.

It follows the program's first group of steps from the same inputs (the
benchmark's corpus, counts and initial tables) and from nothing the
program made: word2vec's frequency subsampling with its keep probability,
the compacted position stream, the reference window (``b`` words before a
centre and ``b - 1`` after it, ``b`` drawn in ``[0, window)``, inside the
sentence), whole positions packed until ``P`` pair slots are full (at
most ``ceil(3P / C)`` positions examined a step), the unigram^0.75
negatives (per pair, or one pool a step shared by every pair, each pool
word weighing ``n / S``), the linear learning-rate anneal by the corpus
words done, and one SGD step of the negative-sampling loss a step, every
gradient taken from the step's starting tables (Mikolov et al. 2013,
arXiv:1310.4546; the shared pool as in Ji et al., arXiv:1604.04661).

It runs in float64 by default; ``dtype=torch.float32, tf32=True`` runs the
same code as the lower-precision control. Tensors may live on any device.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import counter_hash as ch


def keep_probabilities(counts: np.ndarray, sample: float) -> np.ndarray:
    """word2vec's keep probability of each word, ``(sqrt(f / s) + 1) * s /
    f`` with ``f`` its share of the corpus, clipped to [0, 1], as float32.
    Evaluated in float64 in this order, so the draws are held against the
    same float32 numbers as the program's."""
    counts = np.asarray(counts, dtype=np.int64)
    f = counts.astype(np.float64) / float(counts.sum())
    with np.errstate(divide="ignore", invalid="ignore"):
        keep = (np.sqrt(f / sample) + 1.0) * (sample / f)
    keep = np.where(counts > 0, keep, 0.0)
    return np.clip(keep, 0.0, 1.0).astype(np.float32)


def lane_offsets(window: int) -> List[int]:
    """Relative offsets of the context lanes, ``-(W-1) .. -1, 1 .. W-2``;
    lane ``o`` of a position with shrink ``b`` is live when ``-b <= o <=
    b - 1``."""
    return list(range(-(window - 1), 0)) + list(range(1, max(window - 1, 1)))


def packed_pairs(batch_size: int, window: int) -> int:
    """Pair slots of a step: ``batch_size`` positions at ``(W-1)^2 / W``
    pairs each, rounded up, at least one lane's worth."""
    per = max((window - 1) ** 2 / window, 1.0)
    return max(int(math.ceil(batch_size * per)), len(lane_offsets(window)))


class Stream(NamedTuple):
    """One epoch's stream: the kept ids in order, each sentence's start in
    kept positions, and each sentence's start in the whole corpus."""

    ids: torch.Tensor  # (n_kept,) int64
    starts: torch.Tensor  # (sentences + 1,) int64
    offsets: torch.Tensor  # (sentences + 1,) int64

    @property
    def n(self) -> int:
        return int(self.ids.shape[0])


def epoch_stream(ids: torch.Tensor, offsets: torch.Tensor,
                 keep_prob: Optional[torch.Tensor], base_key: int,
                 epoch: int) -> Stream:
    """Subsample the corpus for ``epoch`` (position ``t`` kept when its
    draw is at most its word's keep probability) and close the gaps;
    without ``keep_prob`` every word is kept."""
    ids = ids.long()
    offsets = offsets.long()
    if keep_prob is None:
        return Stream(ids, offsets, offsets)
    u = ch.keep_draws(base_key, epoch, ids.shape[0], ids.device)
    kept = u <= keep_prob[ids]
    before = torch.zeros(ids.shape[0] + 1, dtype=torch.int64, device=ids.device)
    before[1:] = torch.cumsum(kept.long(), 0)
    return Stream(ids[kept], before[offsets], offsets)


def words_done(stream: Stream, end: int) -> int:
    """Corpus words credited once positions ``[0, end)`` of the stream are
    consumed: every word of each sentence any of whose kept positions is
    consumed, and the whole corpus once the stream is."""
    if end >= stream.n:
        return int(stream.offsets[-1])
    if end <= 0:
        return 0
    j = int(torch.searchsorted(stream.starts, torch.tensor([end - 1], device=stream.starts.device),
                               right=True)[0]) - 1
    return int(stream.offsets[j + 1])


class Pairs(NamedTuple):
    centers: torch.Tensor  # (m,) int64
    contexts: torch.Tensor  # (m,) int64
    consumed: int  # positions consumed


def pack(stream: Stream, pos: int, pair_slots: int, window: int,
         shrinks: torch.Tensor) -> Pairs:
    """The pairs of one step starting at stream position ``pos``:
    ``shrinks[i]`` is the draw of position ``pos + i``; positions are
    taken whole while their pairs fit in ``pair_slots``, in position order
    and lane order within a position."""
    dev = stream.ids.device
    span = shrinks.shape[0]
    p = pos + torch.arange(span, dtype=torch.int64, device=dev)
    live = p < stream.n
    pc = p.clamp(max=max(stream.n - 1, 0))
    sent = torch.searchsorted(stream.starts, pc, right=True) - 1
    lo = stream.starts[sent]
    hi = stream.starts[(sent + 1).clamp(max=stream.starts.shape[0] - 1)]
    o = torch.tensor(lane_offsets(window), dtype=torch.int64, device=dev)
    b = shrinks.long()[:, None]
    q = p[:, None] + o[None, :]
    valid = ((o[None, :] >= -b) & (o[None, :] <= b - 1)
             & (q >= lo[:, None]) & (q < hi[:, None]) & live[:, None])
    fits = torch.cumsum(valid.sum(dim=1), 0) <= pair_slots
    consumed = int(fits.sum())
    pi, li = torch.nonzero(valid[:consumed], as_tuple=True)
    return Pairs(stream.ids[p[pi]], stream.ids[q[pi, li]], consumed)


class Step(NamedTuple):
    loss: float
    pos_end: int
    pairs: int
    alpha: float


class Geometry(NamedTuple):
    """What the steps of one run share."""

    base_key: int
    window: int
    batch_size: int  # positions of a grid step (the shrink key schedule)
    pair_slots: int
    negatives: int
    pool: int  # 0: per-pair negatives
    step_size: float
    total_words: int
    words_per_epoch: int


def step_pairs(stream: Stream, g: Geometry, pos: int, grid_step0: int) -> Pairs:
    span = -(-3 * g.pair_slots // len(lane_offsets(g.window)))
    positions = pos + torch.arange(span, dtype=torch.int64, device=stream.ids.device)
    shrinks = ch.shrink(g.base_key, positions, g.batch_size, grid_step0, g.window)
    return pack(stream, pos, g.pair_slots, g.window, shrinks)


def step_noise(g: Geometry, step: int, pairs: Pairs, prob: torch.Tensor,
               alias: torch.Tensor) -> torch.Tensor:
    """The step's negatives ``(m, n)`` or its pool ``(S,)``."""
    if g.pool:
        return ch.pool(g.base_key, step, g.pool, prob, alias)
    rows = torch.arange(pairs.centers.shape[0], dtype=torch.int64,
                        device=prob.device)
    return ch.negatives(g.base_key, step, rows, g.negatives, prob, alias)


def sgd_step(syn0: torch.Tensor, syn1: torch.Tensor, pairs: Pairs,
             noise: torch.Tensor, alpha: float, g: Geometry) -> float:
    """One step on the tables in place; returns the mean loss over the
    pairs. Both tables' updates come from the starting values."""
    c, x = pairs.centers, pairs.contexts
    m = c.shape[0]
    if m == 0:
        return 0.0
    h, u = syn0[c], syn1[x]
    f_pos = (h * u).sum(dim=1)
    c_pos = alpha * torch.sigmoid(-f_pos)
    loss = F.softplus(-f_pos).sum()
    if g.pool:
        up = syn1[noise]
        w = (noise[None, :] != x[:, None]).to(h.dtype) * (g.negatives / g.pool)
        f_pool = h @ up.T
        c_pool = -alpha * torch.sigmoid(f_pool) * w
        loss = loss + (F.softplus(f_pool) * w).sum()
        d_center = c_pos[:, None] * u + c_pool @ up
        syn1.index_add_(0, x, c_pos[:, None] * h)
        syn1.index_add_(0, noise, c_pool.T @ h)
    else:
        un = syn1[noise]
        keep = (noise != x[:, None]).to(h.dtype)
        f_neg = torch.einsum("pd,pnd->pn", h, un)
        c_neg = -alpha * torch.sigmoid(f_neg) * keep
        loss = loss + (F.softplus(f_neg) * keep).sum()
        d_center = c_pos[:, None] * u + (c_neg[..., None] * un).sum(dim=1)
        syn1.index_add_(0, x, c_pos[:, None] * h)
        syn1.index_add_(0, noise.reshape(-1),
                        (c_neg[..., None] * h[:, None, :]).reshape(-1, h.shape[1]))
    syn0.index_add_(0, c, d_center)
    return float(loss) / m


def follow_group(syn0: torch.Tensor, syn1: torch.Tensor, stream: Stream,
                 g: Geometry, prob: torch.Tensor, alias: torch.Tensor, *,
                 epoch: int, pos: int, step0: int, grid_step0: int,
                 n_steps: int, tf32: bool = False) -> List[Step]:
    """``n_steps`` steps from stream position ``pos`` and step number
    ``step0``, on ``syn0``/``syn1`` in place."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        out = []
        for i in range(n_steps):
            pairs = step_pairs(stream, g, pos, grid_step0)
            pos += pairs.consumed
            wd = epoch * g.words_per_epoch + words_done(stream, pos)
            alpha = max(g.step_size * (1.0 - wd / g.total_words),
                        g.step_size * 1e-4)
            noise = step_noise(g, step0 + i, pairs, prob, alias)
            loss = sgd_step(syn0, syn1, pairs, noise, alpha, g)
            out.append(Step(loss, pos, int(pairs.centers.shape[0]), alpha))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def group_rows(stream: Stream, g: Geometry, prob: torch.Tensor,
               alias: torch.Tensor, *, pos: int, step0: int, grid_step0: int,
               n_steps: int):
    """The logical work of a group: ``(syn0 rows, syn1 rows, positions,
    pairs)``, each distinct table row a step of the group updates counted
    once for the group, whatever kernels update it."""
    rows0, rows1, pairs_total, start = [], [], 0, pos
    for i in range(n_steps):
        pairs = step_pairs(stream, g, pos, grid_step0)
        pos += pairs.consumed
        m = int(pairs.centers.shape[0])
        pairs_total += m
        if not m:
            continue
        noise = step_noise(g, step0 + i, pairs, prob, alias)
        rows0.append(pairs.centers)
        rows1.append(pairs.contexts)
        if g.pool:
            rows1.append(noise)
        else:
            rows1.append(noise[noise != pairs.contexts[:, None]])
    u0 = int(torch.unique(torch.cat(rows0)).numel()) if rows0 else 0
    u1 = int(torch.unique(torch.cat(rows1)).numel()) if rows1 else 0
    return u0, u1, pos - start, pairs_total
