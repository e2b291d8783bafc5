"""Skip-gram batch assembly on the device from a device-resident corpus
(counterpart of ``glint_word2vec_tpu/ops/device_batching.py``).

The flat encoded corpus (``ids`` int32, ``offsets`` int64 sentence
starts) is uploaded once; every dense pair batch is then assembled on
the device from a position counter and the step's draws, with no host
round trip. Window semantics are the reference's (see
``corpus/batching.py``). Positions and offsets are int64 tensors here,
ids int32.

Each function that draws takes its draws through one argument, so a test
can hand in the JAX package's: :func:`device_window_batch` and
:func:`pack_window_pairs` take the shrink values, :func:`subsample_compact`
the keep mask. The functions
that make those draws, :func:`grid_window_shrink` and
:func:`subsample_keep_mask`, use the counter-based words of
``ops/random.py``: a position's draw depends on the position alone.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from glint_word2vec_torch.corpus.batching import window_offsets
from glint_word2vec_torch.ops import random as rnd
from glint_word2vec_torch.ops.random import SUBSAMPLE_FOLD, WINDOW_FOLD


#: ``window_offsets(window)`` as int64 tensors, one per (window, device).
_OFFSETS_ON_DEVICE: dict = {}


def _window_offsets_on(window: int, device) -> torch.Tensor:
    """The lane offsets of ``window`` as an int64 tensor on ``device``,
    made once: a copy from host memory to the card waits for the card's
    queued work, and the steps ask for the offsets every step."""
    key = (int(window), str(device))
    offs = _OFFSETS_ON_DEVICE.get(key)
    if offs is None:
        offs = _OFFSETS_ON_DEVICE[key] = torch.as_tensor(
            window_offsets(window), dtype=torch.int64, device=device)
    return offs


def subsample_keep_mask(ids: torch.Tensor, keep_prob: torch.Tensor,
                        epoch_key: int) -> torch.Tensor:
    """Per-position keep mask for frequency subsampling: position ``t``
    is kept iff ``u_t <= keep_prob[ids[t]]``, with ``u_t`` drawn from
    ``fold_in(fold_in(epoch_key, SUBSAMPLE_FOLD), t)``."""
    base = rnd.fold_in(epoch_key, SUBSAMPLE_FOLD)
    t = torch.arange(ids.shape[0], dtype=torch.int64, device=ids.device)
    return rnd.uniform(rnd.fold_in(base, t)) <= keep_prob[ids.long()]


def subsample_compact(ids: torch.Tensor, offsets: torch.Tensor,
                      keep: torch.Tensor):
    """One epoch's subsample-and-compact pass for a given keep mask.

    Returns ``(ids_c, offsets_c, n_kept)``: the kept tokens moved to the
    front of a same-shape buffer (the tail is dead, zeros), the sentence
    offsets remapped into compacted positions (a sentence subsampled to
    nothing becomes an empty span), and the kept count as a 0-d int64
    tensor. Compaction comes before windowing, as in the reference:
    dropping a word brings its neighbours closer."""
    N = ids.shape[0]
    k = keep.to(torch.int64)
    incl = torch.cumsum(k, 0)
    n_kept = incl[-1] if N else torch.zeros((), dtype=torch.int64, device=ids.device)
    dest = torch.where(keep, incl - k, N)  # dropped tokens land past the end
    ids_c = torch.zeros(N + 1, dtype=ids.dtype, device=ids.device)
    ids_c.scatter_(0, dest, ids)
    kept_before = torch.cat([incl.new_zeros(1), incl])
    return ids_c[:N], kept_before[offsets.long()], n_kept


def grid_window_shrink(base_key: int, positions: torch.Tensor,
                       grid_batch: int, grid_step0: int,
                       window: int) -> torch.Tensor:
    """The window-shrink draw ``b`` in ``[0, window)`` of each position:
    position ``p`` draws from ``fold_in(fold_in(fold_in(base_key,
    grid_step0 + p // B), WINDOW_FOLD), p % B)``, the key schedule of the
    JAX package's grid scan (``device_batching.py:187-217``) on this
    package's words. A pure function of the position."""
    positions = positions.to(torch.int64)
    step = (positions // int(grid_batch) + int(grid_step0)) & 0xFFFFFFFF
    k = rnd.fold_in(base_key, step)
    k = rnd.fold_in(k, WINDOW_FOLD)
    k = rnd.fold_in(k, positions % int(grid_batch))
    return rnd.below(k, int(window))


def device_window_batch(
    ids: torch.Tensor, offsets: torch.Tensor, positions: torch.Tensor,
    shrink: torch.Tensor, window: int, n_valid=None,
):
    """Assemble one grid minibatch ``(centers, contexts, mask)`` on the
    device (``device_window_batch``, ``device_batching.py:68-125`` of the
    JAX package).

    Row ``i`` is centered on ``positions[i]`` with the window-shrink draw
    ``shrink[i]`` in ``[0, window)``, which the caller makes as a pure
    function of the step key and the row (``grid_window_shrink`` over the
    positions of a grid step). A position outside ``[0, n_valid)`` gives a
    fully masked row: the epoch tail, and a negative position (a wrapped
    one included) too, which must not train sentence 0. ``n_valid`` (an
    int or a 0-d tensor; None for ``len(ids)``) is the corpus-end bound of
    the active view: the compacted view keeps the buffer's length and
    only its first ``n_kept`` positions live. Context validity needs no
    other bound, since compacted sentence offsets never pass ``n_kept``.

    Returns ``centers (B,) int32``, ``contexts (B, C) int32`` and ``mask
    (B, C) float32``, ``C = context_width(window)``; masked lanes hold id
    0."""
    N = ids.shape[0]
    if n_valid is None:
        n_valid = N
    dev = ids.device
    last = max(N - 1, 0)
    positions = positions.to(torch.int64)
    in_corpus = (positions >= 0) & (positions < n_valid)
    p = positions.clamp(0, last)
    sent = torch.searchsorted(offsets, p, right=True) - 1
    start = offsets[sent]
    end = offsets[(sent + 1).clamp(max=offsets.shape[0] - 1)]
    b = shrink.to(torch.int64)
    offs = _window_offsets_on(window, dev)
    cpos = p[:, None] + offs[None, :]
    valid = (
        (offs[None, :] >= -b[:, None])
        & (offs[None, :] <= b[:, None] - 1)
        & (cpos >= start[:, None])
        & (cpos < end[:, None])
        & in_corpus[:, None]
    )
    centers = torch.where(in_corpus, ids[p], 0).to(torch.int32)
    contexts = torch.where(valid, ids[cpos.clamp(0, last)], 0).to(torch.int32)
    return centers, contexts, valid.to(torch.float32)


def pack_window_pairs(
    ids: torch.Tensor, offsets: torch.Tensor, pos, shrink: torch.Tensor,
    *, window: int, pair_batch: int, n_valid,
):
    """Assemble one dense (center, context) pair batch on the device.

    Windows are built over the candidate span ``[pos, pos + S)``, ``S =
    len(shrink)``, with ``shrink[i]`` the draw of position ``pos + i``;
    the valid pairs are prefix-sum compacted to the front of ``(P,)``
    lists. Only whole positions are consumed: ``n_cons`` is the longest
    prefix of the span whose pairs fit in ``P``, and the next step starts
    at ``pos + n_cons``. Positions at or past ``n_valid`` give no pairs
    but are consumed. ``pos`` and ``n_valid`` may be ints or 0-d tensors.

    Returns ``(pcenters (P,) int32, pcontexts (P,) int32, pmask (P,)
    float32, n_cons () int64, n_pairs () int64)``, pairs in
    position-major, lane-minor order; slots past ``n_pairs`` are index 0,
    mask 0."""
    N = ids.shape[0]
    S = shrink.shape[0]
    P = int(pair_batch)
    dev = ids.device
    offs = _window_offsets_on(window, dev)
    C = offs.shape[0]
    if P < C:
        raise ValueError(f"pair_batch ({P}) must be >= context lanes ({C})")
    last = max(N - 1, 0)

    positions = pos + torch.arange(S, dtype=torch.int64, device=dev)
    in_corpus = (positions >= 0) & (positions < n_valid)
    p = positions.clamp(0, last)
    sent = torch.searchsorted(offsets, p, right=True) - 1
    start = offsets[sent]
    end = offsets[(sent + 1).clamp(max=offsets.shape[0] - 1)]
    b = shrink.to(torch.int64)
    cpos = p[:, None] + offs[None, :]
    valid = (
        (offs[None, :] >= -b[:, None])
        & (offs[None, :] <= b[:, None] - 1)
        & (cpos >= start[:, None])
        & (cpos < end[:, None])
        & in_corpus[:, None]
    )  # (S, C)
    centers = torch.where(in_corpus, ids[p], 0)
    contexts = torch.where(valid, ids[cpos.clamp(0, last)], 0)

    # Whole-position consumption: the longest span prefix whose running
    # pair count fits in P (the running count never decreases).
    cum = torch.cumsum(valid.sum(dim=1), 0)
    n_cons = (cum <= P).sum()
    consumed = torch.arange(S, device=dev) < n_cons
    take = (valid & consumed[:, None]).reshape(-1).to(torch.int64)
    incl = torch.cumsum(take, 0)
    n_pairs = incl[-1]
    dest = torch.where(take > 0, incl - take, P)  # dropped lanes past the end
    pcenters = torch.zeros(P + 1, dtype=torch.int32, device=dev)
    pcenters.scatter_(0, dest, centers.to(torch.int32).repeat_interleave(C))
    pcontexts = torch.zeros(P + 1, dtype=torch.int32, device=dev)
    pcontexts.scatter_(0, dest, contexts.to(torch.int32).reshape(-1))
    pmask = (torch.arange(P, device=dev) < n_pairs).to(torch.float32)
    return pcenters[:P], pcontexts[:P], pmask, n_cons, n_pairs


def device_words_done(offsets: torch.Tensor, offsets_c: torch.Tensor,
                      end_position, n_valid) -> torch.Tensor:
    """:func:`corpus_words_done_compacted` on the device, for a 0-d
    ``end_position``: the pre-subsampling words credited after consuming
    positions ``[0, end)`` of the active stream. For the stream without
    subsampling pass the original offsets twice (it then equals
    :func:`corpus_words_done`). Returns a 0-d int64 tensor."""
    end = torch.as_tensor(end_position, dtype=torch.int64, device=offsets.device)
    # One-element index tensors: indexing with a 0-d tensor would read
    # it back to the host.
    j = torch.searchsorted(offsets_c, (end - 1).reshape(1), right=True) - 1
    done = offsets[(j + 1).clamp(0, offsets.shape[0] - 1)].reshape(())
    done = torch.where(end >= n_valid, offsets[-1], done)
    return torch.where(end <= 0, 0, done)


def corpus_words_done(offsets: np.ndarray, end_position: int) -> int:
    """Host-side words_done after consuming center positions ``[0, end)``:
    a sentence's full word count is credited as soon as any of its
    positions is consumed."""
    if end_position <= 0:
        return 0
    end_position = min(int(end_position), int(offsets[-1]))
    j = int(np.searchsorted(offsets, end_position - 1, side="right")) - 1
    return int(offsets[j + 1])


def corpus_words_done_compacted(offsets: np.ndarray, offsets_c: np.ndarray,
                                end_position: int, n_kept: int) -> int:
    """Host-side words_done over an epoch's compacted position stream: a
    sentence's full pre-subsampling count is credited once any of its
    kept positions is consumed, and consuming the whole compacted stream
    credits the whole corpus."""
    if end_position >= n_kept:
        return int(offsets[-1])
    if end_position <= 0:
        return 0
    j = int(np.searchsorted(offsets_c, end_position - 1, side="right")) - 1
    return int(offsets[j + 1])


def packed_span(pair_batch: int, context_lanes: int) -> int:
    """Candidate positions a packed step examines: ``3P/C``, about 1.3 to
    1.5 times the positions whose pairs fill ``P``, so only the epoch
    tail underfills (``engine.py:1852-1858`` of the JAX package)."""
    return -(-3 * int(pair_batch) // int(context_lanes))


def to_device_corpus(ids: np.ndarray, offsets: np.ndarray,
                     device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flat corpus as device tensors: ids int32, offsets int64."""
    return (
        torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int32)).to(device),
        torch.from_numpy(np.ascontiguousarray(offsets, dtype=np.int64)).to(device),
    )
