"""Faults planted underneath the timed path, to show that the comparison
which decides ``correct`` catches each fault a cell can have. Used by
``calibrate.py --faults`` on the card and by the CPU tests; the
benchmark's own runs never plant one.

Training: ``unchanged``, a step that leaves the tables as they were (its
forward half runs, its scatters do not); ``half``, half of each step's
pair slots left out and the loss taken as the mean over the rest. Query:
``altered``, one neighbour of every fourth query replaced where the top-k
is produced; ``repeated``, the same, with the neighbour before it (a
repeat of a better-ranked word, which no score gap shows); ``half``, the
second half of each query block answered with the first half's
neighbours. There is no exchange between chips to leave
out: every cell runs on one card.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

FAULTS = {"train": ("unchanged", "half"),
          "query": ("altered", "repeated", "half")}


@contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _unchanged():
    from glint_word2vec_torch.ops import fused_sgns as fs
    from glint_word2vec_torch.parallel import engine as eng

    def per_pair(syn0, syn1, centers, contexts, pair_mask, negs, nmask, alpha):
        return fs.pair_forward(syn0, syn1, centers, contexts, pair_mask,
                               negs, nmask, alpha).loss_sum

    def shared(syn0, syn1, centers, contexts, pair_mask, pool, alpha, n):
        return fs.pair_forward_shared(syn0, syn1, centers, contexts,
                                      pair_mask, pool, alpha, n).loss_sum

    return [(eng, "fused_pair_step", per_pair),
            (eng, "fused_pair_step_shared", shared)]


def _half_batch():
    from glint_word2vec_torch.ops import device_batching as dbat

    orig = dbat.pack_window_pairs

    def pack(*a, **kw):
        pc, px, pm, n_cons, n_pairs = orig(*a, **kw)
        keep = torch.arange(pm.shape[0], device=pm.device) < pm.shape[0] // 2
        return pc, px, pm * keep, n_cons, n_pairs

    return [(dbat, "pack_window_pairs", pack)]


def _topk(alter):
    from glint_word2vec_torch.parallel.engine import EmbeddingEngine

    orig = EmbeddingEngine._exact_topk

    def topk(self, q, k_b, *a, **kw):
        return alter(self, q, k_b, orig, a, kw)

    return [(EmbeddingEngine, "_exact_topk", topk)]


def _altered(self, q, k_b, orig, a, kw):
    val, idx = orig(self, q, k_b, *a, **kw)
    idx = idx.clone()
    idx[::4, 2] = (idx[::4, 2] + 7919) % self.vocab_size
    return val, idx


def _repeated(self, q, k_b, orig, a, kw):
    val, idx = orig(self, q, k_b, *a, **kw)
    val, idx = val.clone(), idx.clone()
    val[::4, 2], idx[::4, 2] = val[::4, 1], idx[::4, 1]
    return val, idx


def _half_queries(self, q, k_b, orig, a, kw):
    h = q.shape[0] // 2
    q = q.clone()
    q[h:2 * h] = q[:h]
    return orig(self, q, k_b, *a, **kw)


_PLANTS = {
    ("train", "unchanged"): _unchanged,
    ("train", "half"): _half_batch,
    ("query", "altered"): lambda: _topk(_altered),
    ("query", "repeated"): lambda: _topk(_repeated),
    ("query", "half"): lambda: _topk(_half_queries),
}


@contextmanager
def planted(name: str, kind: str):
    """Plant fault ``name`` of a ``kind`` (``train`` or ``query``) cell
    for the ``with`` block."""
    patches = _PLANTS[(kind, name)]()
    stack = [_patched(o, n, v) for o, n, v in patches]
    for cm in stack:
        cm.__enter__()
    try:
        yield
    finally:
        for cm in reversed(stack):
            cm.__exit__(None, None, None)
