"""Batch assembly, accounting and draws of the port
(glint_word2vec_torch/ops/device_batching.py, ops/random.py,
ops/sampling.py, corpus/alias.py) against the JAX package.

Given the same shrink values and keep mask, ``pack_window_pairs`` and
``subsample_compact`` equal the JAX package's bitwise, as do
``device_words_done`` over every prefix, ``packed_pair_batch``,
``window_offsets`` and the alias table. The port's own draws are held to
their distributions (chi-square) and to the property packing relies on:
a position's draw depends on the position alone.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from glint_word2vec_tpu.corpus import batching as jb
from glint_word2vec_tpu.ops import device_batching as jdb

from glint_word2vec_torch.corpus import batching as pb
from glint_word2vec_torch.ops import device_batching as pdb
from glint_word2vec_torch.ops import random as rnd

V = 73


def _corpus(seed=0, lens=(5, 1, 9, 3, 12, 2, 6, 30, 4, 17, 1, 8)):
    rng = np.random.default_rng(seed)
    sents = [rng.integers(0, V, L).astype(np.int32) for L in lens]
    ids = np.concatenate(sents)
    offsets = np.zeros(len(sents) + 1, np.int64)
    np.cumsum([len(s) for s in sents], out=offsets[1:])
    return ids, offsets


def test_window_geometry_equals_jax():
    for W in range(1, 8):
        assert pb.context_width(W) == jb.context_width(W)
        np.testing.assert_array_equal(pb.window_offsets(W), jb.window_offsets(W))
        for B in (1, 7, 256, 1024):
            for mult in (1, 2, 8):
                assert pb.packed_pair_batch(B, W, mult) == jb.packed_pair_batch(B, W, mult)
    assert pb.packed_pair_batch(1024, 5) == 3277


def _jax_shrink(key, positions, B, gstep0, W):
    return np.asarray(jdb.grid_window_shrink(
        key, jnp.asarray(positions, jnp.int32), B, jnp.uint32(gstep0), W
    )).astype(np.int64)


@pytest.mark.parametrize("window", [2, 3, 5])
@pytest.mark.parametrize("compacted", [False, True])
def test_pack_window_pairs_bitwise_equals_jax(window, compacted):
    ids, offsets = _corpus()
    n_valid = len(ids)
    if compacted:
        keep = np.random.default_rng(4).random(len(ids)) < 0.7
        keep[:2] = [True, False]
        # Compacted buffers: a dead tail past n_valid, as in an epoch
        # with subsampling.
        ids_c, offs_c, n_kept = pdb.subsample_compact(
            torch.from_numpy(ids), torch.from_numpy(offsets), torch.from_numpy(keep)
        )
        ids, offsets, n_valid = ids_c.numpy(), offs_c.numpy(), int(n_kept)
    key = jax.random.PRNGKey(7)
    P, S, B = 24, 16, 8
    pos, n_steps = 0, 0
    while pos < n_valid:
        shrink = _jax_shrink(key, np.arange(pos, pos + S), B, 3, window)
        want = jdb.pack_window_pairs(
            jnp.asarray(ids), jnp.asarray(offsets, jnp.int32), jnp.int32(pos),
            key, jnp.uint32(3), window=window, span=S, pair_batch=P,
            grid_batch=B, n_valid=jnp.int32(n_valid),
        )
        got = pdb.pack_window_pairs(
            torch.from_numpy(ids), torch.from_numpy(offsets),
            torch.tensor(pos), torch.from_numpy(shrink), window=window,
            pair_batch=P, n_valid=n_valid,
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert int(got[3]) >= 1
        pos += int(got[3])
        n_steps += 1
    assert n_steps > 2


def test_subsample_compact_bitwise_equals_jax():
    ids, offsets = _corpus(1)
    kp = np.linspace(0.1, 1.0, V).astype(np.float32)
    ekey = jax.random.fold_in(jax.random.PRNGKey(3), 2)
    keep = np.array(jdb.subsample_keep_mask(jnp.asarray(ids), jnp.asarray(kp), ekey))
    want = jdb.subsample_compact(
        jnp.asarray(ids), jnp.asarray(offsets, jnp.int32), jnp.asarray(kp), ekey
    )
    got = pdb.subsample_compact(
        torch.from_numpy(ids), torch.from_numpy(offsets), torch.from_numpy(keep)
    )
    assert 0 < int(got[2]) < len(ids)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # An all-dropped sentence becomes an empty span.
    keep[offsets[1]:offsets[2]] = False
    _, offs_c, _ = pdb.subsample_compact(
        torch.from_numpy(ids), torch.from_numpy(offsets), torch.from_numpy(keep)
    )
    assert offs_c[1] == offs_c[2]


def test_words_done_over_every_prefix_equals_jax():
    ids, offsets = _corpus(2)
    keep = np.random.default_rng(5).random(len(ids)) < 0.6
    _, offs_c, n_kept = pdb.subsample_compact(
        torch.from_numpy(ids), torch.from_numpy(offsets), torch.from_numpy(keep)
    )
    n_kept = int(n_kept)
    o, oc = torch.from_numpy(offsets), offs_c
    jo, joc = jnp.asarray(offsets, jnp.int32), jnp.asarray(oc.numpy(), jnp.int32)
    for end in range(-1, len(ids) + 3):
        plain = pdb.device_words_done(o, o, torch.tensor(end), len(ids))
        assert int(plain) == int(jdb.device_words_done(jo, jo, jnp.int32(end), len(ids)))
        assert int(plain) == jdb.corpus_words_done(offsets, end) == pdb.corpus_words_done(offsets, end)
        comp = pdb.device_words_done(o, oc, torch.tensor(end), n_kept)
        assert int(comp) == int(jdb.device_words_done(jo, joc, jnp.int32(end), n_kept))
        assert int(comp) == pdb.corpus_words_done_compacted(offsets, oc.numpy(), end, n_kept)


def test_alias_table_equals_jax():
    from glint_word2vec_tpu.corpus.alias import build_unigram_alias as jax_alias

    from glint_word2vec_torch.corpus.alias import build_unigram_alias

    rng = np.random.default_rng(0)
    for counts in (np.arange(V, 0, -1) * 3, rng.zipf(1.3, 5000).astype(np.int64)):
        for kw in ({}, {"power": 0.5}, {"table_size": 100_000}):
            a, b = build_unigram_alias(counts, **kw), jax_alias(counts, **kw)
            np.testing.assert_array_equal(a.prob, b.prob)
            np.testing.assert_array_equal(a.alias, b.alias)


def test_negative_draws_follow_the_alias_distribution():
    from scipy import stats

    from glint_word2vec_torch.corpus.alias import build_unigram_alias
    from glint_word2vec_torch.ops.sampling import sample_negatives_per_row

    counts = (1000 / np.arange(1, 41) ** 1.1).astype(np.int64) + 1
    t = build_unigram_alias(counts)
    rows = torch.arange(4000)
    draws = sample_negatives_per_row(
        rnd.fold_in(rnd.seed_key(3), 11), torch.from_numpy(t.prob),
        torch.from_numpy(t.alias), rows, (5,),
    )
    assert draws.shape == (4000, 5) and draws.dtype == torch.int32
    p = counts.astype(np.float64) ** 0.75
    p /= p.sum()
    obs = np.bincount(draws.numpy().ravel(), minlength=len(counts))
    assert stats.chisquare(obs, p * obs.sum()).pvalue > 1e-3
    # Row i's draws depend on (key, rows[i]) alone.
    again = sample_negatives_per_row(
        rnd.fold_in(rnd.seed_key(3), 11), torch.from_numpy(t.prob),
        torch.from_numpy(t.alias), rows[1000:1010].flip(0), (5,),
    )
    assert torch.equal(again, draws[1000:1010].flip(0))


def test_uniform_words_and_ranges():
    from scipy import stats

    keys = rnd.fold_in(rnd.seed_key(1), torch.arange(200_000))
    u = rnd.uniform(keys)
    assert u.dtype == torch.float32 and 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert stats.kstest(u.numpy(), "uniform").pvalue > 1e-3
    k = rnd.below(keys, 7)
    obs = np.bincount(k.numpy(), minlength=7)
    assert stats.chisquare(obs).pvalue > 1e-3
    # Python ints and tensors give the same words.
    for d in (0, 5, 2**32 - 1):
        assert rnd.fold_in(rnd.seed_key(9), d) == int(
            rnd.fold_in(rnd.seed_key(9), torch.tensor([d]))[0]
        )
    with pytest.raises(ValueError):
        rnd.below(keys, 0)


def test_shrink_draw_depends_on_the_position_alone():
    key = rnd.seed_key(5)
    whole = pdb.grid_window_shrink(key, torch.arange(0, 400), 64, 9, 5)
    for lo, hi in ((0, 17), (33, 240), (399, 400), (130, 131)):
        part = pdb.grid_window_shrink(key, torch.arange(lo, hi), 64, 9, 5)
        assert torch.equal(part, whole[lo:hi])
    assert int(whole.min()) == 0 and int(whole.max()) == 4
    assert not torch.equal(whole, pdb.grid_window_shrink(key, torch.arange(0, 400), 64, 10, 5))


def test_subsample_keep_mask_follows_keep_probabilities():
    ids = torch.arange(4).repeat(20_000).to(torch.int32)
    kp = torch.tensor([0.1, 0.5, 0.9, 1.0])
    keep = pdb.subsample_keep_mask(ids, kp, rnd.fold_in(rnd.seed_key(1), 0))
    frac = keep.reshape(-1, 4).float().mean(0)
    assert torch.allclose(frac, kp, atol=0.01), frac
    # A position's draw depends on the position: a longer corpus keeps
    # the same prefix.
    longer = pdb.subsample_keep_mask(
        torch.cat([ids, ids[:99]]), kp, rnd.fold_in(rnd.seed_key(1), 0)
    )
    assert torch.equal(longer[: ids.shape[0]], keep)
