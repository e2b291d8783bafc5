"""The reference agrees with the port's CPU path, on the frozen draws and
on each cell's checked group or calls."""

import numpy as np
import pytest
import torch

import pb_tiny
from perfbench import data
from perfbench.reference import counter_hash as ch
from perfbench.reference import sgns as ref


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pb_tiny.tiny_root(tmp_path_factory.mktemp("tiny"))


def test_counter_hash_draws_are_the_programs():
    from glint_word2vec_torch.ops import random as rnd
    from glint_word2vec_torch.ops.device_batching import grid_window_shrink
    from glint_word2vec_torch.ops.sampling import (sample_negatives,
                                                   sample_negatives_per_row)

    for seed in (0, 1, 2**31 + 5, 2**33 + 7):
        assert rnd.seed_key(seed) == ch.seed_key(seed)
    key = rnd.seed_key(7)
    t = torch.arange(5000, dtype=torch.int64)
    assert torch.equal(rnd.fold_in(key, t), ch.fold_in(key, t))
    assert torch.equal(grid_window_shrink(key, t, 64, 3, 5), ch.shrink(key, t, 64, 3, 5))
    counts = data.corpus(3, 500, 5000, 5, 20).counts
    prob, alias = (torch.from_numpy(a) for a in ch.alias_table(counts))
    rows = torch.arange(40)
    want = sample_negatives_per_row(rnd.fold_in(key, 9), prob, alias, rows, (5,))
    assert torch.equal(want.long(), ch.negatives(key, 9, rows, 5, prob, alias))
    pool = sample_negatives(rnd.fold_in(key, 9), prob, alias, (64,))
    assert torch.equal(pool.long(), ch.pool(key, 9, 64, prob, alias))


def test_noise_table_and_keep_probabilities_are_the_programs():
    from glint_word2vec_torch.corpus.alias import build_unigram_alias
    from glint_word2vec_torch.corpus.vocab import Vocabulary

    c = data.corpus(5, 3000, 30000, 5, 20)
    t = build_unigram_alias(c.counts, power=0.75)
    prob, alias = ch.alias_table(c.counts, 0.75)
    assert np.array_equal(t.prob, prob) and np.array_equal(t.alias, alias)
    vocab = Vocabulary.from_sorted(data.words(3000), c.counts)
    assert np.array_equal(vocab.device_keep_probabilities(1e-3),
                          ref.keep_probabilities(c.counts, 1e-3))


def test_corpus_is_a_function_of_the_seed():
    a, b = data.corpus(9, 300, 3000, 5, 20), data.corpus(9, 300, 3000, 5, 20)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = data.corpus(10, 300, 3000, 5, 20)
    assert not np.array_equal(a.ids, c.ids)
    assert np.array_equal(a.counts, c.counts)
    assert np.all(np.diff(a.counts) <= 0) and a.counts.min() >= 5
    assert np.array_equal(np.bincount(a.ids, minlength=300), a.counts)


@pytest.mark.parametrize("V,N", [(300, 3000), (2000, 40000), (692000, 48500000)])
def test_zipf_counts_hold_min_count_and_follow_one_over_rank(V, N):
    c = data.zipf_counts(V, N, 5)
    assert c.sum() == N and c.min() >= 5 and np.all(np.diff(c) <= 0)
    top = c[: V // 100 + 1]
    r = np.arange(1, top.shape[0] + 1)
    assert np.all(np.abs(top * r / c[0] - 1) < 2.0 / top.min() + 1e-9)


@pytest.mark.parametrize("cell", pb_tiny.tiny_cells())
@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_reference_agrees_with_the_cpu_path(root, cell, seed):
    line = pb_tiny.run(root, cell, seed=seed)
    assert line["correct"] is True, line["checks"]
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


def test_a_nan_anywhere_fails_the_numbers():
    from perfbench import checks as chk

    nan = float("nan")
    assert np.isnan(chk.worst([1e-7, nan, 2e-7]))
    assert np.isnan(chk.loss_gap([1.0, nan], [1.0, 1.0]))
    leaf = (nan, nan, nan, nan)
    for v in chk.table_numbers({"syn0": (1.0, 1.0, 0.1, 1e-9), "syn1": leaf}).values():
        assert np.isnan(v)
    c = chk.Checks({"x": 1.0})
    c.add("x", nan)
    assert not c.correct
