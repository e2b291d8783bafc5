"""The port's streaming vocabulary (glint_word2vec_torch/corpus/
stream_vocab.py) against the JAX package's (glint_word2vec_tpu/corpus/
stream_vocab.py): the same seeded Zipf sentence stream through both
packages' ``bootstrap_stream_vocab``, ``observe``, ``promotable`` and
``promote``. Everything is host code on integers and float64, so every
comparison is exact: counts, sketch contents and errors, promotion order,
``keep_probabilities``, ``noise_counts``, ``noise_weights`` and the
snapshot's words. The JAX package's unit cases run on both packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_tpu.corpus import stream_vocab as jsv

from glint_word2vec_torch.corpus import stream_vocab as psv

BOTH = pytest.mark.parametrize("sv_mod", [jsv, psv], ids=["jax", "port"])


def _zipf_sentences(n_sentences, vocab=3000, alpha=1.15, seed=7, length=12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_sentences):
        z = rng.zipf(alpha, size=length)
        out.append([f"z{int(i)}" for i in z if i <= vocab])
    return out


def _sketch_state(sk):
    return (sk.items_seen, dict(sk._counts), dict(sk._errors))


def _assert_same(j, p):
    assert p.words == j.words
    assert p.word_index == j.word_index
    assert p.base_size == j.base_size
    np.testing.assert_array_equal(p.counts_array(), j.counts_array())
    assert (p.train_words_count, p.oov_words_seen, p.promoted) == (
        j.train_words_count, j.oov_words_seen, j.promoted)
    assert _sketch_state(p.sketch) == _sketch_state(j.sketch)


@pytest.mark.parametrize("capacity,min_count,promote_min", [
    (4096, 5, 3),   # the sketch never evicts
    (64, 8, 2),     # the sketch evicts: errors inherited
])
def test_stream_vocab_matches_jax(capacity, min_count, promote_min):
    sents = _zipf_sentences(1500)
    boot, rest = sents[:150], sents[150:]
    j = jsv.bootstrap_stream_vocab(boot, min_count=min_count,
                                   sketch_capacity=capacity)
    p = psv.bootstrap_stream_vocab(boot, min_count=min_count,
                                   sketch_capacity=capacity)
    _assert_same(j, p)
    order_j, order_p = [], []
    for k, s in enumerate(rest):
        assert p.observe(s) == j.observe(s)
        assert p.encode(s) == j.encode(s)
        if k % 97 == 0:
            cj = j.promotable(promote_min, limit=5)
            cp = p.promotable(promote_min, limit=5)
            assert cp == cj
            for (wj, ej), (wp, ep) in zip(cj, cp):
                order_j.append(j.promote(wj, ej))
                order_p.append(p.promote(wp, ep))
    assert order_p == order_j and len(order_p) > 10
    _assert_same(j, p)
    for ratio in (0.0, 1e-3, 1e-2):
        np.testing.assert_array_equal(p.keep_probabilities(ratio),
                                      j.keep_probabilities(ratio))
    np.testing.assert_array_equal(p.noise_counts(), j.noise_counts())
    np.testing.assert_array_equal(p.noise_weights(0.75), j.noise_weights(0.75))
    vj, vp = j.snapshot_vocabulary(), p.snapshot_vocabulary()
    assert vp.words == vj.words
    np.testing.assert_array_equal(vp.counts, vj.counts)
    assert vp.train_words_count == vj.train_words_count


@BOTH
def test_sketch_exact_and_eviction(sv_mod):
    sk = sv_mod.SpaceSavingSketch(capacity=64)
    for w in ["a", "b", "a", "c", "a", "b"]:
        sk.add(w)
    assert [sk.estimate(w) for w in "abc"] == [(3, 0), (2, 0), (1, 0)]
    sk = sv_mod.SpaceSavingSketch(capacity=2)
    sk.add("a", 5)
    sk.add("b", 3)
    sk.add("c")  # evicts b, inherits its count as error
    assert sk.estimate("c") == (4, 3) and "b" not in sk
    assert sk.pop("c") == (4, 3) and "c" not in sk
    sk = sv_mod.SpaceSavingSketch(capacity=2)
    sk.add("a", 10)
    sk.add("b", 8)
    sk.add("c", 5)  # est 13, err 8: guaranteed 5
    assert [w for w, _, _ in sk.over_threshold(6)] == ["a"]
    assert {w for w, _, _ in sk.over_threshold(5)} == {"a", "c"}
    with pytest.raises(ValueError):
        sv_mod.SpaceSavingSketch(0)


@BOTH
def test_observe_encode_and_bootstrap_seed(sv_mod):
    sv = sv_mod.bootstrap_stream_vocab(
        [["a", "b", "a"], ["a", "b", "c", "c"], ["rare"]], min_count=2)
    assert sv.sketch.estimate("rare") == (1, 0)
    before = sv.counts_array().copy()
    tw, oov, seen = sv.train_words_count, sv.oov_words_seen, sv.sketch.items_seen
    wi = sv.word_index
    assert sv.encode(["a", "c", "new", "b"]) == [wi["a"], wi["c"], wi["b"]]
    assert (sv.counts_array() == before).all()
    assert (sv.train_words_count, sv.oov_words_seen, sv.sketch.items_seen) == (
        tw, oov, seen)
    assert "new" not in sv.sketch
    assert sv.observe(["a", "c", "new", "b"]) == [wi["a"], wi["c"], wi["b"]]
    assert sv.oov_words_seen == oov + 1 and "new" in sv.sketch
    assert sv.counts_array()[wi["a"]] == 4


@BOTH
def test_promote_order_max_size_and_noise_span(sv_mod):
    sv = sv_mod.bootstrap_stream_vocab([["a", "a"], ["b", "b"]], min_count=2,
                                       max_size=4)
    base = sv.base_size
    sv.sketch.add("x", 5)
    sv.sketch.add("y", 7)
    sv.sketch.add("z", 9)
    assert [w for w, _ in sv.promotable(5)] == ["z", "y"]  # room for two
    assert sv.promote("z") == base and sv.promote("y") == base + 1
    assert sv.promotable(1) == []
    with pytest.raises(ValueError):
        sv.promote("x")  # at max_size
    with pytest.raises(ValueError):
        sv.promote("z")  # already in
    assert sv.train_words_count == 4 + 9 + 7
    assert sv.noise_counts().shape == (base,)
    assert abs(sv.noise_weights().sum() - 1.0) < 1e-12
    v = sv.snapshot_vocabulary()
    assert v.words == sv.words and v.size == base + 2
