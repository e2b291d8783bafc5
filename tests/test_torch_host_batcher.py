"""The host batcher of the port (``corpus/batching.SkipGramBatcher``,
``group_batches``, ``utils/prefetch.py``) against the JAX package's, and
word2vec trained through it.

* The numpy epoch pass equals the JAX package's numpy epoch pass bitwise
  (the same ``default_rng((seed, epoch))`` stream and ``words_done``), and
  the native pass the JAX package's native pass, from a sentence list and
  from the flat corpus, with and without subsampling;
  ``GLINT_W2V_NO_NATIVE=1`` gives the numpy pass.
* ``prefetch`` hands the producer thread's exception to the consumer.
* ``Word2Vec(device="cpu")`` with a device reporting too little free
  memory (``_free_device_bytes`` monkeypatched) trains ``tiny_corpus``
  through the host batcher and passes the quality gates of
  ``tests/test_model_e2e.py:50-84``; an epoch resume equals an
  uninterrupted run bitwise; its checkpoints carry the JAX package's
  host-route ``train_state.json`` keys; its learning-rate schedule
  follows the batcher's pre-subsampling words.
"""

import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_tpu.corpus import batching as jb
from glint_word2vec_tpu.corpus import vocab as jv

from glint_word2vec_torch import Word2Vec
from glint_word2vec_torch.corpus import batching as pb
from glint_word2vec_torch.corpus import vocab as pv
from glint_word2vec_torch.models import word2vec as w2v
from glint_word2vec_torch.utils.prefetch import prefetch


def _encoded(tiny_corpus, vocab_mod, batching_mod):
    voc = vocab_mod.build_vocab(tiny_corpus[:900], min_count=5)
    enc = batching_mod.chunk_sentences(
        batching_mod.encode_sentences(tiny_corpus[:900], voc), 7
    )
    return voc, enc


@pytest.mark.parametrize("block_rows", [1 << 16, 37])
@pytest.mark.parametrize("subsample_ratio", [0.0, 0.05])
def test_batches_equal_the_jax_numpy_pass(tiny_corpus, monkeypatch,
                                          subsample_ratio, block_rows):
    # 37 rows a block: batches of 64 span blocks, and blocks end mid-batch.
    monkeypatch.setattr(pb, "_BLOCK_ROWS", block_rows)
    jvoc, jenc = _encoded(tiny_corpus, jv, jb)
    pvoc, penc = _encoded(tiny_corpus, pv, pb)
    kw = dict(batch_size=64, window=4, subsample_ratio=subsample_ratio, seed=3)
    jbat = jb.SkipGramBatcher(jenc, jvoc, **kw)
    ids = np.concatenate(penc)
    offsets = np.zeros(len(penc) + 1, np.int64)
    np.cumsum([len(s) for s in penc], out=offsets[1:])
    pbats = [pb.SkipGramBatcher(penc, pvoc, **kw),
             pb.SkipGramBatcher.from_flat(ids, offsets, pvoc, **kw)]
    for epoch in (0, 1):
        want = list(jbat._epoch_python(epoch))
        assert len(want) > 3 and want[-1].mask[-1].sum() == 0  # padded tail
        for pbat in pbats:
            got = list(pbat._epoch_python(epoch))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.centers, w.centers)
                np.testing.assert_array_equal(g.contexts, w.contexts)
                np.testing.assert_array_equal(g.mask, w.mask)
                assert g.words_done == w.words_done
            assert pbat.words_done == jbat.words_done
    groups_p = list(pb.group_batches(pbats[0]._epoch_python(2), 4))
    groups_j = list(jb.group_batches(jbat._epoch_python(2), 4))
    assert len(groups_p) == len(groups_j)
    for g, w in zip(groups_p, groups_j):
        assert g.n_real == w.n_real and g.words_done == w.words_done
        for f in ("centers", "contexts", "mask"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
    assert groups_p[-1].n_real < 4  # the tail group is padded


@pytest.mark.parametrize("block_words", [4_000_000, 150])
@pytest.mark.parametrize("subsample_ratio", [0.0, 0.05])
def test_native_batches_equal_the_jax_native_pass(tiny_corpus, tmp_path,
                                                  subsample_ratio, block_words):
    # Both packages' epoch() take their native pass when it is built:
    # bitwise equal batches and words_done, from a sentence list and from
    # the flat corpus. 150 words a block: an epoch of several native
    # calls, batches spanning blocks.
    from glint_word2vec_torch import native as pnative

    from torch_jax_native import jax_native_library

    assert pnative.get_lib() is not None
    with jax_native_library(str(tmp_path)):
        _native_batches_equal(tiny_corpus, subsample_ratio, block_words)


def _native_batches_equal(tiny_corpus, subsample_ratio, block_words):
    from glint_word2vec_torch import native as pnative

    jvoc, jenc = _encoded(tiny_corpus, jv, jb)
    pvoc, penc = _encoded(tiny_corpus, pv, pb)
    kw = dict(batch_size=64, window=4, subsample_ratio=subsample_ratio, seed=3)
    jbat = jb.SkipGramBatcher(jenc, jvoc, **kw)
    jbat.NATIVE_BLOCK_WORDS = block_words
    ids = np.concatenate(penc)
    offsets = np.zeros(len(penc) + 1, np.int64)
    np.cumsum([len(s) for s in penc], out=offsets[1:])
    pbats = [pb.SkipGramBatcher(penc, pvoc, **kw),
             pb.SkipGramBatcher.from_flat(ids, offsets, pvoc, **kw)]
    calls = pnative.calls["window_batch_epoch"]
    for epoch in (0, 1):
        want = list(jbat.epoch(epoch))
        for pbat in pbats:
            pbat.NATIVE_BLOCK_WORDS = block_words
            got = list(pbat.epoch(epoch))
            assert len(got) == len(want) > 3
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.centers, w.centers)
                np.testing.assert_array_equal(g.contexts, w.contexts)
                np.testing.assert_array_equal(g.mask, w.mask)
                assert g.words_done == w.words_done
            assert pbat.words_done == jbat.words_done
    assert pnative.calls["window_batch_epoch"] > calls + 3


def test_no_native_gives_the_numpy_pass(tiny_corpus, monkeypatch):
    # GLINT_W2V_NO_NATIVE=1: epoch() is the numpy pass, which equals the
    # JAX package's numpy pass.
    monkeypatch.setenv("GLINT_W2V_NO_NATIVE", "1")
    jvoc, jenc = _encoded(tiny_corpus, jv, jb)
    pvoc, penc = _encoded(tiny_corpus, pv, pb)
    kw = dict(batch_size=64, window=4, subsample_ratio=0.05, seed=3)
    want = list(jb.SkipGramBatcher(jenc, jvoc, **kw)._epoch_python(1))
    got = list(pb.SkipGramBatcher(penc, pvoc, **kw).epoch(1))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.contexts, w.contexts)
        assert g.words_done == w.words_done


def test_window_batch_and_subsample_equal_jax():
    rng_j, rng_p = np.random.default_rng(1), np.random.default_rng(1)
    ids = np.arange(1, 30, dtype=np.int32) % 11
    kp = np.linspace(0.1, 1.0, 11)
    for _ in range(3):
        np.testing.assert_array_equal(
            pb.subsample_sentence(ids, kp, rng_p),
            jb.subsample_sentence(ids, kp, rng_j),
        )
        for a, b in zip(pb.window_batch(ids, 5, rng_p), jb.window_batch(ids, 5, rng_j)):
            np.testing.assert_array_equal(a, b)


def test_prefetch_passes_producer_errors_and_releases_it():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("producer broke")

    it = prefetch(gen(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="producer broke"):
        next(it)
    # A consumer that leaves early releases the blocked producer thread.
    before = threading.active_count()
    it = prefetch(iter(range(1000)), depth=2)
    assert next(it) == 0
    it.close()
    for t in threading.enumerate():
        if t.name == "batch-prefetch":
            t.join(timeout=5)
            assert not t.is_alive()
    assert threading.active_count() <= before
    assert list(prefetch(iter(range(5)), depth=0)) == list(range(5))


def _host_route(monkeypatch):
    monkeypatch.setattr(w2v, "_free_device_bytes", lambda device: 0)


def _tiny(**kw):
    return (
        Word2Vec(device="cpu")
        .set_vector_size(48).set_window_size(5).set_step_size(0.025)
        .set_batch_size(256).set_num_negatives(5).set_min_count(5)
        .set_num_iterations(6).set_seed(1)
    )._set(**kw)


def test_host_route_passes_quality_gates(tiny_corpus, monkeypatch):
    _host_route(monkeypatch)
    m = _tiny().fit(tiny_corpus)
    tm = m.training_metrics
    assert tm["pipeline"] == "host"
    assert tm["words_done"] == 6 * m.vocab.train_words_count
    syns = m.find_synonyms("austria", 10)
    assert "vienna" in dict(syns) and dict(syns)["vienna"] > 0.5, syns
    res = m.analogy(positive=["vienna", "germany"], negative=["austria"], num=10)
    assert "berlin" in [w for w, _ in res], res


SMALL = [
    "the quick brown fox jumps over the lazy dog".split(),
    "the dog sleeps all day long in the sun".split(),
    "a quick fox and a lazy dog meet in the field".split(),
    "the sun rises over the field every day".split(),
] * 30


def _small(**kw):
    defaults = dict(vector_size=12, batch_size=32, min_count=1,
                    num_iterations=2, seed=7, steps_per_call=4, window=3)
    defaults.update(kw)
    return Word2Vec(device="cpu", **defaults)


@pytest.mark.parametrize("subsample_ratio,dtype", [
    (0.0, "float32"), (0.05, "float32"), (0.0, "bfloat16"),
])
def test_host_route_resume_equals_uninterrupted_run(tmp_path, monkeypatch,
                                                    subsample_ratio, dtype):
    _host_route(monkeypatch)
    ck = str(tmp_path / "ck")
    kw = dict(subsample_ratio=subsample_ratio, dtype=dtype)
    first = _small(**kw).fit(SMALL, checkpoint_dir=ck, stop_after_epochs=1)
    assert first.training_metrics["pipeline"] == "host"
    state = json.load(open(os.path.join(ck, "train_state.json")))
    assert set(state) == {"epochs_completed", "step", "words_done", "ckpt"}
    assert state["epochs_completed"] == 1 and state["ckpt"] == "ckpt-1"
    words = sum(len(s) for s in SMALL)
    assert state["words_done"] == words
    assert state["step"] % 4 == 0 and state["step"] >= words // 32
    resumed = _small(**kw).fit(SMALL, checkpoint_dir=ck)
    full = _small(**kw).fit(SMALL)
    for name in ("syn0", "syn1"):
        assert torch.equal(getattr(resumed.engine, name), getattr(full.engine, name))
    assert resumed.training_metrics["words_done"] == 2 * words


def test_host_route_alphas_follow_the_batchers_words(monkeypatch):
    # The LR anneal reads the pre-subsampling words_done of each batch;
    # pad steps of a group's tail still advance the step counter.
    _host_route(monkeypatch)
    seen = []
    real = w2v.Word2Vec._train_batches

    def spy(self, engine, group, base_key, step0, alphas):
        seen.append((step0, list(group.words_done), alphas.copy(), group.n_real))
        return real(self, engine, group, base_key, step0, alphas)

    monkeypatch.setattr(w2v.Word2Vec, "_train_batches", spy)
    m = _small(num_iterations=1, subsample_ratio=0.05).fit(SMALL)
    total = m.vocab.train_words_count + 1
    assert [s for s, *_ in seen] == [4 * i for i in range(len(seen))]
    for _, wds, alphas, _ in seen:
        want = np.maximum(0.01875 * (1 - np.asarray(wds) / total), 0.01875e-4)
        np.testing.assert_allclose(alphas, want.astype(np.float32), rtol=1e-6)
    assert seen[-1][1][-1] == m.vocab.train_words_count
    assert m.training_metrics["steps"] == sum(n for *_, n in seen)


def test_grid_packing_past_the_budget_trains(monkeypatch):
    # batch_packing="grid" trains on the device corpus, and a corpus past
    # the budget trains grid batches through the host batcher under
    # either packing, as in the JAX package.
    m = _small(batch_packing="grid", num_iterations=1).fit(SMALL)
    assert m.training_metrics["pipeline"] == "device_corpus"
    assert m.training_metrics["batch_packing"] == "grid"
    _host_route(monkeypatch)
    a = _small(batch_packing="grid", num_iterations=1).fit(SMALL)
    b = _small(num_iterations=1).fit(SMALL)
    assert a.training_metrics["pipeline"] == "host"
    for name in ("syn0", "syn1"):
        assert torch.equal(getattr(a.engine, name), getattr(b.engine, name))
