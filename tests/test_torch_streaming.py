"""Streaming training in the port (glint_word2vec_torch/streaming/, the
engine's stream hooks) against the JAX package (tests/test_streaming.py
there).

* Engine: ``set_noise_counts`` builds ``prob``/``alias`` bitwise the JAX
  engine's and installs new tensors; ``assign_extra_rows`` in one batch
  equals the rows assigned one at a time (bitwise), its init lies in
  ``U[-0.5/d, 0.5/d)`` and syn1 rows are zero; ``free_extra_rows``
  zeroes; ``upload_corpus(n_valid=)`` bounds and the refusal to compact a
  bounded view raise with the JAX messages; promoted rows widen the top-k
  mask with no new query shape.
* A packed group on an ``n_valid``-bounded buffer with promoted rows, the
  JAX package's draws injected: pair counts and positions exactly equal,
  the tables within ``test_torch_train.py``'s tolerance (rtol 1e-4, atol
  1e-6: fp32 sums in another order, compounded over the steps).
* The trainer traced: both packages' ``fit_stream`` on the shifted tiny
  corpus, at subsample 0 and 1e-3. The arguments of every
  ``upload_corpus``, ``set_noise_counts`` and ``assign_extra_rows`` call,
  the final words and counts, the promoted rows and each generation's
  name and ``words.txt`` are exactly equal. The port's stream passes the
  JAX quality gate (vienna in austria's top 10).
* The JAX publish, bounded, idle and CLI-source tests, ported; a
  port-published generation loads in the JAX package with equal vectors.
"""

import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from glint_word2vec_tpu import Word2Vec as JaxWord2Vec
from glint_word2vec_tpu import load_model as jax_load_model
from glint_word2vec_tpu.ops.device_batching import grid_window_shrink
from glint_word2vec_tpu.ops.sampling import sample_negatives_per_row
from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
from glint_word2vec_tpu.parallel.mesh import make_mesh

from glint_word2vec_torch import Word2Vec
from glint_word2vec_torch.corpus.batching import packed_pair_batch
from glint_word2vec_torch.models import load_model
from glint_word2vec_torch.parallel.engine import EmbeddingEngine
from glint_word2vec_torch.streaming.publish import (
    LATEST_NAME,
    SnapshotPublisher,
    generation_name,
    next_generation_seq,
    read_latest,
    resolve_latest,
)
from glint_word2vec_torch.utils import faults
from glint_word2vec_torch.utils.params import Word2VecParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _engines(vocab=8, dim=8, extra=4):
    counts = np.arange(vocab, 0, -1, dtype=np.int64) * 10
    je = JaxEngine(make_mesh(1, 1), vocab, dim, counts, num_negatives=2,
                   seed=3, extra_rows=extra)
    pe = EmbeddingEngine(vocab, dim, counts, num_negatives=2, seed=3,
                         extra_rows=extra, device="cpu")
    return je, pe


def _same_error(fj, fp, exc=ValueError):
    with pytest.raises(exc) as ej:
        fj()
    with pytest.raises(exc) as ep:
        fp()
    assert str(ep.value) == str(ej.value)


# ----------------------------------------------------------------------
# Engine hooks
# ----------------------------------------------------------------------


def test_set_noise_counts_bitwise_jax_and_new_tensors():
    je, pe = _engines()
    old_prob, old_alias = (t.clone() for t in pe.noise_tables())
    held = pe.noise_tables()
    rng = np.random.default_rng(0)
    for fresh in (np.array([50, 1, 1, 1, 1, 1, 1, 1], np.int64),
                  rng.integers(1, 1000, 8).astype(np.int64)):
        je.set_noise_counts(fresh)
        pe.set_noise_counts(fresh)
        prob, alias = pe.noise_tables()
        np.testing.assert_array_equal(prob.numpy(), np.asarray(je._prob))
        np.testing.assert_array_equal(alias.numpy(), np.asarray(je._alias))
        np.testing.assert_array_equal(pe._counts, fresh)
    # New tensors: a group enqueued before the refresh keeps its tables.
    assert pe.noise_tables()[0] is not held[0]
    assert torch.equal(held[0], old_prob) and torch.equal(held[1], old_alias)
    for bad in (np.ones(3, np.int64), np.zeros(8, np.int64)):
        _same_error(lambda: je.set_noise_counts(bad),
                    lambda: pe.set_noise_counts(bad))


def test_assign_extra_rows_batch_equals_singles():
    d = 8
    a = EmbeddingEngine(8, d, np.ones(8, np.int64), seed=3, extra_rows=6,
                        device="cpu")
    b = EmbeddingEngine(8, d, np.ones(8, np.int64), seed=3, extra_rows=6,
                        device="cpu")
    assert (a.extra_rows_total, a.extra_rows_free, a.queryable_rows) == (6, 6, 8)
    v0 = a.table_version
    assert a.assign_extra_rows(["x", "y", "z"]) == [8, 9, 10]
    assert a.table_version == v0 + 1  # one tick a batch
    assert [b.assign_extra_row(w) for w in "xyz"] == [8, 9, 10]
    assert b.table_version == v0 + 3
    assert torch.equal(a.syn0, b.syn0) and torch.equal(a.syn1, b.syn1)
    init = a.syn0[8:11]
    assert float(init.abs().max()) > 0
    assert bool((init >= -0.5 / d).all()) and bool((init < 0.5 / d).all())
    assert float(a.syn1[8:11].abs().max()) == 0.0
    assert (a.extra_rows_free, a.queryable_rows) == (3, 11)
    # The rows depend on their global index alone.
    assert torch.equal(a._extra_row_init(9, 2), a.syn0[9:11])
    assert a.assign_extra_rows([]) == []
    v = a.table_version
    assert a.free_extra_rows(2) == 2 and a.table_version == v + 1
    assert float(a.syn0[9:11].abs().max()) == 0.0
    assert float(a.syn1[9:11].abs().max()) == 0.0
    assert a.extra_rows_assigned == 1
    assert a.free_extra_rows(0) == 0 and a.table_version == v + 1
    # A freed row reassigned gets the same fresh init again.
    assert a.assign_extra_row("y2") == 9
    assert torch.equal(a.syn0[9], b.syn0[9])


def test_extra_row_bounds_raise_like_jax():
    je, pe = _engines(extra=2)
    _same_error(lambda: je.assign_extra_rows(["a", "b", "c"]),
                lambda: pe.assign_extra_rows(["a", "b", "c"]))
    je.assign_extra_row("a")
    pe.assign_extra_row("a")
    _same_error(lambda: je.free_extra_rows(2), lambda: pe.free_extra_rows(2))
    _same_error(lambda: je.free_extra_rows(-1), lambda: pe.free_extra_rows(-1))
    assert pe.free_extra_rows() == je.free_extra_rows() == 1


def test_upload_n_valid_bounds_and_compaction_refusal_like_jax():
    je, pe = _engines()
    ids = np.zeros(64, np.int32)
    offs = np.array([0, 32, 64], np.int64)
    for bad in (65, -1):
        _same_error(lambda: je.upload_corpus(ids, offs, n_valid=bad),
                    lambda: pe.upload_corpus(ids, offs, n_valid=bad))
    je.upload_corpus(ids, offs, n_valid=32)
    pe.upload_corpus(ids, offs, n_valid=32)
    assert pe.corpus_positions == je.corpus_positions == 64
    assert pe._active_corpus()[2] == 32
    kp = np.ones(8, np.float32)
    je.set_keep_probs(kp)
    pe.set_keep_probs(kp)
    _same_error(lambda: je.compact_corpus(jax.random.PRNGKey(0)),
                lambda: pe.compact_corpus(0))
    with pytest.raises(ValueError, match="n_valid-bounded"):
        pe.prefetch_compact_corpus(0)
    # An unbounded upload compacts again.
    pe.upload_corpus(ids, offs)
    assert pe.compact_corpus(0) == 64


def test_promoted_rows_widen_topk_with_no_new_query_shape():
    eng = EmbeddingEngine(6, 8, np.ones(6, np.int64), seed=3, extra_rows=2,
                          device="cpu")
    q = np.ones(8, np.float32)
    eng.top_k_cosine(q, 4)
    compiles = eng.query_compiles
    row = eng.assign_extra_row("grown")
    eng.write_rows(row, 100.0 * np.ones((1, 8), np.float32))
    assert row in eng.top_k_cosine(q, 4)[1].tolist()
    assert eng.query_compiles == compiles
    eng.free_extra_rows()
    assert row not in eng.top_k_cosine(q, 4)[1].tolist()
    assert eng.query_compiles == compiles


# ----------------------------------------------------------------------
# A packed group on an n_valid-bounded buffer
# ----------------------------------------------------------------------


class JaxDraws:
    """The JAX package's shrink and negative draws, for the port's
    engine (as in tests/test_torch_train.py)."""

    def __init__(self, key, jeng, window, grid_batch):
        self.key, self.jeng = key, jeng
        self.window, self.grid_batch = window, grid_batch

    def shrink(self, positions, grid_step0):
        b = grid_window_shrink(
            self.key, jnp.asarray(positions.numpy().astype(np.int32)),
            self.grid_batch, jnp.uint32(grid_step0), self.window,
        )
        return torch.from_numpy(np.asarray(b).astype(np.int64))

    def negatives(self, step, n_rows):
        k = jax.random.fold_in(self.key, jnp.uint32(step))
        negs = sample_negatives_per_row(
            k, self.jeng._prob, self.jeng._alias,
            jnp.arange(n_rows, dtype=jnp.int32), (1, self.jeng.num_negatives),
        )
        return torch.from_numpy(np.asarray(negs)[:, 0, :].astype(np.int32))


def _stream_buffer(rng, rows, buffer_words, buffer_sentences, fill_to):
    """One round's buffer as the trainer builds it: sentences of ids below
    ``rows`` up to about ``fill_to`` words, zeros past the fill, offsets of
    ``buffer_sentences + 2`` entries ending in the pad boundary."""
    ids = np.zeros(buffer_words, np.int32)
    offsets, fill = [0], 0
    while fill < fill_to and len(offsets) <= buffer_sentences:
        n = int(rng.integers(1, 25))
        ids[fill : fill + n] = rng.integers(0, rows, n)
        fill += n
        offsets.append(fill)
    offs = np.full(buffer_sentences + 2, fill, np.int64)
    offs[: len(offsets)] = offsets
    offs[-1] = buffer_words
    return ids, offs, fill


@pytest.mark.parametrize("window", [3, 5])
def test_packed_group_on_bounded_buffer_matches_jax(window):
    V, D, EXTRA, PROMOTED = 40, 16, 8, 5
    rng = np.random.default_rng(window)
    counts = np.arange(V, 0, -1).astype(np.int64) * 3
    syn0 = rng.normal(0, 0.3, (V + EXTRA, D)).astype(np.float32)
    syn1 = rng.normal(0, 0.3, (V + EXTRA, D)).astype(np.float32)
    jeng = JaxEngine(make_mesh(1, 1), V, D, counts, num_negatives=3, seed=11,
                     extra_rows=EXTRA, use_pallas=True)
    assert jeng._pallas_fused
    peng = EmbeddingEngine(V, D, counts, num_negatives=3, seed=11,
                           extra_rows=EXTRA, device="cpu")
    fresh = rng.integers(1, 500, V).astype(np.int64)
    for eng in (jeng, peng):
        eng.set_tables(syn0, syn1)
        eng.set_noise_counts(fresh)
    # Promoted rows train as centers and contexts.
    ids, offs, fill = _stream_buffer(rng, V + PROMOTED, 512, 64, 330)
    assert 300 < fill < 512 and (ids[:fill] >= V).any()
    jeng.upload_corpus(ids, offs, n_valid=fill)
    peng.upload_corpus(ids, offs, n_valid=fill)
    key = jax.random.PRNGKey(5)
    B, K = 16, 4
    P = packed_pair_batch(B, window)
    draws = JaxDraws(key, jeng, window, B)
    pos, step, groups = 0, 7, 0
    while pos < fill:
        kw = dict(step0=step, grid_step0=step, step_size=0.025,
                  total_words=1 << 50, words_base=1000)
        jout = jeng.train_steps_corpus_packed(pos, P, window, B, key, K, **kw)
        pout = peng.train_steps_corpus_packed(pos, P, window, B, 0, K, **kw,
                                              draws=draws)
        jl, jpairs, jpos, jalpha = (np.asarray(a) for a in jout)
        pl, ppairs, ppos, palpha = pout
        np.testing.assert_array_equal(ppairs, jpairs)
        np.testing.assert_array_equal(ppos, jpos)
        np.testing.assert_allclose(palpha, jalpha, rtol=1e-6)
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
        pos, step, groups = int(ppos[-1]), step + K, groups + 1
    assert groups >= 2 and pos >= fill
    for name in ("syn0", "syn1"):
        np.testing.assert_allclose(
            getattr(peng, name).numpy(),
            np.asarray(getattr(jeng, name), np.float32)[: V + EXTRA],
            rtol=1e-4, atol=1e-6, err_msg=name,
        )
    # The padding past n_valid trained nothing: rows of words absent from
    # the live prefix (and not drawn as negatives) kept their values.
    live = set(ids[:fill].tolist())
    for r in range(V + PROMOTED, V + EXTRA):
        assert r not in live
        np.testing.assert_array_equal(peng.syn0[r].numpy(), syn0[r])
        np.testing.assert_array_equal(peng.syn1[r].numpy(), syn1[r])


# ----------------------------------------------------------------------
# The trainer, traced against the JAX package's
# ----------------------------------------------------------------------


def _shift_stream(tiny_corpus, new_word="zagreb", repeats=2):
    """tests/test_streaming.py's stream: the corpus, then three passes over
    its first 300 sentences with a new word appended."""
    for s in tiny_corpus:
        yield s
    for _ in range(3):
        for s in tiny_corpus[:300]:
            yield list(s) + [new_word] * repeats


STREAM_KNOBS = dict(bootstrap_words=2000, buffer_words=4096, extra_rows=8,
                    publish_seconds=1e9, publish_words=8000,
                    promote_min_count=50, publish_keep=50)


def _traced_run(monkeypatch, engine_cls, fit, pub_dir):
    """Run ``fit(pub_dir)`` with the engine's stream hooks recording their
    arguments; returns (model, record)."""
    rec = []

    def wrap(name, conv):
        orig = getattr(engine_cls, name)

        def recorder(self, *a, **kw):
            rec.append((name, conv(*a, **kw)))
            return orig(self, *a, **kw)

        monkeypatch.setattr(engine_cls, name, recorder)

    wrap("upload_corpus", lambda ids, offsets, n_valid=None: (
        np.asarray(ids).copy(), np.asarray(offsets).copy(), n_valid))
    wrap("set_noise_counts", lambda counts: np.asarray(counts).copy())
    wrap("assign_extra_rows", lambda words: list(words))
    return fit(pub_dir), rec


def _generations(pub_dir):
    out = {}
    for e in sorted(os.listdir(pub_dir)):
        if e.startswith("gen-"):
            with open(os.path.join(pub_dir, e, "words.txt")) as f:
                out[e] = f.read()
    return out


@pytest.fixture(scope="module", params=[0.0, 1e-3], ids=["sub0", "sub1e-3"])
def traced(request, tiny_corpus, tmp_path_factory):
    ratio = request.param
    kw = dict(vector_size=32, window=3, step_size=0.025, batch_size=256,
              num_negatives=5, min_count=5, seed=1, steps_per_call=4,
              subsample_ratio=ratio)
    jdir = str(tmp_path_factory.mktemp("jax_pub"))
    pdir = str(tmp_path_factory.mktemp("port_pub"))
    with pytest.MonkeyPatch.context() as mp:
        jm, jrec = _traced_run(mp, JaxEngine, lambda d: JaxWord2Vec(
            mesh=make_mesh(1, 1), **kw).fit_stream(
                _shift_stream(tiny_corpus), publish_dir=d, **STREAM_KNOBS), jdir)
        pm, prec = _traced_run(mp, EmbeddingEngine, lambda d: Word2Vec(
            device="cpu", **kw).fit_stream(
                _shift_stream(tiny_corpus), publish_dir=d, **STREAM_KNOBS), pdir)
    yield ratio, (jm, jrec, jdir), (pm, prec, pdir)
    jm.stop()
    pm.stop()


def test_trainer_trace_equals_jax(traced):
    ratio, (jm, jrec, jdir), (pm, prec, pdir) = traced
    assert [n for n, _ in prec] == [n for n, _ in jrec]
    assert sum(n == "upload_corpus" for n, _ in prec) >= 4
    for (name, pa), (_, ja) in zip(prec, jrec):
        if name == "upload_corpus":
            np.testing.assert_array_equal(pa[0], ja[0])
            np.testing.assert_array_equal(pa[1], ja[1])
            assert pa[2] == ja[2]
            # Nothing past the fill: the padding is word 0 (zeros).
            assert not pa[0][pa[2]:].any()
        elif name == "set_noise_counts":
            np.testing.assert_array_equal(pa, ja)
        else:
            assert pa == ja
    assert any(n == "assign_extra_rows" for n, _ in prec)
    assert pm.vocab.words == jm.vocab.words
    np.testing.assert_array_equal(pm.vocab.counts, jm.vocab.counts)
    np.testing.assert_array_equal(pm.engine._counts, jm.engine._counts)
    assert pm.engine.extra_rows_assigned == jm.engine.extra_rows_assigned >= 1
    tp, tj = pm.training_metrics, jm.training_metrics
    for key in ("rounds", "words_trained", "vocab_size", "promoted_words",
                "oov_words_seen", "generations_published"):
        assert tp[key] == tj[key], key
    assert tp["pipeline"] == "stream" and tp["kernel_route"] == "plain"
    gp, gj = _generations(pdir), _generations(jdir)
    assert gp == gj and len(gp) == tp["generations_published"] >= 2
    assert read_latest(pdir)["generation"] == read_latest(jdir)["generation"]
    fills = sum(a[2] for n, a in prec if n == "upload_corpus")
    assert tp["words_trained"] == fills
    if ratio:
        # The host-side subsample draw thinned the buffers.
        assert fills < 0.9 * pm.vocab.train_words_count


def test_port_stream_grows_vocab_and_trains(traced, tiny_corpus):
    ratio, _, (pm, _, pdir) = traced
    assert "zagreb" in pm.vocab.word_index
    idx = pm.vocab.word_index["zagreb"]
    eng = pm.engine
    assert idx >= eng.vocab_size and eng.queryable_rows == pm.vocab.size
    # It trained: off its fresh init.
    init = eng._extra_row_init(idx, 1)[0].numpy()
    assert np.abs(pm.transform("zagreb") - init).max() > 1e-6
    assert len(pm.find_synonyms("zagreb", 3)) == 3
    # Counts exact: the bootstrap window counted once.
    exact = collections.Counter()
    for s in _shift_stream(tiny_corpus):
        exact.update(s)
    for w in ("austria", "vienna", "germany", "berlin"):
        assert pm.vocab.counts[pm.vocab.word_index[w]] == exact[w], w
    assert int(eng._counts.sum()) > 10_000  # live counts, past the bootstrap
    # The final generation reloads as the grown model.
    loaded = load_model(resolve_latest(pdir), device="cpu")
    assert loaded.vocab.words == pm.vocab.words
    np.testing.assert_array_equal(loaded.transform("zagreb"), pm.transform("zagreb"))
    if ratio == 0.0:
        # The JAX streaming quality gate (tests/test_streaming.py:322-327).
        assert "vienna" in dict(pm.find_synonyms("austria", 10))


def test_port_generation_loads_in_jax(traced):
    _, _, (pm, _, pdir) = traced
    jm = jax_load_model(resolve_latest(pdir))
    try:
        assert jm.vocab.words == pm.vocab.words
        for w in ("zagreb", "austria"):
            np.testing.assert_array_equal(np.asarray(jm.transform(w)),
                                          pm.transform(w))
    finally:
        jm.stop()


# ----------------------------------------------------------------------
# Publish protocol (tests/test_streaming.py:152-240, ported)
# ----------------------------------------------------------------------


class _V:
    def __init__(self, words):
        self.words = list(words)


def _engine():
    return EmbeddingEngine(8, 8, np.arange(8, 0, -1) * 10, num_negatives=2,
                           seed=3, extra_rows=4, device="cpu")


def _publisher(tmp_path, eng, keep=3):
    return SnapshotPublisher(str(tmp_path), eng, Word2VecParams(vector_size=8),
                             keep=keep)


WORDS = [f"w{i}" for i in range(8)]


def test_publish_commit_and_pointer(tmp_path):
    eng = _engine()
    pub = _publisher(tmp_path, eng)
    assert pub.publish(_V(WORDS)) == "gen-000001"
    eng.wait_pending_saves()
    latest = read_latest(str(tmp_path))
    assert latest["generation"] == "gen-000001"
    assert latest["table_version"] == eng.table_version
    gen = resolve_latest(str(tmp_path))
    for f in ("words.txt", "params.json", "matrix/manifest.json"):
        assert os.path.exists(os.path.join(gen, f))
    assert not [e for e in os.listdir(tmp_path) if ".tmp-" in e]
    assert next_generation_seq(str(tmp_path)) == 2
    assert generation_name(2) == "gen-000002"
    h = pub.history[-1]
    assert h["generation"] == "gen-000001"
    assert h["snapshot_seconds"] >= 0 and h["write_seconds"] >= 0


def test_publish_retention_keeps_last_k(tmp_path):
    eng = _engine()
    pub = _publisher(tmp_path, eng, keep=1)  # the floor is 2
    for _ in range(4):
        pub.publish(_V(WORDS))
    eng.wait_pending_saves()
    gens = sorted(e for e in os.listdir(tmp_path) if e.startswith("gen-"))
    assert gens == ["gen-000003", "gen-000004"]
    assert read_latest(str(tmp_path))["generation"] == "gen-000004"
    assert pub.published == 4


@pytest.mark.parametrize("point", ["publish.pre_commit", "publish.pre_pointer"])
def test_publish_crash_leaves_pointer_on_last_commit(tmp_path, point):
    eng = _engine()
    pub = _publisher(tmp_path, eng)
    pub.publish(_V(WORDS))
    eng.wait_pending_saves()
    faults.arm(f"{point}:exc")
    try:
        pub.publish(_V(WORDS))
        with pytest.raises(RuntimeError, match="checkpoint write failed"):
            eng.wait_pending_saves()
    finally:
        faults.disarm()
    assert read_latest(str(tmp_path))["generation"] == "gen-000001"
    assert resolve_latest(str(tmp_path)).endswith("gen-000001")
    committed = os.path.isdir(os.path.join(tmp_path, "gen-000002"))
    assert committed == (point == "publish.pre_pointer")
    # A restarted publisher prunes orphans and numbers past everything.
    pub2 = _publisher(tmp_path, eng)
    assert not [e for e in os.listdir(tmp_path) if ".tmp-" in e]
    assert pub2._seq == (3 if committed else 2)


def test_read_latest_tolerates_garbage(tmp_path):
    assert read_latest(str(tmp_path)) is None
    (tmp_path / LATEST_NAME).write_text("{not json")
    assert read_latest(str(tmp_path)) is None
    with pytest.raises(ValueError):
        read_latest(str(tmp_path), raise_errors=True)
    (tmp_path / LATEST_NAME).write_text(json.dumps({"seq": 1}))
    with pytest.raises(ValueError, match="malformed"):
        read_latest(str(tmp_path), raise_errors=True)
    (tmp_path / LATEST_NAME).write_text(json.dumps({"generation": "gen-000077"}))
    assert resolve_latest(str(tmp_path)) is None  # referenced dir missing


# ----------------------------------------------------------------------
# The streaming gauges
# ----------------------------------------------------------------------


def test_stream_gauges_match_jax_and_render(tiny_corpus, tmp_path):
    """``set_streaming`` gives the JAX heartbeat's ``streaming`` block; a
    ``fit_stream`` with a status file mirrors it, and its Prometheus text
    (``glint_stream_*``) passes the linter."""
    from glint_word2vec_tpu.obs.heartbeat import TrainingStatus as JaxStatus

    from glint_word2vec_torch.obs import ObsConfig
    from glint_word2vec_torch.obs.heartbeat import TrainingStatus
    from glint_word2vec_torch.obs.prometheus import (
        lint_prometheus_text,
        training_to_prometheus,
    )

    kw = dict(words_streamed=5, sentences_streamed=2, oov_words=1,
              vocab_size=9, promoted_words=1, extra_rows_free=3,
              sketch_fill=0.25, noise_drift_l1=0.5, stream_lag_seconds=0.1,
              generations_published=2, last_publish_unix=None, buffer_fill=0.75)
    j, p = JaxStatus(pipeline="stream"), TrainingStatus(pipeline="stream")
    j.set_streaming(**kw)
    p.set_streaming(**kw)
    assert p.snapshot(False)["streaming"] == j.snapshot(False)["streaming"]
    status = str(tmp_path / "status.json")
    w2v = _small_w2v()
    w2v.obs = ObsConfig(status_file=status)
    m = w2v.fit_stream(iter(tiny_corpus[:800]), publish_dir=str(tmp_path / "pub"),
                       bootstrap_words=1500, buffer_words=2048, extra_rows=4,
                       publish_seconds=1e9, publish_words=2048)
    with open(status) as f:
        snap = json.load(f)
    assert (snap["pipeline"], snap["state"]) == ("stream", "done")
    st = snap["streaming"]
    assert st["generations_published_total"] == m.training_metrics[
        "generations_published"] >= 2
    assert st["stream_vocab_size"] == m.vocab.size
    assert st["last_publish_age_seconds"] is not None
    text = training_to_prometheus(snap)
    lint_prometheus_text(text)
    assert "glint_stream_words_total" in text
    assert "glint_stream_last_publish_age_seconds" in text


# ----------------------------------------------------------------------
# Bounded, idle and empty streams (tests/test_streaming.py:358-524)
# ----------------------------------------------------------------------


def _small_w2v(**kw):
    return Word2Vec(device="cpu", vector_size=16, window=3, batch_size=128,
                    min_count=5, seed=2, steps_per_call=2, **kw)


def test_fit_stream_bounded_run(tiny_corpus):
    def forever():
        while True:
            yield from tiny_corpus

    m = _small_w2v().fit_stream(forever(), bootstrap_words=1500,
                                buffer_words=2048, extra_rows=4, max_words=5000)
    assert 5000 <= m.training_metrics["words_trained"] < 5000 + 2048 + 1


def test_fit_stream_empty_stream_and_unported_settings_raise(tiny_corpus):
    with pytest.raises(ValueError, match="empty stream"):
        _small_w2v().fit_stream(iter([]))
    with pytest.raises(ValueError, match="not ported yet"):
        _small_w2v(num_partitions=2).fit_stream(iter(tiny_corpus[:10]))
    with pytest.raises(ValueError, match="max_sentence_length"):
        _small_w2v().fit_stream(iter(tiny_corpus), buffer_words=512)


def test_fit_stream_idle_stream_honors_bounds_and_cadence(tiny_corpus, tmp_path):
    def trickle():
        yield from tiny_corpus[:400]
        while True:  # then silence: heartbeats only
            yield []
            time.sleep(0.01)

    pub = str(tmp_path / "pub")
    m = _small_w2v().fit_stream(
        trickle(), publish_dir=pub, bootstrap_words=1500,
        buffer_words=1 << 15, extra_rows=4, publish_seconds=0.2,
        max_seconds=2.0)
    tm = m.training_metrics
    assert 0 < tm["words_trained"] < (1 << 15)
    assert tm["generations_published"] >= 2
    assert read_latest(pub) is not None


def test_fit_stream_quiet_stream_publishes_trained_rounds(tiny_corpus, tmp_path):
    pub = str(tmp_path / "pub")
    seen = []

    def source():
        yield from tiny_corpus[:300]
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if read_latest(pub) is not None:
                seen.append(True)
                return
            yield []
            time.sleep(0.01)

    m = _small_w2v(max_sentence_length=64).fit_stream(
        source(), publish_dir=pub, bootstrap_words=500, buffer_words=512,
        publish_seconds=0.3)
    assert seen and m.training_metrics["generations_published"] >= 1


def test_fit_stream_unbounded_idle_publish(tmp_path):
    words16 = [f"w{i}" for i in range(16)]
    rng = np.random.default_rng(7)
    pub = str(tmp_path / "pub")
    seen = []

    def source():
        # 8-word sentences over 16 words at min_count 1: 64 sentences fill
        # the 512-word buffer exactly, so the quiet phase starts empty.
        for _ in range(64 + 128):
            yield list(rng.choice(words16, size=8))
        deadline = time.monotonic() + 25
        while time.monotonic() < deadline:
            if read_latest(pub) is not None:
                seen.append(True)
                return
            yield []
            time.sleep(0.01)

    Word2Vec(device="cpu", vector_size=16, window=3, batch_size=128,
             min_count=1, seed=2, steps_per_call=2,
             max_sentence_length=64).fit_stream(
        source(), publish_dir=pub, bootstrap_words=512, buffer_words=512,
        publish_seconds=4.0)
    assert seen, "idle unbounded stream never published"


def test_cli_stream_source_follow_holds_partial_lines(tmp_path):
    from glint_word2vec_torch.cli import _stream_sentences

    path = tmp_path / "feed.txt"
    path.write_text("vienna is nice\nza")
    g = _stream_sentences(str(path), follow=True, lowercase=True)
    assert next(g) == ["vienna", "is", "nice"]
    assert next(g) == []  # the dangling "za" is held
    with open(path, "a") as f:
        f.write("greb rocks\n")
    out = next(g)
    while out == []:
        out = next(g)
    assert out == ["zagreb", "rocks"]
    g.close()
    path2 = tmp_path / "batch.txt"
    path2.write_text("A b\nc d")
    assert list(_stream_sentences(str(path2), follow=False, lowercase=True)) == [
        ["a", "b"], ["c", "d"]]


def test_cli_stream_source_stdin_heartbeats_and_partial_lines(monkeypatch):
    import io

    from glint_word2vec_torch.cli import _stream_sentences

    r, w = os.pipe()
    monkeypatch.setattr("sys.stdin", io.TextIOWrapper(os.fdopen(r, "rb")))
    g = _stream_sentences("-", follow=False, lowercase=True)
    assert next(g) == []  # quiet pipe: a heartbeat, not a block
    os.write(w, b"vienna is nice\nza")
    out = next(g)
    while out == []:
        out = next(g)
    assert out == ["vienna", "is", "nice"]
    assert next(g) == []  # "za" held
    os.write(w, b"greb rocks\n")
    out = next(g)
    while out == []:
        out = next(g)
    assert out == ["zagreb", "rocks"]
    os.write(w, b"tail line")
    os.close(w)
    assert [s for s in g if s] == [["tail", "line"]]


def test_cli_fit_stream_publishes_and_kill_mid_publish(tmp_path, tiny_corpus):
    """``fit-stream`` in a child process (JAX poisoned) with
    ``publish.pre_pointer:kill@2``: LATEST stays on gen-000001, gen-000002
    is complete on disk, and a second run numbers past it."""
    corpus = tmp_path / "c.txt"
    corpus.write_text("".join(" ".join(s) + "\n" for s in tiny_corpus[:1200]))
    pub = tmp_path / "pub"
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'glint_word2vec_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from glint_word2vec_torch import cli\n"
        "sys.exit(cli.main(sys.argv[1:]))\n"
    )
    argv = [sys.executable, "-c", code, "fit-stream", "--corpus", str(corpus),
            "--publish-dir", str(pub), "--device", "cpu", "--vector-size", "8",
            "--batch-size", "64", "--window", "2", "--bootstrap-words", "2000",
            "--buffer-words", "2048", "--publish-words", "2048",
            "--publish-every", "1e9", "--extra-rows", "8",
            "--max-sentence-length", "64"]
    env = dict(os.environ, PYTHONPATH=REPO, GLINT_FAULTS="publish.pre_pointer:kill@2")
    r = subprocess.run(argv, cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == -9, r.stderr[-2000:]
    assert read_latest(str(pub))["generation"] == "gen-000001"
    gen2 = pub / "gen-000002"
    assert (gen2 / "words.txt").exists() and (gen2 / "matrix" / "manifest.json").exists()
    assert load_model(str(gen2), device="cpu").vocab.size > 0  # complete
    env.pop("GLINT_FAULTS")
    r = subprocess.run(argv + ["--max-words", "4000"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["pipeline"] == "stream" and out["generations_published"] >= 1
    assert int(read_latest(str(pub))["seq"]) >= 3


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------


@pytest.mark.cuda
def test_fit_stream_on_the_card(tiny_corpus, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the packed path's kernels have no "
                    "CPU form")
    from glint_word2vec_torch.ops import fused_sgns as fs

    before = (fs.pair_forward.launches, fs.scatter_add_rank1_hbm.launches,
              fs.scatter_add_rows_f32.launches)
    m = Word2Vec(vector_size=32, window=3, step_size=0.025, batch_size=256,
                 min_count=5, seed=1, steps_per_call=4).fit_stream(
        _shift_stream(tiny_corpus), publish_dir=str(tmp_path / "pub"),
        **STREAM_KNOBS)
    try:
        assert m.engine.device.type == "cuda"
        assert m.training_metrics["kernel_route"] == "cuda"
        after = (fs.pair_forward.launches, fs.scatter_add_rank1_hbm.launches,
                 fs.scatter_add_rows_f32.launches)
        assert all(a > b for a, b in zip(after, before))
        assert "zagreb" in m.vocab.word_index
        assert "vienna" in dict(m.find_synonyms("austria", 10))
        assert bool(torch.isfinite(m.engine.syn0).all())
    finally:
        m.stop()
