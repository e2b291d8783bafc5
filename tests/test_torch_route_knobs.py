"""The route knobs of ``Word2Vec.fit`` and the packed step's ``span=``
against the JAX package's.

* ``GLINT_HOST_BATCHER=1`` sends every corpus to the host batcher;
  ``GLINT_DEVICE_CORPUS_MAX_BYTES`` sets the corpus budget at 12 bytes a
  word with subsampling and 4 without (2 GiB by default; a value that is
  not an integer warns and keeps the default). The port decides as the
  JAX estimator's ``_device_corpus_eligible`` does on every setting, and
  its fits take the route it decides, with the free-memory check on top.
* ``train_steps_corpus_packed(span=)``: ``None`` is ``packed_span``,
  bitwise; another span gives the JAX engine's pair counts, positions
  and tables on the same draws (rtol 1e-4, atol 1e-6, as
  ``tests/test_torch_train.py``).

Tolerances: routes, spans and counts compare exactly; tables as stated.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from glint_word2vec_tpu import Word2Vec as JaxWord2Vec
from glint_word2vec_tpu.ops.device_batching import grid_window_shrink
from glint_word2vec_tpu.ops.sampling import sample_negatives_per_row
from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
from glint_word2vec_tpu.parallel.mesh import make_mesh

from glint_word2vec_torch import FastTextWord2Vec, Word2Vec
from glint_word2vec_torch.convert import engine_from_arrays
from glint_word2vec_torch.corpus.batching import context_width
from glint_word2vec_torch.models import word2vec as w2v
from glint_word2vec_torch.ops.device_batching import packed_span

SMALL = [[f"w{(i * 7 + j) % 23}" for j in range(9)] for i in range(60)]
WORDS = sum(len(s) for s in SMALL)

#: (environment, subsample ratio, corpus words).
CASES = [
    ({}, 0.0, 10), ({}, 1e-3, 10), ({}, 0.0, (2 << 30) // 4),
    ({}, 0.0, (2 << 30) // 4 + 1), ({}, 1e-3, (2 << 30) // 12 + 1),
    ({}, 0.0, 2**31),
    ({"GLINT_HOST_BATCHER": "1"}, 0.0, 10),
    ({"GLINT_HOST_BATCHER": "0"}, 0.0, 10),
    ({"GLINT_DEVICE_CORPUS_MAX_BYTES": "1"}, 0.0, 10),
    ({"GLINT_DEVICE_CORPUS_MAX_BYTES": "40"}, 0.0, 10),
    ({"GLINT_DEVICE_CORPUS_MAX_BYTES": "40"}, 0.0, 11),
    ({"GLINT_DEVICE_CORPUS_MAX_BYTES": "120"}, 1e-3, 10),
    ({"GLINT_DEVICE_CORPUS_MAX_BYTES": "119"}, 1e-3, 10),
    ({"GLINT_DEVICE_CORPUS_MAX_BYTES": "2gb"}, 0.0, 10),
]


@pytest.mark.parametrize("env,ratio,words", CASES)
def test_route_decision_equals_jax(monkeypatch, env, ratio, words):
    for k in ("GLINT_HOST_BATCHER", "GLINT_DEVICE_CORPUS_MAX_BYTES"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = Word2Vec(subsample_ratio=ratio)._device_corpus_eligible(words)
    want = JaxWord2Vec(subsample_ratio=ratio)._device_corpus_eligible(words)
    assert got == want
    assert FastTextWord2Vec()._device_corpus_eligible(words) is False


def test_a_budget_that_is_not_an_integer_warns(monkeypatch, caplog):
    monkeypatch.setenv("GLINT_DEVICE_CORPUS_MAX_BYTES", "2gb")
    with caplog.at_level(logging.WARNING, logger=w2v.__name__):
        assert Word2Vec()._device_corpus_eligible(10)
    assert "not an integer" in caplog.text


def _fit(**kw):
    return Word2Vec(device="cpu", vector_size=8, batch_size=32, min_count=1,
                    num_iterations=1, seed=3, steps_per_call=4, window=3,
                    **kw).fit(SMALL)


@pytest.mark.parametrize("env,route", [
    ({}, "device_corpus"),
    ({"GLINT_HOST_BATCHER": "1"}, "host"),
    ({"GLINT_DEVICE_CORPUS_MAX_BYTES": "1"}, "host"),
    ({"GLINT_DEVICE_CORPUS_MAX_BYTES": str(4 * WORDS)}, "device_corpus"),
    ({"GLINT_DEVICE_CORPUS_MAX_BYTES": str(4 * WORDS - 1)}, "host"),
])
def test_fit_takes_the_route_the_knobs_decide(monkeypatch, env, route):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    m = _fit()
    assert m.training_metrics["pipeline"] == route
    m.stop()


def test_knobs_apply_on_top_of_the_free_memory_check(monkeypatch):
    # A corpus the knobs allow still goes to the host when the device has
    # no room for it.
    monkeypatch.setenv("GLINT_DEVICE_CORPUS_MAX_BYTES", str(1 << 40))
    monkeypatch.setattr(w2v, "_free_device_bytes", lambda device: 0)
    m = _fit()
    assert m.training_metrics["pipeline"] == "host"
    m.stop()


V, D = 73, 16


class JaxDraws:
    """The JAX package's shrink and negative draws under its packed
    scan's keys, for the port's engine."""

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


def _engines():
    rng = np.random.default_rng(1)
    sents = [rng.integers(0, V, n).astype(np.int32)
             for n in (5, 1, 9, 3, 12, 2, 6, 30, 4, 17)]
    ids = np.concatenate(sents)
    offsets = np.zeros(len(sents) + 1, np.int64)
    np.cumsum([len(s) for s in sents], out=offsets[1:])
    counts = np.arange(V, 0, -1).astype(np.int64) * 3
    syn0 = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    syn1 = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    jeng = JaxEngine(make_mesh(1, 1), V, D, counts, num_negatives=3,
                     seed=11, use_pallas=True)
    jeng.set_tables(syn0, syn1)
    jeng.upload_corpus(ids, offsets)
    pengs = []
    for _ in range(2):
        peng = engine_from_arrays(syn0.copy(), syn1.copy(), counts,
                                  num_negatives=3, device="cpu")
        peng.upload_corpus(ids, offsets)
        pengs.append(peng)
    return jeng, pengs


P, W, B, K = 16, 3, 8, 4
KW = dict(step0=2, grid_step0=3, step_size=0.05, total_words=1000,
          words_base=7)


def test_default_span_is_packed_span_bitwise():
    jeng, (a, b) = _engines()
    key = jax.random.PRNGKey(5)
    span = packed_span(P, context_width(W))
    out_a = a.train_steps_corpus_packed(
        0, P, W, B, 0, K, **KW, draws=JaxDraws(key, jeng, W, B))
    out_b = b.train_steps_corpus_packed(
        0, P, W, B, 0, K, **KW, span=span, draws=JaxDraws(key, jeng, W, B))
    for x, y in zip(out_a, out_b):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(a.syn0, b.syn0) and torch.equal(a.syn1, b.syn1)


@pytest.mark.parametrize("span", [4, 11])
def test_explicit_span_equals_the_jax_engine(span):
    jeng, (peng, _) = _engines()
    key = jax.random.PRNGKey(5)
    jout = jeng.train_steps_corpus_packed(0, P, W, B, key, K, **KW, span=span)
    pout = peng.train_steps_corpus_packed(
        0, P, W, B, 0, K, **KW, span=span, draws=JaxDraws(key, jeng, W, B))
    jl, jpairs, jpos, jalpha = (np.asarray(a) for a in jout)
    pl, ppairs, ppos, palpha = pout
    np.testing.assert_array_equal(ppairs, jpairs)
    np.testing.assert_array_equal(ppos, jpos)
    assert ppos[-1] <= K * span
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    for name in ("syn0", "syn1"):
        np.testing.assert_allclose(
            getattr(peng, name).numpy(),
            np.asarray(getattr(jeng, name), np.float32)[:V],
            rtol=1e-4, atol=1e-6, err_msg=name)
