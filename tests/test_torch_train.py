"""Training with the port (glint_word2vec_torch) against the JAX package.

* K packed steps of the port's engine against the JAX engine's
  ``train_steps_corpus_packed`` with its Pallas kernels (interpret mode,
  ``use_pallas=True`` on ``make_mesh(1, 1)``), from identical tables
  (``set_tables``) and with the JAX package's own draws handed to the
  port. The tables agree within rtol 1e-4 and atol 1e-6 (fp32 sums in
  another order, compounded over the steps); pair counts and positions
  are exact; alphas agree within rel 1e-6.
* ``Word2Vec(device="cpu").fit`` on ``tiny_corpus`` passes the quality
  gates of ``tests/test_model_e2e.py:50-84``, with and without
  subsampling, over the JAX package's vocabulary and encoding.
* Epoch resume equals an uninterrupted run bitwise; a port-trained model
  loads in the JAX package with the same vectors; the ``train`` CLI runs.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from glint_word2vec_tpu.ops.device_batching import grid_window_shrink
from glint_word2vec_tpu.ops.sampling import sample_negatives_per_row
from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
from glint_word2vec_tpu.parallel.mesh import make_mesh

from glint_word2vec_torch import Word2Vec
from glint_word2vec_torch.convert import engine_from_arrays

V, D = 73, 16


def _corpus(seed=0, lens=(5, 1, 9, 3, 12, 2, 6, 30, 4, 17)):
    rng = np.random.default_rng(seed)
    sents = [rng.integers(0, V, L).astype(np.int32) for L in lens]
    ids = np.concatenate(sents)
    offsets = np.zeros(len(sents) + 1, np.int64)
    np.cumsum([len(s) for s in sents], out=offsets[1:])
    return ids, offsets


class JaxDraws:
    """The JAX package's shrink and negative draws, for the port's
    engine: the same functions its packed scan calls, under the same
    keys."""

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


@pytest.mark.parametrize("window,subsample", [(3, False), (5, True)])
def test_packed_steps_match_jax_engine(window, subsample):
    ids, offsets = _corpus()
    rng = np.random.default_rng(1)
    counts = np.arange(V, 0, -1).astype(np.int64) * 3
    syn0 = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    syn1 = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    jeng = JaxEngine(make_mesh(1, 1), V, D, counts, num_negatives=3,
                     seed=11, use_pallas=True)
    assert jeng._pallas_fused
    jeng.set_tables(syn0, syn1)
    peng = engine_from_arrays(syn0, syn1, counts, num_negatives=3, device="cpu")
    jeng.upload_corpus(ids, offsets)
    peng.upload_corpus(ids, offsets)
    if subsample:
        kp = np.linspace(0.2, 1.0, V).astype(np.float32)
        jeng.set_keep_probs(kp)
        peng.set_keep_probs(kp)
        ekey = jax.random.fold_in(jax.random.PRNGKey(5), 0)
        from glint_word2vec_tpu.ops.device_batching import subsample_keep_mask

        keep = np.array(subsample_keep_mask(
            jnp.asarray(ids), jnp.asarray(kp), ekey
        ))
        n_j = jeng.compact_corpus(ekey)
        n_p = peng.compact_corpus(0, keep=torch.from_numpy(keep))
        assert n_j == n_p < len(ids)
        np.testing.assert_array_equal(
            peng.compacted_offsets(), jeng.compacted_offsets()
        )
    key = jax.random.PRNGKey(5)
    P, B, K = 16, 8, 4
    kw = dict(step0=2, grid_step0=3, step_size=0.05, total_words=1000,
              words_base=7)
    jout = jeng.train_steps_corpus_packed(0, P, window, B, key, K, **kw)
    pout = peng.train_steps_corpus_packed(
        0, P, window, B, 0, K, **kw, draws=JaxDraws(key, jeng, window, B)
    )
    jl, jpairs, jpos, jalpha = (np.asarray(a) for a in jout)
    pl, ppairs, ppos, palpha = pout
    np.testing.assert_array_equal(ppairs, jpairs)
    np.testing.assert_array_equal(ppos, jpos)
    assert jpos[-1] > jpos[0] > 0
    np.testing.assert_allclose(palpha, jalpha, rtol=1e-6)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    for name in ("syn0", "syn1"):
        np.testing.assert_allclose(
            getattr(peng, name).numpy(),
            np.asarray(getattr(jeng, name), np.float32)[:V],
            rtol=1e-4, atol=1e-6, err_msg=name,
        )
    assert peng.table_version == 2  # set_tables, then one training call


def _tiny_fit(corpus, **kw):
    w2v = (
        Word2Vec(device="cpu")
        .set_vector_size(48).set_window_size(5).set_step_size(0.025)
        .set_batch_size(256).set_num_negatives(5).set_min_count(5)
        .set_num_iterations(6).set_seed(1)
    )
    return w2v._set(**kw).fit(corpus)


@pytest.mark.parametrize("subsample_ratio,dtype", [
    (0.0, "float32"), (0.03, "float32"), (0.0, "bfloat16"),
])
def test_fit_passes_quality_gates(tiny_corpus, subsample_ratio, dtype):
    # The gates of tests/test_model_e2e.py:50-84, same settings; bf16
    # tables sum each run in fp32 and round once, as the JAX kernels do.
    m = _tiny_fit(tiny_corpus, subsample_ratio=subsample_ratio, dtype=dtype)
    assert m.engine.syn0.dtype == getattr(torch, dtype)
    tm = m.training_metrics
    assert tm["pipeline"] == "device_corpus" and tm["batch_packing"] == "dense"
    assert tm["packed_mask_density"] >= 0.9
    assert tm["words_done"] == 6 * m.vocab.train_words_count
    syns = m.find_synonyms("austria", 10)
    words = [w for w, _ in syns]
    assert "vienna" in words, f"vienna not in {words}"
    assert dict(syns)["vienna"] > 0.5, syns
    res = m.analogy(positive=["vienna", "germany"], negative=["austria"], num=10)
    assert "berlin" in [w for w, _ in res], res


def test_vocab_and_encoding_equal_jax(tiny_corpus, tmp_path):
    from glint_word2vec_tpu.corpus import batching as jb
    from glint_word2vec_tpu.corpus import vocab as jv

    from glint_word2vec_torch.corpus import batching as pb
    from glint_word2vec_torch.corpus import vocab as pv

    corpus = tiny_corpus + [["w1"] * 23]  # one sentence past the chunk length
    jvoc = jv.build_vocab(corpus, min_count=5)
    pvoc = pv.build_vocab(corpus, min_count=5)
    assert pvoc.words == jvoc.words
    np.testing.assert_array_equal(pvoc.counts, jvoc.counts)
    assert pvoc.train_words_count == jvoc.train_words_count
    np.testing.assert_array_equal(
        pvoc.device_keep_probabilities(0.03), jvoc.device_keep_probabilities(0.03)
    )
    je = jb.chunk_sentences(jb.encode_sentences(corpus, jvoc), 10)
    pe = pb.chunk_sentences(pb.encode_sentences(corpus, pvoc), 10)
    assert len(pe) == len(je)
    assert all(np.array_equal(a, b) for a, b in zip(pe, je))

    js = jv.scan_and_encode_stream(iter(corpus), min_count=5, max_sentence_length=10)
    ps = pv.scan_and_encode_stream(iter(corpus), min_count=5, max_sentence_length=10)
    path = tmp_path / "corpus.txt"
    path.write_text("".join(" ".join(s) + "\n" for s in corpus) + "\n")
    jf = jv.scan_and_encode_file(str(path), min_count=5, max_sentence_length=10)
    pf = pv.scan_and_encode_file(str(path), min_count=5, max_sentence_length=10)
    for (pvc, pids, poffs), (jvc, jids, joffs) in ((ps, js), (pf, jf)):
        assert pvc.words == jvc.words == jvoc.words
        np.testing.assert_array_equal(pvc.counts, jvc.counts)
        np.testing.assert_array_equal(pids, jids)
        np.testing.assert_array_equal(poffs, joffs)
    np.testing.assert_array_equal(ps[1], np.concatenate(pe))


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


@pytest.mark.parametrize("subsample_ratio", [0.0, 0.05])
def test_epoch_resume_equals_uninterrupted_run(tmp_path, subsample_ratio):
    ck = str(tmp_path / "ck")
    first = _small(subsample_ratio=subsample_ratio).fit(
        SMALL, checkpoint_dir=ck, stop_after_epochs=1
    )
    state = json.load(open(os.path.join(ck, "train_state.json")))
    assert state["epochs_completed"] == 1 and state["ckpt"] == "ckpt-1"
    assert state["position"] == 0 and state["batch_packing"] == "dense"
    assert state["gstep"] > 0 and state["step"] > 0
    assert first.training_metrics["words_done"] == first.vocab.train_words_count
    resumed = _small(subsample_ratio=subsample_ratio).fit(SMALL, checkpoint_dir=ck)
    full = _small(subsample_ratio=subsample_ratio).fit(SMALL)
    for name in ("syn0", "syn1"):
        assert torch.equal(getattr(resumed.engine, name), getattr(full.engine, name))
    state = json.load(open(os.path.join(ck, "train_state.json")))
    assert state["epochs_completed"] == 2 and state["prev"]["ckpt"] == "ckpt-1"


def test_stream_input_trains_as_the_list():
    # A one-pass iterable goes through scan_and_encode_stream, a list
    # through build_vocab + encode: same vocabulary, ids and tables.
    a = _small(num_iterations=1).fit(iter(SMALL))
    b = _small(num_iterations=1).fit(SMALL)
    assert a.vocab.words == b.vocab.words
    for name in ("syn0", "syn1"):
        assert torch.equal(getattr(a.engine, name), getattr(b.engine, name))


def test_port_model_loads_in_jax_package(tmp_path):
    from glint_word2vec_tpu.models.word2vec import Word2VecModel as JaxModel

    m = _small(num_iterations=1).fit(SMALL)
    m.save(str(tmp_path / "m"))
    jm = JaxModel.load(str(tmp_path / "m"), mesh=make_mesh(1, 1))
    try:
        words = ["fox", "dog", "field"]
        np.testing.assert_array_equal(
            np.asarray(jm.transform_words(words)), m.transform_words(words)
        )
        assert jm.vocab.words == m.vocab.words
    finally:
        jm.stop()


def test_cli_train_on_cpu(tmp_path, capsys):
    from glint_word2vec_torch import cli
    from glint_word2vec_torch.models import load_model

    corpus = tmp_path / "c.txt"
    corpus.write_text("".join(" ".join(s) + "\n" for s in SMALL))
    out = tmp_path / "m"
    rc = cli.main([
        "train", "--corpus", str(corpus), "--output", str(out),
        "--device", "cpu", "--vector-size", "8", "--batch-size", "32",
        "--min-count", "1", "--iterations", "1", "--window", "3",
        "--metrics-out", str(tmp_path / "metrics.json"),
    ])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["saved"] == str(out) and line["pipeline"] == "device_corpus"
    assert json.load(open(tmp_path / "metrics.json"))["steps"] == line["steps"]
    m = load_model(str(out), device="cpu")
    assert m.vector_size == 8 and "fox" in m.vocab


# The ids the cases had while grid packing (kw0) was among them.
@pytest.mark.parametrize("kw,what", [
    pytest.param({"num_shards": 2}, "multi-device", id="kw1-multi-device"),
    pytest.param({"num_partitions": 2}, "multi-device", id="kw2-multi-device"),
    pytest.param({"exchange": "sparse"}, "replica exchange",
                 id="kw3-replica exchange"),
    pytest.param({"layout": "dims"}, "dims layout", id="kw4-dims layout"),
])
def test_unported_settings_raise(kw, what):
    with pytest.raises(ValueError, match=what):
        _small(**kw).fit(SMALL)


def test_budget_overflow_raises(monkeypatch):
    # A corpus past the device budget no longer raises: it trains through
    # the host batcher, as in the JAX package.
    from glint_word2vec_torch.models import word2vec as w2v

    monkeypatch.setattr(w2v, "_free_device_bytes", lambda device: 16)
    m = _small().fit(SMALL)
    assert m.training_metrics["pipeline"] == "host"
    assert m.training_metrics["words_done"] == 2 * m.vocab.train_words_count


@pytest.mark.parametrize("subsample_ratio", [0.0, 0.03])
def test_device_budget_follows_free_memory(monkeypatch, subsample_ratio):
    # The resident fit takes what its estimate says: it trains when
    # DEVICE_MEMORY_FRACTION of the free memory covers the estimate, and
    # the host batcher takes the corpus when one byte more would be
    # needed.
    from glint_word2vec_torch.models import word2vec as w2v

    est = _small(num_iterations=1, subsample_ratio=subsample_ratio)
    needs = []
    real = w2v.Word2Vec._device_bytes_needed
    monkeypatch.setattr(
        w2v.Word2Vec, "_device_bytes_needed",
        lambda self, *a: needs.append(real(self, *a)) or needs[-1],
    )
    est.fit(SMALL)
    need = needs[-1]
    words = sum(len(s) for s in SMALL)
    per_word = (w2v.SUBSAMPLED_CORPUS_BYTES_PER_WORD if subsample_ratio
                else w2v.CORPUS_BYTES_PER_WORD)
    assert need > words * per_word
    fits = int(need / w2v.DEVICE_MEMORY_FRACTION) + 1
    monkeypatch.setattr(w2v, "_free_device_bytes", lambda device: fits)
    assert est.fit(SMALL).training_metrics["pipeline"] == "device_corpus"
    monkeypatch.setattr(w2v, "_free_device_bytes", lambda device: fits - 2)
    assert est.fit(SMALL).training_metrics["pipeline"] == "host"
