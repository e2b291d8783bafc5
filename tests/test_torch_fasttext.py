"""The fastText family of the port (``models/fasttext.py``,
``corpus/subword.py``) against the JAX package's.

* Subword ids: ``fnv1a_32``, ``word_ngrams``, ``subword_group`` and the
  numpy-vectorised ``build_subword_table`` equal the JAX package's,
  exactly, on ASCII and non-ASCII words (FNV-1a runs over UTF-8 bytes).
* ``FastTextWord2Vec(device="cpu").fit`` on ``tiny_corpus`` passes the
  gates of ``tests/test_fasttext.py`` (OOV cosine above 0.5, no bucket row
  in a top-k, save and ``load_model`` keep the vectors within rtol 1e-5
  and atol 1e-6).
* A fastText model saved by the JAX package loads in the port and
  composes the same vectors (rtol 1e-5, atol 1e-6: the group means sum in
  another order), and the port's save loads in the JAX package; both
  servers answer an OOV ``/vector`` alike.
* The port's server answers ``/vector`` and ``/synonyms`` of a fastText
  model through the model's own composed methods, not the coalescer's
  word-row pull.
* ``cli train --fasttext --device cpu`` trains and saves a model that
  ``load_model`` reads back as fastText.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from glint_word2vec_tpu.corpus import subword as jsw
from glint_word2vec_tpu.corpus.vocab import build_vocab as jax_build_vocab
from glint_word2vec_tpu.models.fasttext import FastTextModel as JaxFastTextModel
from glint_word2vec_tpu.models.fasttext import FastTextParams as JaxFastTextParams
from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
from glint_word2vec_tpu.parallel.mesh import make_mesh
from glint_word2vec_tpu.serving import ModelServer as JaxServer

from glint_word2vec_torch import (
    FastTextModel,
    FastTextParams,
    FastTextWord2Vec,
    ModelServer,
    load_model,
)
from glint_word2vec_torch.corpus import subword as psw
from glint_word2vec_torch.models.word2vec import Word2VecModel

# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

WORDS = ["a", "ab", "abc", "berlin", "österreich", "naïve", "日本語", "ß",
         "x🙂y", "über-straße", "<>", "antidisestablishmentarianism"]


@pytest.mark.parametrize("word", WORDS)
def test_subword_ids_equal_jax(word):
    data = word.encode("utf-8")
    assert psw.fnv1a_32(data) == jsw.fnv1a_32(data)
    for min_n, max_n in ((3, 6), (1, 2), (2, 4)):
        assert psw.word_ngrams(word, min_n, max_n) == jsw.word_ngrams(word, min_n, max_n)
        assert (psw.ngram_bucket_ids(word, 50, 997, min_n, max_n)
                == jsw.ngram_bucket_ids(word, 50, 997, min_n, max_n))
        for wid in (None, 7):
            for cap in (1, 4, 32):
                assert (psw.subword_group(word, wid, 50, 997, min_n, max_n, cap)
                        == jsw.subword_group(word, wid, 50, 997, min_n, max_n, cap))


@pytest.mark.parametrize("min_n,max_n,max_subwords,bucket", [
    (3, 6, 32, 2_000_000), (3, 5, 4, 5000), (1, 3, 9, 97), (2, 2, 2, 13),
])
def test_build_subword_table_equals_jax(monkeypatch, min_n, max_n,
                                        max_subwords, bucket):
    words = WORDS + [f"w{i}ünï" * (i % 4) + "z" for i in range(30)]
    want_ids, want_mask = jsw.build_subword_table(
        words, len(words), bucket, min_n, max_n, max_subwords)
    # Blocks of 5 words: the block edges fall inside the vocabulary.
    for block in (1 << 17, 5):
        monkeypatch.setattr(psw, "_TABLE_BLOCK", block)
        ids, mask = psw.build_subword_table(
            words, len(words), bucket, min_n, max_n, max_subwords)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(mask, want_mask)


def test_fasttext_params_validation():
    with pytest.raises(ValueError):
        FastTextParams(min_n=0)
    with pytest.raises(ValueError):
        FastTextParams(bucket=0)
    with pytest.raises(ValueError):
        FastTextParams(max_subwords=1)
    p = FastTextParams(bucket=100)
    assert FastTextParams.from_json(p.to_json()) == p
    # params.json keeps the JAX package's keys: each reads the other's.
    assert JaxFastTextParams.from_json(p.to_json()) == JaxFastTextParams(bucket=100)
    assert FastTextParams.from_json(JaxFastTextParams(bucket=100).to_json()) == p


@pytest.fixture(scope="module")
def ft_model(tiny_corpus):
    """The settings of tests/test_fasttext.py, on the CPU."""
    m = FastTextWord2Vec(
        device="cpu", vector_size=32, min_count=5, batch_size=256,
        num_iterations=4, step_size=0.025, seed=1, bucket=5000,
        min_n=3, max_n=5,
    ).fit(tiny_corpus)
    yield m
    m.stop()


def test_fasttext_trains_and_queries(ft_model):
    tm = ft_model.training_metrics
    assert tm["pipeline"] == "host"
    assert tm["words_done"] == 4 * ft_model.vocab.train_words_count
    v = ft_model.transform("austria")
    assert v.shape == (32,) and np.isfinite(v).all() and np.linalg.norm(v) > 0
    syns = ft_model.find_synonyms("austria", 5)
    assert len(syns) == 5 and "austria" not in [w for w, _ in syns]


def test_fasttext_oov_composition(ft_model):
    v_oov = ft_model.transform("austriaa")
    assert np.isfinite(v_oov).all() and np.linalg.norm(v_oov) > 0
    v = ft_model.transform("austria")
    cos = v @ v_oov / (np.linalg.norm(v) * np.linalg.norm(v_oov))
    assert cos > 0.5, f"shared-ngram word should be similar, cos={cos}"
    with pytest.raises(KeyError):
        ft_model.transform("q")


def test_fasttext_engine_rows_and_no_bucket_leakage(ft_model):
    eng = ft_model.engine
    assert eng.num_rows == ft_model.vocab.size + 5000
    sims, idx = eng.top_k_cosine(ft_model.transform("austria"), 20)
    assert np.all(idx < ft_model.vocab.size)
    # Word vectors are group means: the word row alone is another vector.
    word_row = eng.pull(np.array([ft_model.vocab.word_index["austria"]], np.int32))
    assert not np.allclose(word_row.numpy()[0], ft_model.transform("austria"))


def test_fasttext_transform_sentences_and_packed(ft_model):
    out = ft_model.transform_sentences([["austria", "zzz-unk"], [], ["vienna", "berlin"]])
    assert out.shape == (3, 32)
    assert np.linalg.norm(out[0]) > 0
    np.testing.assert_array_equal(out[1], 0)
    np.testing.assert_allclose(
        out[2], ft_model.transform_words(["vienna", "berlin"]).mean(axis=0),
        rtol=1e-6, atol=1e-7)
    wi = ft_model.vocab.word_index
    idx = np.array([[wi["austria"], 0, 0], [0, 0, 0], [wi["vienna"], wi["berlin"], 0]],
                   np.int32)
    mask = np.array([[1, 0, 0], [0, 0, 0], [1, 1, 0]], np.float32)
    np.testing.assert_array_equal(ft_model.transform_packed(idx, mask), out)


def test_fasttext_save_load_roundtrip(ft_model, tmp_path):
    path = str(tmp_path / "ft")
    ft_model.save(path)
    loaded = load_model(path, device="cpu")
    try:
        assert isinstance(loaded, FastTextModel)
        for w in ("austria", "austriaa"):
            np.testing.assert_allclose(loaded.transform(w), ft_model.transform(w),
                                       rtol=1e-5, atol=1e-6)
        local = loaded.to_local()
        np.testing.assert_allclose(local.transform("vienna"),
                                   ft_model.transform("vienna"), rtol=1e-5, atol=1e-6)
        assert [w for w, _ in loaded.get_vectors()] == loaded.vocab.words
    finally:
        loaded.stop()


SENTS = [
    "österreich wien liegt an der donau".split(),
    "berlin ist die hauptstadt von deutschland".split(),
    "wien ist die hauptstadt von österreich".split(),
    "die donau fließt durch wien".split(),
] * 3
D, BUCKET = 16, 300


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """A fastText model saved by the JAX package: seeded random tables
    over a small German vocabulary with non-ASCII words."""
    voc = jax_build_vocab(SENTS, min_count=1)
    params = JaxFastTextParams(vector_size=D, min_count=1, bucket=BUCKET,
                               min_n=2, max_n=4, max_subwords=8)
    rng = np.random.default_rng(11)
    eng = JaxEngine(make_mesh(1, 1), voc.size, D, voc.counts, seed=0,
                    extra_rows=BUCKET)
    eng.set_tables(rng.normal(0, 0.3, (voc.size + BUCKET, D)).astype(np.float32),
                   rng.normal(0, 0.3, (voc.size + BUCKET, D)).astype(np.float32))
    ids, mask = jsw.build_subword_table(voc.words, voc.size, BUCKET, 2, 4, 8)
    jm = JaxFastTextModel(voc, eng, params, ids, mask)
    path = str(tmp_path_factory.mktemp("ft_jax") / "model")
    jm.save(path)
    yield jm, path
    jm.stop()


QUERY = ["wien", "österreich", "donau", "wienn", "östereich", "fließend"]


def test_jax_saved_model_loads_and_composes_the_same(jax_saved, tmp_path):
    from glint_word2vec_tpu.models import load_model as jax_load_model

    jm, path = jax_saved
    pm = load_model(path, device="cpu")
    try:
        assert isinstance(pm, FastTextModel) and pm.vocab.words == jm.vocab.words
        np.testing.assert_array_equal(pm._sub_ids, jm._sub_ids)
        for w in QUERY:  # in the vocabulary and out of it
            np.testing.assert_allclose(pm.transform(w), jm.transform(w),
                                       rtol=1e-5, atol=1e-6, err_msg=w)
        np.testing.assert_allclose(pm.transform_sentences(SENTS[:4]),
                                   jm.transform_sentences(SENTS[:4]),
                                   rtol=1e-5, atol=1e-6)
        got, want = pm.find_synonyms("wienn", 4), jm.find_synonyms("wienn", 4)
        assert [w for w, _ in got] == [w for w, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                   atol=1e-5)
        # And the port's save reads back in the JAX package.
        pm.save(str(tmp_path / "back"))
        jb = jax_load_model(str(tmp_path / "back"), mesh=make_mesh(1, 1))
        try:
            assert isinstance(jb, JaxFastTextModel)
            for w in QUERY:
                np.testing.assert_allclose(jb.transform(w), pm.transform(w),
                                           rtol=1e-5, atol=1e-6, err_msg=w)
        finally:
            jb.stop()
    finally:
        pm.stop()


def _call(server, path, payload):
    req = urllib.request.Request(
        f"http://{server.host}:{server.port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_served_fasttext_answers_through_composed_vectors(jax_saved):
    jm, path = jax_saved
    pm = load_model(path, device="cpu")
    js = JaxServer(jm, port=0, warmup=False)
    ps = ModelServer(pm, port=0, warmup=False)
    js.start_background()
    ps.start_background()
    try:
        assert not ps._coalescer.can_batch
        for w in ("wienn", "wien", "q"):  # '<q>' has the 2-grams '<q', 'q>'
            code, vec = _call(ps, "/vector", {"word": w})
            assert code == 200
            np.testing.assert_array_equal(np.asarray(vec, np.float32), pm.transform(w))
            jcode, jvec = _call(js, "/vector", {"word": w})
            assert jcode == 200
            np.testing.assert_allclose(vec, jvec, rtol=1e-5, atol=1e-6)
            code, hits = _call(ps, "/synonyms", {"word": w, "num": 4})
            assert code == 200
            want = pm.find_synonyms(w, 4)
            assert [h[0] for h in hits] == [x for x, _ in want]
            np.testing.assert_allclose([h[1] for h in hits], [s for _, s in want],
                                       atol=1e-6)
    finally:
        ps.stop()
        js.stop()
        pm.stop()


def test_served_word_without_ngrams_is_404(ft_model):
    # min_n = 3: '<q>' has no 3-gram but the whole token.
    ps = ModelServer(ft_model, port=0, warmup=False)
    ps.start_background()
    try:
        assert _call(ps, "/vector", {"word": "q"})[0] == 404
        assert _call(ps, "/synonyms", {"word": "q", "num": 3})[0] == 404
        code, vec = _call(ps, "/vector", {"word": "austriaa"})
        assert code == 200
        np.testing.assert_array_equal(np.asarray(vec, np.float32),
                                      ft_model.transform("austriaa"))
    finally:
        ps.stop()


def test_word_level_models_keep_the_batched_path(jax_saved):
    from glint_word2vec_torch.serving import _SynonymCoalescer

    _, path = jax_saved
    pm = load_model(path, device="cpu")
    try:
        assert not _SynonymCoalescer(pm, None).can_batch
        wm = Word2VecModel(pm.vocab, pm.engine, pm.params)
        assert _SynonymCoalescer(wm, None).can_batch
    finally:
        pm.stop()


def test_cli_train_fasttext_on_cpu(tmp_path, capsys):
    from glint_word2vec_torch import cli

    corpus = tmp_path / "c.txt"
    corpus.write_text("".join(" ".join(s) + "\n" for s in SENTS * 5))
    out = tmp_path / "m"
    rc = cli.main([
        "train", "--fasttext", "--corpus", str(corpus), "--output", str(out),
        "--device", "cpu", "--vector-size", "8", "--batch-size", "32",
        "--min-count", "1", "--iterations", "1", "--window", "3",
        "--bucket", "200", "--min-n", "2", "--max-n", "4",
        "--max-subwords", "6",
    ])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["saved"] == str(out) and line["pipeline"] == "host"
    m = load_model(str(out), device="cpu")
    try:
        assert isinstance(m, FastTextModel)
        p = m.params
        assert (p.bucket, p.min_n, p.max_n, p.max_subwords) == (200, 2, 4, 6)
        assert m.engine.num_rows == m.vocab.size + 200
        assert np.isfinite(m.transform("wienn")).all()
    finally:
        m.stop()
