"""The serving slice as a whole: a model fitted and saved by the JAX
package, loaded by the port (``load_model(..., device="cpu")``), answers
the model surface and every HTTP endpoint as the JAX package does.

Tolerances: vectors are copies of the same rows, so bitwise; sentence
means rtol 1e-6 (torch sums in another order); similarity scores within
atol 1e-5, with words equal wherever neighbouring scores differ by more
(ties may order differently)."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_tpu import Word2Vec
from glint_word2vec_tpu.models.word2vec import LocalWord2VecModel as JaxLocalModel
from glint_word2vec_tpu.parallel.mesh import make_mesh
from glint_word2vec_tpu.serving import ModelServer as JaxServer

from glint_word2vec_torch import ModelServer, load_model
from glint_word2vec_torch.models import word2vec as port_w2v

WORDS = ["austria", "vienna", "germany", "berlin", "capital", "w3"]


@pytest.fixture(scope="module")
def models(tiny_corpus, tmp_path_factory):
    jm = Word2Vec(
        mesh=make_mesh(1, 2), vector_size=16, min_count=5, batch_size=128,
        seed=2, num_iterations=2,
    ).fit(tiny_corpus)
    path = str(tmp_path_factory.mktemp("slice") / "model")
    jm.save(path)
    pm = load_model(path, device="cpu")
    yield jm, pm
    jm.stop()
    pm.stop()


@pytest.fixture(scope="module")
def servers(models):
    jm, pm = models
    js = JaxServer(jm, port=0, warmup=False)
    ps = ModelServer(pm, port=0, warmup=False)
    js.start_background()
    ps.start_background()
    yield js, ps
    js.stop()
    ps.stop()


def _assert_hits_close(want, got):
    """Lists of (word, score): scores within 1e-5, words equal where the
    neighbouring scores differ by more than that."""
    assert len(got) == len(want)
    ws = [s for _, s in want]
    np.testing.assert_allclose([s for _, s in got], ws, atol=1e-5, rtol=0)
    for j, ((w, _), (g, _)) in enumerate(zip(want, got)):
        gaps = [ws[j - 1] - ws[j] if j else np.inf,
                ws[j] - ws[j + 1] if j + 1 < len(ws) else np.inf]
        if min(gaps) > 1e-5:
            assert g == w, (j, want, got)


def test_loaded_model_has_the_saved_vocab_and_tables(models):
    jm, pm = models
    assert pm.vocab.words == jm.vocab.words
    np.testing.assert_array_equal(pm.vocab.counts, jm.vocab.counts)
    assert pm.vector_size == jm.vector_size == 16
    np.testing.assert_array_equal(
        pm.transform_words(WORDS), jm.transform_words(WORDS)
    )
    np.testing.assert_array_equal(pm.transform("vienna"), jm.transform("vienna"))
    with pytest.raises(KeyError):
        pm.transform("notaword_xyz")


@pytest.mark.parametrize("num", [3, 10])
def test_synonyms_and_analogy_match_jax(models, num):
    jm, pm = models
    for w in WORDS:
        _assert_hits_close(jm.find_synonyms(w, num), pm.find_synonyms(w, num))
    vecs = jm.transform_words(WORDS[:5])
    for want, got in zip(jm.find_synonyms_batch(vecs, num),
                         pm.find_synonyms_batch(vecs, num)):
        _assert_hits_close(want, got)
    _assert_hits_close(
        jm.find_synonyms_vector(vecs[0], num),
        pm.find_synonyms_vector(vecs[0], num),
    )
    pos, neg = ["vienna", "germany"], ["austria"]
    _assert_hits_close(jm.analogy(pos, neg, num), pm.analogy(pos, neg, num))


def test_transform_sentences_padding_and_chunking(models, monkeypatch):
    jm, pm = models
    sents = [["austria", "zzz", "vienna"], [], ["zzz"], ["berlin"] * 5,
             ["germany", "capital", "of", "w3", "w4", "w5", "w6"]]
    got = pm.transform_sentences(sents)
    np.testing.assert_allclose(got, jm.transform_sentences(sents),
                               rtol=1e-6, atol=1e-7)
    # One unpadded mean per sentence, computed directly from the rows.
    direct = np.zeros_like(got)
    for i, s in enumerate(sents):
        known = [w for w in s if w in pm.vocab]
        if known:
            direct[i] = pm.transform_words(known).mean(axis=0)
    np.testing.assert_allclose(got, direct, rtol=1e-6, atol=1e-7)
    # Past MAX_QUERY_ROWS the rows go in chunks: the same means.
    monkeypatch.setattr(port_w2v, "MAX_QUERY_ROWS", 2)
    np.testing.assert_allclose(pm.transform_sentences(sents), got,
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        pm.transform_words(WORDS), jm.transform_words(WORDS)
    )


def test_to_local_and_get_vectors(models, tmp_path):
    jm, pm = models
    local = pm.to_local()
    vecs = dict(pm.get_vectors())
    assert list(vecs) == pm.vocab.words
    np.testing.assert_array_equal(local.transform("vienna"), vecs["vienna"])
    assert local.find_synonyms("vienna", 3)[0][0] == pm.find_synonyms("vienna", 3)[0][0]
    # The local model's directory reads back in both packages.
    local.save(str(tmp_path / "local"))
    for cls in (port_w2v.LocalWord2VecModel, JaxLocalModel):
        back = cls.load(str(tmp_path / "local"))
        assert back.words == jm.vocab.words
        np.testing.assert_array_equal(back.vectors, local.vectors)
        _assert_hits_close(jm.find_synonyms("vienna", 4),
                           back.find_synonyms("vienna", 4))


def _call(server, path, payload=None):
    """(status, JSON body) of a GET (payload None) or POST."""
    url = f"http://{server.host}:{server.port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("path,payload", [
    ("/synonyms", {"word": "austria", "num": 5}),
    ("/synonyms", {"word": "vienna"}),
    ("/synonyms", {"word": "austria", "num": 0}),
    ("/synonyms_vector", {"vector": [0.5] * 16, "num": 4}),
    ("/analogy", {"positive": ["vienna", "germany"], "negative": ["austria"],
                  "num": 3}),
    ("/vector", {"word": "vienna"}),
    ("/transform", {"sentences": [["austria", "zzz"], [], ["berlin", "capital"]]}),
    ("/vector", {"word": "notaword_xyz"}),
    ("/synonyms", {"word": "notaword_xyz", "num": 5}),
    ("/synonyms", {"word": "austria", "num": -1}),
    ("/synonyms_vector", {"vector": [0.5] * 16, "num": 0}),
    ("/nosuchroute", {}),
])
def test_endpoints_answer_as_jax(servers, path, payload):
    js, ps = servers
    jcode, jbody = _call(js, path, payload)
    pcode, pbody = _call(ps, path, payload)
    assert pcode == jcode
    if jcode != 200:
        assert jcode in (400, 404) and "error" in pbody
    elif path == "/vector":
        assert pbody == jbody
    elif path == "/transform":
        np.testing.assert_allclose(pbody, jbody, rtol=1e-6, atol=1e-7)
    else:
        _assert_hits_close([tuple(x) for x in jbody], [tuple(x) for x in pbody])


def test_healthz_matches_jax(servers):
    js, ps = servers
    (jcode, jh), (pcode, ph) = _call(js, "/healthz"), _call(ps, "/healthz")
    assert jcode == pcode == 200
    for key in ("status", "model", "family", "vocab_size", "dim", "max_batch"):
        assert ph[key] == jh[key], key
    assert ph["device"] == "cpu"


def test_concurrent_synonyms_coalesce(models, servers):
    _, pm = models
    _, ps = servers
    words = pm.vocab.words[:8]
    before = ps.health()["coalescer"]["requests"]
    results = [None] * len(words)

    def hit(i):
        results[i] = _call(ps, "/synonyms", {"word": words[i], "num": 4})

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(words))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for w, (code, body) in zip(words, results):
        assert code == 200
        _assert_hits_close(pm.find_synonyms(w, 4), [tuple(x) for x in body])
    assert ps.health()["coalescer"]["requests"] == before + len(words)
