"""The port's reference-surface layer (glint_word2vec_torch/compat.py)
against the JAX package's (glint_word2vec_tpu/compat.py): the PySpark
binding API (``ServerSideGlintWord2Vec`` / ``ServerSideGlintWord2VecModel``).

* The camelCase setters and getters round-trip, unknown names fail, and
  the ``Word2VecParams`` a fit builds equal the JAX layer's field by field
  on a one-device topology (both fits captured before training).
* A requested topology of 4 x 2 clamps to the port's one device with the
  JAX text, and the fit passes the gates of tests/test_compat.py plus the
  tiny corpus's vienna and berlin gates of tests/test_model_e2e.py.
* A port save loads in the JAX layer and a JAX save in the port's, with
  the same top answers; the overwrite and ``parameterServerHost`` refusals
  are the JAX layer's.

Tolerances: parameters, words and strings compare exactly; the two
packages' top-3 words of a saved model agree exactly (the same tables).
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_tpu import compat as jcompat

from glint_word2vec_torch import (
    ServerSideGlintWord2Vec,
    ServerSideGlintWord2VecModel,
)
from glint_word2vec_torch import compat as pcompat


@pytest.fixture(scope="module")
def fitted(tiny_corpus):
    est = ServerSideGlintWord2Vec(
        vectorSize=48, seed=1, numPartitions=2, numParameterServers=4,
        maxIter=6, stepSize=0.025, batchSize=256, windowSize=5,
        unigramTableSize=100_000, device="cpu",
    )
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        model = est.fit(tiny_corpus)
    model.clamp_warnings = [str(x.message) for x in w]
    yield model
    model.stop()


def test_camelcase_setters_and_getters():
    for cls in (ServerSideGlintWord2Vec, jcompat.ServerSideGlintWord2Vec):
        est = cls()
        assert est.getVectorSize() == 100
        assert est.getStepSize() == 0.01875
        assert est.getBatchSize() == 50
        assert est.getN() == 5
        assert est.getMaxIter() == 1
        assert est.getNumParameterServers() == 5
        assert est.getSubsampleRatio() == 0.0
        assert est.getUnigramTableSize() is None
        est.setVectorSize(64).setWindowSize(3).setN(7)
        assert (est.getVectorSize(), est.getWindowSize(), est.getN()) == (64, 3, 7)
        est.setParams(minCount=2, maxSentenceLength=100)
        assert (est.getMinCount(), est.getMaxSentenceLength()) == (2, 100)


ROUND_TRIP = {
    "VectorSize": 32, "MinCount": 3, "NumPartitions": 4, "StepSize": 0.05,
    "MaxIter": 2, "Seed": 11, "InputCol": "tokens", "OutputCol": "vec",
    "WindowSize": 4, "MaxSentenceLength": 50, "BatchSize": 64, "N": 6,
    "SubsampleRatio": 1e-3, "NumParameterServers": 2,
    "ParameterServerHost": "", "UnigramTableSize": 10_000,
}


def test_every_setter_round_trips_as_in_jax():
    est, jest = ServerSideGlintWord2Vec(), jcompat.ServerSideGlintWord2Vec()
    for name, value in ROUND_TRIP.items():
        assert getattr(est, f"set{name}")(value) is est
        getattr(jest, f"set{name}")(value)
        assert getattr(est, f"get{name}")() == value
    assert est._kw == jest._kw
    assert pcompat.ServerSideGlintWord2Vec._PARAM_NAMES == \
        jcompat.ServerSideGlintWord2Vec._PARAM_NAMES


def test_unknown_param_rejected():
    est = ServerSideGlintWord2Vec()
    with pytest.raises(TypeError, match="numIterations"):
        est.setParams(numIterations=5)
    with pytest.raises(TypeError, match="vectorSzie"):
        ServerSideGlintWord2Vec(vectorSzie=10)


def _captured_params(module, monkeypatch, est):
    """The ``Word2VecParams`` ``est.fit`` hands its package's estimator."""
    seen = []

    class Capture:
        def __init__(self, params, **kw):
            seen.append(params)

        def fit(self, sentences):
            raise StopIteration

    monkeypatch.setattr(module, "Word2Vec", Capture)
    with pytest.raises(StopIteration):
        est.fit([["a", "b"]])
    return seen[0]


@pytest.mark.parametrize("kw", [
    {},
    {"vectorSize": 48, "seed": 1, "maxIter": 6, "stepSize": 0.025,
     "batchSize": 256, "windowSize": 5, "unigramTableSize": 100_000},
    {"minCount": 2, "n": 7, "subsampleRatio": 1e-4, "maxSentenceLength": 20},
])
def test_fit_builds_the_jax_params(monkeypatch, kw):
    kw = {"seed": 5, **kw, "numPartitions": 1, "numParameterServers": 1}
    p = _captured_params(pcompat, monkeypatch,
                         ServerSideGlintWord2Vec(device="cpu", **kw))
    j = _captured_params(jcompat, monkeypatch, jcompat.ServerSideGlintWord2Vec(**kw))
    assert dataclasses.asdict(p) == dataclasses.asdict(j)


def test_seed_none_draws_a_fresh_seed(monkeypatch):
    est = ServerSideGlintWord2Vec(seed=None, numParameterServers=1, device="cpu")
    seeds = {_captured_params(pcompat, monkeypatch, est).seed for _ in range(4)}
    assert len(seeds) > 1


def test_topology_clamps_with_the_jax_text(monkeypatch):
    with pytest.warns(UserWarning) as rec:
        pcompat._clamp_topology(4, 2, "cpu")
    assert str(rec[0].message) == (
        "requested topology 4x2 (partitions x parameter servers) clamped to "
        "mesh 1x1 for 1 device(s)")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pcompat._clamp_topology(1, 1, "cpu")
    # Four partitions and two servers never reach the estimator's
    # refusal of a multi-device topology.
    p = _captured_params(pcompat, monkeypatch, ServerSideGlintWord2Vec(
        numPartitions=4, numParameterServers=2, device="cpu"))
    assert (p.num_partitions, p.num_shards) == (1, 1)


def test_fit_clamps_and_passes_the_quality_gates(fitted):
    assert any("clamped to mesh 1x1" in w for w in fitted.clamp_warnings)
    by_word = fitted.findSynonyms("germany", 5)
    assert len(by_word) == 5 and all(isinstance(w, str) for w, _ in by_word)
    arr = fitted.findSynonymsArray(np.asarray(fitted.getVectors()[0][1]), 3)
    assert len(arr) == 3
    syns = dict(fitted.findSynonyms("austria", 10))
    assert syns.get("vienna", 0.0) > 0.5, syns
    ana = fitted._model.analogy(positive=["vienna", "germany"],
                                negative=["austria"], num=10)
    assert "berlin" in [w for w, _ in ana], ana


def test_get_vectors_and_transform(fitted):
    vecs = fitted.getVectors()
    assert len(vecs) > 50
    word, vec = vecs[0]
    assert isinstance(word, str) and vec.shape == (48,)
    out = fitted.transform([["germany", "berlin"], ["nonexistent_word"]])
    assert out.shape == (2, 48)
    assert np.linalg.norm(out[0]) > 0
    np.testing.assert_array_equal(out[1], 0)


def test_save_refuses_overwrite(fitted, tmp_path):
    path = str(tmp_path / "m")
    fitted.save(path)
    with pytest.raises(FileExistsError, match="overwrite"):
        fitted.save(path)
    fitted.write().overwrite().save(path)


def test_parameter_server_host_rejected(tiny_corpus, tmp_path):
    est = ServerSideGlintWord2Vec(parameterServerHost="10.0.0.1", device="cpu")
    with pytest.raises(ValueError, match="parameterServerHost"):
        est.fit(tiny_corpus[:10])
    with pytest.raises(ValueError, match="parameterServerHost"):
        ServerSideGlintWord2VecModel.load(str(tmp_path), parameterServerHost="h")


def test_saves_load_across_the_packages(fitted, tmp_path):
    path = str(tmp_path / "port_saved")
    fitted.write().overwrite().save(path)
    loaded = ServerSideGlintWord2VecModel.load(path, device="cpu")
    jloaded = jcompat.ServerSideGlintWord2VecModel.load(path)
    want = [w for w, _ in fitted.findSynonyms("germany", 3)]
    assert [w for w, _ in loaded.findSynonyms("germany", 3)] == want
    assert [w for w, _ in jloaded.findSynonyms("germany", 3)] == want
    jpath = str(tmp_path / "jax_saved")
    jloaded.save(jpath)
    back = ServerSideGlintWord2VecModel.load(jpath, device="cpu")
    assert [w for w, _ in back.findSynonyms("germany", 3)] == want
    for m in (loaded, jloaded, back):
        m.stop(terminateOtherClients=True)
