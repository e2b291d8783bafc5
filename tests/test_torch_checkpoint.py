"""Checkpoints across the two packages: the port loads every on-disk form
the JAX package writes (``single`` files, ``sharded`` row blocks, ``dims``
column blocks) and the JAX package loads what the port writes. Tables
must come back bitwise equal; a corrupted shard must raise the port's
CheckpointCorruptError."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_tpu.models.word2vec import Word2VecModel as JaxModel
from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
from glint_word2vec_tpu.parallel.mesh import make_mesh

from glint_word2vec_torch.convert import engine_from_arrays, model_from_arrays
from glint_word2vec_torch.models import load_model
from glint_word2vec_torch.parallel.engine import EmbeddingEngine
from glint_word2vec_torch.utils.integrity import CheckpointCorruptError
from glint_word2vec_torch.utils.params import Word2VecParams

V, D = 61, 12


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(V, D)).astype(np.float32),
            rng.normal(size=(V, D)).astype(np.float32),
            np.arange(V, 0, -1).astype(np.int64))


def _rounded(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()


@pytest.mark.parametrize("layout,mode,dtype", [
    ("rows", "single", "float32"),
    ("rows", "sharded", "float32"),
    ("rows", "sharded", "bfloat16"),
    ("dims", "sharded", "float32"),
])
def test_port_loads_jax_checkpoints(tmp_path, layout, mode, dtype):
    syn0, syn1, counts = _tables()
    jeng = JaxEngine(make_mesh(1, 2), V, D, counts, dtype=dtype,
                     layout=layout, num_negatives=3)
    jeng.set_tables(syn0, syn1)
    path = str(tmp_path / "ck")
    jeng.save(path, mode=mode)
    jeng.destroy()
    files = os.listdir(path)
    if mode == "sharded":
        tag = ".r" if layout == "rows" else ".c"
        assert sum(tag in f and f.endswith(".npy") for f in files) == 4

    peng = EmbeddingEngine.load(path, device="cpu")
    assert (peng.vocab_size, peng.dim, peng.dtype) == (V, D, dtype)
    assert peng.num_negatives == 3
    np.testing.assert_array_equal(peng.syn0.float().numpy(), _rounded(syn0, dtype))
    np.testing.assert_array_equal(peng.syn1.float().numpy(), _rounded(syn1, dtype))
    np.testing.assert_array_equal(peng._counts, counts)


@pytest.mark.parametrize("mode", ["sharded", "single"])
def test_jax_loads_port_engine_checkpoints(tmp_path, mode):
    syn0, syn1, counts = _tables(1)
    peng = engine_from_arrays(syn0, syn1, counts, device="cpu",
                              dtype="bfloat16", num_negatives=4)
    path = str(tmp_path / "ck")
    peng.save(path, mode=mode)
    jeng = JaxEngine.load(path, make_mesh(1, 2))
    assert (jeng.vocab_size, jeng.dim, jeng.num_negatives) == (V, D, 4)
    np.testing.assert_array_equal(
        np.asarray(jeng.syn0).astype(np.float32)[:V], _rounded(syn0, "bfloat16")
    )
    np.testing.assert_array_equal(
        np.asarray(jeng.syn1).astype(np.float32)[:V], _rounded(syn1, "bfloat16")
    )
    jeng.destroy()


def test_jax_model_loads_port_model_dir_and_resave_in_place(tmp_path):
    syn0, syn1, counts = _tables(2)
    words = [f"w{i}" for i in range(V)]
    params = Word2VecParams(vector_size=D, min_count=1, seed=9)
    pm = model_from_arrays(words, syn0, syn1, counts, params, device="cpu")
    path = str(tmp_path / "model")
    pm.save(path)
    pm.save(path)  # re-save over the existing directory, file by file
    jm = JaxModel.load(path, mesh=make_mesh(1, 2))
    assert jm.vocab.words == words
    assert json.loads(jm.params.to_json()) == json.loads(params.to_json())
    np.testing.assert_array_equal(np.asarray(jm.engine.syn0)[:V], syn0)
    np.testing.assert_array_equal(np.asarray(jm.engine.syn1)[:V], syn1)
    assert [w for w, _ in jm.find_synonyms("w3", 4)] == [
        w for w, _ in pm.find_synonyms("w3", 4)
    ]
    jm.stop()
    again = load_model(path, device="cpu")
    np.testing.assert_array_equal(again.engine.syn0.numpy(), syn0)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_corrupted_shard_raises(tmp_path, writer):
    syn0, syn1, counts = _tables(3)
    path = str(tmp_path / "ck")
    if writer == "jax":
        jeng = JaxEngine(make_mesh(1, 2), V, D, counts)
        jeng.set_tables(syn0, syn1)
        jeng.save(path)
        jeng.destroy()
    else:
        engine_from_arrays(syn0, syn1, counts, device="cpu").save(path)
    shard = sorted(f for f in os.listdir(path)
                   if f.startswith("syn0.r") and f.endswith(".npy"))[-1]
    with open(os.path.join(path, shard), "r+b") as f:
        f.seek(-5, os.SEEK_END)
        b = f.read(1)
        f.seek(-5, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(CheckpointCorruptError, match="sha256"):
        EmbeddingEngine.load(path, device="cpu")


def test_geometry_mismatch_and_partial_dir_raise(tmp_path):
    syn0, syn1, counts = _tables(4)
    path = str(tmp_path / "ck")
    engine_from_arrays(syn0, syn1, counts, device="cpu").save(path)
    other = EmbeddingEngine(V + 1, D, np.ones(V + 1), device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        other.load_tables(path)
    os.remove(os.path.join(path, "engine.json"))
    with pytest.raises(CheckpointCorruptError, match="partial"):
        other.stage_tables(path)
