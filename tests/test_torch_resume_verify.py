"""Checkpoint resolution, legacy resume, snapshot verification and the
engine's load keywords of the port against the JAX package's.

* ``resolve_train_state`` returns ``(record, snapshot_path)``, and
  ``(record, None)`` for a legacy record with no ``"ckpt"``, as the JAX
  function does on the same directories.
* A legacy checkpoint (``ckpt/syn0.npy``, ``ckpt/syn1.npy`` and a
  ``train_state.json`` with no ``"ckpt"``) resumes: on the host route
  both packages restore the same tables bitwise, and on both routes of
  the port a resumed second epoch equals the modern-layout resume
  bitwise.
* ``verify_snapshot_dir(deep=)``, ``resolve_train_state(deep=)`` and
  ``GLINT_CKPT_NO_VERIFY=1`` accept and refuse the same damaged
  directories as the JAX functions: a flipped byte only the deep check
  sees, a truncated file every check sees; ``load_tables(verify=False)``
  and ``stage_tables(verify=False)`` skip the check and leave
  ``checkpoint_shard_verify_seconds`` as it was.
* ``EmbeddingEngine.load(path, device, **overrides)`` takes the JAX
  overrides and refuses any other key; ``load_model(path, mesh=)``
  re-homes a model onto a mesh.

Tolerances: tables, records, paths and decisions compare exactly.
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_tpu.utils import integrity as jint

from glint_word2vec_torch import Word2Vec
from glint_word2vec_torch.convert import engine_from_arrays
from glint_word2vec_torch.corpus.vocab import build_vocab
from glint_word2vec_torch.parallel.engine import EmbeddingEngine
from glint_word2vec_torch.utils import integrity as pint

V, D = 50, 8
KW = dict(vector_size=8, batch_size=64, min_count=5, window=3, seed=11,
          steps_per_call=4, subsample_ratio=0.0)


def _engine(seed=0):
    rng = np.random.default_rng(seed)
    s0 = rng.normal(size=(V, D)).astype(np.float32)
    s1 = rng.normal(size=(V, D)).astype(np.float32)
    return engine_from_arrays(s0, s1, np.arange(V, 0, -1).astype(np.int64),
                              device="cpu")


def _snapshot(tmp_path, name="ckpt-1"):
    path = str(tmp_path / name)
    _engine().save(path)
    return path


def _table_file(path):
    with open(os.path.join(path, "engine.json")) as f:
        meta = json.load(f)
    if meta.get("format") == "sharded":
        return meta["shards"]["syn0"][0]["file"]
    return "syn0.npy"


def _flip_byte(path):
    fp = os.path.join(path, _table_file(path))
    with open(fp, "r+b") as f:
        f.seek(os.path.getsize(fp) - 3)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x5A]))


def _truncate(path):
    fp = os.path.join(path, _table_file(path))
    with open(fp, "r+b") as f:
        f.truncate(os.path.getsize(fp) - 16)


def _outcome(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except (jint.CheckpointCorruptError, pint.CheckpointCorruptError) as e:
        return type(e).__name__


def test_resolve_train_state_returns_the_jax_tuple(tmp_path):
    _snapshot(tmp_path)
    with open(tmp_path / "train_state.json", "w") as f:
        json.dump({"epochs_completed": 1, "step": 5, "words_done": 40,
                   "ckpt": "ckpt-1"}, f)
    got = pint.resolve_train_state(str(tmp_path))
    assert got == jint.resolve_train_state(str(tmp_path))
    assert got[1] == os.path.join(str(tmp_path), "ckpt-1")
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    with open(legacy / "train_state.json", "w") as f:
        json.dump({"epochs_completed": 1, "alpha": 0.02}, f)
    got = pint.resolve_train_state(str(legacy))
    assert got == jint.resolve_train_state(str(legacy))
    assert got == ({"epochs_completed": 1, "alpha": 0.02}, None)
    assert pint.resolve_train_state(str(tmp_path / "fresh")) is None


def _legacy_dir(tmp_path, tiny_corpus, name, tables=None, state=None):
    """A checkpoint directory in the legacy single-file layout."""
    ck = tmp_path / name
    (ck / "ckpt").mkdir(parents=True)
    if tables is None:
        n = build_vocab(tiny_corpus, min_count=KW["min_count"]).size
        rng = np.random.default_rng(5)
        tables = [rng.normal(scale=0.1, size=(n, D)).astype(np.float32)
                  for _ in range(2)]
    np.save(ck / "ckpt" / "syn0.npy", tables[0])
    np.save(ck / "ckpt" / "syn1.npy", tables[1])
    with open(ck / "train_state.json", "w") as f:
        json.dump(state or {"epochs_completed": 1, "step": 7,
                            "words_done": 1000}, f)
    return str(ck), tables


def test_legacy_resume_restores_the_jax_tables(tmp_path, tiny_corpus,
                                               monkeypatch):
    from glint_word2vec_tpu import Word2Vec as JaxWord2Vec
    from glint_word2vec_tpu.parallel.mesh import make_mesh

    monkeypatch.setenv("GLINT_HOST_BATCHER", "1")
    ck, tables = _legacy_dir(tmp_path, tiny_corpus, "ck-port")
    jck, _ = _legacy_dir(tmp_path, tiny_corpus, "ck-jax", tables=tables)
    port = Word2Vec(device="cpu", num_iterations=1, **KW).fit(
        tiny_corpus, checkpoint_dir=ck)
    jax = JaxWord2Vec(mesh=make_mesh(1, 1), num_iterations=1, **KW).fit(
        tiny_corpus, checkpoint_dir=jck)
    assert port.training_metrics["pipeline"] == "host"
    j0, j1 = jax.engine.syn0, jax.engine.syn1
    for mine, ref, theirs in ((port.engine.syn0, tables[0], j0),
                              (port.engine.syn1, tables[1], j1)):
        got = mine.numpy()[:ref.shape[0]]
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, np.asarray(theirs)[:ref.shape[0]])
    port.stop()
    jax.stop()


@pytest.mark.parametrize("route", ["device_corpus", "host"])
def test_legacy_resume_equals_the_modern_resume(tmp_path, tiny_corpus,
                                                monkeypatch, route):
    if route == "host":
        monkeypatch.setenv("GLINT_HOST_BATCHER", "1")
    corpus = tiny_corpus[:1500]
    modern = str(tmp_path / "modern")
    Word2Vec(device="cpu", num_iterations=2, **KW).fit(
        corpus, checkpoint_dir=modern, stop_after_epochs=1).stop()
    rec, snap = pint.resolve_train_state(modern)
    one = EmbeddingEngine.load(snap, device="cpu")
    state = {k: v for k, v in rec.items() if k != "ckpt"}
    legacy, _ = _legacy_dir(tmp_path, corpus, "legacy",
                            tables=[one.syn0.numpy(), one.syn1.numpy()],
                            state=state)
    a = Word2Vec(device="cpu", num_iterations=2, **KW).fit(
        corpus, checkpoint_dir=modern)
    b = Word2Vec(device="cpu", num_iterations=2, **KW).fit(
        corpus, checkpoint_dir=legacy)
    assert a.training_metrics["pipeline"] == b.training_metrics["pipeline"] \
        == route
    assert torch.equal(a.engine.syn0, b.engine.syn0)
    assert torch.equal(a.engine.syn1, b.engine.syn1)
    assert b.training_metrics["steps"] == a.training_metrics["steps"]
    a.stop()
    b.stop()


DAMAGE = {"intact": lambda p: None, "flipped": _flip_byte,
          "truncated": _truncate}


@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_verify_checks_agree_with_jax_on_damaged_dirs(tmp_path, damage,
                                                      monkeypatch):
    path = _snapshot(tmp_path)
    DAMAGE[damage](path)
    for deep in (True, False):
        got = _outcome(pint.verify_snapshot_dir, path, deep=deep)
        assert got == _outcome(jint.verify_snapshot_dir, path, deep=deep)
    deep_ok = _outcome(pint.verify_snapshot_dir, path) is True
    size_ok = _outcome(pint.verify_snapshot_dir, path, deep=False) is True
    assert (deep_ok, size_ok) == {"intact": (True, True),
                                  "flipped": (False, True),
                                  "truncated": (False, False)}[damage]
    monkeypatch.setenv("GLINT_CKPT_NO_VERIFY", "1")
    got = _outcome(pint.verify_snapshot_dir, path)
    assert got == _outcome(jint.verify_snapshot_dir, path)
    assert (got is True) == size_ok
    with open(tmp_path / "train_state.json", "w") as f:
        json.dump({"epochs_completed": 1, "step": 1, "words_done": 1,
                   "ckpt": "ckpt-1"}, f)
    monkeypatch.delenv("GLINT_CKPT_NO_VERIFY")
    for deep in (True, False):
        got = _outcome(pint.resolve_train_state, str(tmp_path), deep=deep)
        want = _outcome(jint.resolve_train_state, str(tmp_path), deep=deep)
        assert got == want if isinstance(got, tuple) else \
            isinstance(want, str)


def test_load_tables_verify_false_skips_the_check(tmp_path):
    path = _snapshot(tmp_path)
    _flip_byte(path)
    eng = _engine(seed=1)
    with pytest.raises(pint.CheckpointCorruptError):
        eng.load_tables(path)
    eng._ckpt_shard_verify_s = 12.5
    eng.load_tables(path, verify=False)
    assert eng.checkpoint_stats()["checkpoint_shard_verify_seconds"] == 12.5
    eng.adopt_tables(eng.stage_tables(path, verify=False))
    ref = _engine()
    assert torch.equal(eng.syn1, ref.syn1)
    assert not torch.equal(eng.syn0, ref.syn0)  # the flipped byte loaded
    clean = _snapshot(tmp_path, "clean")
    eng.load_tables(clean)
    assert eng.checkpoint_stats()["checkpoint_shard_verify_seconds"] != 12.5


def test_engine_load_takes_the_jax_overrides(tmp_path):
    from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
    from glint_word2vec_tpu.parallel.mesh import make_mesh

    path = _snapshot(tmp_path)
    over = dict(num_negatives=3, unigram_power=0.5, unigram_table_size=4096,
                shared_negatives=16, dtype="bfloat16")
    eng = EmbeddingEngine.load(path, "cpu", **over)
    jeng = JaxEngine.load(path, make_mesh(1, 1), **over)
    for key in ("num_negatives", "shared_negatives"):
        assert getattr(eng, key) == getattr(jeng, key) == over[key], key
    assert eng.syn0.dtype == torch.bfloat16 and jeng.syn0.dtype.name == "bfloat16"
    np.testing.assert_array_equal(
        eng.syn1.float().numpy(),
        np.asarray(jeng.syn1, np.float32)[:V])
    with pytest.raises(TypeError, match="vector_size"):
        EmbeddingEngine.load(path, "cpu", vector_size=4)


def test_load_model_takes_a_mesh(tmp_path):
    from glint_word2vec_torch.convert import model_from_arrays
    from glint_word2vec_torch.models import load_model
    from glint_word2vec_torch.parallel.mesh import make_mesh
    from glint_word2vec_torch.utils.params import Word2VecParams

    rng = np.random.default_rng(2)
    s0 = rng.normal(size=(V, D)).astype(np.float32)
    words = [f"w{i}" for i in range(V)]
    m = model_from_arrays(words, s0, s0, np.arange(V, 0, -1),
                          Word2VecParams(vector_size=D), device="cpu")
    m.save(str(tmp_path / "m"))
    m.stop()
    back = load_model(str(tmp_path / "m"),
                      mesh=make_mesh(1, 2, devices=["cpu"] * 2))
    assert back.engine.mesh.shape == {"data": 1, "model": 2}
    np.testing.assert_array_equal(back.engine.logical_table(0).numpy(), s0)
    back.stop()
    shutil.rmtree(tmp_path / "m")
