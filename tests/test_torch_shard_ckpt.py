"""Shard-streaming checkpoints of the port's mesh engine, the seven cases
of tests/test_shard_ckpt.py: one block and one sidecar manifest per model
shard, a save and a restore that hold one shard in host memory at a time,
the fallback past a corrupt shard to the previous committed snapshot,
skip-clean in-place re-saves, the replica save split, the asynchronous
save and the ``ckpt.shard_commit`` fault point. Each case also holds the
port's directory against the JAX package's: the JAX engine on the same
mesh shape loads it (and the port loads the JAX engine's) with the same
tables.

Tolerances: file names, counts and tables compare exactly.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
from glint_word2vec_tpu.parallel.mesh import make_mesh as jax_mesh

from glint_word2vec_torch.parallel import mesh as pmesh
from glint_word2vec_torch.parallel.engine import EmbeddingEngine
from glint_word2vec_torch.utils import faults, integrity

V, D = 203, 16


def _mesh(shape=(1, 2)):
    return pmesh.make_mesh(*shape, devices=["cpu"] * 8)


def _engine(mesh=None, seed=3):
    counts = np.random.default_rng(1).integers(1, 100, V)
    return EmbeddingEngine(V, D, counts, seed=seed, mesh=mesh or _mesh())


def _step(engine, seed=0, alpha=0.025):
    rng = np.random.default_rng(seed)
    engine.train_step(
        rng.integers(0, V, 32).astype(np.int32),
        rng.integers(0, V, (32, 4)).astype(np.int32),
        np.ones((32, 4), np.float32), seed, alpha,
    )


def _syn0(eng):
    if isinstance(eng, EmbeddingEngine):
        return eng.logical_table(0).float().numpy()[:V, :D]
    return np.asarray(eng.syn0, np.float32)[:V, :D]


def test_per_shard_manifests_and_verify(tmp_path):
    eng = _engine()
    _step(eng)
    _step(eng, seed=1)
    path = str(tmp_path / "snap")
    eng.save(path)
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert man["version"] == 2
    assert man["shard_files"] == [
        "syn0.r000000000000.npy", "syn0.r000000000102.npy",
        "syn1.r000000000000.npy", "syn1.r000000000102.npy"]
    for fname in man["shard_files"]:
        side = os.path.join(path, fname + integrity.SHARD_MANIFEST_SUFFIX)
        ent = json.load(open(side))["file"]
        assert ent["size"] == os.path.getsize(os.path.join(path, fname))
    assert integrity.verify_snapshot_dir(path) is True
    # The JAX engine on the same mesh reads the port's blocks.
    j = JaxEngine.load(path, jax_mesh(1, 2))
    np.testing.assert_array_equal(_syn0(j), _syn0(eng))
    bad = man["shard_files"][-1]
    with open(os.path.join(path, bad), "r+b") as f:
        f.seek(300)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(integrity.CheckpointCorruptError) as ei:
        integrity.verify_snapshot_dir(path)
    assert bad in str(ei.value)
    eng.destroy()


def test_save_restore_peak_bounded_by_one_shard(tmp_path):
    eng = _engine()
    _step(eng)
    path = str(tmp_path / "snap")
    eng.save(path)
    st = eng.checkpoint_stats()
    table_bytes = eng.padded_vocab * eng.padded_dim * 4
    shard_bytes = (eng.padded_vocab // 2) * eng.padded_dim * 4
    slack = V * 8 + 4096
    assert st["checkpoint_peak_block_bytes"] <= shard_bytes + slack, st
    assert st["checkpoint_peak_block_bytes"] < table_bytes
    assert st["checkpoint_shard_write_seconds"] is not None
    dst = _engine(_mesh((1, 2)), seed=7)
    dst.adopt_tables(dst.stage_tables(path))
    np.testing.assert_array_equal(_syn0(dst), _syn0(eng))
    assert 0 < dst._stage_peak_block_bytes <= table_bytes // 2 + 4096
    assert dst.checkpoint_stats()["checkpoint_shard_verify_seconds"] is not None
    eng.destroy()
    dst.destroy()


def test_corrupt_shard_falls_back_to_previous_snapshot(tmp_path):
    eng = _engine()
    _step(eng)
    ck1 = str(tmp_path / "ckpt-1")
    eng.save(ck1)
    _step(eng, seed=2)
    ck2 = str(tmp_path / "ckpt-2")
    eng.save(ck2)
    state = {"epochs_completed": 2, "step": 2, "words_done": 64,
             "ckpt": "ckpt-2",
             "prev": {"epochs_completed": 1, "step": 1, "words_done": 32,
                      "ckpt": "ckpt-1"}}
    with open(tmp_path / "train_state.json", "w") as f:
        json.dump(state, f)
    rec, path = integrity.resolve_train_state(str(tmp_path))
    assert (rec["ckpt"], path) == ("ckpt-2", ck2)
    shard = json.load(open(os.path.join(ck2, "manifest.json")))["shard_files"][0]
    with open(os.path.join(ck2, shard), "r+b") as f:
        f.seek(128)
        f.write(b"\x00" * 8 + b"\xff" * 8)
    rec, path = integrity.resolve_train_state(str(tmp_path))
    assert (rec["ckpt"], path) == ("ckpt-1", ck1)
    eng.destroy()


def test_skip_clean_shards_in_place(tmp_path):
    eng = _engine()
    _step(eng)
    path = str(tmp_path / "model")
    eng.save(path)
    assert eng.checkpoint_stats()["checkpoint_shards_skipped"] == 0
    eng.save(path)  # nothing changed: all 4 shard files skip
    assert eng.checkpoint_stats()["checkpoint_shards_skipped"] == 4
    _step(eng, seed=2)  # a mutation: everything dirty again
    eng.save(path)
    assert eng.checkpoint_stats()["checkpoint_shards_skipped"] == 4
    per_shard = eng.padded_vocab // 2
    touched = np.arange(4, dtype=np.int64)
    assert touched.max() < per_shard
    eng.exchange_adopt(eng.logical_table(0), eng.logical_table(1),
                       touched_ids=touched)
    eng.save(path)
    assert eng.checkpoint_stats()["checkpoint_shards_skipped"] == 6
    assert integrity.verify_snapshot_dir(path) is True
    _step(eng, seed=3)  # unknown mutation, then a narrow mark
    eng.exchange_adopt(eng.logical_table(0), eng.logical_table(1),
                       touched_ids=touched)
    before = eng.checkpoint_stats()["checkpoint_shards_skipped"]
    eng.save(path)
    assert eng.checkpoint_stats()["checkpoint_shards_skipped"] == before
    assert integrity.verify_snapshot_dir(path) is True
    j = JaxEngine.load(path, jax_mesh(2, 1))
    np.testing.assert_array_equal(_syn0(j), _syn0(eng))
    eng.destroy()


def test_exchange_round_narrows_the_skip_clean_save(tmp_path):
    # A replica-exchange round hands exchange_adopt the rows it changed:
    # a rank that saved, took no step since and adopts another rank's
    # deltas re-writes only the row blocks that hold them.
    from glint_word2vec_torch.parallel import exchange as pex

    a, b = _engine(), _engine()
    xa, xb = (pex.ReplicaExchanger(e, mode="sparse", capacity=64) for e in (a, b))
    path = str(tmp_path / "model")
    a.save(path)
    a.save(path)
    skipped = a.checkpoint_stats()["checkpoint_shards_skipped"]
    assert skipped == 4
    rows = np.random.default_rng(4).normal(size=(6, D)).astype(np.float32)
    assert 3 + 6 <= a.rows_per_shard
    b.write_rows(3, rows)
    pex.sync_group([xa, xb])
    assert torch.equal(a.logical_table(0), b.logical_table(0))
    a.save(path)
    # Block 1 of both tables is clean: two files skip, block 0's rewrite.
    assert a.checkpoint_stats()["checkpoint_shards_skipped"] == skipped + 2
    assert integrity.verify_snapshot_dir(path) is True
    back = EmbeddingEngine.load(path, mesh=_mesh())
    np.testing.assert_array_equal(_syn0(back), _syn0(b))
    # base + (rows - base): the written rows to an fp32 rounding.
    np.testing.assert_allclose(_syn0(back)[3:9], rows, rtol=1e-5, atol=1e-6)
    j = JaxEngine.load(path, jax_mesh(1, 2))
    np.testing.assert_array_equal(np.asarray(j.syn0, np.float32)[:V, :D], _syn0(b))
    for e in (a, b, back):
        e.destroy()


def test_replica_save_split_assembles_and_reloads(tmp_path):
    e0 = _engine(_mesh((1, 1)))
    e1 = _engine(_mesh((1, 1)))
    _step(e0)
    _step(e1)
    np.testing.assert_array_equal(_syn0(e0), _syn0(e1))
    e0.set_save_split(0, 2)
    e1.set_save_split(1, 2)
    path = str(tmp_path / "snap")
    e0.save(path)
    per_shard = -(-e0.padded_vocab // 2)
    r1_block = f"syn0.r{per_shard:012d}.npy"
    assert os.path.exists(os.path.join(path, "syn0.r000000000000.npy"))
    assert not os.path.exists(os.path.join(path, r1_block))
    e1.save(path)
    assert os.path.exists(os.path.join(path, r1_block))
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert len(man["shard_files"]) == 4
    assert integrity.verify_snapshot_dir(path) is True
    dst = _engine(_mesh((1, 2)), seed=11)
    dst.load_tables(path)
    np.testing.assert_array_equal(_syn0(dst), _syn0(e0))
    # The split stays the rows layout's: column blocks span every row.
    dims = EmbeddingEngine(V, D, np.ones(V), mesh=_mesh((1, 2)), layout="dims")
    with pytest.raises(ValueError, match="rows layout"):
        dims.set_save_split(0, 2)
    for e in (e0, e1, dst):
        e.destroy()


def test_async_save_keeps_sidecars(tmp_path):
    eng = _engine(_mesh((2, 2)))
    _step(eng)
    path = str(tmp_path / "snap")
    committed = []
    assert eng.save_async(path, on_commit=lambda: committed.append(1))
    eng.wait_pending_saves()
    assert committed == [1]
    assert integrity.verify_snapshot_dir(path) is True
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert man["version"] == 2 and len(man["shard_files"]) == 4
    j = JaxEngine(jax_mesh(2, 2), V, D, np.ones(V, np.int64), seed=5)
    j.save(str(tmp_path / "jax"))
    e2 = EmbeddingEngine.load(str(tmp_path / "jax"), mesh=_mesh((2, 2)))
    np.testing.assert_array_equal(_syn0(e2), _syn0(j))
    eng.destroy()


def test_shard_commit_fault_point(tmp_path):
    eng = _engine()
    _step(eng)
    faults.arm("ckpt.shard_commit:exc@2")
    try:
        with pytest.raises(faults.FaultInjected):
            eng.save(str(tmp_path / "snap"))
    finally:
        faults.disarm()
    assert not os.path.exists(tmp_path / "snap")
    eng.destroy()
