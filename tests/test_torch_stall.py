"""The port's stall-free fit loop against its synchronous schedule and
the JAX package's checkpoint contract (``tests/test_stall.py`` there).

* Deferred readbacks with the compaction prefetch give tables bitwise
  equal to ``GLINT_SYNC_READBACK=1 GLINT_NO_COMPACT_PREFETCH=1``, with
  equal step, word and pair counts, over 3 epochs at subsample 0 and
  0.01 (and the grid loop's prefetch); the deferred loop dispatches one
  zero-pair phantom group an epoch and no more.
* The dispatch form chains a group on the previous group's device-side
  end position and reads it back later, equal to synchronous calls.
* Under the deferred schedule a group's ``readback_harvest`` lands after
  the next group's ``device_steps`` and before the one after it.
* ``save_async`` writes the files ``save`` writes; ``GLINT_SYNC_CKPT=1``
  blocks; a second async save waits and is counted; a write killed
  between the temp directory and the rename leaves the previous
  checkpoint authoritative; the snapshot holds the tables as they were
  when it was asked for, though the write runs after later training.
* Mid-epoch resume from an async checkpoint equals one from a sync
  checkpoint, bitwise; a checkpoint the port wrote asynchronously loads
  in the JAX package's ``EmbeddingEngine.load`` with equal tables and
  verifying manifests.
* A prefetched compaction is adopted bitwise, a stale one dropped, and
  the device budget counts the prefetched copy.

Tables are compared bitwise (``torch.equal``), counters exactly.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_torch import Word2Vec
from glint_word2vec_torch.convert import engine_from_arrays
from glint_word2vec_torch.models import word2vec as w2v_mod
from glint_word2vec_torch.obs import ObsConfig
from glint_word2vec_torch.parallel.engine import EmbeddingEngine

SMALL = [
    "the quick brown fox jumps over the lazy dog".split(),
    "the dog sleeps all day long in the sun".split(),
    "a quick fox and a lazy dog meet in the field".split(),
    "the sun rises over the field every day".split(),
] * 30

SYNC = {"GLINT_SYNC_READBACK": "1", "GLINT_NO_COMPACT_PREFETCH": "1"}


def _small(**kw):
    defaults = dict(vector_size=12, batch_size=32, min_count=1,
                    num_iterations=2, seed=7, steps_per_call=4, window=3)
    defaults.update(kw)
    return Word2Vec(device="cpu", **defaults)


def _same_tables(a, b):
    for name in ("syn0", "syn1"):
        assert torch.equal(getattr(a.engine, name), getattr(b.engine, name)), name


def _engine(seed=0):
    rng = np.random.default_rng(seed)
    return engine_from_arrays(
        rng.normal(0, 0.3, (100, 16)).astype(np.float32),
        rng.normal(0, 0.3, (100, 16)).astype(np.float32),
        np.arange(100, 0, -1).astype(np.int64), device="cpu",
    )


def _state(ck):
    with open(os.path.join(ck, "train_state.json")) as f:
        return json.load(f)


# ---------------------- fit-loop parity ---------------------------------


def _count_dispatches(monkeypatch):
    calls = []
    real = EmbeddingEngine.train_steps_corpus_packed

    def spy(self, *a, **kw):
        calls.append(kw.get("readback", True))
        return real(self, *a, **kw)

    monkeypatch.setattr(EmbeddingEngine, "train_steps_corpus_packed", spy)
    return calls


@pytest.mark.parametrize("packing,subsample_ratio", [
    ("dense", 0.0), ("dense", 0.01), ("grid", 0.01),
])
def test_deferred_schedule_equals_sync_bitwise(monkeypatch, packing,
                                               subsample_ratio):
    kw = dict(batch_packing=packing, subsample_ratio=subsample_ratio,
              num_iterations=3)
    calls = _count_dispatches(monkeypatch)
    deferred = _small(**kw).fit(SMALL)
    n_deferred = len(calls)
    for k, v in SYNC.items():
        monkeypatch.setenv(k, v)
    sync = _small(**kw).fit(SMALL)
    n_sync = len(calls) - n_deferred
    _same_tables(deferred, sync)
    for key in ("steps", "words_done", "packed_pairs"):
        assert deferred.training_metrics.get(key) == sync.training_metrics.get(key), key
    assert deferred.training_metrics["words_done"] == 3 * deferred.vocab.train_words_count
    if packing == "dense":
        # One zero-pair phantom group an epoch, dispatched before the
        # previous group's end was read.
        assert n_deferred == n_sync + 3 and n_sync > 3
        assert deferred.training_metrics["packed_pairs"] > 0


def test_dispatch_form_chains_on_a_device_start_and_reads_back_later():
    # Two groups chained on the first's device-side end position, read
    # back after both are dispatched, equal two synchronous calls.
    from glint_word2vec_torch.corpus.batching import packed_pair_batch
    from glint_word2vec_torch.parallel.engine import DeferredReadback

    rng = np.random.default_rng(4)
    ids = rng.integers(0, 100, 3000).astype(np.int32)
    offsets = np.arange(0, 3001, 15, dtype=np.int64)
    engines = [_engine(), _engine()]
    for e in engines:
        e.upload_corpus(ids, offsets)
    P, kw = packed_pair_batch(32, 3), dict(step_size=0.05, total_words=3001)
    sync = []
    pos = 0
    for g in range(2):
        sync.append(engines[0].train_steps_corpus_packed(
            pos, P, 3, 32, 9, 4, step0=4 * g, **kw))
        pos = int(sync[-1][2][-1])
    first = engines[1].train_steps_corpus_packed(0, P, 3, 32, 9, 4, step0=0,
                                                 readback=False, **kw)
    assert isinstance(first, DeferredReadback) and first.out.shape == (4, 4)
    second = engines[1].train_steps_corpus_packed(
        first.out[2, -1], P, 3, 32, 9, 4, step0=4, readback=False, **kw)
    for want, group in zip(sync, (first, second)):
        for a, b in zip(want, EmbeddingEngine.packed_readback(group)):
            assert np.array_equal(a, b)
    assert torch.equal(engines[0].syn0, engines[1].syn0)
    assert torch.equal(engines[0].syn1, engines[1].syn1)


def test_deferred_harvest_lags_exactly_one_group(tmp_path):
    log = str(tmp_path / "events.jsonl")
    model = _small(num_iterations=1, obs=ObsConfig(event_log=log)).fit(SMALL)
    events = [json.loads(line) for line in open(log) if line.strip()]
    ordered = [e for e in events
               if e["name"] == "readback_harvest"
               or (e["name"] == "device_steps" and e.get("args", {}).get("packed"))]
    d_pos = [i for i, e in enumerate(ordered) if e["name"] == "device_steps"]
    h_pos = [i for i, e in enumerate(ordered) if e["name"] == "readback_harvest"]
    assert len(d_pos) >= 3
    # Every dispatched group is read back once (the phantom too).
    assert len(h_pos) == len(d_pos)
    for g in range(len(h_pos) - 1):
        assert h_pos[g] > d_pos[g + 1], (g, d_pos, h_pos)
        if g + 2 < len(d_pos):
            assert h_pos[g] < d_pos[g + 2], (g, d_pos, h_pos)
    assert h_pos[-1] > d_pos[-1]
    # The phantom group records no step.
    assert ordered[h_pos[-1]]["args"]["n"] == 0
    assert sum(ordered[h]["args"]["n"] for h in h_pos) == model.training_metrics["steps"]


# ---------------------- async save / commit protocol --------------------


def test_async_save_writes_the_sync_save_files(tmp_path):
    eng = _engine()
    for mode in ("sharded", "single"):
        s_dir, a_dir = str(tmp_path / f"s-{mode}"), str(tmp_path / f"a-{mode}")
        eng.save(s_dir, mode=mode)
        assert eng.save_async(a_dir, mode=mode) is True
        eng.wait_pending_saves()
        assert sorted(os.listdir(s_dir)) == sorted(os.listdir(a_dir))
        for f in os.listdir(s_dir):
            with open(os.path.join(s_dir, f), "rb") as x, \
                    open(os.path.join(a_dir, f), "rb") as y:
                assert x.read() == y.read(), f
        other = EmbeddingEngine.load(a_dir, device="cpu")
        assert torch.equal(other.syn0, eng.syn0) and torch.equal(other.syn1, eng.syn1)
    stats = eng.checkpoint_stats()
    assert stats["pending_async_saves"] == 0 and stats["forced_sync_saves"] == 0
    assert stats["checkpoint_write_seconds"] is not None
    assert stats["last_checkpoint_age_seconds"] is not None


def test_sync_ckpt_env_forces_blocking(tmp_path, monkeypatch):
    monkeypatch.setenv("GLINT_SYNC_CKPT", "1")
    eng = _engine()
    committed = []
    assert eng.save_async(str(tmp_path / "ck"),
                          on_commit=lambda: committed.append(1)) is False
    assert committed == [1]
    assert os.path.exists(tmp_path / "ck" / "manifest.json")
    stats = eng.checkpoint_stats()
    assert stats["pending_async_saves"] == 0
    assert stats["forced_sync_saves"] == 1


def test_second_async_save_blocks_and_is_counted(tmp_path, monkeypatch):
    eng = _engine()
    release = threading.Event()
    orig = EmbeddingEngine._write_snapshot

    def slow_write(self, *a, **kw):
        release.wait(timeout=30)
        return orig(self, *a, **kw)

    monkeypatch.setattr(EmbeddingEngine, "_write_snapshot", slow_write)
    eng.save_async(str(tmp_path / "ck-1"))
    assert eng.checkpoint_stats()["pending_async_saves"] == 1
    t0 = time.time()
    threading.Timer(0.3, release.set).start()
    eng.save_async(str(tmp_path / "ck-2"))  # waits for ck-1
    assert time.time() - t0 >= 0.25
    eng.wait_pending_saves()
    stats = eng.checkpoint_stats()
    assert stats["async_save_waits"] == 1 and stats["pending_async_saves"] == 0
    assert os.path.exists(tmp_path / "ck-1" / "engine.json")
    assert os.path.exists(tmp_path / "ck-2" / "engine.json")


def test_crash_between_temp_write_and_rename(tmp_path, monkeypatch):
    ckdir = tmp_path / "ckpts"
    ckdir.mkdir()
    state_path = str(ckdir / "train_state.json")
    eng = _engine()

    def flip(ck_name):
        w2v_mod._flip_checkpoint_state(
            str(ckdir), state_path, ck_name,
            epochs_completed=1, step=10, words_done=100,
        )

    eng.save(str(ckdir / "ckpt-1"))
    flip("ckpt-1")
    before = eng.syn0.clone()

    def killed(tmp, path):
        raise RuntimeError("simulated kill between write and rename")

    monkeypatch.setattr(EmbeddingEngine, "_commit_snapshot_dir", staticmethod(killed))
    eng.syn0 += 1.0
    eng.save_async(str(ckdir / "ckpt-2"), on_commit=lambda: flip("ckpt-2"))
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        eng.wait_pending_saves()
    monkeypatch.undo()
    # The state still names ckpt-1; the aborted snapshot is only an
    # unreferenced temp directory.
    assert _state(str(ckdir))["ckpt"] == "ckpt-1"
    assert not os.path.exists(ckdir / "ckpt-2")
    assert [e for e in os.listdir(ckdir) if ".tmp-" in e]
    restored = _engine(seed=3)
    restored.load_tables(os.path.join(str(ckdir), "ckpt-1"))
    assert torch.equal(restored.syn0, before)
    # The next flip prunes the orphaned temp directory.
    eng.save(str(ckdir / "ckpt-3"))
    flip("ckpt-3")
    assert not [e for e in os.listdir(ckdir) if ".tmp-" in e]


def test_async_snapshot_is_immune_to_later_training(tmp_path, monkeypatch):
    eng = _engine()
    expect0, expect1 = eng.syn0.clone(), eng.syn1.clone()
    release = threading.Event()
    orig = EmbeddingEngine._write_snapshot

    def late_write(self, *a, **kw):
        release.wait(timeout=30)
        return orig(self, *a, **kw)

    monkeypatch.setattr(EmbeddingEngine, "_write_snapshot", late_write)
    eng.save_async(str(tmp_path / "ck"))
    # Train in place while the write waits, then let it run.
    eng.train_steps(np.full((1, 8), 3, np.int32), np.ones((1, 8, 3), np.int32),
                    np.ones((1, 8, 3), np.float32), 0, [0.5])
    assert not torch.equal(expect1, eng.syn1)
    release.set()
    eng.wait_pending_saves()
    back = EmbeddingEngine.load(str(tmp_path / "ck"), device="cpu")
    assert torch.equal(back.syn0, expect0) and torch.equal(back.syn1, expect1)


def test_async_and_sync_mid_epoch_resume_are_bitwise_equal(tmp_path, monkeypatch):
    def drill(ck, sync_ckpt):
        if sync_ckpt:
            monkeypatch.setenv("GLINT_SYNC_CKPT", "1")
        monkeypatch.setenv("GLINT_PACKED_STOP_AFTER_GROUPS", "3")
        _small(subsample_ratio=0.01).fit(SMALL, checkpoint_dir=ck)
        monkeypatch.delenv("GLINT_PACKED_STOP_AFTER_GROUPS")
        monkeypatch.delenv("GLINT_SYNC_CKPT", raising=False)
        assert _state(ck)["position"] > 0
        return _small(subsample_ratio=0.01).fit(SMALL, checkpoint_dir=ck)

    a = drill(str(tmp_path / "a"), sync_ckpt=False)
    s = drill(str(tmp_path / "s"), sync_ckpt=True)
    _same_tables(a, s)
    _same_tables(a, _small(subsample_ratio=0.01).fit(SMALL))
    assert _state(str(tmp_path / "a"))["epochs_completed"] == 2


def test_async_checkpoint_loads_in_the_jax_engine(tmp_path):
    from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
    from glint_word2vec_tpu.parallel.mesh import make_mesh
    from glint_word2vec_tpu.utils.integrity import verify_snapshot_dir

    ck = str(tmp_path / "ck")
    m = _small().fit(SMALL, checkpoint_dir=ck)
    path = os.path.join(ck, _state(ck)["ckpt"])
    verify_snapshot_dir(path)
    jeng = JaxEngine.load(path, make_mesh(1, 1))
    for name in ("syn0", "syn1"):
        want = getattr(m.engine, name).numpy()
        got = np.asarray(getattr(jeng, name), np.float32)[: want.shape[0]]
        assert np.array_equal(got, want), name


def test_fit_checkpoints_async_and_reports_the_stall(tmp_path):
    ck = str(tmp_path / "ck")
    status = str(tmp_path / "status.json")
    m = _small(obs=ObsConfig(status_file=status, status_interval=0.0)).fit(
        SMALL, checkpoint_dir=ck)
    state = _state(ck)
    assert state["epochs_completed"] == 2 and state["prev"]["ckpt"] == "ckpt-1"
    assert sorted(e for e in os.listdir(ck) if e.startswith("ckpt-")) == [
        "ckpt-1", "ckpt-2"]
    assert m.training_metrics["device_stall_seconds"] >= 0
    assert set(m.training_metrics["steptime"]) >= {"checkpoint", "dispatch"}
    snap = json.loads(open(status).read())
    # Two ckpt_snapshot spans on the fit thread.
    assert snap["steptime"]["phases"]["checkpoint"]["count"] == 2
    assert snap["state"] == "done" and snap["pending_async_saves"] == 0
    assert snap["checkpoint_write_seconds"] is not None
    assert m.engine.checkpoint_stats()["forced_sync_saves"] == 0


# ---------------------- compaction prefetch -----------------------------


def test_prefetched_compaction_is_adopted_bitwise():
    eng = _engine()
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 100, 4000).astype(np.int32)
    offsets = np.arange(0, 4001, 20, dtype=np.int64)
    eng.upload_corpus(ids, offsets)
    eng.set_keep_probs(np.full(100, 0.6, np.float32))
    n_direct = eng.compact_corpus(17)
    direct = [t.clone() for t in eng._corpus_compacted]
    eng.prefetch_compact_corpus(17)
    assert isinstance(eng._compact_prefetch[3], torch.Tensor)  # not read back
    assert eng.compact_corpus(17) == n_direct
    assert eng._compact_prefetch is None
    for a, b in zip(direct, eng._corpus_compacted):
        assert torch.equal(a, b)
    # A prefetch for another key is dropped, not adopted.
    eng.prefetch_compact_corpus(17)
    n_other = eng.compact_corpus(18)
    assert eng._compact_prefetch is None
    assert n_other != n_direct or not torch.equal(direct[0], eng._corpus_compacted[0])


def test_device_budget_counts_the_prefetched_copy(monkeypatch):
    est = _small(subsample_ratio=1e-3, num_iterations=3)
    n_words, n_offsets = 1_000_000, 50_001
    with_prefetch = est._device_bytes_needed(1000, n_words, n_offsets)
    monkeypatch.setenv("GLINT_NO_COMPACT_PREFETCH", "1")
    without = est._device_bytes_needed(1000, n_words, n_offsets)
    assert with_prefetch - without == (
        n_words * w2v_mod.PREFETCHED_CORPUS_BYTES_PER_WORD + 8 * n_offsets)
    monkeypatch.delenv("GLINT_NO_COMPACT_PREFETCH")
    # One epoch prefetches nothing.
    one = _small(subsample_ratio=1e-3, num_iterations=1)
    assert one._device_bytes_needed(1000, n_words, n_offsets) == without
