"""Grid packing on the device corpus and mid-epoch resume in the port.

* ``device_window_batch`` equals the JAX package's bitwise, on the same
  ids, offsets, positions (past ``n_valid``, negative, a compacted
  ``n_valid < N``) and the JAX package's own shrink draws.
* ``EmbeddingEngine.train_steps_corpus`` against the JAX engine's
  ``train_steps_corpus`` (Pallas kernels in interpret mode on
  ``make_mesh(1, 1)``) from identical tables, with the JAX package's
  shrink and negative draws replayed, subsampled and not: the tolerance
  ``tests/test_torch_composed.py`` holds the composed step to (tables
  within rtol 1e-5 and atol 1e-6, losses within rtol 1e-5).
* Over one epoch, grid and dense steps consume the same multiset of valid
  (center, context) pairs (the JAX package's ``tests/test_packed.py``
  parity contract); a grid step over the device corpus is the composed
  step of the same batch handed in from the host.
* ``Word2Vec(batch_packing="grid")`` on the device corpus passes the
  ``tiny_corpus`` gates; the packed path's mid-epoch drill
  (``GLINT_PACKED_STOP_AFTER_GROUPS``) resumes bitwise, with and without
  subsampling and with a shared pool; a mid-epoch state is refused under
  the other packing and an epoch-boundary one is not; a JAX-written
  mid-epoch state resumes from its position; the CLI drives both.
"""

import json
import os
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from glint_word2vec_tpu.ops import device_batching as jdb
from glint_word2vec_tpu.ops.device_batching import WINDOW_FOLD
from glint_word2vec_tpu.ops.sampling import sample_negatives_per_row
from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
from glint_word2vec_tpu.parallel.mesh import make_mesh

from glint_word2vec_torch import Word2Vec
from glint_word2vec_torch.convert import engine_from_arrays
from glint_word2vec_torch.corpus.batching import context_width
from glint_word2vec_torch.ops import device_batching as pdb
from glint_word2vec_torch.ops import rows as rows_mod
from glint_word2vec_torch.parallel import engine as peng_mod

V, D = 73, 16


def _corpus(seed=0, lens=(5, 1, 9, 3, 12, 2, 6, 30, 4, 17)):
    rng = np.random.default_rng(seed)
    sents = [rng.integers(0, V, L).astype(np.int32) for L in lens]
    ids = np.concatenate(sents)
    offsets = np.zeros(len(sents) + 1, np.int64)
    np.cumsum([len(s) for s in sents], out=offsets[1:])
    return ids, offsets


def _jax_shrink(key, n_rows, window):
    """The shrinks JAX's device_window_batch draws for rows 0..n-1 under
    ``key``: ``randint(fold_in(fold_in(key, WINDOW_FOLD), r), 0, W)``."""
    base = jax.random.fold_in(key, WINDOW_FOLD)
    return np.array(jax.vmap(lambda r: jax.random.randint(
        jax.random.fold_in(base, r), (), 0, window, dtype=jnp.int32
    ))(jnp.arange(n_rows, dtype=jnp.int32)))


@pytest.mark.parametrize("window", [3, 5])
@pytest.mark.parametrize("compacted", [False, True])
def test_device_window_batch_bitwise_equals_jax(window, compacted):
    ids, offsets = _corpus()
    N = ids.size
    n_valid = N
    if compacted:
        # The compacted view (subsample_compact equals the JAX package's
        # bitwise, tests/test_torch_device_batching.py).
        keep = np.random.default_rng(3).random(N) < 0.6
        c, oc, n_kept = pdb.subsample_compact(
            torch.from_numpy(ids), torch.from_numpy(offsets), torch.from_numpy(keep))
        ids, offsets, n_valid = c.numpy(), oc.numpy(), int(n_kept)
        assert n_valid < N
    # Every live position, positions past n_valid and past N, and
    # negative (wrapped) ones.
    positions = np.concatenate([
        np.arange(-3, N + 5), [-(2**31), 2**31 - 1, n_valid, n_valid + 1],
    ]).astype(np.int32)
    key = jax.random.fold_in(jax.random.PRNGKey(9), 4)
    want = jdb.device_window_batch(
        jnp.asarray(ids), jnp.asarray(offsets, jnp.int32),
        jnp.asarray(positions), jnp.arange(positions.size, dtype=jnp.int32),
        key, window, n_valid=jnp.int32(n_valid),
    )
    shrink = _jax_shrink(key, positions.size, window)
    got = pdb.device_window_batch(
        torch.from_numpy(ids), torch.from_numpy(offsets.astype(np.int64)),
        torch.from_numpy(positions.astype(np.int64)), torch.from_numpy(shrink),
        window, n_valid=torch.tensor(n_valid),
    )
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(np.float32): torch.float32}[w.dtype]
        assert np.array_equal(g.numpy(), w)
    m = got[2].numpy()
    dead = (positions < 0) | (positions >= n_valid)
    assert m[dead].sum() == 0 and m[~dead].sum() > 0


class JaxGridDraws:
    """The JAX package's grid-step draws for the port's engine: the
    shrinks of ``device_window_batch`` and the negatives of ``step_body``
    under ``fold_in(key, step)``."""

    def __init__(self, key, jeng, window):
        self.key, self.jeng, self.window = key, jeng, window

    def step_shrink(self, step, n_rows):
        k = jax.random.fold_in(self.key, jnp.uint32(step))
        return torch.from_numpy(_jax_shrink(k, n_rows, self.window).astype(np.int64))

    def window_negatives(self, step, n_rows, lanes):
        k = jax.random.fold_in(self.key, jnp.uint32(step))
        return torch.from_numpy(np.asarray(sample_negatives_per_row(
            k, self.jeng._prob, self.jeng._alias,
            jnp.arange(n_rows, dtype=jnp.int32), (lanes, self.jeng.num_negatives),
        )).astype(np.int32))


@pytest.mark.parametrize("window,subsample", [(3, False), (5, True)])
def test_train_steps_corpus_matches_jax_engine(window, subsample):
    ids, offsets = _corpus()
    rng = np.random.default_rng(1)
    counts = np.arange(V, 0, -1).astype(np.int64) * 3
    syn0 = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    syn1 = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    jeng = JaxEngine(make_mesh(1, 1), V, D, counts, num_negatives=3,
                     seed=11, use_pallas=True)
    jeng.set_tables(syn0, syn1)
    peng = engine_from_arrays(syn0, syn1, counts, num_negatives=3, device="cpu")
    jeng.upload_corpus(ids, offsets)
    peng.upload_corpus(ids, offsets)
    if subsample:
        kp = np.linspace(0.2, 1.0, V).astype(np.float32)
        jeng.set_keep_probs(kp)
        peng.set_keep_probs(kp)
        ekey = jax.random.fold_in(jax.random.PRNGKey(5), 0)
        keep = np.array(jdb.subsample_keep_mask(jnp.asarray(ids), jnp.asarray(kp), ekey))
        n_j = jeng.compact_corpus(ekey)
        assert peng.compact_corpus(0, keep=torch.from_numpy(keep)) == n_j < len(ids)
    key = jax.random.PRNGKey(5)
    B, step0 = 8, 2
    # Three steps, the last partly past the epoch's end.
    alphas = np.array([0.05, 0.04, 0.03], np.float32)
    n_pos = peng._active_corpus()[2]
    start = n_pos - 2 * B - 3
    assert start > 0
    jl = np.asarray(jeng.train_steps_corpus(start, B, window, key, alphas, step0))
    launches = (rows_mod.gather_rows.launches, rows_mod.scatter_add_rows.launches)
    pl = peng.train_steps_corpus(start, B, window, 0, alphas, step0,
                                 draws=JaxGridDraws(key, jeng, window))
    assert (rows_mod.gather_rows.launches,
            rows_mod.scatter_add_rows.launches) == launches  # CPU: plain
    assert isinstance(pl, torch.Tensor) and pl.shape == (3,)
    np.testing.assert_allclose(pl.numpy(), jl, rtol=1e-5)
    for name, before in (("syn0", syn0), ("syn1", syn1)):
        got = getattr(peng, name).numpy()
        want = np.asarray(getattr(jeng, name), np.float32)[:V]
        assert not np.array_equal(want, before)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
    assert peng.table_version == 2  # set_tables, then one training call


def test_grid_step_is_the_composed_step_of_its_batch():
    # The device corpus's grid step draws what train_steps draws for the
    # same batch: the engine's own key schedule, end to end.
    ids, offsets = _corpus()
    counts = np.arange(V, 0, -1).astype(np.int64)
    rng = np.random.default_rng(2)
    s0 = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    s1 = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    a = engine_from_arrays(s0, s1, counts, num_negatives=3, device="cpu")
    b = engine_from_arrays(s0, s1, counts, num_negatives=3, device="cpu")
    a.upload_corpus(ids, offsets)
    B, W, K, step0, key = 16, 4, 3, 5, 123
    la = a.train_steps_corpus(0, B, W, key, [0.05] * K, step0)
    draws = peng_mod.TrainingDraws(key, *b.noise_tables(), W, B, 3)
    c, x, m = zip(*(pdb.device_window_batch(
        torch.from_numpy(ids), torch.from_numpy(offsets),
        torch.arange(i * B, (i + 1) * B), draws.step_shrink(step0 + i, B), W,
    ) for i in range(K)))
    lb = b.train_steps(torch.stack(c), torch.stack(x), torch.stack(m), key,
                       [0.05] * K, step0)
    assert torch.equal(la, lb)
    assert torch.equal(a.syn0, b.syn0) and torch.equal(a.syn1, b.syn1)


def test_grid_and_dense_consume_the_same_pairs(monkeypatch):
    # One epoch: the grid steps' valid (center, context) pairs and the
    # packed steps' are one multiset, since both take each position's
    # shrink from the grid key schedule.
    ids, offsets = _corpus(lens=(5, 1, 9, 3, 12, 2, 6, 30, 4, 17, 8, 11))
    counts = np.arange(V, 0, -1).astype(np.int64)
    eng = engine_from_arrays(
        np.zeros((V, D), np.float32), np.zeros((V, D), np.float32), counts,
        num_negatives=2, device="cpu")
    eng.upload_corpus(ids, offsets)
    grid, packed = Counter(), Counter()
    real_window, real_pack = pdb.device_window_batch, pdb.pack_window_pairs

    def window_spy(*a, **kw):
        c, x, m = real_window(*a, **kw)
        for i, lane in zip(*np.nonzero(m.numpy())):
            grid[(int(c[i]), int(x[i, lane]))] += 1
        return c, x, m

    def pack_spy(*a, **kw):
        out = real_pack(*a, **kw)
        pc, px, pm = (t.numpy() for t in out[:3])
        packed.update(zip(pc[pm > 0].tolist(), px[pm > 0].tolist()))
        return out

    monkeypatch.setattr(pdb, "device_window_batch", window_spy)
    monkeypatch.setattr(pdb, "pack_window_pairs", pack_spy)
    B, W, spc, key = 8, 5, 4, 77
    groups = -(-(-(-ids.size // B)) // spc)
    for g in range(groups):
        eng.train_steps_corpus(g * spc * B, B, W, key, [0.0] * spc, g * spc)
    pos = 0
    P = 12
    while pos < ids.size:
        pos = int(eng.train_steps_corpus_packed(pos, P, W, B, key, spc)[2][-1])
    assert sum(grid.values()) > 100
    assert grid == packed


def _tiny(**kw):
    return (
        Word2Vec(device="cpu")
        .set_vector_size(48).set_window_size(5).set_step_size(0.025)
        .set_batch_size(256).set_num_negatives(5).set_min_count(5)
        .set_num_iterations(6).set_seed(1)
    )._set(**kw)


def test_grid_fit_passes_quality_gates(tiny_corpus):
    # The gates of tests/test_model_e2e.py:50-84 (tests/conftest.py's
    # tiny_corpus), grid batches assembled on the device corpus.
    m = _tiny(batch_packing="grid").fit(tiny_corpus)
    tm = m.training_metrics
    assert tm["pipeline"] == "device_corpus" and tm["batch_packing"] == "grid"
    assert tm["words_done"] == 6 * m.vocab.train_words_count
    assert "packed_pairs" not in tm
    syns = m.find_synonyms("austria", 10)
    assert "vienna" in dict(syns) and dict(syns)["vienna"] > 0.5, syns
    res = m.analogy(positive=["vienna", "germany"], negative=["austria"], num=10)
    assert "berlin" in [w for w, _ in res], res


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


def _state(ck):
    with open(os.path.join(ck, "train_state.json")) as f:
        return json.load(f)


def _same_tables(a, b):
    for name in ("syn0", "syn1"):
        assert torch.equal(getattr(a.engine, name), getattr(b.engine, name)), name


@pytest.mark.parametrize("kw", [
    {}, {"subsample_ratio": 0.05}, {"shared_negatives": 8},
], ids=["plain", "subsampled", "shared_pool"])
def test_mid_epoch_drill_resumes_bitwise(tmp_path, monkeypatch, kw):
    ck = str(tmp_path / "ck")
    monkeypatch.setenv("GLINT_PACKED_STOP_AFTER_GROUPS", "3")
    stopped = _small(**kw).fit(SMALL, checkpoint_dir=ck)
    monkeypatch.delenv("GLINT_PACKED_STOP_AFTER_GROUPS")
    state = _state(ck)
    assert state["position"] > 0 and state["epochs_completed"] == 0
    assert state["step"] == 3 * 4 and state["gstep"] == 0
    assert state["batch_packing"] == "dense"
    assert state["ckpt"] == f"ckpt-e0-p{state['position']}"
    assert 0 < state["words_done"] < stopped.vocab.train_words_count
    assert stopped.training_metrics["words_done"] == state["words_done"]
    resumed = _small(**kw).fit(SMALL, checkpoint_dir=ck)
    full = _small(**kw).fit(SMALL)
    _same_tables(resumed, full)
    final = _state(ck)
    assert final["epochs_completed"] == 2 and final["position"] == 0
    assert resumed.training_metrics["words_done"] == 2 * full.vocab.train_words_count


def test_mid_epoch_state_refuses_cross_mode_resume(tmp_path, monkeypatch):
    ck = str(tmp_path / "ck")
    monkeypatch.setenv("GLINT_PACKED_STOP_AFTER_GROUPS", "2")
    _small().fit(SMALL, checkpoint_dir=ck)
    monkeypatch.delenv("GLINT_PACKED_STOP_AFTER_GROUPS")
    assert _state(ck)["position"] > 0
    with pytest.raises(ValueError, match="batch_packing"):
        _small(batch_packing="grid").fit(SMALL, checkpoint_dir=ck)
    _small().fit(SMALL, checkpoint_dir=ck)  # dense resumes its own state
    # Epoch-boundary states resume under either packing, both ways.
    for first, then in (("dense", "grid"), ("grid", "dense")):
        ck2 = str(tmp_path / f"ck-{first}")
        _small(batch_packing=first).fit(SMALL, checkpoint_dir=ck2,
                                        stop_after_epochs=1)
        state = _state(ck2)
        assert state["position"] == 0 and state["batch_packing"] == first
        m = _small(batch_packing=then).fit(SMALL, checkpoint_dir=ck2)
        assert m.training_metrics["batch_packing"] == then
        assert _state(ck2)["epochs_completed"] == 2


@pytest.mark.parametrize("subsample_ratio", [0.0, 0.05])
def test_grid_epoch_resume_equals_uninterrupted_run(tmp_path, subsample_ratio):
    ck = str(tmp_path / "ck")
    kw = dict(batch_packing="grid", subsample_ratio=subsample_ratio)
    _small(**kw).fit(SMALL, checkpoint_dir=ck, stop_after_epochs=1)
    state = _state(ck)
    # The grid step counter is the grid-equivalent counter.
    assert state["gstep"] == state["step"] > 0 and state["position"] == 0
    assert state["batch_packing"] == "grid"
    resumed = _small(**kw).fit(SMALL, checkpoint_dir=ck)
    full = _small(**kw).fit(SMALL)
    _same_tables(resumed, full)


def test_grid_alphas_follow_the_corpus_words(monkeypatch):
    # Each grid step's alpha reads the pre-subsampling words done at its
    # batch's end; steps advance spc a group, tail no-ops included.
    seen = []
    real = peng_mod.EmbeddingEngine.train_steps_corpus

    def spy(self, start, B, W, key, alphas, step0=0, **kw):
        seen.append((start, step0, np.asarray(alphas).copy()))
        return real(self, start, B, W, key, alphas, step0, **kw)

    monkeypatch.setattr(peng_mod.EmbeddingEngine, "train_steps_corpus", spy)
    m = _small(batch_packing="grid", num_iterations=1).fit(SMALL)
    words = sum(len(s) for s in SMALL)
    assert [s for s, *_ in seen] == [i * 4 * 32 for i in range(len(seen))]
    assert [s for _, s, _ in seen] == [4 * i for i in range(len(seen))]
    assert m.training_metrics["steps"] == -(-words // 32)
    ends = np.minimum(np.arange(1, 4 * len(seen) + 1) * 32, words)
    offsets = np.cumsum([0] + [len(s) for s in SMALL])
    wd = np.array([pdb.corpus_words_done(offsets, e) for e in ends])
    a0 = m.params.step_size
    want = np.maximum(a0 * (1 - wd / (words + 1)), a0 * 1e-4).astype(np.float32)
    np.testing.assert_allclose(np.concatenate([a for *_, a in seen]), want, rtol=1e-6)


def test_jax_written_mid_epoch_checkpoint_resumes_from_its_position(
        tmp_path, monkeypatch):
    from glint_word2vec_tpu import Word2Vec as JaxWord2Vec

    ck = str(tmp_path / "ck")
    monkeypatch.setenv("GLINT_PACKED_STOP_AFTER_GROUPS", "2")
    JaxWord2Vec(mesh=make_mesh(1, 1), vector_size=12, batch_size=32,
                min_count=1, num_iterations=2, seed=7, steps_per_call=4,
                window=3).fit(SMALL, checkpoint_dir=ck)
    monkeypatch.delenv("GLINT_PACKED_STOP_AFTER_GROUPS")
    state = _state(ck)
    assert state["position"] > 0 and state["epochs_completed"] == 0
    calls = []
    real = peng_mod.EmbeddingEngine.train_steps_corpus_packed

    def spy(self, start, *a, **kw):
        calls.append((start, kw["step0"], kw["grid_step0"]))
        return real(self, start, *a, **kw)

    monkeypatch.setattr(peng_mod.EmbeddingEngine, "train_steps_corpus_packed", spy)
    m = _small().fit(SMALL, checkpoint_dir=ck)
    assert calls[0] == (state["position"], state["step"], state["gstep"])
    assert m.training_metrics["words_done"] == 2 * m.vocab.train_words_count
    assert _state(ck)["epochs_completed"] == 2


def test_cli_trains_grid_and_resumes_mid_epoch(tmp_path, capsys, monkeypatch):
    from glint_word2vec_torch import cli

    corpus = tmp_path / "c.txt"
    corpus.write_text("".join(" ".join(s) + "\n" for s in SMALL))
    common = ["--corpus", str(corpus), "--device", "cpu", "--vector-size", "8",
              "--batch-size", "32", "--min-count", "1", "--iterations", "2",
              "--window", "3", "--steps-per-call", "4"]
    rc = cli.main(["train", *common, "--packing", "grid",
                   "--output", str(tmp_path / "g")])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["pipeline"] == "device_corpus"
    assert line["batch_packing"] == "grid"
    ck = str(tmp_path / "ck")
    monkeypatch.setenv("GLINT_PACKED_STOP_AFTER_GROUPS", "2")
    assert cli.main(["train", *common, "--checkpoint-dir", ck,
                     "--output", str(tmp_path / "m1")]) == 0
    monkeypatch.delenv("GLINT_PACKED_STOP_AFTER_GROUPS")
    assert _state(ck)["position"] > 0
    capsys.readouterr()
    assert cli.main(["train", *common, "--checkpoint-dir", ck,
                     "--output", str(tmp_path / "m2")]) == 0
    assert cli.main(["train", *common, "--output", str(tmp_path / "m3")]) == 0
    from glint_word2vec_torch.models import load_model

    a = load_model(str(tmp_path / "m2"), device="cpu")
    b = load_model(str(tmp_path / "m3"), device="cpu")
    assert torch.equal(a.engine.syn0, b.engine.syn0)
    assert _state(ck)["epochs_completed"] == 2
