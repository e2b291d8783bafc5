"""The port's replica exchange (``glint_word2vec_torch/parallel/
exchange.py`` and the rest of ``parallel/distributed.py``) against the JAX
package's, at ``V = 157``, ``D = 16`` as ``tests/test_exchange.py``.

* The pure-numpy helpers (the corpus splits, ``wire_row_bytes``,
  ``default_capacity``, ``decide_dense``) give the JAX outputs exactly.
* The encoder, on identical fp32 deltas and carries with exact-zero rows,
  gives JAX's ``_build_encode_fn`` outputs bit for bit, for each wire and
  for a flush, with and without an overflow; the sparse and dense applies
  on identical bases and payloads are bitwise JAX's for fp32 and bf16
  tables at world 2 and 3. The sparse apply lands through B3's plain
  version here (``scatter_add_rows`` counts no launch on the CPU).
* ``sync_group`` over port engines and over JAX engines from identical
  tables, the port replaying JAX's grid draws: every replica bitwise
  equal inside each package after each round, and the port's tables
  within ``tests/test_torch_train.py``'s training tolerance of JAX's.
* The protocol tests of ``tests/test_exchange.py`` on the port's engines:
  sparse against dense, the overflow spill, coalescing as a bitwise
  schedule, error-feedback conservation, two-level parity and its byte
  split, the world-1 short circuit, adaptive capacity (the same decisions
  as JAX on the same headers), the fit-level exchange on the packed and
  the grid path, a checkpointed exchange fit resuming bitwise, and the
  telemetry through the heartbeat, the Prometheus lint and the gang merge.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from glint_word2vec_tpu.parallel import distributed as jdist
from glint_word2vec_tpu.parallel import exchange as jex
from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
from glint_word2vec_tpu.parallel.mesh import make_mesh

from glint_word2vec_torch import Word2Vec
from glint_word2vec_torch.ops import random as rnd
from glint_word2vec_torch.ops import rows as rows_mod
from glint_word2vec_torch.parallel import distributed as pdist
from glint_word2vec_torch.parallel import exchange as pex
from glint_word2vec_torch.parallel.engine import EmbeddingEngine

V, D = 157, 16
COUNTS = np.random.default_rng(1).integers(1, 100, V)


def _engines(world, seed=3, dtype="float32"):
    return [EmbeddingEngine(V, D, COUNTS, seed=seed, dtype=dtype, device="cpu")
            for _ in range(world)]


def _corpus_shard(rank, world, n_words=4000, seed=9):
    """Rank ``rank``'s round-robin shard of one synthetic corpus (the
    split ``tests/test_exchange.py`` drives its replicas with)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, n_words).astype(np.int32)
    lens = rng.integers(4, 12, 600)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(np.minimum(lens, 8), out=offsets[1:])
    offsets = offsets[offsets <= n_words]
    if offsets[-1] != n_words:
        offsets = np.append(offsets, n_words)
    return pdist.shard_flat_for_process(ids, offsets, rank, world)


def _keep_probs():
    return np.clip(np.random.default_rng(2).uniform(0.5, 1.0, V), 0,
                   1).astype(np.float32)


def _run_replicas(mode, capacity, *, world=2, epochs=2, subsample=False,
                  resume_after_groups=None, flush_after_groups=None,
                  dtype="float32", wire="fp32", every=1, topology="flat",
                  node_size=None, n_words=4000, tmp_path=None):
    """Drive ``world`` in-process port replicas through the device-corpus
    grid steps with one exchange boundary per ``every`` groups (the
    schedule of ``tests/test_exchange.py``'s driver). Returns the rank-0
    engine; every replica is asserted bitwise equal."""
    engines = _engines(world, dtype=dtype)

    def _mk(engs):
        return [pex.ReplicaExchanger(e, mode=mode, capacity=capacity, wire=wire,
                                     every=every, topology=topology,
                                     node_size=node_size) for e in engs]

    def _upload(engs, epoch=None):
        for r, e in enumerate(engs):
            e.upload_corpus(*_corpus_shard(r, world, n_words=n_words))
            if subsample:
                e.set_keep_probs(_keep_probs())
                if epoch is not None:
                    e.compact_corpus(rnd.fold_in(key, epoch))

    exs = _mk(engines)
    key = rnd.seed_key(5)
    B, W, spc = 64, 3, 2
    _upload(engines)
    groups_done, resumed = 0, False
    for epoch in range(epochs):
        n_pos = [e.compact_corpus(rnd.fold_in(key, epoch)) if subsample
                 else e.corpus_positions for e in engines]
        groups = max(max(1, -(-max(1, -(-n // B)) // spc)) for n in n_pos)
        for g in range(groups):
            for r, e in enumerate(engines):
                e.train_steps_corpus(g * spc * B, B, W, rnd.fold_in(key, 1000 + r),
                                     np.full(spc, 0.02, np.float32),
                                     epoch * groups * spc + g * spc)
            groups_done += 1
            boundary = (groups_done % every == 0) or g == groups - 1
            if boundary:
                pex.sync_group(exs)
            if flush_after_groups is not None and groups_done == flush_after_groups:
                assert boundary, "flush point must be a sync boundary"
                pex.flush_group(exs)
            if (resume_after_groups is not None and not resumed
                    and groups_done == resume_after_groups):
                # All replicas are equal after a round, so one rank's
                # snapshot restores every rank.
                resumed = True
                path = str(tmp_path / "snap")
                engines[0].save(path)
                fresh = _engines(world, dtype=dtype)
                for e in fresh:
                    e.load_tables(path)
                _upload(fresh, epoch)
                engines = fresh
                exs = _mk(engines)
    for e in engines[1:]:
        assert torch.equal(engines[0].syn0, e.syn0)
        assert torch.equal(engines[0].syn1, e.syn1)
    return engines[0]


def _tables(engine):
    return engine.syn0.float().numpy(), engine.syn1.float().numpy()


def _train_step(eng, centers, ctx, mask, key, alpha=0.025):
    """One composed step of a host batch (the JAX engine's ``train_step``)."""
    eng.train_steps(centers[None], ctx[None], mask[None], key,
                    np.array([alpha], np.float32), 0)


def _random_step(eng, rng, key=1):
    _train_step(eng, rng.integers(0, V, 16).astype(np.int32),
                rng.integers(0, V, (16, 4)).astype(np.int32),
                np.ones((16, 4), np.float32), key)


# ----------------------------------------------------------------------
# The pure-numpy helpers equal JAX's exactly
# ----------------------------------------------------------------------


def _flat_corpus(seed=5, n=400, vocab=500):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 9, n)  # with empty sentences
    ids = rng.integers(0, vocab, int(lens.sum())).astype(np.int32)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return ids, offsets


@pytest.mark.parametrize("name", ["shard_flat_for_process",
                                  "shard_flat_locality"])
@pytest.mark.parametrize("pc", [1, 2, 3, 4])
def test_flat_sharders_equal_jax(name, pc):
    ids, offsets = _flat_corpus()
    for pi in range(pc):
        want = getattr(jdist, name)(ids, offsets, process_index=pi,
                                    process_count=pc)
        got = getattr(pdist, name)(ids, offsets, process_index=pi,
                                   process_count=pc)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize("pc", [1, 2, 3, 5])
def test_sentence_split_and_word_counts_equal_jax(pc):
    ids, offsets = _flat_corpus(seed=6, n=101)
    sents = [ids[a:b].tolist() for a, b in zip(offsets[:-1], offsets[1:])]
    for pi in range(pc):
        assert (pdist.shard_sentences_for_process(sents, pi, pc)
                == jdist.shard_sentences_for_process(sents, pi, pc))
    lens = np.diff(offsets)
    np.testing.assert_array_equal(pdist.per_process_word_counts(lens, pc),
                                  jdist.per_process_word_counts(lens, pc))


def test_wire_helpers_and_decide_dense_equal_jax(monkeypatch):
    for wire in ("fp32", "bf16", "int8"):
        for dim in (1, 16, 300):
            assert pex.wire_row_bytes(wire, dim) == jex.wire_row_bytes(wire, dim)

    class Geo:
        def __init__(self, num_rows, num_negatives):
            self.num_rows, self.num_negatives = num_rows, num_negatives

    monkeypatch.delenv("GLINT_EXCHANGE_CAPACITY", raising=False)
    for rows, n, pb, spc in [(981_169, 5, 3277, 16), (157, 5, 64, 2),
                             (4096, 3, 64, 4), (10, 5, 1, 1)]:
        g = Geo(rows, n)
        assert pex.default_capacity(g, pb, spc) == jex.default_capacity(g, pb, spc)
    assert pex.default_capacity(Geo(981_169, 5), 3277, 16) == 524_288
    monkeypatch.setenv("GLINT_EXCHANGE_CAPACITY", "1000")
    assert pex.default_capacity(Geo(400, 5), 8, 8) == jex.default_capacity(
        Geo(400, 5), 8, 8) == 400
    monkeypatch.delenv("GLINT_EXCHANGE_CAPACITY")
    rng = np.random.default_rng(0)
    for _ in range(20):
        h = rng.integers(0, 2, (3, pex.HEADER_LEN)).astype(np.int64)
        for mode in ("sparse", "dense"):
            assert pex.decide_dense(mode, h) == jex.decide_dense(mode, h)
    monkeypatch.setenv("GLINT_DENSE_EXCHANGE", "1")
    assert pex.decide_dense("sparse", np.zeros((2, 6), np.int64)) is True


# ----------------------------------------------------------------------
# Encode and apply, bitwise JAX's
# ----------------------------------------------------------------------


class _Geo:
    num_rows, dim = V, D


def _delta_and_carry(seed, touched=60):
    rng = np.random.default_rng(seed)
    delta = np.zeros((V, D), np.float32)
    rows = rng.choice(V, touched, replace=False)
    delta[rows] = rng.normal(0, 1e-2, (touched, D)).astype(np.float32)
    delta[rows[:3], :5] = 0.0  # touched rows with some exact-zero lanes
    carry = np.zeros((V + 1, D), np.float32)
    crow = rng.choice(V, 40, replace=False)
    carry[crow] = rng.normal(0, 1e-4, (40, D)).astype(np.float32)
    return delta, carry


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def _torch_bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits(t.numpy())


@pytest.mark.parametrize("wire,flush", [("fp32", False), ("bf16", False),
                                        ("int8", False), ("int8", True)])
@pytest.mark.parametrize("cap", [64, 32])  # 32 < touched rows: overflow
def test_encode_is_bitwise_jax(wire, flush, cap):
    delta, carry = _delta_and_carry(3)
    want = jax.jit(jex._build_encode_fn(_Geo, cap, wire, flush))(
        jnp.asarray(delta), jnp.asarray(carry))
    got = pex._build_encode_fn(_Geo, cap, wire, flush)(
        torch.from_numpy(delta), torch.from_numpy(carry))
    names = ("ids", "payload", "scales", "n", "overflow", "new_carry", "resid")
    for name, w, g in zip(names, want, got):
        np.testing.assert_array_equal(_bits(w), _torch_bits(g), err_msg=name)
    assert bool(got[4]) == (int(got[3]) > cap)


def _payloads(world, wire, cap, seed):
    """``world`` ranks' encoded sparse payloads (JAX's encoder), stacked."""
    enc = jax.jit(jex._build_encode_fn(_Geo, cap, wire, False))
    outs = []
    for r in range(world):
        delta, carry = _delta_and_carry(seed + r, touched=40 + 5 * r)
        outs.append([np.asarray(x) for x in enc(jnp.asarray(delta),
                                                jnp.asarray(carry))[:3]])
    return [np.stack([o[k] for o in outs]) for k in range(3)]


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("wire", ["fp32", "bf16", "int8"])
def test_sparse_apply_is_bitwise_jax(dtype, world, wire):
    cap = 64
    jeng = JaxEngine(make_mesh(1, 1), V, D, COUNTS, seed=3, dtype=dtype)
    base0 = np.array(jeng.syn0.astype(jnp.float32))
    base1 = np.array(jeng.syn1.astype(jnp.float32))
    i0, p0, s0 = _payloads(world, wire, cap, 10)
    i1, p1, s1 = _payloads(world, wire, cap, 20)
    want = jex._build_apply_sparse_fn(jeng, cap, world, wire)(
        jeng.syn0, jeng.syn1, i0, p0, s0, i1, p1, s1)
    peng = EmbeddingEngine(V, D, COUNTS, dtype=dtype, device="cpu")
    peng.set_tables(base0, base1)
    launches = rows_mod.scatter_add_rows.launches
    got = pex._build_apply_sparse_fn(peng, cap, world, wire)(
        peng.syn0, peng.syn1, *map(_to_torch, (i0, p0, s0, i1, p1, s1)))
    assert rows_mod.scatter_add_rows.launches == launches  # CPU: plain B3
    for w, g in zip(want, got):
        assert g.dtype == peng.syn0.dtype
        np.testing.assert_array_equal(_bits(np.asarray(w)), _torch_bits(g))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("world", [2, 3])
def test_dense_apply_is_bitwise_jax(dtype, world):
    jeng = JaxEngine(make_mesh(1, 1), V, D, COUNTS, seed=4, dtype=dtype)
    rng = np.random.default_rng(7)
    d0 = rng.normal(0, 1e-2, (world, V, D)).astype(np.float32)
    d1 = rng.normal(0, 1e-2, (world, V, D)).astype(np.float32)
    d0[:, :10] = 0.0
    want = jex._build_apply_dense_fn(jeng, world)(jeng.syn0, jeng.syn1, d0, d1)
    peng = EmbeddingEngine(V, D, COUNTS, dtype=dtype, device="cpu")
    peng.set_tables(np.array(jeng.syn0.astype(jnp.float32)),
                    np.array(jeng.syn1.astype(jnp.float32)))
    got = pex._build_apply_dense_fn(peng, world)(
        peng.syn0, peng.syn1, torch.from_numpy(d0), torch.from_numpy(d1))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_bits(np.asarray(w)), _torch_bits(g))


def test_node_fold_is_bitwise_jax():
    cap, world = 64, 4
    jeng = JaxEngine(make_mesh(1, 1), V, D, COUNTS, seed=3)
    ids, payload, _ = _payloads(world, "fp32", cap, 30)
    for members in ((0, 1), (2, 3), (0, 1, 2, 3)):
        want = jex._build_node_accum_fn(jeng, cap, members)(ids, payload)
        got = pex._build_node_accum_fn(_engines(1)[0], cap, members)(
            torch.from_numpy(ids), torch.from_numpy(payload))
        np.testing.assert_array_equal(_bits(np.asarray(want)), _torch_bits(got))


# ----------------------------------------------------------------------
# sync_group: the port's replicas against JAX's
# ----------------------------------------------------------------------


class _JaxGridDraws:
    """The JAX package's grid-step draws for the port's engine
    (``tests/test_torch_grid.py``'s ``JaxGridDraws``)."""

    def __init__(self, key, jeng, window):
        self.key, self.jeng, self.window = key, jeng, window

    def step_shrink(self, step, n_rows):
        from glint_word2vec_tpu.ops.device_batching import WINDOW_FOLD

        k = jax.random.fold_in(self.key, jnp.uint32(step))
        base = jax.random.fold_in(k, WINDOW_FOLD)
        s = np.array(jax.vmap(lambda r: jax.random.randint(
            jax.random.fold_in(base, r), (), 0, self.window, dtype=jnp.int32
        ))(jnp.arange(n_rows, dtype=jnp.int32)))
        return torch.from_numpy(s.astype(np.int64))

    def window_negatives(self, step, n_rows, lanes):
        from glint_word2vec_tpu.ops.sampling import sample_negatives_per_row

        k = jax.random.fold_in(self.key, jnp.uint32(step))
        return torch.from_numpy(np.asarray(sample_negatives_per_row(
            k, self.jeng._prob, self.jeng._alias,
            jnp.arange(n_rows, dtype=jnp.int32),
            (lanes, self.jeng.num_negatives))).astype(np.int32))


@pytest.mark.parametrize("wire,every", [("fp32", 1), ("int8", 2)])
def test_sync_group_port_replicas_track_jax(wire, every):
    world, B, W, spc, groups = 2, 32, 3, 2, 4
    rng = np.random.default_rng(2)
    s0 = rng.normal(0, 0.1, (V, D)).astype(np.float32)
    s1 = rng.normal(0, 0.1, (V, D)).astype(np.float32)
    jengs, pengs = [], []
    for r in range(world):
        je = JaxEngine(make_mesh(1, 1), V, D, COUNTS, seed=3)
        je.set_tables(s0, s1)
        pe = EmbeddingEngine(V, D, COUNTS, seed=3, device="cpu")
        pe.set_tables(s0, s1)
        shard = _corpus_shard(r, world, n_words=1500)
        je.upload_corpus(*shard)
        pe.upload_corpus(*shard)
        jengs.append(je)
        pengs.append(pe)
    jx = [jex.ReplicaExchanger(e, mode="sparse", capacity=128, wire=wire,
                               every=every) for e in jengs]
    px = [pex.ReplicaExchanger(e, mode="sparse", capacity=128, wire=wire,
                               every=every) for e in pengs]
    key = jax.random.PRNGKey(5)
    for g in range(groups):
        alphas = np.full(spc, 0.03, np.float32)
        for r in range(world):
            k = jax.random.fold_in(key, 1000 + r)
            jengs[r].train_steps_corpus(g * spc * B, B, W, k, alphas, g * spc)
            pengs[r].train_steps_corpus(g * spc * B, B, W, 0, alphas, g * spc,
                                        draws=_JaxGridDraws(k, jengs[r], W))
        if (g + 1) % every == 0:
            jex.sync_group(jx)
            pex.sync_group(px)
            for name in ("syn0", "syn1"):
                j0 = np.asarray(getattr(jengs[0], name))
                assert np.array_equal(j0, np.asarray(getattr(jengs[1], name)))
                p0 = getattr(pengs[0], name)
                assert torch.equal(p0, getattr(pengs[1], name))
                np.testing.assert_allclose(p0.numpy(), j0, rtol=1e-4, atol=1e-6,
                                           err_msg=f"{name} after group {g}")
    assert pengs[0].exchange_stats()["exchange_syncs_total"] == groups // every


# ----------------------------------------------------------------------
# The protocol tests of tests/test_exchange.py on the port
# ----------------------------------------------------------------------


def test_sparse_vs_dense_parity_multi_epoch():
    sp = _run_replicas("sparse", 1024)
    de = _run_replicas("dense", 1024)
    for a, b in zip(_tables(sp), _tables(de)):
        np.testing.assert_array_equal(a, b)
    st = sp.exchange_stats()
    assert st["exchange_syncs_total"] > 0
    assert st["exchange_dense_syncs_total"] == 0
    assert st["exchange_rows_total"] > 0


def test_sparse_vs_dense_parity_subsampled_resume(tmp_path):
    sp = _run_replicas("sparse", 1024, subsample=True, resume_after_groups=3,
                       tmp_path=tmp_path / "a")
    de = _run_replicas("dense", 1024, subsample=True, resume_after_groups=3,
                       tmp_path=tmp_path / "b")
    for a, b in zip(_tables(sp), _tables(de)):
        np.testing.assert_array_equal(a, b)


def test_overflow_spill_parity():
    sp = _run_replicas("sparse", 8, epochs=1)
    de = _run_replicas("dense", 8, epochs=1)
    for a, b in zip(_tables(sp), _tables(de)):
        np.testing.assert_array_equal(a, b)
    st = sp.exchange_stats()
    assert st["exchange_overflow_total"] > 0
    assert st["exchange_dense_syncs_total"] == st["exchange_overflow_total"]


def test_bf16_parity():
    sp = _run_replicas("sparse", 1024, epochs=1, dtype="bfloat16")
    de = _run_replicas("dense", 1024, epochs=1, dtype="bfloat16")
    assert sp.syn0.dtype == torch.bfloat16
    for a, b in zip(_tables(sp), _tables(de)):
        np.testing.assert_array_equal(a, b)


def test_wire_matrix_parity_and_bytes():
    base = _run_replicas("sparse", 1024, epochs=1, n_words=2500)
    b16 = _run_replicas("sparse", 1024, epochs=1, n_words=2500, wire="bf16")
    i8 = _run_replicas("sparse", 1024, epochs=1, n_words=2500, wire="int8")
    ref = _tables(base)
    for run in (b16, i8):
        for a, b in zip(_tables(run), ref):
            assert np.isfinite(a).all()
            np.testing.assert_allclose(a, b, atol=2e-3, rtol=0)
    sb, s16, s8 = (e.exchange_stats() for e in (base, b16, i8))
    assert (sb["exchange_syncs_total"] == s16["exchange_syncs_total"]
            == s8["exchange_syncs_total"])
    assert (s8["exchange_bytes_total"] < s16["exchange_bytes_total"]
            < sb["exchange_bytes_total"])
    assert sb["exchange_bytes_wire_fp32_total"] == sb["exchange_bytes_total"]
    assert s16["exchange_bytes_wire_bf16_total"] == s16["exchange_bytes_total"]
    assert s8["exchange_bytes_wire_int8_total"] == s8["exchange_bytes_total"]
    assert s8["exchange_dense_syncs_total"] == 0
    c32 = _run_replicas("sparse", 1024, epochs=1, n_words=2500, every=2)
    c8 = _run_replicas("sparse", 1024, epochs=1, n_words=2500, wire="int8",
                       every=2)
    sc32, sc8 = c32.exchange_stats(), c8.exchange_stats()
    assert sc32["exchange_syncs_total"] < sb["exchange_syncs_total"]
    assert sc8["exchange_syncs_total"] == sc32["exchange_syncs_total"]
    for run in (c32, c8):
        for a in _tables(run):
            assert np.isfinite(a).all()


def test_coalescing_schedule_bitwise(monkeypatch):
    """``every=2`` through ``group_end`` is bitwise ``every=1`` synced by
    hand on the same boundaries, through the loopback wire."""
    monkeypatch.setenv("GLINT_EXCHANGE_FORCE_WIRE", "1")
    B, W, spc = 64, 3, 2
    ids, offsets = _corpus_shard(0, 1)

    def _drive(eng, r):
        eng.train_steps_corpus(r * spc * B, B, W, rnd.fold_in(rnd.seed_key(7), r),
                               np.full(spc, 0.02, np.float32), r * spc)

    (e1,) = _engines(1)
    e1.upload_corpus(ids, offsets)
    xa = pex.ReplicaExchanger(e1, mode="sparse", capacity=256, every=2)
    assert not xa.short_circuit
    for r in range(4):
        _drive(e1, r)
        xa.group_end(live=True, done=(r == 3))
    (e2,) = _engines(1)
    e2.upload_corpus(ids, offsets)
    xb = pex.ReplicaExchanger(e2, mode="sparse", capacity=256, every=1)
    for r in range(4):
        _drive(e2, r)
        if (r + 1) % 2 == 0:
            xb.sync(live=True, done=(r == 3))
    sa, sb = e1.exchange_stats(), e2.exchange_stats()
    assert sa["exchange_syncs_total"] == 2 == sb["exchange_syncs_total"]
    assert sa["exchange_groups_total"] == 4
    assert torch.equal(e1.syn0, e2.syn0) and torch.equal(e1.syn1, e2.syn1)


def test_error_feedback_residual_conservation():
    """Dequantized payload + new carry == true delta + old carry, row for
    row; a flush drains the carry to zero."""
    (eng,) = _engines(1)
    ex = pex.ReplicaExchanger(eng, mode="sparse", capacity=256, wire="int8")
    rng = np.random.default_rng(4)

    def _round(old_carry):
        bases = [t.float().numpy().copy() for t in (eng.syn0, eng.syn1)]
        _random_step(eng, rng, key=2)
        (n0, o0, n1, o1), (i0, p0, s0, i1, p1, s1) = ex.harvest()
        assert not o0 and not o1 and n0 + n1 > 0
        curs = [t.float().numpy() for t in (eng.syn0, eng.syn1)]
        for lane, (n, ids, q, sc) in enumerate([(n0, i0, p0, s0),
                                                (n1, i1, p1, s1)]):
            if n == 0:
                continue
            rows = ids[:n].numpy()
            delta = curs[lane][rows] - bases[lane][rows]
            deq = q[:n].float().numpy() * sc[:n].numpy()[:, None]
            new_carry = ex._pending_carry[lane].numpy()[rows]
            np.testing.assert_allclose(deq + new_carry,
                                       delta + old_carry[lane][rows],
                                       atol=1e-5, rtol=0)
            assert np.all(np.abs(q[:n].numpy().astype(np.int32)) <= 127)
            assert np.all(np.abs(new_carry)
                          <= sc[:n].numpy()[:, None] * 0.5 + 1e-7)

    zeros = np.zeros((V, D), np.float32)
    _round((zeros, zeros))
    pex.sync_group([ex])
    carried = (ex._carry[0].numpy()[:V], ex._carry[1].numpy()[:V])
    assert ex.residual_stats()["residual_abs"] >= float(max(
        np.abs(carried[0]).max(), np.abs(carried[1]).max())) > 0.0
    _round(carried)
    pex.flush_group([ex])
    assert ex._carry is None
    assert ex.residual_stats()["residual_abs"] == 0.0
    assert eng.exchange_stats()["exchange_flushes_total"] == 1


def test_overflow_spill_coalesced_int8():
    sp = _run_replicas("sparse", 8, epochs=1, n_words=2500, wire="int8", every=2)
    de = _run_replicas("dense", 8, epochs=1, n_words=2500, wire="int8", every=2)
    for a, b in zip(_tables(sp), _tables(de)):
        np.testing.assert_array_equal(a, b)
    st = sp.exchange_stats()
    assert st["exchange_overflow_total"] > 0
    assert st["exchange_dense_syncs_total"] == st["exchange_syncs_total"]
    assert st["exchange_bytes_wire_int8_total"] == 0
    assert st["exchange_bytes_wire_fp32_total"] == st["exchange_bytes_total"]


def test_midrun_resume_coalesced_int8(tmp_path):
    a = _run_replicas("sparse", 1024, epochs=1, n_words=2500, wire="int8",
                      every=2, resume_after_groups=4, flush_after_groups=4,
                      tmp_path=tmp_path)
    b = _run_replicas("sparse", 1024, epochs=1, n_words=2500, wire="int8",
                      every=2, flush_after_groups=4)
    for x, y in zip(_tables(a), _tables(b)):
        np.testing.assert_array_equal(x, y)
    assert b.exchange_stats()["exchange_flushes_total"] == 1


def test_twolevel_topology_parity_and_byte_split():
    eng = _run_replicas("sparse", 1024, epochs=1, world=4, n_words=2400,
                        wire="int8", topology="twolevel", node_size=2)
    st = eng.exchange_stats()
    assert st["exchange_syncs_total"] > 0
    assert st["exchange_dense_syncs_total"] == 0
    assert st["exchange_intra_bytes_total"] > 0
    assert st["exchange_inter_bytes_total"] > 0
    assert (st["exchange_intra_bytes_total"] + st["exchange_inter_bytes_total"]
            == st["exchange_bytes_total"])
    assert st["exchange_inter_bytes_total"] < st["exchange_intra_bytes_total"]
    for a in _tables(eng):
        assert np.isfinite(a).all()


def test_world1_short_circuit(monkeypatch):
    (eng,) = _engines(1)
    ex = pex.ReplicaExchanger(eng, mode="sparse", capacity=64, wire="int8")
    assert ex.short_circuit
    rng = np.random.default_rng(0)
    _random_step(eng, rng)
    assert ex.sync(live=True, done=False) is True
    assert ex.sync(live=True, done=True) is False
    assert ex.flush() is False
    st = eng.exchange_stats()
    assert st["exchange_syncs_total"] == 2
    assert st["exchange_world1_skips_total"] == 2
    assert st["exchange_bytes_total"] == 0
    assert st["exchange_flushes_total"] == 0
    monkeypatch.setenv("GLINT_EXCHANGE_FORCE_WIRE", "1")
    (e2,) = _engines(1)
    x2 = pex.ReplicaExchanger(e2, mode="sparse", capacity=64)
    assert not x2.short_circuit
    _random_step(e2, rng)
    x2.sync(live=True)
    st2 = e2.exchange_stats()
    assert st2["exchange_bytes_total"] > 0
    assert st2["exchange_world1_skips_total"] == 0


def test_adaptive_capacity_matches_jax_decisions(monkeypatch):
    """Unpinned capacity shrinks after a full window of small rounds and
    grows past an overflow, with the same decision sequence as JAX's on the
    same headers; a pinned capacity never adapts."""
    monkeypatch.setenv("GLINT_EXCHANGE_FORCE_WIRE", "1")
    monkeypatch.delenv("GLINT_EXCHANGE_CAPACITY", raising=False)
    V2 = 4096
    counts = np.random.default_rng(0).integers(1, 100, V2)
    peng = EmbeddingEngine(V2, 8, counts, seed=3, device="cpu")
    jeng = JaxEngine(make_mesh(1, 1), V2, 8, counts, seed=3)
    px = pex.ReplicaExchanger(peng, mode="sparse", pair_batch=64, steps_per_call=4)
    jx = jex.ReplicaExchanger(jeng, mode="sparse", pair_batch=64, steps_per_call=4)
    assert not px.capacity_pinned and px.capacity == jx.capacity > pex.CAPACITY_FLOOR
    rng = np.random.default_rng(1)
    seq = list(rng.integers(1, 200, 40)) + [3000] + list(rng.integers(1, 90, 20))
    ovf = [False] * 40 + [True] + [False] * 20
    for n, o in zip(seq, ovf):
        assert px._adapt_capacity(int(n), o) == jx._adapt_capacity(int(n), o)
        assert px.capacity == jx.capacity

    # Through real rounds: a window of small rounds shrinks, an overflow grows.
    start = pex.ReplicaExchanger(peng, mode="sparse", pair_batch=64,
                                 steps_per_call=4)
    first = start.capacity
    for _ in range(pex.CAPACITY_WINDOW):
        _train_step(peng, rng.integers(0, 32, 4).astype(np.int32),
                    rng.integers(0, 32, (4, 2)).astype(np.int32),
                    np.ones((4, 2), np.float32), 1, 0.01)
        start.sync(live=True)
    small = start.capacity
    assert small < first
    st = peng.exchange_stats()
    assert st["exchange_capacity_shrinks_total"] == 1
    assert st["exchange_capacity"] == small
    _train_step(peng, (np.arange(1024, dtype=np.int32) * 3) % V2,
                ((np.arange(2048, dtype=np.int32) * 7) % V2).reshape(1024, 2),
                np.ones((1024, 2), np.float32), 2, 0.01)
    start.sync(live=True)
    assert start.capacity > small
    st = peng.exchange_stats()
    assert st["exchange_capacity_grows_total"] >= 1
    assert st["exchange_overflow_total"] >= 1
    (e2,) = _engines(1)
    x2 = pex.ReplicaExchanger(e2, mode="sparse", capacity=64)
    assert x2.capacity_pinned
    for _ in range(pex.CAPACITY_WINDOW + 1):
        assert x2._adapt_capacity(4, False) is None
    assert x2.capacity == 64


def test_kept_host_buffers_follow_capacity_and_skip_flush(monkeypatch):
    """A wire round gathers into named (kept) buffers, a flush round into
    none; a capacity change drops the buffers kept for the old capacity,
    the exchanger's own and the transport's."""
    monkeypatch.setenv("GLINT_EXCHANGE_FORCE_WIRE", "1")
    monkeypatch.delenv("GLINT_EXCHANGE_CAPACITY", raising=False)

    class Recording(pex.NullTransport):
        def __init__(self):
            self.slots, self.drops = [], 0

        def allgather(self, arr, slot=None):
            self.slots.append(slot)
            return super().allgather(arr)

        def drop_buffers(self):
            self.drops += 1

        def kept_bytes(self):
            return 0

    V2 = 4096
    counts = np.random.default_rng(0).integers(1, 100, V2)
    eng = EmbeddingEngine(V2, 8, counts, seed=3, device="cpu")
    tr = Recording()
    ex = pex.ReplicaExchanger(eng, mode="sparse", pair_batch=64,
                              steps_per_call=4, wire="int8", transport=tr)
    assert not ex.short_circuit and ex.capacity < V2
    rng = np.random.default_rng(1)
    _train_step(eng, rng.integers(0, 64, 4).astype(np.int32),
                rng.integers(0, 64, (4, 2)).astype(np.int32),
                np.ones((4, 2), np.float32), 1, 0.01)
    ex.sync(live=True)
    assert {"ids0", "p0", "s0", "ids1", "p1", "s1"} <= set(tr.slots)
    tr.slots.clear()
    assert ex.flush()
    assert tr.slots and all(s is None for s in tr.slots), tr.slots
    ex._host_bufs["kept"] = torch.zeros(8)
    assert ex.host_memory()["exchange_kept_bytes"] == 32
    assert ex._adapt_capacity(V2, True) == "grow"
    assert tr.drops == 1 and not ex._host_bufs
    assert ex.host_memory()["exchange_kept_bytes"] == 0


def test_harvest_exact_touched_rows():
    (eng,) = _engines(1)
    ex = pex.ReplicaExchanger(eng, mode="sparse", capacity=64)
    rng = np.random.default_rng(0)
    base0 = eng.syn0.numpy().copy()
    _random_step(eng, rng)
    (n0, o0, n1, o1), (i0, d0, _s0, i1, d1, _s1) = ex.harvest()
    cur0 = eng.syn0.numpy()
    true_touched = np.where(np.any(cur0 != base0, axis=1))[0]
    got = np.sort(i0[:n0].numpy())
    np.testing.assert_array_equal(got, true_touched)
    assert len(np.unique(got)) == n0 and not o0
    rows = i0[:n0].numpy()
    np.testing.assert_array_equal(base0[rows] + d0[:n0].numpy(), cur0[rows])


def test_transport_allgather_keeps_bf16_bits():
    """The one-process transport round-trips every wire dtype; the byte
    view the gloo wire sends bf16 lanes as is the identity on the bits."""
    t = torch.randn(5, 7).to(torch.bfloat16)
    out = pex.NullTransport().allgather(t)
    assert out.shape == (1, 5, 7) and torch.equal(out[0], t)
    w = pdist._wire_view(t)
    assert w.dtype == torch.uint8
    assert torch.equal(w.view(torch.bfloat16).reshape(5, 7), t)
    h = np.arange(6, dtype=np.int64)
    np.testing.assert_array_equal(pdist.allgather_host(h), h[None])
    with pytest.raises(RuntimeError, match="process group"):
        pex.ProcessTransport()


# ----------------------------------------------------------------------
# Fit level
# ----------------------------------------------------------------------


def _sents(seed, n_words, length, n):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(n_words)]
    return [[str(w) for w in rng.choice(words, size=length)] for _ in range(n)]


_COMMON = dict(vector_size=16, min_count=1, batch_size=128, num_iterations=1,
               seed=3, steps_per_call=4)


def test_fit_level_exchange_and_escape_hatch(monkeypatch):
    sents = _sents(11, 60, 8, 400)
    m = Word2Vec(device="cpu", **_COMMON, exchange="sparse").fit(sents)
    st = m.training_metrics["exchange"]
    assert m.training_metrics["exchange_mode"] == "sparse"
    assert st["exchange_syncs_total"] > 0
    assert st["exchange_dense_syncs_total"] == 0
    assert st["exchange_world1_skips_total"] == st["exchange_syncs_total"]
    assert st["exchange_bytes_total"] == 0
    monkeypatch.setenv("GLINT_EXCHANGE_FORCE_WIRE", "1")
    monkeypatch.setenv("GLINT_DENSE_EXCHANGE", "1")
    m2 = Word2Vec(device="cpu", **_COMMON, exchange="sparse").fit(sents)
    st2 = m2.training_metrics["exchange"]
    assert st2["exchange_syncs_total"] > 0
    assert st2["exchange_dense_syncs_total"] == st2["exchange_syncs_total"]
    assert st2["exchange_bytes_total"] > 0


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_fit_level_exchange_grid_path(monkeypatch, wire):
    """The grid loop runs a round a group; through the loopback wire an
    exact round rebuilds ``base + delta``, which stays within float
    rounding of the unexchanged fit."""
    sents = _sents(12, 40, 6, 300)
    kw = dict(_COMMON, batch_packing="grid")
    plain = Word2Vec(device="cpu", **kw).fit(sents)
    monkeypatch.setenv("GLINT_EXCHANGE_FORCE_WIRE", "1")
    m = Word2Vec(device="cpu", **kw, exchange="sparse",
                 exchange_wire=wire).fit(sents)
    st = m.training_metrics["exchange"]
    assert st["exchange_syncs_total"] > 0 and st["exchange_bytes_total"] > 0
    assert m.training_metrics["steps"] == plain.training_metrics["steps"]
    if wire == "fp32":
        np.testing.assert_allclose(m.engine.syn0.numpy(),
                                   plain.engine.syn0.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_fit_level_wire_knobs():
    sents = _sents(13, 50, 7, 350)
    m = Word2Vec(device="cpu", **_COMMON, exchange="sparse",
                 exchange_wire="int8", exchange_every=2,
                 exchange_shard="locality").fit(sents)
    tm = m.training_metrics
    assert tm["exchange_wire"] == "int8"
    assert tm["exchange_every"] == 2
    assert tm["exchange_topology"] == "flat"
    st = tm["exchange"]
    assert st["exchange_syncs_total"] > 0
    assert st["exchange_groups_total"] >= 2 * st["exchange_syncs_total"]


@pytest.mark.parametrize("packing", ["dense", "grid"])
def test_checkpointed_exchange_fit_resumes_bitwise(tmp_path, monkeypatch,
                                                   packing):
    """A checkpointed int8 coalesced exchange fit (loopback wire) stopped
    after one epoch and resumed ends bitwise equal to the uninterrupted
    fit: the carry is flushed before every checkpoint."""
    monkeypatch.setenv("GLINT_EXCHANGE_FORCE_WIRE", "1")
    sents = _sents(14, 50, 7, 300)
    kw = dict(_COMMON, num_iterations=2, exchange="sparse",
              exchange_wire="int8", exchange_every=2, batch_packing=packing)
    full = Word2Vec(device="cpu", **kw).fit(sents, checkpoint_dir=str(tmp_path / "a"))
    ck = str(tmp_path / "b")
    Word2Vec(device="cpu", **kw).fit(sents, checkpoint_dir=ck, stop_after_epochs=1)
    resumed = Word2Vec(device="cpu", **kw).fit(sents, checkpoint_dir=ck)
    assert torch.equal(full.engine.syn0, resumed.engine.syn0)
    assert torch.equal(full.engine.syn1, resumed.engine.syn1)
    assert full.training_metrics["exchange"]["exchange_flushes_total"] == 2
    assert resumed.training_metrics["exchange"]["exchange_flushes_total"] == 1


def test_exchange_telemetry_through_obs_layers(monkeypatch):
    from glint_word2vec_torch.obs.aggregate import merge_training_snapshots
    from glint_word2vec_torch.obs.heartbeat import TrainingStatus
    from glint_word2vec_torch.obs.prometheus import (
        gang_to_prometheus,
        lint_prometheus_text,
        training_to_prometheus,
    )

    monkeypatch.setenv("GLINT_EXCHANGE_FORCE_WIRE", "1")
    (eng,) = _engines(1)
    ex = pex.ReplicaExchanger(eng, mode="sparse", capacity=64)
    _random_step(eng, np.random.default_rng(0))
    ex.sync()
    snap = TrainingStatus(pipeline="device_corpus", engine=eng).snapshot(
        include_devices=False)
    assert snap["exchange_syncs_total"] == 1
    assert snap["exchange_bytes_total"] > 0
    assert snap["exchange_bytes_wire_fp32_total"] == snap["exchange_bytes_total"]
    assert snap["exchange_groups_total"] == 1
    assert snap["exchange_capacity"] == 64
    assert "exchange_residual_abs" in snap
    assert "checkpoint_shards_skipped" in snap
    text = training_to_prometheus(snap)
    lint_prometheus_text(text)
    for name in ("glint_training_exchange_bytes_total",
                 "glint_training_exchange_bytes_wire_int8_total",
                 "glint_training_exchange_capacity",
                 "glint_training_exchange_residual_abs"):
        assert name in text
    merged = merge_training_snapshots({0: snap, 1: snap})
    assert merged["counters"]["exchange_bytes_total"] == \
        2 * snap["exchange_bytes_total"]
    assert merged["counters"]["exchange_groups_total"] == 2
    gtext = gang_to_prometheus(merged)
    lint_prometheus_text(gtext)
    for name in ("glint_gang_exchange_rows_total",
                 "glint_gang_exchange_groups_total",
                 "glint_gang_exchange_intra_bytes_total",
                 "glint_gang_exchange_inter_bytes_total"):
        assert name in gtext


def test_gang_merge_equals_jax_merge():
    """The port's gang merge gives the JAX merge's counters, words/s,
    skew and step-time quantiles on the same snapshots."""
    from glint_word2vec_tpu.obs.aggregate import merge_training_snapshots as jm
    from glint_word2vec_tpu.utils.metrics import StepTimeLedger as JLedger

    from glint_word2vec_torch.obs.aggregate import merge_training_snapshots as pm
    from glint_word2vec_torch.utils.metrics import StepTimeLedger

    snaps = {}
    for r in range(3):
        led, jled = StepTimeLedger(), JLedger()
        for i in range(5):
            led.account("dispatch", 0.01 * (i + r + 1))
            jled.account("dispatch", 0.01 * (i + r + 1))
        snaps[r] = {"state": "running", "supervisor_generation": 1,
                    "step": 10 * (r + 1), "words_done": 100 * (r + 1),
                    "words_per_sec_rolling": 5.0 * (r + 1), "step_time": 1.0,
                    "exchange_bytes_total": 7 * r, "exchange_rows_total": r,
                    "events": {"recorded": 2, "dropped": 1},
                    "steptime": led.snapshot()}
    snaps[3] = None
    got = pm(snaps, generation=1, num_workers=4)
    want = jm(snaps, generation=1, num_workers=4)
    for key in ("ranks_reporting", "state", "words_per_sec_total", "rank_skew"):
        assert got[key] == want[key], key
    for k, v in got["counters"].items():
        assert v == want["counters"][k], k
    assert got["steptime"]["dispatch"] == want["steptime"]["dispatch"]
    assert pm({0: dict(snaps[0], supervisor_generation=0)},
              generation=1)["ranks_reporting"] == 0


def test_engine_save_split_writes_only_its_block(tmp_path):
    """Under a save split each rank writes only its row block and sidecar
    (rank 0 also the small files and the manifest); the blocks together
    load as the table."""
    eng = _engines(1)[0]
    path = str(tmp_path / "ck")
    eng.set_save_split(1, 3)
    assert not eng.async_saves_enabled()
    eng.save(path)
    per = -(-V // 3)
    assert sorted(os.listdir(path)) == sorted(
        f"{t}.r{per:012d}.npy{s}" for t in ("syn0", "syn1")
        for s in ("", ".manifest.json"))
    for rank in (0, 2):
        eng.set_save_split(rank, 3)
        eng.save(path)
    assert {"counts.npy", "engine.json", "manifest.json"} <= set(os.listdir(path))
    back = EmbeddingEngine.load(path, device="cpu")
    assert torch.equal(back.syn0, eng.syn0) and torch.equal(back.syn1, eng.syn1)
    eng.set_save_split(0, 1)
    assert eng.async_saves_enabled()


def test_gang_rank_has_no_fallback(monkeypatch):
    """A gang rank whose shard is sent to the host batcher raises (there
    is no host-batcher gang), and a rank that finds no card raises unless
    the CPU was asked for."""
    monkeypatch.setattr(pdist, "process_count", lambda: 2)
    monkeypatch.setenv("GLINT_HOST_BATCHER", "1")
    with pytest.raises(ValueError, match="device-resident corpus"):
        Word2Vec(device="cpu", **_COMMON, exchange="sparse").fit(
            _sents(15, 30, 6, 100))
    assert pdist.rank_device("cpu", 1) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pdist.rank_device(None, 1)
