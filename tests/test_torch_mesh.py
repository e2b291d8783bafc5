"""The port's SPMD mesh (glint_word2vec_torch/parallel/mesh.py and the
mesh half of parallel/engine.py) against the JAX engine on the same mesh
shape: the port on ``devices=["cpu"] * 8``, JAX on its 8 forced CPU
devices (tests/conftest.py), both from the same tables (the JAX engine's
initial ones, installed with ``set_tables``) and the same draws (the JAX
package's threefry negatives handed to the port with ``negs=``, its
shrink, negative and pool draws through a draws object on the packed
path). The mesh cases of tests/test_engine.py, on the shapes (1, 1),
(1, 8), (2, 4), (8, 1) and (4, 2).

Tolerances: geometry, ids, draws and top-k indices compare exactly; fp32
tables within rtol 1e-5 and atol 1e-6 (sums in another order: XLA's
einsums and psums against PyTorch's); losses within rel 1e-5; saved and
reloaded tables bitwise.
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
from glint_word2vec_tpu.ops.sampling import (
    sample_negatives,
    sample_negatives_per_row,
)
from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
from glint_word2vec_tpu.parallel.mesh import make_mesh as jax_mesh

from glint_word2vec_torch.ops import fused_sgns as fs
from glint_word2vec_torch.parallel import engine as peng_mod
from glint_word2vec_torch.parallel import mesh as pmesh
from glint_word2vec_torch.parallel.engine import EmbeddingEngine, TrainingDraws

V, D, N = 50, 12, 4
SHAPES = [(1, 1), (1, 8), (2, 4), (8, 1), (4, 2)]
CPU8 = ["cpu"] * 8
TOL = dict(rtol=1e-5, atol=1e-6)


def _mesh(shape):
    return pmesh.make_mesh(*shape, devices=CPU8)


def _counts():
    return np.arange(V, 0, -1).astype(np.int64) * 10


def _pair(shape, layout="rows", **kw):
    """A JAX engine and a port engine on the same mesh shape and layout,
    holding the JAX engine's initial tables (syn1 made non-zero so that
    the first step moves syn0 too)."""
    jeng = JaxEngine(jax_mesh(*shape), V, D, _counts(), num_negatives=N,
                     seed=3, layout=layout, **kw)
    rng = np.random.default_rng(11)
    s0 = np.asarray(jeng.syn0, np.float32)[:V, :D]
    s1 = rng.normal(0, 0.2, (V, D)).astype(np.float32)
    jeng.set_tables(s0, s1)
    peng = EmbeddingEngine(V, D, _counts(), num_negatives=N, seed=3,
                           mesh=_mesh(shape), layout=layout, **kw)
    peng.set_tables(s0, s1)
    return jeng, peng


def _batch(K=3, B=16, C=5, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, V, (K, B)).astype(np.int32)
    contexts = rng.integers(0, V, (K, B, C)).astype(np.int32)
    mask = (rng.random((K, B, C)) < 0.8).astype(np.float32)
    return centers, np.where(mask > 0, contexts, 0).astype(np.int32), mask


def _jax_negs(jeng, key, step0, K, B, C):
    return np.stack([
        np.asarray(sample_negatives_per_row(
            jax.random.fold_in(key, jnp.uint32(step0 + i)), jeng._prob,
            jeng._alias, jnp.arange(B, dtype=jnp.int32), (C, N),
        )) for i in range(K)
    ])


def _tables(eng):
    return (np.asarray(eng.syn0, np.float32)[:V, :D],
            np.asarray(eng.syn1, np.float32)[:V, :D])


def _port_tables(eng):
    return (eng.logical_table(0).float().numpy()[:V, :D],
            eng.logical_table(1).float().numpy()[:V, :D])


# ----------------------------------------------------------------------
# Mesh construction and geometry
# ----------------------------------------------------------------------


def test_mesh_construction_variants():
    for args in [(2, 4), (None, 8), (8, None), (1, 1)]:
        assert (pmesh.make_mesh(*args, devices=CPU8).shape
                == jax_mesh(*args).shape)
    assert pmesh.make_mesh(devices=CPU8).shape == jax_mesh().shape
    with pytest.raises(ValueError):
        jax_mesh(3, 3)
    with pytest.raises(ValueError):
        pmesh.make_mesh(3, 3, devices=CPU8)
    m = pmesh.make_mesh(2, 4, devices=CPU8)
    assert m.model_devices == (torch.device("cpu"),) * 4
    assert pmesh.table_sharding(m).spec == ("model", None)
    assert pmesh.table_sharding_dims(m).spec == (None, "model")
    assert pmesh.batch_sharding(m).spec == ("data",)
    assert pmesh.replicated(m).spec == ()
    assert [pmesh.pad_to_multiple(n, 8) for n in (1, 8, 9)] == [8, 8, 16]
    if not torch.cuda.is_available():
        # No devices named: the visible cards, never the CPU.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.make_mesh(1, 1)


def test_collectives_sum_in_shard_order_and_join_in_rank_order():
    parts = [torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])]
    assert pmesh.psum(parts).tolist() == [4.0, 6.0]
    assert pmesh.all_gather(parts).tolist() == [1.0, 2.0, 3.0, 4.0]
    two = [torch.ones(2, 1), torch.zeros(2, 2)]
    assert pmesh.all_gather(two, dim=1).shape == (2, 3)


@pytest.mark.parametrize("layout", ["rows", "dims"])
@pytest.mark.parametrize("shape", SHAPES)
def test_geometry_and_initial_tables_match(shape, layout):
    jeng = JaxEngine(jax_mesh(*shape), V, D, _counts(), seed=3, layout=layout)
    peng = EmbeddingEngine(V, D, _counts(), seed=3, mesh=_mesh(shape),
                           layout=layout)
    for name in ("padded_vocab", "rows_per_shard", "cols_per_shard",
                 "padded_dim", "num_data", "num_model", "layout"):
        assert getattr(peng, name) == getattr(jeng, name), name
    assert peng.mesh.shape == jeng.mesh.shape
    table = peng.logical_table(0)
    assert table.shape == (jeng.padded_vocab, jeng.padded_dim)
    # The initial tables do not depend on the mesh shape or the layout.
    one = EmbeddingEngine(V, D, _counts(), seed=3, device="cpu")
    np.testing.assert_array_equal(table.numpy()[:V, :D], one.syn0.numpy())
    assert not table.numpy()[V:].any() and not table.numpy()[:, D:].any()
    shards = peng.shard_tables(0)
    assert len(shards) == peng.num_model
    assert all(t.is_contiguous() for t in shards)
    if layout == "dims":
        assert {tuple(t.shape) for t in shards} == {(V, peng.cols_per_shard)}


@pytest.mark.parametrize("shape,layout", [((1, 2), "rows"), ((2, 4), "dims"),
                                          ((8, 1), "rows")])
def test_table_getters_refuse_a_table_split_over_model_shards(shape, layout):
    # A write through the getter must reach the table: on a model-sharded
    # mesh there is no one live tensor, so the getter raises, and the
    # shards themselves are live.
    peng = EmbeddingEngine(V, D, _counts(), seed=3, mesh=_mesh(shape),
                           layout=layout)
    if peng.num_model == 1:
        assert peng.syn0 is peng.shard_tables(0)[0]
        peng.syn1.fill_(0.5)
        assert bool((peng.logical_table(1) == 0.5).all())
        return
    for name in ("syn0", "syn1"):
        with pytest.raises(RuntimeError, match="logical_table"):
            getattr(peng, name)
    peng.shard_tables(0)[1].fill_(0.5)
    whole = peng.logical_table(0)
    if layout == "rows":
        lo = peng.rows_per_shard
        assert bool((whole[lo:2 * lo] == 0.5).all())
    else:
        c = peng.cols_per_shard
        assert bool((whole[:, c:2 * c] == 0.5).all())
    whole.fill_(0.0)  # a copy: no shard moves
    assert bool((peng.shard_tables(0)[1] == 0.5).all())


# ----------------------------------------------------------------------
# Queries
# ----------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["rows", "dims"])
@pytest.mark.parametrize("shape", SHAPES)
def test_queries_match_jax(shape, layout):
    jeng, peng = _pair(shape, layout)
    idx = np.array([0, 7, 49, 3, 3], np.int32)
    np.testing.assert_allclose(peng.pull(idx).numpy(),
                               np.asarray(jeng.pull(idx)), **TOL)
    sent = np.array([[1, 2, 3], [4, 0, 0], [0, 0, 0]], np.int32)
    smask = np.array([[1, 1, 1], [1, 0, 0], [0, 0, 0]], np.float32)
    np.testing.assert_allclose(peng.pull_average(sent, smask).numpy(),
                               np.asarray(jeng.pull_average(sent, smask)), **TOL)
    np.testing.assert_allclose(peng.norms().numpy()[:V],
                               np.asarray(jeng.norms())[:V], **TOL)
    v = np.random.default_rng(2).normal(size=D).astype(np.float32)
    np.testing.assert_allclose(peng.multiply(v).numpy()[:V],
                               np.asarray(jeng.multiply(v))[:V], **TOL)
    ps, pi = peng.top_k_cosine(v, 5)
    js, ji = jeng.top_k_cosine(v, 5)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, **TOL)
    q = np.random.default_rng(3).normal(size=(3, D)).astype(np.float32)
    ps, pi = peng.top_k_cosine_batch(q, 7)
    js, ji = jeng.top_k_cosine_batch(q, 7)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, **TOL)
    # A k covering nearly all of the vocabulary surfaces no padded row.
    sims, ids = peng.top_k_cosine(np.ones(D, np.float32), V)
    assert np.all(ids < V) and np.all(np.isfinite(sims))


def test_write_rows_on_a_mesh_matches_jax():
    jeng, peng = _pair((2, 4), "dims")
    rows = np.random.default_rng(4).normal(size=(5, D)).astype(np.float32)
    jeng.write_rows(20, jnp.asarray(rows))
    peng.write_rows(20, rows)
    np.testing.assert_array_equal(_port_tables(peng)[0], _tables(jeng)[0])
    e2 = EmbeddingEngine(V, D, _counts(), mesh=_mesh((1, 8)), extra_rows=6)
    start = e2.assign_extra_rows(["a", "b"])[0]
    assert start == V and e2.queryable_rows == V + 2
    one = EmbeddingEngine(V, D, _counts(), device="cpu", extra_rows=6)
    one.assign_extra_rows(["a", "b"])
    np.testing.assert_array_equal(e2.logical_table(0).numpy()[:V + 6],
                                  one.syn0.numpy())
    assert e2.free_extra_rows() == 2
    assert not e2.logical_table(0).numpy()[V:V + 2].any()


def test_destroy_frees_the_shards():
    peng = EmbeddingEngine(V, D, _counts(), mesh=_mesh((2, 4)))
    assert peng.tables_resident and peng.resident_bytes() == 2 * 52 * D * 4
    peng.destroy()
    assert not peng.tables_resident and peng.resident_bytes() == 0


# ----------------------------------------------------------------------
# Training
# ----------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["rows", "dims"])
@pytest.mark.parametrize("shape", SHAPES)
def test_train_steps_match_jax_on_the_same_mesh(shape, layout):
    jeng, peng = _pair(shape, layout)
    centers, contexts, mask = _batch(seed=4)
    key, step0 = jax.random.PRNGKey(5), 2
    alphas = np.array([0.05, 0.04, 0.03], np.float32)
    jl = np.asarray(jeng.train_steps(centers, contexts, mask, key, alphas, step0))
    negs = _jax_negs(jeng, key, step0, 3, 16, 5)
    pl = peng.train_steps(centers, contexts, mask, 0, alphas, step0, negs=negs)
    np.testing.assert_allclose(pl.numpy(), jl, rtol=1e-5)
    for got, want in zip(_port_tables(peng), _tables(jeng)):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape,layout,dtype", [
    ((2, 4), "rows", "float32"), ((4, 2), "dims", "float32"),
    ((8, 1), "rows", "float32"), ((1, 8), "rows", "bfloat16"),
])
def test_shared_pool_and_grouped_steps_match_jax(shape, layout, dtype):
    S, K, B, C, G = 8, 2, 16, 3, 3
    jeng, peng = _pair(shape, layout, shared_negatives=S, dtype=dtype)
    rng = np.random.default_rng(6)
    cg = rng.integers(0, V, (K, B, G)).astype(np.int32)
    gm = (rng.random((K, B, G)) < 0.7).astype(np.float32)
    gm[..., 0] = 1.0
    cx = rng.integers(0, V, (K, B, C)).astype(np.int32)
    mk = (rng.random((K, B, C)) < 0.8).astype(np.float32)
    key = jax.random.PRNGKey(9)
    alphas = np.array([0.05, 0.04], np.float32)
    jl = np.asarray(jeng.train_steps_grouped(cg, gm, cx, mk, key, alphas, 1))
    pools = np.stack([np.asarray(sample_negatives(
        jax.random.fold_in(key, jnp.uint32(1 + i)), jeng._prob, jeng._alias,
        (S,))) for i in range(K)])
    pl = peng.train_steps_grouped(cg, gm, cx, mk, 0, alphas, 1, pools=pools)
    np.testing.assert_allclose(pl.numpy(), jl, rtol=1e-5)
    for got, want in zip(_port_tables(peng), _tables(jeng)):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **TOL)
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2**-126))) - 7)
            assert (np.abs(got - want) <= ulp).all()


class JaxDraws:
    """The JAX package's shrink, negative and pool draws for the port's
    packed path, a data rank's rows keyed by their global pair row."""

    def __init__(self, key, jeng, window, grid_batch):
        self.key, self.jeng = key, jeng
        self.window, self.grid_batch = window, grid_batch

    def shrink(self, positions, grid_step0):
        b = grid_window_shrink(
            self.key, jnp.asarray(positions.numpy().astype(np.int32)),
            self.grid_batch, jnp.uint32(grid_step0), self.window)
        return torch.from_numpy(np.asarray(b).astype(np.int64))

    def negatives(self, step, n_rows, row0=0):
        negs = sample_negatives_per_row(
            jax.random.fold_in(self.key, jnp.uint32(step)), self.jeng._prob,
            self.jeng._alias, jnp.arange(row0, row0 + n_rows, dtype=jnp.int32),
            (1, N))
        return torch.from_numpy(np.asarray(negs)[:, 0, :].astype(np.int32))

    def pool(self, step, size):
        return torch.from_numpy(np.asarray(sample_negatives(
            jax.random.fold_in(self.key, jnp.uint32(step)), self.jeng._prob,
            self.jeng._alias, (size,))).astype(np.int32))


def _corpus(seed=0):
    rng = np.random.default_rng(seed)
    lens = (5, 1, 9, 3, 12, 2, 6, 30, 4, 17)
    ids = np.concatenate([rng.integers(0, V, L) for L in lens]).astype(np.int32)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return ids, offsets


@pytest.mark.parametrize("shape,layout,S", [
    ((2, 1), "rows", 0), ((8, 1), "rows", 8), ((1, 8), "rows", 0),
    ((4, 2), "rows", 0), ((2, 4), "dims", 0), ((4, 2), "dims", 8),
    ((1, 1), "rows", 0),
])
def test_packed_steps_match_jax_on_the_same_mesh(shape, layout, S):
    jeng, peng = _pair(shape, layout, shared_negatives=S)
    ids, offsets = _corpus()
    jeng.upload_corpus(ids, offsets)
    peng.upload_corpus(ids, offsets)
    key = jax.random.PRNGKey(5)
    P, W, B, K = 16, 3, 8, 4
    kw = dict(step0=2, grid_step0=3, step_size=0.05, total_words=1000,
              words_base=7)
    jout = jeng.train_steps_corpus_packed(0, P, W, B, key, K, **kw)
    pout = peng.train_steps_corpus_packed(
        0, P, W, B, 0, K, draws=JaxDraws(key, jeng, W, B), **kw)
    for j, p, name in zip(jout, pout, ("loss", "pairs", "pos", "alpha")):
        if name in ("pairs", "pos"):
            np.testing.assert_array_equal(p, np.asarray(j), err_msg=name)
        else:
            np.testing.assert_allclose(p, np.asarray(j), rtol=1e-5, err_msg=name)
    for got, want in zip(_port_tables(peng), _tables(jeng)):
        np.testing.assert_allclose(got, want, **TOL)


def test_train_step_batch_divisibility_guard():
    peng = EmbeddingEngine(V, D, _counts(), mesh=_mesh((2, 4)))
    c, x, m = _batch(K=1, B=15)
    with pytest.raises(ValueError, match="divisible"):
        peng.train_step(c[0], x[0], m[0], 0, 0.01)


def test_zero_mask_batch_is_noop():
    peng = EmbeddingEngine(V, D, _counts(), mesh=_mesh((2, 4)))
    s0, s1 = peng.logical_table(0), peng.logical_table(1)
    peng.train_step(np.zeros(16, np.int32), np.zeros((16, 5), np.int32),
                    np.zeros((16, 5), np.float32), 0, 0.05)
    assert (torch.equal(peng.logical_table(0), s0)
            and torch.equal(peng.logical_table(1), s1))


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_negative_draws_slice_invariant_across_ranks(ranks):
    # A data rank draws only its own rows, keyed by their global row: the
    # rows [r0, r0 + Bl) draw what a one-rank run draws for them.
    peng = EmbeddingEngine(V, D, _counts(), device="cpu")
    draws = TrainingDraws(7, *peng.noise_tables(), 3, 16, N)
    full = draws.window_negatives(3, 16, 4)
    Bl = 16 // ranks
    for r in range(ranks):
        part = draws.window_negatives(3, Bl, 4, r * Bl)
        assert part.shape == (Bl, 4, N)
        assert torch.equal(part, full[r * Bl:(r + 1) * Bl])
        assert torch.equal(draws.negatives(3, Bl, r * Bl),
                           draws.negatives(3, 16)[r * Bl:(r + 1) * Bl])


def test_mesh_draws_are_mesh_invariant():
    # The port's own draws (no negs= given) train the same tables on
    # every mesh shape, up to fp32 reduction order.
    c, x, m = _batch(seed=8)
    alphas = np.array([0.05, 0.04, 0.03], np.float32)
    ref = EmbeddingEngine(V, D, _counts(), num_negatives=N, device="cpu")
    ref.train_steps(c, x, m, 11, alphas)
    for shape, layout in [((2, 4), "rows"), ((4, 2), "dims"), ((8, 1), "rows")]:
        e = EmbeddingEngine(V, D, _counts(), num_negatives=N,
                            mesh=_mesh(shape), layout=layout)
        e.train_steps(c, x, m, 11, alphas)
        for got, want in zip(_port_tables(e), _port_tables(ref)):
            np.testing.assert_allclose(got, want, **TOL)


def _count_wrappers(monkeypatch):
    """Counting wrappers over every kernel wrapper the engine calls (on
    the CPU the wrappers run their plain versions and count nothing)."""
    counts = {}

    def wrap(mod, name):
        fn = getattr(mod, name)

        def counted(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)

    for name in ("gather_rows", "scatter_add_rank1", "scatter_add_rows",
                 "fused_pair_step", "fused_pair_step_shared"):
        wrap(peng_mod, name)
    for name in ("pair_forward", "pair_forward_shared",
                 "scatter_add_rank1_hbm", "scatter_add_rows_f32"):
        wrap(fs, name)
    return counts


def test_one_by_one_mesh_takes_the_single_device_path(monkeypatch):
    counts = _count_wrappers(monkeypatch)
    c, x, m = _batch(seed=2)
    ids, offsets = _corpus()
    alphas = np.array([0.05, 0.04, 0.03], np.float32)
    seen, tables = [], []
    for mesh in (None, _mesh((1, 1))):
        e = EmbeddingEngine(V, D, _counts(), num_negatives=N,
                            device="cpu" if mesh is None else None, mesh=mesh)
        assert not e._meshed
        counts.clear()
        e.train_steps(c, x, m, 3, alphas)
        e.upload_corpus(ids, offsets)
        e.train_steps_corpus_packed(0, 16, 3, 8, 3, 4)
        seen.append(dict(counts))
        tables.append(_port_tables(e))
    assert seen[0] == seen[1]
    assert seen[0] == {"gather_rows": 9, "scatter_add_rank1": 3,
                       "scatter_add_rows": 3, "fused_pair_step": 4,
                       "pair_forward": 4, "scatter_add_rank1_hbm": 4,
                       "scatter_add_rows_f32": 4}
    for a, b in zip(*tables):
        np.testing.assert_array_equal(a, b)


def test_mesh_kernels_launch_shard_by_shard(monkeypatch):
    counts = _count_wrappers(monkeypatch)
    c, x, m = _batch(K=1, seed=2)
    e = EmbeddingEngine(V, D, _counts(), num_negatives=N, mesh=_mesh((2, 4)))
    e.train_steps(c, x, m, 3, np.array([0.05], np.float32))
    # Each data rank pulls centers, contexts and negatives from every
    # model shard; every shard applies the syn1 and syn0 updates once.
    assert counts == {"gather_rows": 2 * 3 * 4, "scatter_add_rank1": 4,
                      "scatter_add_rows": 4}
    counts.clear()
    ids, offsets = _corpus()
    e2 = EmbeddingEngine(V, D, _counts(), num_negatives=N, mesh=_mesh((2, 1)))
    e2.upload_corpus(ids, offsets)
    e2.train_steps_corpus_packed(0, 16, 3, 8, 3, 2)
    assert counts == {"pair_forward": 4, "scatter_add_rank1_hbm": 2,
                      "scatter_add_rows_f32": 2}


def test_rows_scatters_take_only_the_owned_updates(monkeypatch):
    # A model shard's scatter gets the updates it owns, compacted in input
    # order, with local ids: no run of disowned updates on a clipped row.
    calls = []
    real = peng_mod.scatter_add_rows

    def spy(table, ids, upd):
        calls.append((table.shape[0], ids.clone()))
        return real(table, ids, upd)

    monkeypatch.setattr(peng_mod, "scatter_add_rows", spy)
    e = EmbeddingEngine(V, D, _counts(), num_negatives=N, mesh=_mesh((1, 4)))
    c, x, m = _batch(K=1, B=16, seed=5)
    e.train_steps(c, x, m, 3, np.array([0.05], np.float32))
    Vs = e.rows_per_shard
    assert len(calls) == 4
    assert sum(int(ids.numel()) for _, ids in calls) == c.size
    for k, (rows, ids) in enumerate(calls):
        assert rows == Vs and bool(((ids >= 0) & (ids < Vs)).all())
        want = c[0][(c[0] >= k * Vs) & (c[0] < (k + 1) * Vs)] - k * Vs
        np.testing.assert_array_equal(ids.numpy(), want)


# ----------------------------------------------------------------------
# Checkpoints across mesh shapes
# ----------------------------------------------------------------------


def test_sharded_save_reloads_across_mesh_shapes_and_packages(tmp_path):
    jeng, peng = _pair((2, 4))
    c, x, m = _batch(K=1, seed=7)
    peng.train_steps(c, x, m, 3, np.array([0.05], np.float32))
    path = str(tmp_path / "m")
    peng.save(path)
    files = sorted(os.listdir(path))
    assert "syn0.npy" not in files
    assert sum(f.startswith("syn0.r") and f.endswith(".npy") for f in files) == 4
    assert sum(f.endswith(".npy.manifest.json") for f in files) == 8
    meta = json.load(open(os.path.join(path, "engine.json")))
    assert meta["format"] == "sharded" and len(meta["shards"]["syn1"]) == 4
    want = _port_tables(peng)
    for mesh, layout in [(None, None), (_mesh((1, 8)), "dims"),
                         (_mesh((8, 1)), None), (_mesh((4, 2)), "rows")]:
        e2 = EmbeddingEngine.load(path, device="cpu" if mesh is None else None,
                                  mesh=mesh, layout=layout)
        for got, w in zip(_port_tables(e2), want):
            np.testing.assert_array_equal(got, w)
    # The JAX package reads the port's blocks onto its own mesh.
    j2 = JaxEngine.load(path, jax_mesh(1, 8), layout="dims")
    for got, w in zip(_tables(j2), want):
        np.testing.assert_array_equal(got, w)
    e3 = EmbeddingEngine.load(path, mesh=_mesh((2, 4)))
    e3.train_steps(c, x, m, 4, np.array([0.05], np.float32))


def test_single_mode_save_and_noise_geometry(tmp_path):
    peng = EmbeddingEngine(V, D, _counts(), num_negatives=N, unigram_power=0.5,
                           mesh=_mesh((1, 8)))
    path = str(tmp_path / "m")
    peng.save(path, mode="single")
    assert os.path.exists(os.path.join(path, "syn0.npy"))
    e2 = EmbeddingEngine.load(path, mesh=_mesh((2, 4)))
    assert e2.unigram_power == 0.5
    np.testing.assert_array_equal(e2.logical_table(0).numpy()[:V],
                                  peng.logical_table(0).numpy()[:V])
    assert torch.equal(e2.noise_tables()[0], peng.noise_tables()[0])
    other = EmbeddingEngine(V + 1, D, np.arange(V + 1, 0, -1),
                            mesh=_mesh((1, 8)))
    with pytest.raises(ValueError, match="geometry"):
        other.load_tables(path)


def test_cli_train_on_a_mesh_and_compat_topology(tmp_path, tiny_corpus):
    from glint_word2vec_torch import cli
    from glint_word2vec_torch import compat as pcompat
    from glint_word2vec_torch.models import load_model

    corpus = tmp_path / "c.txt"
    corpus.write_text("\n".join(" ".join(s) for s in tiny_corpus[:300]) + "\n")
    out = tmp_path / "m"
    assert cli.main([
        "train", "--corpus", str(corpus), "--output", str(out),
        "--device", "cpu", "--vector-size", "12", "--min-count", "1",
        "--batch-size", "64", "--num-partitions", "2", "--num-shards", "2",
        "--layout", "dims"]) == 0
    files = sorted(f for f in os.listdir(out / "matrix") if f.endswith(".npy"))
    assert files == ["counts.npy", "syn0.c000000000000.npy",
                     "syn0.c000000000006.npy", "syn1.c000000000000.npy",
                     "syn1.c000000000006.npy"]
    m = load_model(str(out), device="cpu")  # one device: loads 1 x 1
    assert (m.engine.num_data, m.engine.num_model) == (1, 1)
    assert m.params.num_partitions == 2 and m.params.layout == "dims"
    # compat maps the topology onto the mesh, clamped to the devices.
    with pytest.warns(UserWarning, match="clamped to mesh 1x1"):
        assert pcompat._clamp_topology(4, 2, "cpu") == (1, 1)
    assert pcompat._clamp_topology(1, 1, "cpu") == (1, 1)


@pytest.mark.parametrize("asked,cards,want", [
    ("cuda:1", 3, [[1, 2]]), ("cuda:2", 3, None), ("cuda:0", 4, [[0, 1]])])
def test_model_load_clamps_onto_the_cards_from_the_asked_one(
        tmp_path, monkeypatch, asked, cards, want):
    # A (1, 2) model loaded onto a named card of a host with several
    # cards: the clamped mesh starts at that card (the engine's device
    # is the mesh's first) and takes the cards after it; with one card
    # left it loads 1 x 1. The cards are faked: the load stops at the
    # engine.
    from glint_word2vec_torch.convert import model_from_arrays
    from glint_word2vec_torch.models import word2vec as w2v
    from glint_word2vec_torch.utils.params import Word2VecParams

    rng = np.random.default_rng(0)
    s0 = rng.normal(size=(V, D)).astype(np.float32)
    params = Word2VecParams(vector_size=D, num_shards=2)
    model_from_arrays([f"w{i}" for i in range(V)], s0, s0, _counts(), params,
                      device="cpu").save(str(tmp_path / "m"))
    seen = {}

    class Stop(Exception):
        pass

    def fake_load(cls, path, device=None, mesh=None, **kw):
        seen["device"], seen["mesh"] = device, mesh
        raise Stop

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(w2v, "resolve_device", lambda d: torch.device(d))
    monkeypatch.setattr(peng_mod.EmbeddingEngine, "load", classmethod(fake_load))
    with pytest.raises(Stop):
        w2v.Word2VecModel.load(str(tmp_path / "m"), device=asked)
    if want is None:
        assert seen["mesh"] is None
    else:
        assert [[d.index for d in row] for row in seen["mesh"].devices] == want
        assert seen["mesh"].devices[0][0] == torch.device(asked)
