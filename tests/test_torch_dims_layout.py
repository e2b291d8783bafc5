"""The ``dims`` layout of the port's mesh (every row on every model shard,
the columns split) against the JAX engine's, the eight cases of
tests/test_dims_layout.py: the port on ``devices=["cpu"] * 8``, JAX on its
8 forced CPU devices, from the same tables and the same negatives
(``negs=``/``pools=``, the JAX package's threefry draws). D = 12 is not a
multiple of 8, so the (1, 8) and (2, 4) meshes pad the columns and hold
slices 2 and 3 wide.

Tolerances: ids compare exactly; fp32 tables within rtol 1e-5 and atol
1e-6; losses within rel 1e-5; checkpoints reload bitwise. The traffic
cases count the elements the port's collectives carry
(``parallel/mesh.psum`` and ``all_gather``) against the JAX tests'
budgets.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from glint_word2vec_tpu.ops.sampling import (
    sample_negatives,
    sample_negatives_per_row,
)
from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
from glint_word2vec_tpu.parallel.mesh import make_mesh as jax_mesh

from glint_word2vec_torch.parallel import mesh as pmesh
from glint_word2vec_torch.parallel.engine import EmbeddingEngine

V, D, N = 50, 12, 4
TOL = dict(rtol=1e-5, atol=1e-6)


def _counts():
    return np.arange(V, 0, -1).astype(np.int64) * 10


def _port(layout, shape, shared=0, dim=D):
    return EmbeddingEngine(V, dim, _counts(), num_negatives=N, seed=3,
                           layout=layout, shared_negatives=shared,
                           mesh=pmesh.make_mesh(*shape, devices=["cpu"] * 8))


def _jax(layout, shape, shared=0):
    return JaxEngine(jax_mesh(*shape), V, D, _counts(), num_negatives=N,
                     seed=3, layout=layout, shared_negatives=shared)


def _start(*engines):
    """The same tables in every engine: the first one's syn0 and a
    non-zero syn1."""
    s0 = np.asarray(engines[0].syn0, np.float32)[:V, :D]
    s1 = np.random.default_rng(11).normal(0, 0.2, (V, D)).astype(np.float32)
    for e in engines:
        e.set_tables(s0, s1)


def _batch(B=16, C=5, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, V, B).astype(np.int32)
    contexts = rng.integers(0, V, (B, C)).astype(np.int32)
    mask = (rng.random((B, C)) < 0.8).astype(np.float32)
    return centers, np.where(mask > 0, contexts, 0).astype(np.int32), mask


def _negs(jeng, key, B, C):
    """The negatives the JAX engine's ``train_step`` draws under ``key``."""
    return np.asarray(sample_negatives_per_row(
        key, jeng._prob, jeng._alias, jnp.arange(B, dtype=jnp.int32), (C, N)))


def _tables(eng):
    return (np.asarray(eng.syn0, np.float32)[:V, :D],
            np.asarray(eng.syn1, np.float32)[:V, :D])


def _ptables(eng):
    return (eng.logical_table(0).float().numpy()[:V, :D],
            eng.logical_table(1).float().numpy()[:V, :D])


@pytest.mark.parametrize("shape", [(1, 1), (1, 8), (2, 4), (8, 1)])
def test_dims_train_step_matches_rows_layout(shape):
    jref = _jax("rows", (2, 4))
    jeng = _jax("dims", shape)
    peng = _port("dims", shape)
    prows = _port("rows", (2, 4))
    _start(jref, jeng, peng, prows)
    centers, contexts, mask = _batch()
    key = jax.random.PRNGKey(5)
    negs = _negs(jref, key, 16, 5)
    l_ref = float(jref.train_step(centers, contexts, mask, key, 0.05))
    assert float(jeng.train_step(centers, contexts, mask, key, 0.05)) \
        == pytest.approx(l_ref, rel=1e-5)
    assert peng.train_step(centers, contexts, mask, 0, 0.05, negs=negs) \
        == pytest.approx(l_ref, rel=1e-5)
    assert prows.train_step(centers, contexts, mask, 0, 0.05, negs=negs) \
        == pytest.approx(l_ref, rel=1e-5)
    for e in (peng, prows):
        for a, b in zip(_ptables(e), _tables(jeng)):
            np.testing.assert_allclose(a, b, **TOL)


def test_dims_shared_negatives_matches_rows_layout():
    jref = _jax("rows", (2, 4), shared=16)
    jeng = _jax("dims", (4, 2), shared=16)
    peng = _port("dims", (4, 2), shared=16)
    _start(jref, jeng, peng)
    centers, contexts, mask = _batch(seed=2)
    key = jax.random.PRNGKey(9)
    pool = np.asarray(sample_negatives(key, jref._prob, jref._alias, (16,)))
    l_ref = float(jref.train_step(centers, contexts, mask, key, 0.05))
    l_jd = float(jeng.train_step(centers, contexts, mask, key, 0.05))
    l_p = peng.train_step(centers, contexts, mask, 0, 0.05, pools=pool)
    assert l_jd == pytest.approx(l_ref, rel=1e-5)
    assert l_p == pytest.approx(l_ref, rel=1e-5)
    for a, b in zip(_ptables(peng), _tables(jref)):
        np.testing.assert_allclose(a, b, **TOL)


def test_dims_query_ops_match_host_and_jax():
    jeng = _jax("dims", (2, 4))
    peng = _port("dims", (2, 4))
    _start(jeng, peng)
    syn0 = _ptables(peng)[0]
    idx = np.array([0, 7, 49, 3, 3], np.int32)
    np.testing.assert_allclose(peng.pull(idx).numpy(), syn0[idx], rtol=1e-6)
    sent = np.array([[1, 2, 3, 0], [4, 4, 0, 0]], np.int32)
    m = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], np.float32)
    np.testing.assert_allclose(peng.pull_average(sent, m).numpy(),
                               np.asarray(jeng.pull_average(sent, m)), **TOL)
    np.testing.assert_allclose(peng.norms().numpy()[:V],
                               np.linalg.norm(syn0, axis=1), rtol=1e-5)
    v = np.linspace(-1, 1, D).astype(np.float32)
    np.testing.assert_allclose(peng.multiply(v).numpy()[:V], syn0 @ v,
                               rtol=1e-4, atol=1e-6)
    q = syn0[17].copy()
    sims, ids = peng.top_k_cosine(q, 5)
    jsims, jids = jeng.top_k_cosine(q, 5)
    assert ids[0] == 17
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(sims, jsims, **TOL)
    bs, bi = peng.top_k_cosine_batch(syn0[[5, 9]].copy(), 3)
    assert bi[0, 0] == 5 and bi[1, 0] == 9
    np.testing.assert_array_equal(
        bi, jeng.top_k_cosine_batch(syn0[[5, 9]].copy(), 3)[1])


def test_dims_save_load_roundtrips_across_layouts(tmp_path):
    peng = _port("dims", (2, 4))
    centers, contexts, mask = _batch()
    peng.train_step(centers, contexts, mask, 0, 0.05)
    s0, s1 = _ptables(peng)
    p1 = str(tmp_path / "dims_ckpt")
    peng.save(p1)
    cpu8 = ["cpu"] * 8
    e2 = EmbeddingEngine.load(p1, mesh=pmesh.make_mesh(1, 8, devices=cpu8))
    assert e2.layout == "dims"
    np.testing.assert_array_equal(_ptables(e2)[0], s0)
    e3 = EmbeddingEngine.load(p1, mesh=pmesh.make_mesh(2, 4, devices=cpu8),
                              layout="rows")
    assert e3.layout == "rows"
    np.testing.assert_array_equal(_ptables(e3)[0], s0)
    np.testing.assert_array_equal(_ptables(e3)[1], s1)
    p2 = str(tmp_path / "rows_ckpt")
    e3.save(p2)
    e4 = EmbeddingEngine.load(p2, mesh=pmesh.make_mesh(1, 8, devices=cpu8),
                              layout="dims")
    np.testing.assert_array_equal(_ptables(e4)[0], s0)
    # The JAX package loads the port's column blocks, and the port its.
    j5 = JaxEngine.load(p1, jax_mesh(4, 2))
    np.testing.assert_array_equal(_tables(j5)[1], s1)
    p3 = str(tmp_path / "jax_dims")
    j5.save(p3)
    e6 = EmbeddingEngine.load(p3, mesh=pmesh.make_mesh(2, 4, devices=cpu8))
    np.testing.assert_array_equal(_ptables(e6)[0], s0)
    e4.train_step(centers, contexts, mask, 1, 0.05)


def test_dims_grouped_centers_subword_path():
    jref = _jax("rows", (1, 1))
    peng = _port("dims", (2, 4))
    _start(jref, peng)
    rng = np.random.default_rng(7)
    B, S, C = 8, 3, 4
    groups = rng.integers(0, V, (B, S)).astype(np.int32)
    gmask = (rng.random((B, S)) < 0.7).astype(np.float32)
    gmask[:, 0] = 1.0
    contexts = rng.integers(0, V, (B, C)).astype(np.int32)
    mask = np.ones((B, C), np.float32)
    key = jax.random.PRNGKey(3)
    l_ref = float(jref.train_step_grouped(groups, gmask, contexts, mask, key,
                                          0.05))
    l_p = peng.train_step_grouped(groups, gmask, contexts, mask, 0, 0.05,
                                  negs=_negs(jref, key, B, C))
    assert l_p == pytest.approx(l_ref, rel=1e-5)
    for a, b in zip(_ptables(peng), _tables(jref)):
        np.testing.assert_allclose(a, b, **TOL)


def _record(monkeypatch, name):
    sizes = []
    real = getattr(pmesh, name)

    def spy(parts, *a, **kw):
        out = real(parts, *a, **kw)
        sizes.append(int(out.numel()))
        return out

    monkeypatch.setattr(pmesh, name, spy)
    return sizes


def test_dims_model_axis_traffic_is_scalar_logits(monkeypatch):
    # The step's model-axis sums carry the logit partials and the loss
    # scalars only, never gathered rows.
    B, C, D2 = 16, 5, 64
    eng = _port("dims", (2, 4), dim=D2)
    centers, contexts, mask = _batch(B=B, C=C)
    sizes = _record(monkeypatch, "psum")
    eng.train_step(centers, contexts, mask, 0, 0.05)
    reduced = 4 * sum(sizes)
    budget = 4 * (B * C + B * C * N + 4) * 2
    row_psum_traffic = B * C * (1 + N) * D2 * 4
    assert 0 < reduced <= budget, (reduced, budget)
    assert reduced < row_psum_traffic / 4


@pytest.mark.parametrize("layout", ["rows", "dims"])
def test_topk_batch_empty_query_batch(layout):
    eng = _port(layout, (2, 4))
    sims, idx = eng.top_k_cosine_batch(np.zeros((0, D), np.float32), 5)
    assert sims.shape == (0, 5) and idx.shape == (0, 5)


def test_dims_data_axis_exchange_ships_scalars_not_payloads(monkeypatch):
    # The data axis gathers h and center-gradient slices, the scalar
    # coefficients and int32 ids: never the expanded rank-1 payload.
    B, C, D2 = 16, 5, 64
    eng = _port("dims", (4, 2), dim=D2)
    centers, contexts, mask = _batch(B=B, C=C)
    sizes = _record(monkeypatch, "all_gather")
    eng.train_step(centers, contexts, mask, 0, 0.05)
    gathered = 4 * sum(sizes)
    dl = eng.cols_per_shard
    # Per model shard: h and d_center slices; once: coefficients and ids.
    budget = 4 * (2 * B * dl * eng.num_model + 4 * B * C * (1 + N) + 2 * B) * 2
    expanded_payload = B * C * (1 + N) * dl * 4 * eng.num_model
    assert 0 < gathered <= budget, (gathered, budget)
    assert gathered < expanded_payload, (gathered, expanded_payload)
