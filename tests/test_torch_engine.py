"""The port's EmbeddingEngine (glint_word2vec_torch/parallel/engine.py)
against the JAX EmbeddingEngine holding the same tables (``set_tables``
with the same numpy arrays), in fp32 and bf16 storage. The JAX pull runs
its Pallas gather in interpret mode (``use_pallas=True`` on the CPU).

Tolerances: pull is a copy, so bitwise; the masked mean, the norms and the
products sum in another order in torch than in XLA, so rtol 1e-6 (sums of
a few fp32 terms) and 1e-5 (a d-term dot product); top-k values within
atol 1e-5, and indices equal wherever neighbouring scores differ by more
than that (ties may order differently)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
from glint_word2vec_tpu.parallel.mesh import make_mesh

from glint_word2vec_torch.convert import engine_from_arrays

V, D, EXTRA = 150, 16, 3
ZERO_ROW = 17


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def engines(request):
    rng = np.random.default_rng(0)
    syn0 = rng.normal(size=(V + EXTRA, D)).astype(np.float32)
    syn0[ZERO_ROW] = 0.0
    syn1 = rng.normal(size=(V + EXTRA, D)).astype(np.float32)
    counts = np.arange(V, 0, -1).astype(np.int64)
    jeng = JaxEngine(
        make_mesh(1, 2), V, D, counts, dtype=request.param,
        extra_rows=EXTRA, use_pallas=True,
    )
    jeng.set_tables(syn0, syn1)
    peng = engine_from_arrays(
        syn0, syn1, counts, dtype=request.param, device="cpu"
    )
    yield jeng, peng
    jeng.destroy()
    peng.destroy()


def _assert_topk_close(jv, ji, pv, pi):
    jv, ji, pv, pi = (np.atleast_2d(np.asarray(a)) for a in (jv, ji, pv, pi))
    assert pv.shape == jv.shape and pi.shape == ji.shape
    np.testing.assert_allclose(pv, jv, atol=1e-5, rtol=0)
    for q in range(jv.shape[0]):
        s = jv[q]
        for j in range(s.shape[0]):
            gaps = [s[j - 1] - s[j] if j else np.inf,
                    s[j] - s[j + 1] if j + 1 < s.shape[0] else np.inf]
            if np.isfinite(s[j]) and min(gaps) > 1e-5:
                assert pi[q, j] == ji[q, j], (q, j)


def test_pull_bitwise(engines):
    jeng, peng = engines
    ids = np.array([0, V - 1, 5, 5, 5, V + 1, 88, 0, V + EXTRA, 500, 3],
                   np.int32)
    np.testing.assert_array_equal(
        peng.pull(ids).numpy(), np.asarray(jeng.pull(ids))
    )


def test_pull_average_padded_buckets(engines):
    jeng, peng = engines
    rng = np.random.default_rng(1)
    lens = [3, 0, 5, 1, 2]  # S=5 rows in an 8-row bucket, L=5 in 8
    idx = np.zeros((8, 8), np.int32)
    m = np.zeros((8, 8), np.float32)
    for i, n in enumerate(lens):
        idx[i, :n] = rng.integers(0, V, n)
        m[i, :n] = 1.0
    got = peng.pull_average(idx, m).numpy()
    np.testing.assert_allclose(got, np.asarray(jeng.pull_average(idx, m)),
                               rtol=1e-6, atol=1e-7)
    assert not got[1].any() and not got[5:].any()


def test_norms_and_multiply(engines):
    jeng, peng = engines
    rows = V + EXTRA
    np.testing.assert_allclose(
        peng.norms().numpy(), np.asarray(jeng.norms())[:rows], rtol=1e-6
    )
    vec = np.random.default_rng(2).normal(size=D).astype(np.float32)
    np.testing.assert_allclose(
        peng.multiply(vec).numpy(), np.asarray(jeng.multiply(vec))[:rows],
        rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("k", [5, 19])
def test_top_k_cosine(engines, k):
    jeng, peng = engines
    vec = np.random.default_rng(k).normal(size=D).astype(np.float32)
    _assert_topk_close(*jeng.top_k_cosine(vec, k), *peng.top_k_cosine(vec, k))


@pytest.mark.parametrize("q,k", [(3, 7), (11, 20)])
def test_top_k_cosine_batch(engines, q, k):
    jeng, peng = engines
    vecs = np.random.default_rng(q).normal(size=(q, D)).astype(np.float32)
    vecs[1] = 0.0  # a zero query scores 0 against every real row
    _assert_topk_close(
        *jeng.top_k_cosine_batch(vecs, k), *peng.top_k_cosine_batch(vecs, k)
    )


def test_masked_rows_never_surface(engines):
    _, peng = engines
    vecs = np.random.default_rng(3).normal(size=(4, D)).astype(np.float32)
    sims, idx = peng.top_k_cosine_batch(vecs, V)
    live = np.isfinite(sims)
    # Every real row but the zero-norm one is ranked; the zero-norm row and
    # the extra rows past queryable_rows only ever come as -inf filler.
    assert (live.sum(axis=1) == V - 1).all()
    assert (idx[live] < peng.queryable_rows).all()
    assert (idx[live] != ZERO_ROW).all()
    s1, i1 = peng.top_k_cosine(vecs[0], V)
    assert ZERO_ROW not in i1[np.isfinite(s1)]


# ----------------------------------------------------------------------
# train_step and train_step_grouped (engine.py:1417, 1458 of the JAX
# package): one batch, the negatives JAX draws from ``key`` handed in.
# Tolerances are tests/test_torch_composed.py's: fp32 tables within rtol
# 1e-5 and atol 1e-6, the loss within rtol 1e-5.
# ----------------------------------------------------------------------

TB, TC, TN, TS = 8, 5, 3, 3


def _one_batch(seed):
    rng = np.random.default_rng(seed)
    cg = rng.integers(0, V + EXTRA, (TB, TS)).astype(np.int32)
    cg[:, 0] = rng.integers(0, V, TB)
    gm = (rng.random((TB, TS)) < 0.7).astype(np.float32)
    gm[:, 0] = 1.0
    cg = np.where(gm > 0, cg, 0).astype(np.int32)
    cx = rng.integers(0, V, (TB, TC)).astype(np.int32)
    mk = (rng.random((TB, TC)) < 0.6).astype(np.float32)
    mk[-1] = 0.0
    cx = np.where(mk > 0, cx, 0).astype(np.int32)
    return cg, gm, cx, mk


@pytest.mark.parametrize("grouped", [False, True])
def test_train_step_matches_the_jax_engine(grouped):
    import jax
    import jax.numpy as jnp

    from glint_word2vec_tpu.ops.sampling import sample_negatives_per_row

    rng = np.random.default_rng(11)
    s0 = rng.normal(0, 0.3, (V + EXTRA, D)).astype(np.float32)
    s1 = rng.normal(0, 0.3, (V + EXTRA, D)).astype(np.float32)
    counts = np.arange(V, 0, -1).astype(np.int64) * 3
    jeng = JaxEngine(make_mesh(1, 1), V, D, counts, num_negatives=TN, seed=3,
                     extra_rows=EXTRA, use_pallas=True)
    jeng.set_tables(s0, s1)
    peng = engine_from_arrays(s0, s1, counts, num_negatives=TN, device="cpu")
    cg, gm, cx, mk = _one_batch(int(grouped))
    key, alpha = jax.random.PRNGKey(9), 0.05
    negs = np.array(sample_negatives_per_row(
        key, jeng._prob, jeng._alias, jnp.arange(TB, dtype=jnp.int32), (TC, TN)))
    if grouped:
        jl = jeng.train_step_grouped(cg, gm, cx, mk, key, alpha)
        pl = peng.train_step_grouped(cg, gm, cx, mk, 0, alpha, negs=negs)
    else:
        jl = jeng.train_step(cg[:, 0], cx, mk, key, alpha)
        pl = peng.train_step(cg[:, 0], cx, mk, 0, alpha, negs=negs)
    assert isinstance(pl, float)
    np.testing.assert_allclose(pl, float(jl), rtol=1e-5)
    for name in ("syn0", "syn1"):
        want = np.asarray(getattr(jeng, name), np.float32)[: V + EXTRA]
        np.testing.assert_allclose(getattr(peng, name).numpy(), want,
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    jeng.destroy()
    peng.destroy()


@pytest.mark.parametrize("grouped", [False, True])
def test_train_step_is_one_step_of_train_steps_grouped(grouped):
    rng = np.random.default_rng(5)
    s0 = rng.normal(0, 0.3, (V + EXTRA, D)).astype(np.float32)
    s1 = rng.normal(0, 0.3, (V + EXTRA, D)).astype(np.float32)
    counts = np.arange(V, 0, -1).astype(np.int64)
    a = engine_from_arrays(s0, s1, counts, num_negatives=TN, device="cpu")
    b = engine_from_arrays(s0, s1, counts, num_negatives=TN, device="cpu")
    cg, gm, cx, mk = _one_batch(7)
    if not grouped:
        cg, gm = cg[:, :1], np.ones_like(gm[:, :1])
    # The port's own draws: fold_in(key, 0), as train_steps_grouped's
    # step 0 makes them.
    lb = b.train_steps_grouped(cg[None], gm[None], cx[None], mk[None], 21,
                               [0.025], 0)
    la = (a.train_step_grouped(cg, gm, cx, mk, 21, 0.025) if grouped
          else a.train_step(cg[:, 0], cx, mk, 21, 0.025))
    assert la == float(lb[0])
    assert torch.equal(a.syn0, b.syn0) and torch.equal(a.syn1, b.syn1)
    assert a.table_version == b.table_version
