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
