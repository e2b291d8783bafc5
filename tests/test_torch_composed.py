"""The composed step of the port's engine (``train_steps_grouped`` in
glint_word2vec_torch/parallel/engine.py) against the JAX engine's
``train_steps_grouped`` with its Pallas kernels in interpret mode
(``use_pallas=True`` on ``make_mesh(1, 1)``), from identical tables
(``set_tables``), on identical grid batches, with the JAX package's own
negative draws handed to the port (``negs=``): the draws the JAX engine
makes, ``sample_negatives_per_row(fold_in(base_key, step0 + i), prob,
alias, rows, (C, n))`` (``engine.py:713-716``).

Tolerances: fp32 tables within rtol 1e-5 and atol 1e-6 (fp32 sums in
another order: XLA's einsums and group means against PyTorch's); bf16
tables within one bf16 ulp of the JAX table; losses within rtol 1e-5.
The fp32 rank-1 route and the payload route are bitwise equal, and
``_dup_sum_f32`` is bitwise equal to the JAX function on dyadic updates
and within rtol 1e-6 (atol 1e-6 of the largest prefix sum) on random
ones, where the two cumsums add in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from glint_word2vec_tpu.ops.sampling import sample_negatives_per_row
from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
from glint_word2vec_tpu.parallel.mesh import make_mesh

from glint_word2vec_torch.convert import engine_from_arrays
from glint_word2vec_torch.ops import rows as rows_mod
from glint_word2vec_torch.parallel import engine as peng_mod

V, X, D, N_NEG = 30, 20, 16, 3
K, B, C = 3, 8, 5


def _batches(S, seed=0):
    """K grid batches: subword groups of S rows (the word row first,
    bucket rows after it, padded slots at row 0 with mask 0), contexts
    with about 40% padded lanes, and one all-padding batch row."""
    rng = np.random.default_rng(seed)
    cg = rng.integers(0, V + X, (K, B, S)).astype(np.int32)
    cg[..., 0] = rng.integers(0, V, (K, B))
    gm = (rng.random((K, B, S)) < 0.7).astype(np.float32)
    gm[..., 0] = 1.0
    cg = np.where(gm > 0, cg, 0).astype(np.int32)
    cx = rng.integers(0, V, (K, B, C)).astype(np.int32)
    mk = (rng.random((K, B, C)) < 0.6).astype(np.float32)
    mk[:, -1] = 0.0
    cg[:, -1], gm[:, -1] = 0, 0.0
    gm[:, -1, 0] = 1.0
    cx = np.where(mk > 0, cx, 0).astype(np.int32)
    return cg, gm, cx, mk


def _ulp_bf16(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("S,dtype,compute", [
    (1, "float32", "float32"),
    (4, "float32", "float32"),
    (4, "bfloat16", "float32"),
    (4, "float32", "bfloat16"),
    (1, "bfloat16", "bfloat16"),
])
def test_train_steps_grouped_matches_jax_engine(S, dtype, compute):
    rng = np.random.default_rng(S)
    counts = np.arange(V, 0, -1).astype(np.int64) * 3
    s0 = rng.normal(0, 0.3, (V + X, D)).astype(np.float32)
    s1 = rng.normal(0, 0.3, (V + X, D)).astype(np.float32)
    jeng = JaxEngine(make_mesh(1, 1), V, D, counts, num_negatives=N_NEG,
                     seed=3, extra_rows=X, use_pallas=True, dtype=dtype,
                     compute_dtype=compute)
    jeng.set_tables(s0, s1)
    peng = engine_from_arrays(s0, s1, counts, num_negatives=N_NEG,
                              device="cpu", dtype=dtype, compute_dtype=compute)
    cg, gm, cx, mk = _batches(S)
    key, step0 = jax.random.PRNGKey(5), 4
    alphas = np.array([0.05, 0.04, 0.03], np.float32)
    jl = np.asarray(jeng.train_steps_grouped(cg, gm, cx, mk, key, alphas, step0))
    negs = np.stack([
        np.asarray(sample_negatives_per_row(
            jax.random.fold_in(key, jnp.uint32(step0 + i)), jeng._prob,
            jeng._alias, jnp.arange(B, dtype=jnp.int32), (C, N_NEG),
        )) for i in range(K)
    ])
    launches = (rows_mod.scatter_add_rows.launches,
                rows_mod.scatter_add_rank1.launches)
    pl = peng.train_steps_grouped(cg, gm, cx, mk, 0, alphas, step0, negs=negs)
    assert (rows_mod.scatter_add_rows.launches,
            rows_mod.scatter_add_rank1.launches) == launches  # CPU: plain
    np.testing.assert_allclose(pl.numpy(), jl, rtol=1e-5)
    assert peng.table_version == 2  # set_tables, then one training call
    for name in ("syn0", "syn1"):
        got = getattr(peng, name).float().numpy()
        want = np.asarray(getattr(jeng, name), np.float32)[: V + X]
        assert not np.array_equal(want, (s0 if name == "syn0" else s1))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        else:
            assert (np.abs(got - want) <= _ulp_bf16(want)).all(), name


def test_train_steps_is_the_one_row_group():
    counts = np.arange(V, 0, -1).astype(np.int64)
    rng = np.random.default_rng(1)
    s0 = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    s1 = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    cg, gm, cx, mk = _batches(1)
    cg = cg % V
    a = engine_from_arrays(s0, s1, counts, num_negatives=N_NEG, device="cpu")
    b = engine_from_arrays(s0, s1, counts, num_negatives=N_NEG, device="cpu")
    la = a.train_steps(cg[..., 0], cx, mk, 7, [0.05] * K, 2)
    lb = b.train_steps_grouped(cg, np.ones_like(gm), cx, mk, 7, [0.05] * K, 2)
    assert torch.equal(la, lb)
    assert torch.equal(a.syn0, b.syn0) and torch.equal(a.syn1, b.syn1)


def test_shared_negatives_raise_naming_the_next_slice():
    # The shared pool used to raise here; it now trains. Subword groups,
    # bf16 tables and bf16 operands against the JAX engine's composed
    # shared step, with its pools handed in (engine.py:685-687):
    # tables within one bf16 ulp, losses within rtol 1e-5.
    from glint_word2vec_tpu.ops.sampling import sample_negatives

    rng = np.random.default_rng(8)
    counts = np.arange(V, 0, -1).astype(np.int64) * 3
    s0 = rng.normal(0, 0.3, (V + X, D)).astype(np.float32)
    s1 = rng.normal(0, 0.3, (V + X, D)).astype(np.float32)
    kw = dict(num_negatives=N_NEG, dtype="bfloat16", compute_dtype="bfloat16",
              shared_negatives=8)
    jeng = JaxEngine(make_mesh(1, 1), V, D, counts, seed=3, extra_rows=X,
                     use_pallas=True, **kw)
    jeng.set_tables(s0, s1)
    peng = engine_from_arrays(s0, s1, counts, device="cpu", **kw)
    cg, gm, cx, mk = _batches(4)
    key, alphas = jax.random.PRNGKey(9), np.full(K, 0.05, np.float32)
    jl = np.asarray(jeng.train_steps_grouped(cg, gm, cx, mk, key, alphas, 1))
    pools = np.stack([np.asarray(sample_negatives(
        jax.random.fold_in(key, jnp.uint32(1 + i)), jeng._prob, jeng._alias,
        (8,))) for i in range(K)])
    pl = peng.train_steps_grouped(cg, gm, cx, mk, 0, alphas, 1, pools=pools)
    np.testing.assert_allclose(pl.numpy(), jl, rtol=1e-5)
    for name in ("syn0", "syn1"):
        got = getattr(peng, name).float().numpy()
        want = np.asarray(getattr(jeng, name), np.float32)[: V + X]
        start = torch.from_numpy(s0 if name == "syn0" else s1).bfloat16()
        assert not np.array_equal(got, start.float().numpy())
        assert (np.abs(got - want) <= _ulp_bf16(want)).all(), name


def test_fp32_rank1_route_equals_payload_route_bitwise():
    # The fp32 syn1 update takes scatter_add_rank1 whatever h's size (the
    # JAX engine gates it on 10 MB of TPU VMEM); the payload route it
    # replaces, the (N, d) rows plus scatter_add_rows, gives the same
    # table bit for bit.
    rng = np.random.default_rng(2)
    c_pos = torch.from_numpy(rng.normal(0, 0.1, (B, C)).astype(np.float32))
    c_neg = torch.from_numpy(rng.normal(0, 0.1, (B, C, N_NEG)).astype(np.float32))
    h = torch.from_numpy(rng.normal(0, 1, (B, D)).astype(np.float32))
    ids1 = torch.from_numpy(rng.integers(0, 6, B * C * (1 + N_NEG)).astype(np.int32))
    ids1[: B * C // 2] = 0
    table = torch.from_numpy(rng.normal(0, 1, (V, D)).astype(np.float32))
    a, b = table.clone(), table.clone()
    assert peng_mod._apply_rank1_updates(a, ids1, c_pos, c_neg, h, C, N_NEG) is None
    payload = peng_mod._rank1_dense_payload(c_pos, c_neg, h)
    peng_mod._scatter_rows(b, ids1, payload)
    assert torch.equal(a, b)
    # Under bf16 storage the payload comes back for the fp32 pre-sum.
    payload16 = peng_mod._apply_rank1_updates(
        table.to(torch.bfloat16), ids1, c_pos, c_neg, h, C, N_NEG
    )
    assert torch.equal(payload16, payload)


def _jax_dup_sum(ids, upd):
    from glint_word2vec_tpu.parallel.engine import _dup_sum_f32

    sid, summed = _dup_sum_f32(jnp.asarray(ids), jnp.asarray(upd))
    return np.asarray(sid), np.asarray(summed)


def test_dup_sum_f32_matches_jax():
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 7, 60).astype(np.int32)
    ids[:20] = 0
    dy = (rng.integers(-64, 64, (60, D)) / 8.0).astype(np.float32)
    jsid, jsum = _jax_dup_sum(ids, dy)
    psid, psum = peng_mod._dup_sum_f32(torch.from_numpy(ids), torch.from_numpy(dy))
    np.testing.assert_array_equal(psid.numpy(), jsid)
    assert np.array_equal(psum.numpy(), jsum)
    # Every run's total sits at its last slot, zeros elsewhere.
    last = np.r_[jsid[1:] != jsid[:-1], True]
    assert not psum.numpy()[~last].any()
    rn = rng.normal(0, 1, (60, D)).astype(np.float32)
    jsid, jsum = _jax_dup_sum(ids, rn)
    psid, psum = peng_mod._dup_sum_f32(torch.from_numpy(ids), torch.from_numpy(rn))
    np.testing.assert_array_equal(psid.numpy(), jsid)
    scale = float(np.abs(np.cumsum(rn[np.argsort(ids, kind="stable")], 0)).max())
    np.testing.assert_allclose(psum.numpy(), jsum, rtol=1e-6, atol=1e-6 * scale)


def test_write_rows_overwrites_syn0():
    eng = engine_from_arrays(np.zeros((V, D), np.float32),
                             np.zeros((V, D), np.float32),
                             np.ones(V, np.int64), device="cpu", dtype="bfloat16")
    rows = np.full((3, D), 1.0 + 2.0**-9, np.float32)  # rounds to 1.0 in bf16
    v0 = eng.table_version
    eng.write_rows(5, rows)
    assert eng.table_version == v0 + 1
    assert torch.equal(eng.syn0[5:8].float(), torch.ones((3, D)))
    assert not eng.syn0[:5].any() and not eng.syn0[8:].any()
    with pytest.raises(ValueError, match="outside"):
        eng.write_rows(V - 2, rows)
