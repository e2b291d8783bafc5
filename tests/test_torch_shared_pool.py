"""The shared negative pool of the port (``shared_negatives = S > 0``)
against the JAX package, on the CPU.

* ``pair_forward_shared_reference`` (the plain version of the B5 kernel)
  against the JAX ``pair_forward_shared`` in interpret mode
  (``block_rows=4``), with P not a multiple of the block, S = 1, 5 (the
  pool smaller than the kernel's DMA pipeline) and 32, a forced
  pool/context collision, repeated pool ids, masked pairs, and fp32 and
  bf16 tables. Tolerances: ``h`` bitwise; ``c_pos`` rtol 1e-5;
  ``d_center`` and ``d_pool`` rtol 2e-5, atol 1e-6 (the JAX tests' own,
  ``tests/test_pallas_sgns.py:282-283``); the loss rel 1e-5.
* ``fused_pair_step_shared`` against the JAX one: fp32 tables within rtol
  2e-5, atol 1e-6; bf16 tables within one bf16 ulp of the JAX table (the
  fp32 run sums differ in their last bits and may round the other way;
  the JAX scatters take every update in one block there, since they
  round a run once for each block it spans).
* ``shared_sgns_grads`` (fp32 and bf16 operands) within rtol 1e-5, atol
  1e-6, and ``pool_collision_mask`` exactly, against the JAX functions.
* Both training routes against the JAX engine with the JAX package's
  pools handed in: the packed route (``train_steps_corpus_packed``, its
  fused Pallas step in interpret mode) with losses, pair counts,
  positions and alphas equal and tables within rtol 2e-5, atol 1e-6; the
  composed route (``train_steps_grouped(..., pools=)``), in word and
  subword-group form, as ``tests/test_torch_composed.py`` holds the
  per-pair step.
* ``Word2Vec(device="cpu").set_shared_negatives(256).fit`` passes the
  gates of ``tests/test_shared_negatives.py:114-134`` on both routes, the
  fastText fit its ``tiny_corpus`` gate, resume is bitwise, and ``cli
  train --shared-negatives`` trains and saves.

``test_split_tf32_products_keep_fp32_accuracy`` emulates the B5 kernel's
split-TF32 products on the CPU and holds their error against float64.

The ``cuda`` tests hold the kernel against its plain version on a card,
and two of its calls bitwise against each other:

    python -m pytest tests/test_torch_shared_pool.py -m cuda --noconftest -q
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_torch.ops import fused_sgns as fs
from glint_word2vec_torch.ops import sgns as psgns

V, D, N_NEG = 64, 24, 5


def _t(a):
    return torch.from_numpy(np.array(a))


def _ulp_bf16(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126)))
    return 2.0 ** (e - 7)


def _pair_case(P, S, seed=0):
    """Tables and one pair batch: a masked pair and a masked tail, pool
    ids with repeats, pool word 0 equal to the first pair's context."""
    rng = np.random.default_rng(seed)
    s0 = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    s1 = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    pc = rng.integers(0, V, P).astype(np.int32)
    px = rng.integers(0, V, P).astype(np.int32)
    pm = np.ones(P, np.float32)
    pm[1] = 0.0
    pm[-3:] = 0.0
    pc[-3:], px[-3:] = 0, 0
    pool = rng.integers(0, V, S).astype(np.int32)
    pool[0] = px[0]
    if S > 2:
        pool[2] = pool[1]
    return s0, s1, pc, px, pm, pool


def _jax_tables(s0, s1, dtype):
    import jax.numpy as jnp

    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return jnp.asarray(s0).astype(jd), jnp.asarray(s1).astype(jd)


def _torch_tables(s0, s1, dtype):
    td = getattr(torch, dtype)
    return _t(s0).to(td), _t(s1).to(td)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,S", [(13, 1), (13, 5), (37, 5), (37, 32)])
def test_pair_forward_shared_reference_matches_jax(P, S, dtype):
    import jax.numpy as jnp

    from glint_word2vec_tpu.ops.pallas_sgns import pair_forward_shared as jax_fn

    s0, s1, pc, px, pm, pool = _pair_case(P, S, seed=P + S)
    j0, j1 = _jax_tables(s0, s1, dtype)
    jfw = jax_fn(j0, j1, *(jnp.asarray(a) for a in (pc, px, pm, pool)),
                 jnp.float32(0.05), N_NEG, interpret=True, block_rows=4)
    t0, t1 = _torch_tables(s0, s1, dtype)
    before = fs.pair_forward_shared.launches
    pfw = fs.pair_forward_shared(t0, t1, *(_t(a) for a in (pc, px, pm, pool)),
                                 torch.tensor(0.05), N_NEG)
    assert fs.pair_forward_shared.launches == before  # CPU: plain version
    assert np.array_equal(pfw.h.numpy(), np.asarray(jfw.h))
    np.testing.assert_allclose(pfw.c_pos.numpy(), np.asarray(jfw.c_pos),
                               rtol=1e-5, atol=1e-9)
    for name in ("d_center", "d_pool"):
        np.testing.assert_allclose(
            getattr(pfw, name).numpy(), np.asarray(getattr(jfw, name)),
            rtol=2e-5, atol=1e-6, err_msg=name,
        )
    assert pfw.d_pool.shape == (S, D)
    assert float(pfw.loss_sum) == pytest.approx(float(jfw.loss_sum), rel=1e-5)


def test_pair_forward_shared_reference_is_the_numpy_estimator():
    # The dense float64 restatement of the estimator: collisions of a pool
    # word with the pair's context dropped, weight mask * n / S, masked
    # pairs adding exact zeros to d_pool.
    P, S = 37, 32
    s0, s1, pc, px, pm, pool = _pair_case(P, S, seed=3)
    pfw = fs.pair_forward_shared(*(_t(a) for a in (s0, s1, pc, px, pm, pool)),
                                 torch.tensor(0.05), N_NEG)
    h, u, up = (s0.astype(np.float64)[pc], s1.astype(np.float64)[px],
                s1.astype(np.float64)[pool])
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    f_pos, f_pool = (h * u).sum(-1), h @ up.T
    w = (pm * (N_NEG / S))[:, None] * (pool[None, :] != px[:, None])
    c_pos = 0.05 * (1 - sig(f_pos)) * pm
    c_pool = -0.05 * sig(f_pool) * w
    np.testing.assert_allclose(pfw.c_pos.numpy(), c_pos, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(pfw.d_center.numpy(),
                               c_pos[:, None] * u + c_pool @ up,
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(pfw.d_pool.numpy(), c_pool.T @ h,
                               rtol=2e-5, atol=1e-6)
    loss = (-np.log(sig(f_pos)) * pm).sum() - (np.log(sig(-f_pool)) * w).sum()
    assert float(pfw.loss_sum) == pytest.approx(loss, rel=1e-5)
    # The masked pairs' rows of h do not reach d_pool.
    keep = pm > 0
    np.testing.assert_allclose(pfw.d_pool.numpy(),
                               c_pool[keep].T @ h[keep], rtol=2e-5, atol=1e-6)


def _tf32(x):
    """``cvt.rna.tf32.f32``: round a float32 tensor to nearest on its 13
    low fraction bits, ties away from zero (finite values)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tensor_core_product(a, b, split, chunks=1):
    """``a @ b`` (float32) as the B5 kernel takes it: each stage of 32
    k-values summed in steps of 8, each step a tensor-core product
    (emulated as its 8 exact products added to the running value and
    rounded to float32), the split terms small first (``a_lo.b_hi``,
    ``a_hi.b_lo``, ``a_hi.b_hi``) or one TF32 pass; each stage's sum then
    added to its chunk's fp32 sum, rounded to nearest. The stages are cut
    evenly into ``chunks`` chunks, whose sums are added in chunk order."""
    ah, bh = _tf32(a), _tf32(b)
    terms = [(ah, bh)]
    if split:
        terms = [(_tf32(a - ah), bh), (ah, _tf32(b - bh)), (ah, bh)]
    terms = [(x.double(), y.double()) for x, y in terms]
    K = a.shape[1]
    stages = (K + 31) // 32
    out = None
    for c in range(chunks):
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
        for st in range(stages * c // chunks, stages * (c + 1) // chunks):
            part = torch.zeros_like(acc)
            for k in range(32 * st, min(32 * st + 32, K), 8):
                for x, y in terms:
                    part = (part.double() + x[:, k : k + 8] @ y[k : k + 8]).float()
            acc = acc + part
        out = acc if out is None else out + acc
    return out


def test_split_tf32_products_keep_fp32_accuracy():
    # B5's three products at P = 333, S = 4,096, d = 300, emulated on the
    # CPU in split TF32 and in one TF32 pass, against float64: the split
    # form stays within 10 times the fp32 plain version's norm-wise error
    # and one pass is at least 100 times worse than the split form.
    # (B5's stated tolerances, rtol 1e-4 with atol 1e-6 on entries of
    # about 1e-4, may pass one pass of TF32 too.)
    P, S, d, Vs, alpha = 333, 4096, 300, 5000, 0.025
    rng = np.random.default_rng(8)
    s0 = (0.3 * rng.standard_normal((Vs, d))).astype(np.float32)
    s1 = (0.3 * rng.standard_normal((Vs, d))).astype(np.float32)
    pc, px = rng.integers(0, Vs, P).astype(np.int32), rng.integers(0, Vs, P).astype(np.int32)
    pool = rng.integers(0, Vs, S).astype(np.int32)
    pool[0] = px[0]
    pm = np.ones(P, np.float32)
    pm[-5:] = 0.0
    args = [_t(a) for a in (s0, s1, pc, px, pm, pool)]
    plain = fs.pair_forward_shared_reference(*args, torch.tensor(alpha), N_NEG)

    h64, u64, up64 = (x.astype(np.float64) for x in (s0[pc], s1[px], s1[pool]))
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    w = (pm * (N_NEG / S))[:, None] * (pool[None, :] != px[:, None])
    f64 = h64 @ up64.T
    c_pool64 = -alpha * sig(f64) * w
    want = {"logits": f64,
            "d_center": (alpha * (1 - sig((h64 * u64).sum(-1))) * pm)[:, None] * u64
            + c_pool64 @ up64,
            "d_pool": c_pool64.T @ h64}

    def err(got):
        return {k: np.linalg.norm(got[k].double().numpy() - x) / np.linalg.norm(x)
                for k, x in want.items()}

    h, up = plain.h, _t(s1[pool])
    wt = torch.from_numpy(w.astype(np.float32))

    def kernel(split):
        f = _tensor_core_product(h, up.T.contiguous(), split)
        c_pool = -alpha * torch.sigmoid(f) * wt
        u = _t(s1[px])
        return {"logits": f,
                "d_center": plain.c_pos[:, None] * u
                + _tensor_core_product(c_pool, up, split, chunks=2),
                "d_pool": _tensor_core_product(c_pool.T.contiguous(), h, split, chunks=2)}

    e_plain = err({"logits": h @ up.T, "d_center": plain.d_center,
                   "d_pool": plain.d_pool})
    e_split, e_one = err(kernel(True)), err(kernel(False))
    for k in want:
        assert e_split[k] <= 10 * e_plain[k], (k, e_split[k], e_plain[k])
        assert e_one[k] >= 100 * e_split[k], (k, e_one[k], e_split[k])


@pytest.mark.parametrize("dtype,S", [("float32", 5), ("float32", 32),
                                     ("bfloat16", 32)])
def test_fused_pair_step_shared_matches_jax(dtype, S):
    import jax.numpy as jnp

    from glint_word2vec_tpu.ops.pallas_sgns import fused_pair_step_shared as jax_fn

    s0, s1, pc, px, pm, pool = _pair_case(37, S, seed=11)
    j0, j1 = _jax_tables(s0, s1, dtype)
    # Under bf16 one JAX block takes every update: a run that spans two
    # of its grid steps is rounded once a step there, once here.
    block = 4 if dtype == "float32" else 64
    g0, g1, jl = jax_fn(j0, j1, *(jnp.asarray(a) for a in (pc, px, pm, pool)),
                        jnp.float32(0.05), N_NEG, interpret=True,
                        block_rows=block)
    t0, t1 = _torch_tables(s0, s1, dtype)
    loss = fs.fused_pair_step_shared(
        t0, t1, *(_t(a) for a in (pc, px, pm, pool)), torch.tensor(0.05), N_NEG
    )
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    for got, want, name in ((t0, g0, "syn0"), (t1, g1, "syn1")):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        assert not np.array_equal(want, s0 if name == "syn0" else s1)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6,
                                       err_msg=name)
        else:
            assert (np.abs(got - want) <= _ulp_bf16(want)).all(), name


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_shared_sgns_grads_match_jax(compute):
    import jax.numpy as jnp

    from glint_word2vec_tpu.ops import sgns as jsgns

    rng = np.random.default_rng(4)
    B, C, S = 9, 5, 13
    h = rng.normal(size=(B, D)).astype(np.float32)
    u_pos = rng.normal(size=(B, C, D)).astype(np.float32)
    u_pool = rng.normal(size=(S, D)).astype(np.float32)
    mask = (rng.random((B, C)) < 0.7).astype(np.float32)
    mask[-1] = 0.0
    collide = (rng.random((B, S)) < 0.2).astype(np.float32)
    jg = jsgns.shared_sgns_grads(
        *(jnp.asarray(a) for a in (h, u_pos, u_pool, mask, collide)),
        jnp.float32(0.05), N_NEG,
        compute_dtype=jnp.float32 if compute == "float32" else jnp.bfloat16,
    )
    pg = psgns.shared_sgns_grads(
        *(_t(a) for a in (h, u_pos, u_pool, mask, collide)),
        torch.tensor(0.05), N_NEG, compute,
    )
    for name in ("c_pos", "c_pool", "d_center", "d_pool"):
        np.testing.assert_allclose(
            getattr(pg, name).numpy(), np.asarray(getattr(jg, name)),
            rtol=1e-5, atol=1e-6, err_msg=name,
        )
    assert float(pg.loss) == pytest.approx(float(jg.loss), rel=1e-5)


def test_pool_collision_mask_matches_jax():
    import jax.numpy as jnp

    from glint_word2vec_tpu.ops import sgns as jsgns

    # The case of tests/test_shared_negatives.py:54-63.
    pool = np.array([3, 7, 9], np.int32)
    contexts = np.array([[3, 5], [7, 7], [1, 2]], np.int32)
    mask = np.array([[1, 1], [0, 1], [1, 1]], np.float32)
    m = psgns.pool_collision_mask(_t(pool), _t(contexts), _t(mask)).numpy()
    np.testing.assert_array_equal(m, [[1, 0, 0], [0, 1, 0], [0, 0, 0]])
    # Random rows: repeated pool ids and contexts, padded lanes, id 0
    # (the padding id) and V-1 in the pool.
    rng = np.random.default_rng(5)
    B, C, S = 17, 7, 40
    pool = rng.integers(0, 12, S).astype(np.int32)
    pool[:2] = [0, V - 1]
    contexts = rng.integers(0, 12, (B, C)).astype(np.int32)
    contexts[0, 0] = V - 1
    mask = (rng.random((B, C)) < 0.6).astype(np.float32)
    contexts = np.where(mask > 0, contexts, 0).astype(np.int32)
    want = np.asarray(jsgns.pool_collision_mask(
        jnp.asarray(pool), jnp.asarray(contexts), jnp.asarray(mask)))
    got = psgns.pool_collision_mask(_t(pool), _t(contexts), _t(mask)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


# ----------------------------------------------------------------------
# The engine's two routes against the JAX engine
# ----------------------------------------------------------------------


def _corpus(seed=0, lens=(5, 1, 9, 3, 12, 2, 6, 30, 4, 17)):
    rng = np.random.default_rng(seed)
    sents = [rng.integers(0, V, L).astype(np.int32) for L in lens]
    ids = np.concatenate(sents)
    offsets = np.zeros(len(sents) + 1, np.int64)
    np.cumsum([len(s) for s in sents], out=offsets[1:])
    return ids, offsets


class JaxDraws:
    """The JAX package's shrink and pool draws, for the port's engine:
    the functions its packed scan calls, under the same keys."""

    def __init__(self, key, jeng, window, grid_batch):
        self.key, self.jeng = key, jeng
        self.window, self.grid_batch = window, grid_batch

    def shrink(self, positions, grid_step0):
        import jax.numpy as jnp

        from glint_word2vec_tpu.ops.device_batching import grid_window_shrink

        b = grid_window_shrink(
            self.key, jnp.asarray(positions.numpy().astype(np.int32)),
            self.grid_batch, jnp.uint32(grid_step0), self.window,
        )
        return torch.from_numpy(np.asarray(b).astype(np.int64))

    def negatives(self, step, n_rows):
        raise AssertionError("the shared pool draws no per-pair negatives")

    def pool(self, step, size):
        return _t(_jax_pool(self.key, self.jeng, step, size))


def _jax_pool(key, jeng, step, size):
    import jax
    import jax.numpy as jnp

    from glint_word2vec_tpu.ops.sampling import sample_negatives

    k = jax.random.fold_in(key, jnp.uint32(step))
    return np.asarray(sample_negatives(k, jeng._prob, jeng._alias, (size,)),
                      np.int32)


@pytest.mark.parametrize("window,subsample", [(3, False), (5, True)])
def test_packed_shared_steps_match_jax_engine(window, subsample):
    import jax
    import jax.numpy as jnp

    from glint_word2vec_tpu.ops.device_batching import subsample_keep_mask
    from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
    from glint_word2vec_tpu.parallel.mesh import make_mesh

    from glint_word2vec_torch.convert import engine_from_arrays

    ids, offsets = _corpus()
    rng = np.random.default_rng(1)
    counts = np.arange(V, 0, -1).astype(np.int64) * 3
    syn0 = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    syn1 = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    S = 16
    jeng = JaxEngine(make_mesh(1, 1), V, D, counts, num_negatives=3,
                     seed=11, use_pallas=True, shared_negatives=S)
    assert jeng._pallas_fused
    jeng.set_tables(syn0, syn1)
    peng = engine_from_arrays(syn0, syn1, counts, num_negatives=3,
                              device="cpu", shared_negatives=S)
    jeng.upload_corpus(ids, offsets)
    peng.upload_corpus(ids, offsets)
    if subsample:
        kp = np.linspace(0.2, 1.0, V).astype(np.float32)
        jeng.set_keep_probs(kp)
        peng.set_keep_probs(kp)
        ekey = jax.random.fold_in(jax.random.PRNGKey(5), 0)
        keep = np.array(subsample_keep_mask(jnp.asarray(ids), jnp.asarray(kp), ekey))
        assert jeng.compact_corpus(ekey) == peng.compact_corpus(
            0, keep=torch.from_numpy(keep))
    key = jax.random.PRNGKey(5)
    P, B, K = 16, 8, 4
    kw = dict(step0=2, grid_step0=3, step_size=0.05, total_words=1000,
              words_base=7)
    jout = jeng.train_steps_corpus_packed(0, P, window, B, key, K, **kw)
    before = (fs.pair_forward.launches, fs.pair_forward_shared.launches)
    pout = peng.train_steps_corpus_packed(
        0, P, window, B, 0, K, **kw, draws=JaxDraws(key, jeng, window, B)
    )
    assert (fs.pair_forward.launches, fs.pair_forward_shared.launches) == before
    jl, jpairs, jpos, jalpha = (np.asarray(a) for a in jout)
    pl, ppairs, ppos, palpha = pout
    np.testing.assert_array_equal(ppairs, jpairs)
    np.testing.assert_array_equal(ppos, jpos)
    assert jpos[-1] > jpos[0] > 0
    np.testing.assert_array_equal(palpha, jalpha)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    for name in ("syn0", "syn1"):
        np.testing.assert_allclose(
            getattr(peng, name).numpy(),
            np.asarray(getattr(jeng, name), np.float32)[:V],
            rtol=2e-5, atol=1e-6, err_msg=name,
        )


X, KS, BS, CS = 20, 3, 8, 5


def _batches(S, seed=0):
    """K grid batches as tests/test_torch_composed.py builds them: subword
    groups of S rows, contexts with about 40% padded lanes, one
    all-padding batch row."""
    rng = np.random.default_rng(seed)
    cg = rng.integers(0, V + X, (KS, BS, S)).astype(np.int32)
    cg[..., 0] = rng.integers(0, V, (KS, BS))
    gm = (rng.random((KS, BS, S)) < 0.7).astype(np.float32)
    gm[..., 0] = 1.0
    cg = np.where(gm > 0, cg, 0).astype(np.int32)
    cx = rng.integers(0, V, (KS, BS, CS)).astype(np.int32)
    mk = (rng.random((KS, BS, CS)) < 0.6).astype(np.float32)
    mk[:, -1] = 0.0
    cg[:, -1], gm[:, -1] = 0, 0.0
    gm[:, -1, 0] = 1.0
    cx = np.where(mk > 0, cx, 0).astype(np.int32)
    return cg, gm, cx, mk


@pytest.mark.parametrize("S,dtype,compute", [
    (1, "float32", "float32"),
    (4, "float32", "float32"),
    (4, "bfloat16", "float32"),
    (1, "float32", "bfloat16"),
])
def test_grouped_shared_steps_match_jax_engine(S, dtype, compute):
    import jax

    from glint_word2vec_tpu.parallel.engine import EmbeddingEngine as JaxEngine
    from glint_word2vec_tpu.parallel.mesh import make_mesh

    from glint_word2vec_torch.convert import engine_from_arrays
    from glint_word2vec_torch.ops import rows as rows_mod

    Ps = 12
    rng = np.random.default_rng(S)
    counts = np.arange(V, 0, -1).astype(np.int64) * 3
    s0 = rng.normal(0, 0.3, (V + X, D)).astype(np.float32)
    s1 = rng.normal(0, 0.3, (V + X, D)).astype(np.float32)
    jeng = JaxEngine(make_mesh(1, 1), V, D, counts, num_negatives=N_NEG,
                     seed=3, extra_rows=X, use_pallas=True, dtype=dtype,
                     compute_dtype=compute, shared_negatives=Ps)
    jeng.set_tables(s0, s1)
    peng = engine_from_arrays(s0, s1, counts, num_negatives=N_NEG,
                              device="cpu", dtype=dtype, compute_dtype=compute,
                              shared_negatives=Ps)
    cg, gm, cx, mk = _batches(S)
    key, step0 = jax.random.PRNGKey(5), 4
    alphas = np.array([0.05, 0.04, 0.03], np.float32)
    jl = np.asarray(jeng.train_steps_grouped(cg, gm, cx, mk, key, alphas, step0))
    pools = np.stack([_jax_pool(key, jeng, step0 + i, Ps) for i in range(KS)])
    launches = (rows_mod.scatter_add_rows.launches,
                rows_mod.scatter_add_rank1.launches)
    pl = peng.train_steps_grouped(cg, gm, cx, mk, 0, alphas, step0, pools=pools)
    assert (rows_mod.scatter_add_rows.launches,
            rows_mod.scatter_add_rank1.launches) == launches  # CPU: plain
    np.testing.assert_allclose(pl.numpy(), jl, rtol=1e-5)
    for name in ("syn0", "syn1"):
        got = getattr(peng, name).float().numpy()
        want = np.asarray(getattr(jeng, name), np.float32)[: V + X]
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        else:
            assert (np.abs(got - want) <= _ulp_bf16(want)).all(), name
    with pytest.raises(ValueError, match="pools must have shape"):
        peng.train_steps_grouped(cg, gm, cx, mk, 0, alphas, step0,
                                 pools=pools[:, :-1])


def test_engine_draws_its_own_pool_per_step():
    # Without pools= the composed step draws sample_negatives(fold_in(key,
    # step), (S,)): the same tables as handing in those pools.
    from glint_word2vec_torch.convert import engine_from_arrays
    from glint_word2vec_torch.ops import random as rnd
    from glint_word2vec_torch.ops.sampling import sample_negatives

    rng = np.random.default_rng(2)
    counts = np.arange(V, 0, -1).astype(np.int64)
    s0 = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    s1 = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    cg, gm, cx, mk = _batches(1)
    cg = cg % V
    a, b = (engine_from_arrays(s0, s1, counts, device="cpu", shared_negatives=8)
            for _ in range(2))
    prob, alias = a.noise_tables()
    pools = torch.stack([sample_negatives(rnd.fold_in(7, 2 + i), prob, alias, (8,))
                         for i in range(KS)])
    la = a.train_steps(cg[..., 0], cx, mk, 7, [0.05] * KS, 2)
    lb = b.train_steps(cg[..., 0], cx, mk, 7, [0.05] * KS, 2, pools=pools)
    assert torch.equal(la, lb)
    assert torch.equal(a.syn0, b.syn0) and torch.equal(a.syn1, b.syn1)


# ----------------------------------------------------------------------
# End to end
# ----------------------------------------------------------------------


def _tiny_fit(corpus, **kw):
    from glint_word2vec_torch import Word2Vec

    w2v = (
        Word2Vec(device="cpu")
        .set_vector_size(48).set_window_size(5).set_step_size(0.025)
        .set_batch_size(256).set_min_count(5).set_num_iterations(6)
        .set_seed(1).set_shared_negatives(256)
    )
    return w2v._set(**kw).fit(corpus)


@pytest.mark.parametrize("route,dtype", [
    ("device_corpus", "float32"), ("device_corpus", "bfloat16"),
    ("host", "float32"),
])
def test_fit_shared_pool_passes_quality_gates(tiny_corpus, monkeypatch,
                                              route, dtype):
    # The gates of tests/test_shared_negatives.py:114-134.
    from glint_word2vec_torch.models import word2vec as w2v

    if route == "host":
        monkeypatch.setattr(w2v, "_free_device_bytes", lambda device: 0)
    m = _tiny_fit(tiny_corpus, dtype=dtype)
    assert m.training_metrics["pipeline"] == route
    assert m.engine.shared_negatives == 256
    for country, capital in [("germany", "berlin"), ("france", "paris")]:
        hits = [w for w, _ in m.find_synonyms(country, 10)]
        assert capital in hits, (country, capital, hits)


def test_fasttext_shared_pool_passes_its_gate(tiny_corpus):
    # The tiny_corpus gate of tests/test_torch_fasttext.py:124-129.
    from glint_word2vec_torch import FastTextWord2Vec

    m = FastTextWord2Vec(
        device="cpu", vector_size=32, min_count=5, batch_size=256,
        num_iterations=4, step_size=0.025, seed=1, bucket=5000,
        min_n=3, max_n=5, shared_negatives=256,
    ).fit(tiny_corpus)
    assert m.training_metrics["pipeline"] == "host"
    v, v_oov = m.transform("austria"), m.transform("austriaa")
    cos = v @ v_oov / (np.linalg.norm(v) * np.linalg.norm(v_oov))
    assert cos > 0.5, cos
    syns = m.find_synonyms("austria", 5)
    assert len(syns) == 5 and "austria" not in dict(syns)


SMALL = [
    "the quick brown fox jumps over the lazy dog".split(),
    "the dog sleeps all day long in the sun".split(),
    "a quick fox and a lazy dog meet in the field".split(),
    "the sun rises over the field every day".split(),
] * 30


def _small(**kw):
    from glint_word2vec_torch import Word2Vec

    defaults = dict(vector_size=12, batch_size=32, min_count=1,
                    num_iterations=2, seed=7, steps_per_call=4, window=3,
                    shared_negatives=16)
    defaults.update(kw)
    return Word2Vec(device="cpu", **defaults)


@pytest.mark.parametrize("route", ["device_corpus", "host"])
def test_shared_pool_resume_equals_uninterrupted_run(tmp_path, monkeypatch,
                                                     route):
    from glint_word2vec_torch.models import word2vec as w2v

    if route == "host":
        monkeypatch.setattr(w2v, "_free_device_bytes", lambda device: 0)
    ck = str(tmp_path / "ck")
    first = _small(subsample_ratio=0.05).fit(SMALL, checkpoint_dir=ck,
                                             stop_after_epochs=1)
    assert first.training_metrics["pipeline"] == route
    resumed = _small(subsample_ratio=0.05).fit(SMALL, checkpoint_dir=ck)
    full = _small(subsample_ratio=0.05).fit(SMALL)
    for name in ("syn0", "syn1"):
        assert torch.equal(getattr(resumed.engine, name),
                           getattr(full.engine, name))
    # The pool differs from per-pair draws: the same run without it
    # trains other tables.
    other = _small(subsample_ratio=0.05, shared_negatives=0).fit(SMALL)
    assert not torch.equal(other.engine.syn1, full.engine.syn1)


@pytest.mark.parametrize("family", ["word2vec", "fasttext"])
def test_cli_train_shared_negatives_on_cpu(tmp_path, capsys, family):
    from glint_word2vec_torch import cli
    from glint_word2vec_torch.models import load_model

    corpus = tmp_path / "c.txt"
    corpus.write_text("".join(" ".join(s) + "\n" for s in SMALL))
    out = tmp_path / "m"
    extra = ["--fasttext", "--bucket", "200"] if family == "fasttext" else []
    rc = cli.main([
        "train", "--corpus", str(corpus), "--output", str(out),
        "--device", "cpu", "--vector-size", "8", "--batch-size", "32",
        "--min-count", "1", "--iterations", "1", "--window", "3",
        "--shared-negatives", "16", *extra,
    ])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["saved"] == str(out) and np.isfinite(line["final_loss"])
    m = load_model(str(out), device="cpu")
    assert m.params.shared_negatives == 16 and m.engine.shared_negatives == 16
    assert "fox" in m.vocab and np.isfinite(m.transform("fox")).all()


def test_device_budget_counts_the_pool(monkeypatch):
    # The shared step's working set (pool rows, d_pool, the (P, S)
    # c_pool of the forward kernel) enters the resident fit's estimate.
    est = _small(shared_negatives=0)
    base = est._device_bytes_needed(1000, 10_000, 100)
    est = _small(shared_negatives=4096)
    grown = est._device_bytes_needed(1000, 10_000, 100)
    from glint_word2vec_torch.corpus.batching import packed_pair_batch

    P = packed_pair_batch(32, 3)
    assert grown - base >= P * 4096 * 4 + 2 * 4096 * 12 * 4


def test_pair_forward_shared_validates_inputs():
    table = torch.zeros((V, D))
    ids = torch.zeros(4, dtype=torch.int32)
    args = (table, table, ids, ids, torch.zeros(4))
    with pytest.raises(ValueError, match="S >= 1"):
        fs.pair_forward_shared(*args, torch.zeros(0, dtype=torch.int32),
                               torch.tensor(0.1), 5)
    with pytest.raises(TypeError, match="pool must be"):
        fs.pair_forward_shared(*args, torch.zeros(3, dtype=torch.int64),
                               torch.tensor(0.1), 5)
    with pytest.raises(ValueError, match="num_negatives"):
        fs.pair_forward_shared(*args, ids, torch.tensor(0.1), 0)
    with pytest.raises(ValueError, match="share dtype"):
        fs.pair_forward_shared(table, table.to(torch.bfloat16), ids, ids,
                               torch.zeros(4), ids, torch.tensor(0.1), 5)


# ----------------------------------------------------------------------
# On the card: the kernel against its plain version
# ----------------------------------------------------------------------


def _cuda_case(dtype, P, S, d):
    """Tables and one pair batch on the card: the pool's word 0 is the
    first pair's context, a repeated pool id, a masked tail of 7."""
    gen = torch.Generator(device="cuda").manual_seed(P + S + d)
    Vc = 5000
    td = getattr(torch, dtype)
    syn0 = (0.3 * torch.randn((Vc, d), generator=gen, device="cuda")).to(td)
    syn1 = (0.3 * torch.randn((Vc, d), generator=gen, device="cuda")).to(td)
    ids = torch.randint(0, Vc, (2 * P + S,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pc, px, pool = ids[:P], ids[P : 2 * P], ids[2 * P :].clone()
    pool[0] = px[0]
    if S > 2:
        pool[2] = pool[1]
    pm = (torch.arange(P, device="cuda") < max(P - 7, 1)).to(torch.float32)
    alpha = torch.tensor(0.025, device="cuda")
    return (syn0, syn1, pc.contiguous(), px.contiguous(), pm, pool, alpha)


def _f64_errors(args, got, want):
    """Norm-wise relative error ``||x - x64|| / ||x64||`` of ``d_center``
    and ``d_pool`` in ``got`` and in ``want``, against the estimator
    computed in float64 on the card from the same inputs."""
    syn0, syn1, centers, contexts, mask, pool, alpha = args
    h = syn0[centers.long()].double()
    u = syn1[contexts.long()].double()
    up = syn1[pool.long()].double()
    a, m = alpha.double(), mask.double()
    keep = (pool[None, :] != contexts[:, None]).double()
    w = (m * fs._pool_weight(N_NEG, pool.shape[0]))[:, None] * keep
    c_pos = a * (1.0 - torch.sigmoid((h * u).sum(-1))) * m
    c_pool = -a * torch.sigmoid(h @ up.T) * w
    x64 = {"d_center": c_pos[:, None] * u + c_pool @ up, "d_pool": c_pool.T @ h}
    return {name: [float(torch.linalg.vector_norm(getattr(o, name).cuda().double() - x)
                         / torch.linalg.vector_norm(x)) for o in (got, want)]
            for name, x in x64.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,S,d", [(333, 5, 300), (333, 257, 301),
                                   (129, 128, 7), (1, 1, 1),
                                   (3277, 4096, 300), (70, 127, 8),
                                   (70, 129, 9)])
def test_cuda_pair_forward_shared_matches_plain(dtype, P, S, d):
    # Shapes on and off the 64 x 64 block tiles, the depth-32 stages and
    # the m16n8k8 tiles, rows 16-byte aligned (d = 8, 300) or not.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    args = _cuda_case(dtype, P, S, d)
    before = fs.pair_forward_shared.launches
    got = fs.pair_forward_shared(*args, N_NEG)
    torch.cuda.synchronize()
    assert fs.pair_forward_shared.launches == before + 1
    want = fs.pair_forward_shared_reference(*(t.cpu() for t in args), N_NEG)
    assert torch.equal(got.h.cpu(), want.h)  # a copy: bitwise
    torch.testing.assert_close(got.c_pos.cpu(), want.c_pos, rtol=1e-5, atol=1e-9)
    for name in ("d_center", "d_pool"):
        w = getattr(want, name)
        torch.testing.assert_close(getattr(got, name).cpu(), w, rtol=1e-4,
                                   atol=1e-6 * max(1.0, float(w.abs().max())))
    assert float(got.loss_sum) == pytest.approx(float(want.loss_sum), rel=1e-5)
    if (P, S, d) == (3277, 4096, 300):
        # At full width the kernel's norm-wise error against float64 stays
        # within 10 times the fp32 plain version's: the split keeps fp32
        # accuracy, where one TF32 pass would not.
        for name, (e_kernel, e_plain) in _f64_errors(args, got, want).items():
            assert e_kernel <= 10 * e_plain, (name, e_kernel, e_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_pair_forward_shared_is_deterministic(dtype):
    # Every output has one owner that sums it in a fixed order: two calls
    # on the same inputs agree bitwise, the loss too.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    args = _cuda_case(dtype, 1000, 4096, 300)
    a = fs.pair_forward_shared(*args, N_NEG)
    b = fs.pair_forward_shared(*args, N_NEG)
    torch.cuda.synchronize()
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
