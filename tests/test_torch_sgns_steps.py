"""The step functions of the port's ``ops/sgns.py`` against the JAX
package's on the same tables and the same draws: ``train_step`` (the
window step over ``(B, C)`` contexts), ``sgns_loss`` and
``train_step_pairs_fused`` (against ``train_step_pairs_pallas`` in
interpret mode). The JAX functions draw their negatives from a key; the
test reads those draws back (``sample_negatives_per_row``, as the JAX
steps call it) and hands them to the port as ``negs``.

Tolerances: fp32, rtol 1e-5 and atol 1e-6 on the tables (duplicate rows
summed in another order), rel 1e-5 on the loss; the inputs of the port's
functions are left unchanged, bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from glint_word2vec_tpu.corpus.alias import build_unigram_alias
from glint_word2vec_tpu.ops import sgns as jsgns
from glint_word2vec_tpu.ops.sampling import sample_negatives_per_row

from glint_word2vec_torch.ops import sgns as psgns

V, D, N_NEG = 61, 16, 3
RTOL, ATOL = 1e-5, 1e-6


def _tables(seed):
    rng = np.random.default_rng(seed)
    s0 = (0.3 * rng.standard_normal((V, D))).astype(np.float32)
    s1 = (0.3 * rng.standard_normal((V, D))).astype(np.float32)
    return s0, s1


def _alias():
    t = build_unigram_alias(np.arange(V, 0, -1).astype(np.int64), power=0.75)
    return jnp.asarray(t.prob), jnp.asarray(t.alias)


def _window_batch(seed, B=24, C=5):
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, V, B).astype(np.int32)
    contexts = rng.integers(0, 8, (B, C)).astype(np.int32)  # duplicate rows
    mask = (rng.random((B, C)) < 0.7).astype(np.float32)
    contexts = np.where(mask > 0, contexts, 0).astype(np.int32)
    return centers, contexts, mask


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("seed", [0, 1])
def test_train_step_matches_the_jax_window_step(seed):
    s0, s1 = _tables(seed)
    centers, contexts, mask = _window_batch(seed)
    prob, alias = _alias()
    key = jax.random.PRNGKey(seed + 5)
    B, C = contexts.shape
    j0, j1, jl = jsgns.train_step(
        jnp.asarray(s0), jnp.asarray(s1), prob, alias, jnp.asarray(centers),
        jnp.asarray(contexts), jnp.asarray(mask), key, jnp.float32(0.05), N_NEG)
    negs = np.asarray(sample_negatives_per_row(
        key, prob, alias, jnp.arange(B, dtype=jnp.int32), (C, N_NEG)))
    t0, t1 = _t(s0), _t(s1)
    p0, p1, pl = psgns.train_step(t0, t1, _t(centers), _t(contexts), _t(mask),
                                  _t(negs), 0.05)
    _close(p0, j0, "syn0")
    _close(p1, j1, "syn1")
    assert float(pl) == pytest.approx(float(jl), rel=RTOL)
    assert np.array_equal(t0.numpy(), s0) and np.array_equal(t1.numpy(), s1)


@pytest.mark.parametrize("seed", [0, 1])
def test_sgns_loss_matches_the_jax_loss(seed):
    s0, s1 = _tables(seed)
    centers, contexts, mask = _window_batch(seed + 10)
    prob, alias = _alias()
    key = jax.random.PRNGKey(seed + 9)
    B, C = contexts.shape
    jl = jsgns.sgns_loss(
        jnp.asarray(s0), jnp.asarray(s1), prob, alias, jnp.asarray(centers),
        jnp.asarray(contexts), jnp.asarray(mask), key, N_NEG)
    negs = np.asarray(sample_negatives_per_row(
        key, prob, alias, jnp.arange(B, dtype=jnp.int32), (C, N_NEG)))
    pl = psgns.sgns_loss(_t(s0), _t(s1), _t(centers), _t(contexts), _t(mask),
                         _t(negs))
    assert float(pl) == pytest.approx(float(jl), rel=RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_train_step_pairs_fused_matches_the_pallas_step(seed):
    s0, s1 = _tables(seed)
    rng = np.random.default_rng(seed + 20)
    P = 40
    centers = rng.integers(0, V, P).astype(np.int32)
    contexts = rng.integers(0, 6, P).astype(np.int32)  # runs of one row
    pair_mask = (rng.random(P) < 0.8).astype(np.float32)
    centers = np.where(pair_mask > 0, centers, 0).astype(np.int32)
    contexts = np.where(pair_mask > 0, contexts, 0).astype(np.int32)
    prob, alias = _alias()
    key = jax.random.PRNGKey(seed + 3)
    j0, j1, jl = jsgns.train_step_pairs_pallas(
        jnp.asarray(s0), jnp.asarray(s1), prob, alias, jnp.asarray(centers),
        jnp.asarray(contexts), jnp.asarray(pair_mask), key, jnp.float32(0.05),
        N_NEG, interpret=True, block_rows=4)
    negs = np.asarray(sample_negatives_per_row(
        key, prob, alias, jnp.arange(P, dtype=jnp.int32), (1, N_NEG)))[:, 0, :]
    t0, t1 = _t(s0), _t(s1)
    args = (_t(centers), _t(contexts), _t(pair_mask), _t(negs), 0.05)
    p0, p1, pl = psgns.train_step_pairs_fused(t0, t1, *args)
    _close(p0, j0, "syn0")
    _close(p1, j1, "syn1")
    assert float(pl) == pytest.approx(float(jl), rel=RTOL)
    assert np.array_equal(t0.numpy(), s0) and np.array_equal(t1.numpy(), s1)
    # The composed pair step on the same draws gives the same update.
    c0, c1, cl = psgns.train_step_pairs(t0, t1, *args)
    _close(p0, c0.numpy(), "syn0 against train_step_pairs")
    _close(p1, c1.numpy(), "syn1 against train_step_pairs")
    assert float(pl) == pytest.approx(float(cl), rel=RTOL)


def test_train_step_pairs_fused_runs_the_plain_versions_on_the_cpu():
    from glint_word2vec_torch.ops import fused_sgns as fs

    s0, s1 = _tables(4)
    kernels = (fs.pair_forward, fs.scatter_add_rank1_hbm, fs.scatter_add_rows_f32)
    before = [k.launches for k in kernels]
    P = 8
    psgns.train_step_pairs_fused(
        _t(s0), _t(s1), torch.arange(P, dtype=torch.int32),
        torch.arange(P, dtype=torch.int32), torch.ones(P),
        torch.zeros((P, N_NEG), dtype=torch.int32), 0.05)
    assert [k.launches for k in kernels] == before
