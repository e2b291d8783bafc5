"""The fused pair step of the port (glint_word2vec_torch/ops/fused_sgns.py)
against the JAX package's Pallas kernels run in interpret mode
(``ops/pallas_sgns.py``, as ``tests/test_pallas_sgns.py`` runs them) and
a NumPy pair oracle.

Tolerances: the scatters are bitwise on dyadic inputs (every partial sum
exact in fp32), with runs longer than the JAX kernels' ``block_rows=4``;
``pair_forward``, ``fused_pair_step`` and the composed ``train_step_pairs``
agree within rtol 2e-5 and atol 1e-6 (fp32 dot products summed in
another order), the loss within rel 1e-5.

The ``cuda`` tests hold each CUDA kernel against its plain version on a
card. They import no JAX, so they also run where JAX is not installed:

    python -m pytest tests/test_torch_fused_sgns.py -m cuda --noconftest -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_torch.ops import fused_sgns as fs
from glint_word2vec_torch.ops.sgns import negative_mask, train_step_pairs

V, D = 73, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _dyadic_rows_case(seed=0, n=19):
    rng = np.random.default_rng(seed)
    table = (rng.integers(-32, 32, (V, D)) / 4.0).astype(np.float32)
    ids = rng.integers(0, 3, n).astype(np.int32)  # three ids: long runs
    upd = (rng.integers(-32, 32, (n, D)) / 8.0).astype(np.float32)
    return table, ids, upd


def test_scatter_add_rows_f32_bitwise_dyadic():
    import jax.numpy as jnp

    from glint_word2vec_tpu.ops.pallas_sgns import scatter_add_rows_f32 as jax_fn

    table, ids, upd = _dyadic_rows_case()
    want = np.asarray(jax_fn(jnp.asarray(table), jnp.asarray(ids),
                             jnp.asarray(upd), interpret=True, block_rows=4))
    exp = table.copy()
    np.add.at(exp, ids, upd)
    assert np.array_equal(want, exp)
    t = _t(table.copy())
    before = fs.scatter_add_rows_f32.launches
    out = fs.scatter_add_rows_f32(t, _t(ids), _t(upd))
    assert out is t  # in place
    assert np.array_equal(t.numpy(), want)
    assert fs.scatter_add_rows_f32.launches == before  # CPU: plain version


def test_scatter_add_rank1_hbm_bitwise_dyadic():
    import jax.numpy as jnp

    from glint_word2vec_tpu.ops.pallas_sgns import scatter_add_rank1_hbm as jax_fn

    rng = np.random.default_rng(3)
    B, N = 12, 37
    table = (rng.integers(-16, 16, (V, D)) / 4.0).astype(np.float32)
    ids = rng.integers(0, V, N).astype(np.int32)
    ids[:11] = 7  # a run longer than two JAX blocks
    ids[20:23] = V - 1
    coef = (rng.integers(-8, 8, N) / 8.0).astype(np.float32)
    h = (rng.integers(-16, 16, (B, D)) / 8.0).astype(np.float32)
    hidx = rng.integers(0, B, N).astype(np.int32)
    want = np.asarray(jax_fn(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(coef),
        jnp.asarray(h), jnp.asarray(hidx), interpret=True, block_rows=4,
    ))
    t = _t(table.copy())
    fs.scatter_add_rank1_hbm(t, _t(ids), _t(coef), _t(h), _t(hidx))
    assert np.array_equal(t.numpy(), want)


def test_scatter_bf16_rounds_once_per_run():
    # Row value 256 (bf16 ulp 2.0) plus 8 x 0.5: summed in fp32 and
    # rounded once, 260; rounded per update, every 0.5 would be lost.
    table = torch.zeros((V, D), dtype=torch.bfloat16)
    table[5] = 256.0
    ids = torch.full((8,), 5, dtype=torch.int32)
    fs.scatter_add_rows_f32(table, ids, torch.full((8, D), 0.5))
    assert torch.equal(table[5].float(), torch.full((D,), 260.0))
    table[6] = 256.0
    fs.scatter_add_rank1_hbm(
        table, torch.full((8,), 6, dtype=torch.int32), torch.full((8,), 0.25),
        torch.full((2, D), 2.0), torch.zeros(8, dtype=torch.int32),
    )
    assert torch.equal(table[6].float(), torch.full((D,), 260.0))


def _packed_stream(window, P=32):
    """One real dense pair batch from the JAX package's packed assembly
    (repeated corpus words give duplicate rows; mask-0 tail slots)."""
    import jax
    import jax.numpy as jnp

    from glint_word2vec_tpu.ops.device_batching import pack_window_pairs

    rng = np.random.default_rng(0)
    sents = [rng.integers(0, V, L).astype(np.int32) for L in (5, 1, 9, 3, 12, 2, 6)]
    ids = np.concatenate(sents)
    offsets = np.zeros(len(sents) + 1, np.int64)
    np.cumsum([len(s) for s in sents], out=offsets[1:])
    pc, px, pm, _, _ = pack_window_pairs(
        jnp.asarray(ids), jnp.asarray(offsets, jnp.int32), jnp.int32(0),
        jax.random.PRNGKey(7), jnp.uint32(0), window=window, span=16,
        pair_batch=P, grid_batch=8, n_valid=jnp.int32(len(ids)),
    )
    return np.asarray(pc), np.asarray(px), np.asarray(pm)


def _step_inputs(window, n=3):
    """Tables, a packed pair stream and the JAX package's negative draws
    with their mask."""
    import jax
    import jax.numpy as jnp

    from glint_word2vec_tpu.corpus.alias import build_unigram_alias
    from glint_word2vec_tpu.ops import sgns
    from glint_word2vec_tpu.ops.sampling import sample_negatives_per_row

    pc, px, pm = _packed_stream(window)
    s0, s1 = sgns.init_tables(jax.random.PRNGKey(2), V, D)
    s0 = np.asarray(s0) * 100.0  # off the 1/d init scale
    s1 = np.asarray(s1) + 0.01 * s0
    t = build_unigram_alias(np.arange(V, 0, -1).astype(np.int64))
    negs = np.asarray(sample_negatives_per_row(
        jax.random.PRNGKey(1), jnp.asarray(t.prob), jnp.asarray(t.alias),
        jnp.arange(pc.shape[0], dtype=jnp.int32), (1, n),
    ))[:, 0, :]
    nmask = np.asarray(sgns.negative_mask(
        jnp.asarray(negs)[:, None, :], jnp.asarray(px)[:, None],
        jnp.asarray(pm)[:, None],
    ))[:, 0, :]
    return s0.astype(np.float32), s1.astype(np.float32), pc, px, pm, negs, nmask


def _numpy_pair_oracle(s0, s1, c, x, m, negs, nm, alpha):
    s0h, s1h = s0.astype(np.float64), s1.astype(np.float64)
    h, u, un = s0h[c], s1h[x], s1h[negs]
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    f_pos = (h * u).sum(-1)
    f_neg = (h[:, None, :] * un).sum(-1)
    c_pos = alpha * (1.0 - sig(f_pos)) * m
    c_neg = -alpha * sig(f_neg) * nm
    d_center = c_pos[:, None] * u + (c_neg[..., None] * un).sum(1)
    o0, o1 = s0h.copy(), s1h.copy()
    np.add.at(o0, c, d_center)
    np.add.at(o1, x, c_pos[:, None] * h)
    np.add.at(o1, negs.reshape(-1),
              c_neg.reshape(-1)[:, None] * np.repeat(h, negs.shape[1], axis=0))
    loss = ((-np.log(sig(f_pos)) - (np.log(sig(-f_neg)) * nm).sum(-1)) * m).sum()
    return dict(c_pos=c_pos, c_neg=c_neg, h=h, d_center=d_center, syn0=o0,
                syn1=o1, loss_sum=loss)


TOL = dict(rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("window", [2, 3, 5])
def test_pair_forward_matches_jax_and_oracle(window):
    import jax.numpy as jnp

    from glint_word2vec_tpu.ops.pallas_sgns import pair_forward as jax_fn

    s0, s1, pc, px, pm, negs, nmask = _step_inputs(window)
    jfw = jax_fn(*(jnp.asarray(a) for a in (s0, s1, pc, px, pm, negs, nmask)),
                 jnp.float32(0.05), interpret=True, block_rows=4)
    ora = _numpy_pair_oracle(s0, s1, pc, px, pm, negs, nmask, 0.05)
    pfw = fs.pair_forward(*(_t(a) for a in (s0, s1, pc, px, pm, negs, nmask)),
                          torch.tensor(0.05))
    assert pm.min() == 0.0 < pm.max()  # padded slots present
    for name in ("c_pos", "c_neg", "h", "d_center"):
        got = getattr(pfw, name).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jfw, name)), **TOL,
                                   err_msg=f"jax/{name}")
        np.testing.assert_allclose(got, ora[name], **TOL, err_msg=f"oracle/{name}")
    assert float(pfw.loss_sum) == pytest.approx(float(jfw.loss_sum), rel=1e-5)
    assert float(pfw.loss_sum) == pytest.approx(ora["loss_sum"], rel=1e-5)


@pytest.mark.parametrize("window", [2, 3, 5])
def test_fused_pair_step_matches_jax_and_oracle(window):
    import jax.numpy as jnp

    from glint_word2vec_tpu.ops.pallas_sgns import fused_pair_step as jax_fn

    s0, s1, pc, px, pm, negs, nmask = _step_inputs(window)
    j0, j1, jl = jax_fn(*(jnp.asarray(a) for a in (s0, s1, pc, px, pm, negs, nmask)),
                        jnp.float32(0.05), interpret=True, block_rows=4)
    ora = _numpy_pair_oracle(s0, s1, pc, px, pm, negs, nmask, 0.05)
    t0, t1 = _t(s0.copy()), _t(s1.copy())
    loss = fs.fused_pair_step(
        t0, t1, *(_t(a) for a in (pc, px, pm, negs, nmask)), torch.tensor(0.05)
    )
    for got, j, o, name in ((t0, j0, ora["syn0"], "syn0"),
                            (t1, j1, ora["syn1"], "syn1")):
        np.testing.assert_allclose(got.numpy(), np.asarray(j), **TOL,
                                   err_msg=f"jax/{name}")
        np.testing.assert_allclose(got.numpy(), o, **TOL, err_msg=f"oracle/{name}")
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    # The composed plain step over the same draws: the fused step's
    # reference.
    c0, c1, closs = train_step_pairs(
        _t(s0), _t(s1), _t(pc), _t(px), _t(pm), _t(negs), 0.05
    )
    np.testing.assert_allclose(c0.numpy(), t0.numpy(), **TOL)
    np.testing.assert_allclose(c1.numpy(), t1.numpy(), **TOL)
    assert float(closs) == pytest.approx(float(loss) / pm.sum(), rel=1e-5)
    nm = negative_mask(_t(negs), _t(px), _t(pm))
    assert torch.equal(nm, _t(nmask))


def test_padded_slots_leave_rows_bitwise_unchanged():
    # Mask-0 slots carry zero coefficients: a row touched only by padding
    # (index 0 here, also the padding id) keeps its bits.
    s0, s1, pc, px, pm, negs, nmask = _step_inputs(3)
    pc = np.where(pm > 0, np.maximum(pc, 1), 0).astype(np.int32)
    px = np.where(pm > 0, np.maximum(px, 1), 0).astype(np.int32)
    negs = np.where(pm[:, None] > 0, np.maximum(negs, 1), 0).astype(np.int32)
    nmask = np.asarray(negative_mask(_t(negs), _t(px), _t(pm)))
    t0, t1 = _t(s0.copy()), _t(s1.copy())
    fs.fused_pair_step(t0, t1, *(_t(a) for a in (pc, px, pm, negs, nmask)),
                       torch.tensor(0.05))
    assert np.array_equal(t0.numpy()[0].view(np.uint32), s0[0].view(np.uint32))
    assert np.array_equal(t1.numpy()[0].view(np.uint32), s1[0].view(np.uint32))
    assert not np.array_equal(t0.numpy()[1:], s0[1:])


def test_wrappers_validate_inputs():
    table = torch.zeros((V, D))
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        fs.scatter_add_rows_f32(table, ids.long(), torch.zeros((4, D)))
    with pytest.raises(TypeError, match="float32"):
        fs.scatter_add_rows_f32(table, ids, torch.zeros((4, D), dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        fs.scatter_add_rows_f32(torch.zeros((D, V)).T, ids, torch.zeros((4, V)))
    with pytest.raises(ValueError, match="h must be"):
        fs.scatter_add_rank1_hbm(table, ids, torch.zeros(4), torch.zeros((2, 3)), ids)
    with pytest.raises(ValueError, match="n >= 1"):
        fs.pair_forward(table, table, ids, ids, torch.zeros(4),
                        torch.zeros((4, 0), dtype=torch.int32),
                        torch.zeros((4, 0)), torch.tensor(0.1))
    meta = torch.zeros((V, D), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fs.scatter_add_rows_f32(
            meta, ids.to("meta"), torch.zeros((4, D), device="meta")
        )


# ----------------------------------------------------------------------
# On the card: each kernel against its plain version
# ----------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")


def _random_step(dtype, d, P=333, n=5, Vc=5000, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    syn0 = (0.3 * torch.randn((Vc, d), generator=gen, device="cuda")).to(dtype)
    syn1 = (0.3 * torch.randn((Vc, d), generator=gen, device="cuda")).to(dtype)
    # Zipf-like ids (long runs) with ids 0 and V-1.
    z = torch.rand((P, n + 2), generator=gen, device="cuda")
    ids = ((Vc ** z) - 1).to(torch.int32).clamp(0, Vc - 1)
    ids[0] = Vc - 1
    pc, px, negs = ids[:, 0].contiguous(), ids[:, 1].contiguous(), ids[:, 2:].contiguous()
    pm = (torch.arange(P, device="cuda") < P - 7).to(torch.float32)
    nmask = negative_mask(negs, px, pm)
    return syn0, syn1, pc, px, pm, negs, nmask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [300, 301, 7, 1100])
def test_cuda_scatters_bitwise_equal_plain_on_cpu(dtype, d):
    _cuda_or_skip()
    syn0, syn1, pc, px, pm, negs, nmask = _random_step(getattr(torch, dtype), d)
    P, n = negs.shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    upd = torch.randn((P, d), generator=gen, device="cuda")
    h = torch.randn((P, d), generator=gen, device="cuda")
    ids1 = torch.cat([px, negs.reshape(-1)])
    coef = torch.randn(ids1.shape[0], generator=gen, device="cuda")
    rows = torch.arange(P, dtype=torch.int32, device="cuda")
    hidx = torch.cat([rows, rows.repeat_interleave(n)])
    want0 = fs.scatter_add_rows_f32_reference(syn0.cpu(), pc.cpu(), upd.cpu())
    want1 = fs.scatter_add_rank1_hbm_reference(
        syn1.cpu(), ids1.cpu(), coef.cpu(), h.cpu(), hidx.cpu()
    )
    before = (fs.scatter_add_rows_f32.launches, fs.scatter_add_rank1_hbm.launches)
    fs.scatter_add_rows_f32(syn0, pc, upd)
    fs.scatter_add_rank1_hbm(syn1, ids1, coef, h, hidx)
    torch.cuda.synchronize()
    assert (fs.scatter_add_rows_f32.launches, fs.scatter_add_rank1_hbm.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(syn0.cpu(), want0)
    assert torch.equal(syn1.cpu(), want1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [300, 301, 7])
def test_cuda_pair_forward_matches_plain(dtype, d):
    _cuda_or_skip()
    syn0, syn1, pc, px, pm, negs, nmask = _random_step(getattr(torch, dtype), d)
    alpha = torch.tensor(0.025, device="cuda")
    before = fs.pair_forward.launches
    got = fs.pair_forward(syn0, syn1, pc, px, pm, negs, nmask, alpha)
    torch.cuda.synchronize()
    assert fs.pair_forward.launches == before + 1
    want = fs.pair_forward_reference(
        *(t.cpu() for t in (syn0, syn1, pc, px, pm, negs, nmask, alpha))
    )
    assert torch.equal(got.h.cpu(), want.h)  # a copy: bitwise
    for name in ("c_pos", "c_neg", "d_center"):
        w = getattr(want, name)
        torch.testing.assert_close(
            getattr(got, name).cpu(), w, rtol=1e-5,
            atol=1e-6 * float(w.abs().max()),
        )
    assert float(got.loss_sum) == pytest.approx(float(want.loss_sum), rel=1e-5)
