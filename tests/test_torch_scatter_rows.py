"""The table-dtype scatters of the port (``scatter_add_rows`` and
``scatter_add_rank1`` in glint_word2vec_torch/ops/rows.py) against the
JAX package's Pallas kernels of ``ops/pallas_rows.py`` run in interpret
mode, as ``tests/test_pallas_rows.py`` runs them.

Tolerance: none. The plain versions are bitwise equal to the JAX kernels
in fp32 and bf16: a run starts from the table row and every add rounds to
the table's dtype, in stable sorted order. ``scatter_add_rows`` is
compared on random normal data. ``scatter_add_rank1`` is compared on
dyadic data, where every product and partial sum is exact in fp32,
because XLA on the CPU contracts the JAX kernel's ``coef * h + acc`` into
one fused multiply-add, which the CUDA kernel and the plain version do
not.

The ``cuda`` tests hold each kernel against its plain version on a card.
They import no JAX:

    python -m pytest tests/test_torch_scatter_rows.py -m cuda --noconftest -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_torch.ops import fused_sgns as fs
from glint_word2vec_torch.ops import rows

V, D = 64, 16
DTYPES = ["float32", "bfloat16"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_rows(table, ids, upd, dtype, block_rows=8):
    import jax.numpy as jnp

    from glint_word2vec_tpu.ops.pallas_rows import scatter_add_rows

    out = scatter_add_rows(
        jnp.asarray(table, dtype=getattr(jnp, dtype)), jnp.asarray(ids),
        jnp.asarray(upd), interpret=True, block_rows=block_rows,
    )
    return np.asarray(out.astype(jnp.float32))


def _jax_rank1(table, ids, coef, h, hidx, dtype, block_rows=8):
    import jax.numpy as jnp

    from glint_word2vec_tpu.ops.pallas_rows import scatter_add_rank1

    out = scatter_add_rank1(
        jnp.asarray(table, dtype=getattr(jnp, dtype)), jnp.asarray(ids),
        jnp.asarray(coef), jnp.asarray(h), jnp.asarray(hidx),
        interpret=True, block_rows=block_rows,
    )
    return np.asarray(out.astype(jnp.float32))


def _port_rows(table, ids, upd, dtype):
    t = _t(table).to(getattr(torch, dtype))
    before = rows.scatter_add_rows.launches
    out = rows.scatter_add_rows(t, _t(ids), _t(upd))
    assert out is t  # in place
    assert rows.scatter_add_rows.launches == before  # CPU: plain version
    return t.float().numpy()


def _port_rank1(table, ids, coef, h, hidx, dtype):
    t = _t(table).to(getattr(torch, dtype))
    rows.scatter_add_rank1(t, _t(ids), _t(coef), _t(h), _t(hidx))
    return t.float().numpy()


def _bits_equal(a, b):
    return np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_rows", [4, 8])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 31])
def test_scatter_add_rows_block_boundary_runs_bitwise(dtype, block_rows, n):
    # The cases of tests/test_pallas_rows.py:113: runs of equal ids across
    # the JAX kernel's block boundaries and N not a multiple of its block.
    rng = np.random.default_rng(n * 31 + block_rows)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = np.sort(rng.integers(0, 3, n).astype(np.int32))
    upd = (rng.normal(size=(n, D)) * 30).astype(np.float32)
    want = _jax_rows(table, ids, upd, dtype, block_rows)
    assert _bits_equal(_port_rows(table, ids, upd, dtype), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_scatter_add_rows_row0_duplicates_bitwise(dtype):
    # Row 0 takes many updates (every padded slot of a grid batch targets
    # it) beside unsorted real ids; magnitudes far apart make every bf16
    # add round.
    rng = np.random.default_rng(3)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = np.zeros(45, np.int32)
    ids[10:30] = rng.integers(0, V, 20)
    upd = (rng.normal(size=(45, D))
           * rng.choice([1e-3, 1.0, 100.0], size=(45, 1))).astype(np.float32)
    want = _jax_rows(table, ids, upd, dtype)
    assert _bits_equal(_port_rows(table, ids, upd, dtype), want)


def _long_run_case(seed, run, d, others=40, distinct=V):
    """``run`` updates to id 3 among ``others`` random ids, shuffled, with
    update rows of magnitudes 1e-3, 1 and 100 (every bf16 add rounds)."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full(run, 3), rng.integers(0, distinct, others)])
    ids = rng.permutation(ids).astype(np.int32)
    upd = (rng.normal(size=(ids.size, d))
           * rng.choice([1e-3, 1.0, 100.0], size=(ids.size, 1))).astype(np.float32)
    table = rng.normal(size=(distinct, d)).astype(np.float32)
    return table, ids, upd


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("run", [33, 257])
def test_scatter_add_rows_long_runs_bitwise(dtype, run):
    # Runs past the CUDA kernel's long-run threshold (32), across the JAX
    # kernel's blocks of 8: the order and the rounding (one per add, in
    # stable sorted order) that the long-run path must reproduce.
    table, ids, upd = _long_run_case(run, run, D)
    want = _jax_rows(table, ids, upd, dtype, block_rows=8)
    assert _bits_equal(_port_rows(table, ids, upd, dtype), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_scatter_add_rows_single_id_whole_batch_bitwise(dtype):
    rng = np.random.default_rng(9)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = np.full(29, 5, np.int32)
    upd = rng.normal(size=(29, D)).astype(np.float32)
    want = _jax_rows(table, ids, upd, dtype)
    assert _bits_equal(_port_rows(table, ids, upd, dtype), want)


def _dyadic_rank1_case(seed, N, B=12, distinct=V):
    rng = np.random.default_rng(seed)
    table = (rng.integers(-64, 64, (V, D)) / 4.0).astype(np.float32)
    ids = rng.integers(0, distinct, N).astype(np.int32)
    coef = (rng.integers(-16, 16, N) / 8.0).astype(np.float32)
    h = (rng.integers(-128, 128, (B, D)) / 4.0).astype(np.float32)
    hidx = rng.integers(0, B, N).astype(np.int32)
    return table, ids, coef, h, hidx


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_rows", [4, 8])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 31])
def test_scatter_add_rank1_block_boundary_runs_bitwise(dtype, block_rows, n):
    table, ids, coef, h, hidx = _dyadic_rank1_case(n * 7 + block_rows, n,
                                                    distinct=3)
    want = _jax_rank1(table, ids, coef, h, hidx, dtype, block_rows)
    assert _bits_equal(_port_rank1(table, ids, coef, h, hidx, dtype), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_scatter_add_rank1_row0_and_single_id_bitwise(dtype):
    table, ids, coef, h, hidx = _dyadic_rank1_case(5, 64)
    ids[:40] = 0  # row 0 with zero coefficients, as padded slots have
    coef[:25] = 0.0
    want = _jax_rank1(table, ids, coef, h, hidx, dtype)
    assert _bits_equal(_port_rank1(table, ids, coef, h, hidx, dtype), want)
    ids[:] = 11  # one id for the whole batch
    want = _jax_rank1(table, ids, coef, h, hidx, dtype)
    assert _bits_equal(_port_rank1(table, ids, coef, h, hidx, dtype), want)


def _dyadic_rank1_long_run(seed, run, d, others=40, distinct=V, B=12):
    """``run`` updates to id 3 among ``others`` random ids, shuffled, on
    dyadic data (every product and fp32 partial sum exact) whose products
    span 1/32 to 512, so that under bf16 every add rounds."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full(run, 3), rng.integers(0, distinct, others)])
    ids = rng.permutation(ids).astype(np.int32)
    table = (rng.integers(-64, 64, (distinct, d)) / 4.0).astype(np.float32)
    coef = (rng.integers(-16, 16, ids.size) / 8.0).astype(np.float32)
    h = (rng.integers(-128, 128, (B, d)) / 4.0).astype(np.float32)
    hidx = rng.integers(0, B, ids.size).astype(np.int32)
    return table, ids, coef, h, hidx


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("run", [33, 257])
def test_scatter_add_rank1_long_runs_bitwise(dtype, run):
    # Runs past the CUDA kernel's long-run threshold (32), across the JAX
    # kernel's blocks of 8: the order and the rounding (one per add, in
    # stable sorted order) that the long-run path must reproduce.
    table, ids, coef, h, hidx = _dyadic_rank1_long_run(run, run, D)
    want = _jax_rank1(table, ids, coef, h, hidx, dtype, block_rows=8)
    assert _bits_equal(_port_rank1(table, ids, coef, h, hidx, dtype), want)


def _signed_zero_case(seed, d, B=12, distinct=V):
    """Rows 0, 5 and 9 at -0.0 take a run of 40 (every third coefficient
    0, the others positive), a run of 7 and a run of 1 (coefficients 0),
    beside 16 updates to other rows, shuffled. Every product is -0.0 in
    columns 0-3 of ``h``; in columns 4-7 the zero coefficients' products
    are +0.0 (even h rows) and the others' -0.0 (odd rows); the rest of
    ``h`` is negative. Adding every update, as the JAX kernel does, gives
    -0.0 in columns 0-3 and +0.0 in 4-7 of those rows; skipping the zero
    coefficients would leave -0.0 in 4-7. Dyadic values: every product
    and fp32 sum is exact."""
    rng = np.random.default_rng(seed)
    table = (rng.integers(-64, 64, (distinct, d)) / 4.0).astype(np.float32)
    table[[0, 5, 9]] = -0.0
    h = (-rng.integers(1, 128, (B, d)) / 4.0).astype(np.float32)
    h[:, :4] = -0.0
    h[0::2, 4:8] = 0.0
    h[1::2, 4:8] = -0.0
    ids = np.concatenate([np.zeros(40), np.full(7, 5), [9],
                          rng.integers(10, distinct, 16)]).astype(np.int32)
    zero = np.zeros(ids.size, bool)
    zero[:40:3] = True
    zero[40:48] = True
    coef = np.where(zero, 0.0, rng.integers(1, 16, ids.size) / 8.0).astype(np.float32)
    pick = rng.integers(0, B // 2, ids.size)
    hidx = np.where(zero, 2 * pick, 2 * pick + 1).astype(np.int32)
    perm = rng.permutation(ids.size)
    return table, ids[perm], coef[perm], h, hidx[perm]


def _check_signed_zero_rows(out):
    rows = out[[0, 5, 9]]
    assert np.all(np.signbit(rows[:, :4])) and np.all(rows[:, :4] == 0)
    assert not np.any(np.signbit(rows[:, 4:8])) and np.all(rows[:, 4:8] == 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_scatter_add_rank1_zero_coefficients_keep_signed_zeros(dtype):
    # Most of row 0's run is padding with coefficient 0; the kernels must
    # add those updates, not skip them: -0.0 + (+0.0) is +0.0. One JAX
    # block (block_rows = N), so no padded update joins the last run.
    table, ids, coef, h, hidx = _signed_zero_case(12, D)
    want = _jax_rank1(table, ids, coef, h, hidx, dtype, block_rows=ids.size)
    got = _port_rank1(table, ids, coef, h, hidx, dtype)
    assert _bits_equal(got, want)
    _check_signed_zero_rows(got)


def test_bf16_table_dtype_runs_round_every_add():
    # Row value 256 (bf16 ulp 2.0) plus 8 x 0.5: rounded after every add
    # each 0.5 is lost (256), where the fused step's scatters, which sum
    # the run in fp32 and round once, give 260.
    table = torch.zeros((V, D), dtype=torch.bfloat16)
    table[5] = 256.0
    ids = torch.full((8,), 5, dtype=torch.int32)
    half = torch.full((8, D), 0.5)
    rows.scatter_add_rows(table, ids, half)
    assert torch.equal(table[5].float(), torch.full((D,), 256.0))
    rows.scatter_add_rank1(table, ids, torch.full((8,), 0.25),
                           torch.full((2, D), 2.0), torch.zeros(8, dtype=torch.int32))
    assert torch.equal(table[5].float(), torch.full((D,), 256.0))
    fs.scatter_add_rows_f32(table, ids, half)
    assert torch.equal(table[5].float(), torch.full((D,), 260.0))


def _bf16_round_f32(x):
    """fp32 -> bf16 bits as fp32, round to nearest even (finite x)."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _bf16_round_exact(x):
    """A float64 value rounded once to bf16 (8 significant bits, nearest
    even; subnormals keep bf16's 2^-133 spacing)."""
    _, e = np.frexp(x)
    step = np.maximum(e - 8, -133)
    return np.ldexp(np.round(np.ldexp(x, -step)), step).astype(np.float32)


def test_bf16_add_rounded_through_fp32_equals_rounded_once():
    # The long-run path of scatter_add_rows (B3) adds a bf16 update to a
    # bf16 sum with one fma.rn.bf16: the exact sum rounded once to bf16.
    # The plain version adds in fp32, then rounds to bf16. The two agree
    # because fp32 keeps 24 bits, more than 2 x 8 + 1 of bf16's: every
    # finite bf16 value against 64 others, subnormals included.
    rng = np.random.default_rng(6)
    every = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    finite = every[np.isfinite(every)]
    a = np.repeat(finite, 64)
    b = rng.choice(finite, a.size)
    exact = a.astype(np.float64) + b.astype(np.float64)  # exact for |exp diff| < 45
    keep = np.abs(exact) < 3.3e38  # no overflow to infinity
    with np.errstate(over="ignore"):
        twice = _bf16_round_f32(a[keep] + b[keep])
    once = _bf16_round_exact(exact[keep])
    assert keep.sum() > 4_000_000
    assert np.array_equal(twice.view(np.uint32), once.view(np.uint32))


def test_fp32_scatters_equal_the_fused_ones():
    # For fp32 tables both contracts are ((row + u0) + u1) + ... in sorted
    # order: the table-dtype scatters equal the fused step's, bitwise.
    rng = np.random.default_rng(4)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, 5, 50).astype(np.int32)
    upd = rng.normal(size=(50, D)).astype(np.float32)
    coef = rng.normal(size=50).astype(np.float32)
    h = rng.normal(size=(6, D)).astype(np.float32)
    hidx = rng.integers(0, 6, 50).astype(np.int32)
    a, b = _t(table.copy()), _t(table.copy())
    rows.scatter_add_rows(a, _t(ids), _t(upd))
    fs.scatter_add_rows_f32(b, _t(ids), _t(upd))
    assert torch.equal(a, b)
    rows.scatter_add_rank1(a, _t(ids), _t(coef), _t(h), _t(hidx))
    fs.scatter_add_rank1_hbm(b, _t(ids), _t(coef), _t(h), _t(hidx))
    assert torch.equal(a, b)


def test_fp32_plain_version_adds_in_order_at_large_n():
    # Past 32768 elements PyTorch's CPU index_put_(accumulate=True) turns
    # to parallel float atomics for fp32; the plain version must still add
    # serially in input order, as np.add.at does.
    rng = np.random.default_rng(8)
    N, d = 20_000, 4
    table = rng.normal(size=(V, d)).astype(np.float32)
    ids = rng.integers(0, 3, N).astype(np.int32)
    upd = (rng.normal(size=(N, d)) * rng.choice([1e-4, 1e4], (N, 1))).astype(np.float32)
    want = table.copy()
    np.add.at(want, ids, upd)
    got = _t(table.copy())
    rows.scatter_add_rows(got, _t(ids), _t(upd))
    assert _bits_equal(got.numpy(), want)


def test_wrappers_validate_inputs():
    table = torch.zeros((V, D))
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        rows.scatter_add_rows(table, ids.long(), torch.zeros((4, D)))
    with pytest.raises(TypeError, match="upd must be"):
        rows.scatter_add_rows(table, ids, torch.zeros((4, D), dtype=torch.float64))
    with pytest.raises(TypeError, match="upd"):
        rows.scatter_add_rows(table, ids, torch.zeros((5, D)))
    with pytest.raises(ValueError, match="contiguous"):
        rows.scatter_add_rows(torch.zeros((D, V)).T, ids, torch.zeros((4, V)))
    with pytest.raises(ValueError, match="h must be"):
        rows.scatter_add_rank1(table, ids, torch.zeros(4), torch.zeros((2, 3)), ids)
    meta = torch.zeros((V, D), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rows.scatter_add_rows(meta, ids.to("meta"), torch.zeros((4, D), device="meta"))


# ----------------------------------------------------------------------
# On the card: each kernel against its plain version
# ----------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")


def _zipf_step(d, B=300, C=7, n=5, Vc=5000, seed=0):
    """A grid step's update ids on the card: contexts and negatives with
    Zipf-like ids (long runs, ids 0 and V-1), 40% of the context slots
    padded to row 0 with zero coefficients, as the composed step sends
    them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.rand((B, C, 1 + n), generator=gen, device="cuda")
    ids = ((Vc ** z) - 1).to(torch.int32).clamp(0, Vc - 1)
    ids[0, 0, 0] = Vc - 1
    mask = (torch.rand((B, C), generator=gen, device="cuda") < 0.6).float()
    ids[..., 0] = torch.where(mask > 0, ids[..., 0], 0)
    ids1 = torch.cat([ids[..., 0].reshape(-1), ids[..., 1:].reshape(-1)])
    coef = torch.randn(ids1.shape[0], generator=gen, device="cuda")
    coef[: B * C] *= mask.reshape(-1)
    h = torch.randn((B, d), generator=gen, device="cuda")
    r = torch.arange(B, dtype=torch.int32, device="cuda")
    hidx = torch.cat([r.repeat_interleave(C), r.repeat_interleave(C * n)])
    table = (0.3 * torch.randn((Vc, d), generator=gen, device="cuda"))
    return table, ids1, coef, h, hidx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [300, 301, 7, 700, 1100])
def test_cuda_scatter_add_rank1_bitwise_equals_plain(dtype, d):
    _cuda_or_skip()
    table, ids1, coef, h, hidx = _zipf_step(d)
    table = table.to(getattr(torch, dtype))
    want = rows.scatter_add_rank1_reference(
        table.cpu(), ids1.cpu(), coef.cpu(), h.cpu(), hidx.cpu()
    )
    before = rows.scatter_add_rank1.launches
    rows.scatter_add_rank1(table, ids1, coef, h, hidx)
    torch.cuda.synchronize()
    assert rows.scatter_add_rank1.launches == before + 1
    assert torch.equal(table.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [300, 301, 7, 700, 1100, 1, 31, 32, 33])
def test_cuda_scatter_add_rows_bitwise_equals_plain(dtype, d):
    _cuda_or_skip()
    table, ids1, coef, h, hidx = _zipf_step(d, seed=1)
    table = table.to(getattr(torch, dtype))
    gen = torch.Generator(device="cuda").manual_seed(2)
    upd = torch.randn((ids1.shape[0], d), generator=gen, device="cuda")
    upd[:500] = 0.0  # exact zeros, as the fp32 pre-sum leaves in a run
    want = rows.scatter_add_rows_reference(table.cpu(), ids1.cpu(), upd.cpu())
    before = rows.scatter_add_rows.launches
    rows.scatter_add_rows(table, ids1, upd)
    torch.cuda.synchronize()
    assert rows.scatter_add_rows.launches == before + 1
    assert torch.equal(table.cpu(), want)
    # Update rows already in the table's dtype take the same path.
    want = rows.scatter_add_rows_reference(
        table.cpu(), ids1.cpu(), upd.cpu().to(table.dtype)
    )
    rows.scatter_add_rows(table, ids1, upd.to(table.dtype))
    torch.cuda.synchronize()
    assert torch.equal(table.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 7, 31, 32, 33, 300, 301])
@pytest.mark.parametrize("run", [31, 32, 33, 257, 9262, 32768])
def test_cuda_scatter_add_rows_run_lengths_bitwise(dtype, d, run):
    # Each side of the long-run threshold (32), a run of 257, row 0's run
    # at fastText width (9,262), and a batch of 32,768 updates to one id;
    # update rows of mixed magnitude, then the same payload 4 bytes off
    # 16-byte alignment (the long-run path's 4-byte copies).
    _cuda_or_skip()
    if run == 32768:
        rng = np.random.default_rng(d)
        table = rng.normal(size=(V, d)).astype(np.float32)
        ids = np.full(run, 3, np.int32)
        upd = (rng.normal(size=(run, d))
               * rng.choice([1e-3, 1.0, 100.0], size=(run, 1))).astype(np.float32)
    else:
        table, ids, upd = _long_run_case(run * 7 + d, run, d, others=300,
                                         distinct=4096)
    t = torch.from_numpy(table).to(getattr(torch, dtype)).cuda()
    ids_c = torch.from_numpy(ids).cuda()
    flat = torch.empty(upd.size + 1, device="cuda")
    for upd_c in (torch.from_numpy(upd).cuda(), flat[1:].view(upd.shape)):
        upd_c.copy_(torch.from_numpy(upd))
        want = rows.scatter_add_rows_reference(t.cpu(), ids_c.cpu(), upd_c.cpu())
        before = rows.scatter_add_rows.launches
        rows.scatter_add_rows(t, ids_c, upd_c)
        torch.cuda.synchronize()
        assert rows.scatter_add_rows.launches == before + 1
        assert torch.equal(t.cpu(), want)


def _equal_bits(a, b):
    """Equal bits, so -0.0 differs from +0.0 (``torch.equal`` compares
    values)."""
    as_int = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(as_int), b.view(as_int))


def _cuda_rank1_twice(t, ids, coef, h, hidx):
    """The kernel on ``t`` against the plain version, then a second call
    from the same table against the first, bit for bit."""
    start = t.clone()
    want = rows.scatter_add_rank1_reference(
        t.cpu(), ids.cpu(), coef.cpu(), h.cpu(), hidx.cpu())
    before = rows.scatter_add_rank1.launches
    rows.scatter_add_rank1(t, ids, coef, h, hidx)
    torch.cuda.synchronize()
    assert rows.scatter_add_rank1.launches == before + 1
    first = t.cpu()
    assert _equal_bits(first, want)
    t.copy_(start)
    rows.scatter_add_rank1(t, ids, coef, h, hidx)
    torch.cuda.synchronize()
    assert _equal_bits(t.cpu(), first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 7, 31, 32, 33, 300, 301])
@pytest.mark.parametrize("run", [31, 32, 33, 257, 4616, 43008])
def test_cuda_scatter_add_rank1_run_lengths_bitwise(dtype, d, run):
    # Each side of the long-run threshold (32), a run of 257, row 0's run
    # at fastText width (4,616), and a batch of 43,008 updates to one id;
    # coefficients of mixed magnitude with zeros among them, then the same
    # h 4 bytes off 16-byte alignment (the long-run path's 4-byte copies).
    _cuda_or_skip()
    rng = np.random.default_rng(run * 7 + d)
    if run == 43008:
        ids = np.full(run, 3, np.int32)
        distinct = V
    else:
        distinct = 4096
        ids = np.concatenate([np.full(run, 3), rng.integers(0, distinct, 300)])
        ids = rng.permutation(ids).astype(np.int32)
    table = rng.normal(size=(distinct, d)).astype(np.float32)
    coef = (rng.normal(size=ids.size)
            * rng.choice([0.0, 1e-3, 1.0, 100.0], size=ids.size)).astype(np.float32)
    B = 64
    h = rng.normal(size=(B, d)).astype(np.float32)
    hidx = rng.integers(0, B, ids.size).astype(np.int32)
    t = torch.from_numpy(table).to(getattr(torch, dtype)).cuda()
    ids_c, coef_c, hidx_c = (torch.from_numpy(a).cuda() for a in (ids, coef, hidx))
    flat = torch.empty(h.size + 1, device="cuda")
    for h_c in (torch.from_numpy(h).cuda(), flat[1:].view(h.shape)):
        h_c.copy_(torch.from_numpy(h))
        _cuda_rank1_twice(t, ids_c, coef_c, h_c, hidx_c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [16, 300])
def test_cuda_scatter_add_rank1_zero_coefficients_keep_signed_zeros(dtype, d):
    _cuda_or_skip()
    table, ids, coef, h, hidx = _signed_zero_case(12, d)
    t = torch.from_numpy(table).to(getattr(torch, dtype)).cuda()
    _cuda_rank1_twice(t, *(torch.from_numpy(a).cuda() for a in (ids, coef, h, hidx)))
    _check_signed_zero_rows(t.float().cpu().numpy())
