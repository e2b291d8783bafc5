"""The fused step's per-pair kernels, ``pair_forward`` (B4) and
``scatter_add_rank1_hbm`` (B7) of glint_word2vec_torch/ops/fused_sgns.py:
their plain versions against the JAX package's Pallas kernels run in
interpret mode, and their CUDA kernels against their plain versions on a
card.

Tolerances: ``pair_forward`` within rtol 2e-5 and atol 1e-6 of the JAX
kernel on the CPU (fp32 dot products summed in another order), its loss
within rel 1e-5; on the card ``h`` bitwise (an exact upcast), ``c_pos``,
``c_neg`` and ``d_center`` within rtol 1e-5 and atol 1e-6 x max, the loss
within rel 1e-5, and two calls bitwise equal; its one-pass and tiled
forms bitwise equal where both run. ``scatter_add_rank1_hbm``
has none: each run is summed in fp32 in stable sorted order onto the fp32
value of the table row and rounded to the table's dtype once. The CPU
cases use dyadic values, whose products and fp32 sums are exact, and give
the JAX kernel one block (``block_rows = N``) under bf16, where it rounds
once per run per block.

The ``cuda`` tests import no JAX:

    python -m pytest tests/test_torch_pair_kernels.py -m cuda --noconftest -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_torch.ops import fused_sgns as fs

V, D = 64, 16
DTYPES = ["float32", "bfloat16"]


def _dyadic_rank1_case(seed, run, others, d=D, B=12):
    """``run`` updates to id 3 among ``others`` random ids, shuffled (a
    negative ``others``: the whole batch is id 3), on dyadic data whose
    products (multiples of 1/32 up to 32 in size) and fp32 sums are
    exact."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full(run, 3), rng.integers(0, V, max(others, 0))])
    ids = rng.permutation(ids).astype(np.int32)
    table = (rng.integers(-64, 64, (V, d)) / 4.0).astype(np.float32)
    coef = (rng.integers(-16, 17, ids.size) / 8.0).astype(np.float32)
    h = (rng.integers(-64, 65, (B, d)) / 4.0).astype(np.float32)
    hidx = rng.integers(0, B, ids.size).astype(np.int32)
    return table, ids, coef, h, hidx


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("run,others", [(33, 40), (257, 40), (96, -1)])
def test_cpu_rank1_hbm_long_runs_bitwise_equal_jax(dtype, run, others):
    # Runs past the CUDA kernel's long-run threshold (32) and a batch of
    # one id: the plain version against the TPU kernel in interpret mode.
    import jax.numpy as jnp

    from glint_word2vec_tpu.ops.pallas_sgns import scatter_add_rank1_hbm as jax_fn

    table, ids, coef, h, hidx = _dyadic_rank1_case(run, run, others)
    block_rows = 8 if dtype == "float32" else ids.size
    want = np.asarray(jax_fn(
        jnp.asarray(table, dtype=getattr(jnp, dtype)), jnp.asarray(ids),
        jnp.asarray(coef), jnp.asarray(h), jnp.asarray(hidx), interpret=True,
        block_rows=block_rows,
    ).astype(jnp.float32))
    t = torch.from_numpy(table).to(getattr(torch, dtype))
    before = fs.scatter_add_rank1_hbm.launches
    out = fs.scatter_add_rank1_hbm(t, *(torch.from_numpy(a) for a in (ids, coef, h, hidx)))
    assert out is t  # in place
    assert fs.scatter_add_rank1_hbm.launches == before  # CPU: plain version
    got = t.float().numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _pair_case(seed, n, P=24, d=D, scale=0.3):
    """Tables near the training scale (entries ``scale`` times normal
    draws), ``P`` pairs with the last 3 padded, ``n`` negatives each (some
    equal to the pair's context, masked out)."""
    rng = np.random.default_rng(seed)
    syn0 = (scale * rng.normal(size=(V, d))).astype(np.float32)
    syn1 = (scale * rng.normal(size=(V, d))).astype(np.float32)
    centers = rng.integers(0, V, P).astype(np.int32)
    contexts = rng.integers(0, V, P).astype(np.int32)
    negs = rng.integers(0, V, (P, n)).astype(np.int32)
    negs[::5, 0] = contexts[::5]
    mask = (np.arange(P) < P - 3).astype(np.float32)
    nmask = ((negs != contexts[:, None]) * mask[:, None]).astype(np.float32)
    return syn0, syn1, centers, contexts, mask, negs, nmask


def _cpu_pair_forward_against_jax(dtype, n, **case):
    import jax.numpy as jnp

    from glint_word2vec_tpu.ops.pallas_sgns import pair_forward as jax_fn

    syn0, syn1, *rest = _pair_case(n, n, **case)
    jdt = getattr(jnp, dtype)
    jfw = jax_fn(jnp.asarray(syn0, dtype=jdt), jnp.asarray(syn1, dtype=jdt),
                 *(jnp.asarray(a) for a in rest), jnp.float32(0.05),
                 interpret=True, block_rows=4)
    tdt = getattr(torch, dtype)
    before = fs.pair_forward.launches
    pfw = fs.pair_forward(torch.from_numpy(syn0).to(tdt),
                          torch.from_numpy(syn1).to(tdt),
                          *(torch.from_numpy(a) for a in rest), torch.tensor(0.05))
    assert fs.pair_forward.launches == before  # CPU: plain version
    for name in ("c_pos", "c_neg", "h", "d_center"):
        np.testing.assert_allclose(getattr(pfw, name).numpy(),
                                   np.asarray(getattr(jfw, name)),
                                   rtol=2e-5, atol=1e-6, err_msg=name)
    assert float(pfw.loss_sum) == pytest.approx(float(jfw.loss_sum), rel=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 15])
def test_cpu_pair_forward_matches_jax(dtype, n):
    # One negative, and more than one pass of the kernel's chunk of 8.
    _cpu_pair_forward_against_jax(dtype, n)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_pair_forward_wide_matches_jax(dtype):
    # d = 2,200, n = 25, P = 16: past the one-pass form's shared memory in
    # fp32 (the card takes the tiled form there); entries at 1/sqrt(d).
    _cpu_pair_forward_against_jax(dtype, 25, P=16, d=2_200, scale=2_200 ** -0.5)


# ----------------------------------------------------------------------
# On the card: each kernel against its plain version
# ----------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")


def _random_pairs(dtype, d, n, P=333, Vc=5000, seed=0, tables=None,
                  scale=0.3):
    """Tables on the card (or ``tables``), entries ``scale`` times normal
    draws, and ``P`` pairs of Zipf-like ids (repeats) with ids 0 and V-1,
    the last 7 pairs padded."""
    from glint_word2vec_torch.ops.sgns import negative_mask

    gen = torch.Generator(device="cuda").manual_seed(seed)
    if tables is None:
        tables = tuple((scale * torch.randn((Vc, d), generator=gen, device="cuda"))
                       .to(dtype) for _ in range(2))
    Vc = tables[0].shape[0]
    z = torch.rand((P, n + 2), generator=gen, device="cuda")
    ids = ((Vc ** z) - 1).to(torch.int32).clamp(0, Vc - 1)
    ids[0] = Vc - 1
    ids[1, 2:] = 0
    pc, px, negs = (ids[:, 0].contiguous(), ids[:, 1].contiguous(),
                    ids[:, 2:].contiguous())
    pm = (torch.arange(P, device="cuda") < P - 7).to(torch.float32)
    return (*tables, pc, px, pm, negs, negative_mask(negs, px, pm),
            torch.tensor(0.025, device="cuda"))


def _check_pair_forward(args, fn=fs.pair_forward):
    """The kernel (``fn``: ``pair_forward`` or ``pair_forward_tiled``)
    against the plain version on the CPU, one launch a call, and a second
    call bitwise equal to the first. Returns the first call's result."""
    before = fn.launches
    got = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    want = fs.pair_forward_reference(*(t.cpu() for t in args))
    assert torch.equal(got.h.cpu(), want.h)  # an upcast: bitwise
    for name in ("c_pos", "c_neg", "d_center"):
        w = getattr(want, name)
        torch.testing.assert_close(getattr(got, name).cpu(), w, rtol=1e-5,
                                   atol=1e-6 * float(w.abs().max()))
    assert float(got.loss_sum) == pytest.approx(float(want.loss_sum), rel=1e-5)
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    return got


def _bitwise_equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 7, 300, 301, 1100])
@pytest.mark.parametrize("n", [1, 5, 15])
def test_cuda_pair_forward_matches_plain(dtype, d, n):
    _cuda_or_skip()
    _check_pair_forward(_random_pairs(getattr(torch, dtype), d, n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [302, 304])
def test_cuda_pair_forward_copy_widths(dtype, d):
    # Rows of 1,208 and 1,216 bytes (fp32: 8- and 16-byte copies) and of
    # 604 and 608 bytes (bf16: 4- and 16-byte copies).
    _cuda_or_skip()
    _check_pair_forward(_random_pairs(getattr(torch, dtype), d, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [8, 300])
def test_cuda_pair_forward_tables_4_bytes_off(dtype, d):
    # Tables that are views of a flat buffer 4 bytes past its start: no
    # 16- or 8-byte copy is allowed, so the kernel takes 4-byte copies.
    _cuda_or_skip()
    tdt = getattr(torch, dtype)
    Vc, off = 3000, 4 // torch.tensor([], dtype=tdt).element_size()
    gen = torch.Generator(device="cuda").manual_seed(d)
    tables = []
    for _ in range(2):
        flat = torch.empty(Vc * d + off, dtype=tdt, device="cuda")
        t = flat[off:].view(Vc, d)
        t.copy_(0.3 * torch.randn((Vc, d), generator=gen, device="cuda"))
        assert t.data_ptr() % 8 == 4
        tables.append(t)
    _check_pair_forward(_random_pairs(tdt, d, 5, tables=tuple(tables)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_pair_forward_ragged_last_block(dtype):
    # P one past a multiple of the pairs a block takes: the last block
    # holds one live pair.
    _cuda_or_skip()
    tdt = getattr(torch, dtype)
    probe = _random_pairs(tdt, 300, 5, P=16)
    per_block = fs.pair_forward_grid(16, 5, probe[0], probe[1])["pairs_per_block"]
    P = 40 * per_block + 1
    args = _random_pairs(tdt, 300, 5, P=P, tables=probe[:2])
    assert fs.pair_forward_grid(P, 5, args[0], args[1])["blocks"] == 41
    _check_pair_forward(args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,n", [(20_000, 5), (2_200, 25)])
def test_cuda_pair_forward_rows_past_shared_memory_raise(dtype, d, n):
    # Rows past a block's 227 KB of shared memory in fp32 (7 rows of
    # 20,000 values: 560 KB; 27 rows of 2,200: 238 KB) no longer raise:
    # the wrapper takes the tiled form. bf16 rows of 2,200 fit (119 KB),
    # so there the wrapper keeps the one-pass form and the two forms are
    # held bitwise against each other. Entries at about 1/sqrt(d) keep the
    # logits O(1), as training tables keep them.
    _cuda_or_skip()
    tdt = getattr(torch, dtype)
    args = _random_pairs(tdt, d, n, P=64, Vc=300, scale=d ** -0.5)
    fits = (2 + n) * d * tdt.itemsize < 227 * 1024
    assert fs.pair_forward_grid(64, n, args[0], args[1])["tiled"] == (not fits)
    tiled_before = fs.pair_forward.tiled_launches
    auto = _check_pair_forward(args)
    assert fs.pair_forward.tiled_launches == tiled_before + (0 if fits else 2)
    tiled = _check_pair_forward(args, fs.pair_forward_tiled)
    _bitwise_equal(auto, tiled)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 7, 300, 301, 1100])
@pytest.mark.parametrize("n", [1, 5, 15])
def test_cuda_pair_forward_tiled_equals_one_pass_bitwise(dtype, d, n):
    # Where both forms run, the same lane-to-column order gives the same
    # bits; the tiled form alone against the plain version too.
    _cuda_or_skip()
    args = _random_pairs(getattr(torch, dtype), d, n)
    assert not fs.pair_forward_grid(333, n, args[0], args[1])["tiled"]
    assert fs.pair_forward_grid(333, n, args[0], args[1], tiled=True)["tiled"]
    _bitwise_equal(fs.pair_forward(*args),
                   _check_pair_forward(args, fs.pair_forward_tiled))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_pair_forward_tiled_tables_4_bytes_off(dtype):
    # The tiled form's narrow loads: tables 4 bytes off 16-byte alignment
    # (fp32 one value a load; bf16 pairs of values), and bf16 rows of an
    # odd width (2-byte aligned).
    _cuda_or_skip()
    tdt = getattr(torch, dtype)
    for d in (300, 301):
        Vc, off = 3000, 4 // tdt.itemsize
        gen = torch.Generator(device="cuda").manual_seed(d)
        tables = []
        for _ in range(2):
            flat = torch.empty(Vc * d + off, dtype=tdt, device="cuda")
            t = flat[off:].view(Vc, d)
            t.copy_(0.3 * torch.randn((Vc, d), generator=gen, device="cuda"))
            tables.append(t)
        args = _random_pairs(tdt, d, 5, tables=tuple(tables))
        _bitwise_equal(fs.pair_forward(*args),
                       _check_pair_forward(args, fs.pair_forward_tiled))


def _check_rank1_hbm(table, ids, coef, h, hidx):
    """The kernel against the plain version on the CPU, bit for bit (signed
    zeros too), one launch a call, and a second call from the same table
    bitwise equal to the first."""
    bits = torch.int32 if table.dtype == torch.float32 else torch.int16
    before_rows = table.clone()
    want = fs.scatter_add_rank1_hbm_reference(
        table.cpu(), ids.cpu(), coef.cpu(), h.cpu(), hidx.cpu())
    launches = fs.scatter_add_rank1_hbm.launches
    fs.scatter_add_rank1_hbm(table, ids, coef, h, hidx)
    torch.cuda.synchronize()
    assert fs.scatter_add_rank1_hbm.launches == launches + 1
    first = table.cpu()
    assert torch.equal(first.view(bits), want.view(bits))
    table.copy_(before_rows)
    fs.scatter_add_rank1_hbm(table, ids, coef, h, hidx)
    torch.cuda.synchronize()
    assert torch.equal(table.cpu().view(bits), first.view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 7, 31, 32, 33, 300, 301])
@pytest.mark.parametrize("run", [31, 32, 33, 257, 1500, "whole"])
def test_cuda_rank1_hbm_run_lengths_bitwise(dtype, d, run):
    # Each side of the long-run threshold (32), runs of 257 and 1,500, and
    # a batch of 19,662 updates (phase 5's N) to one id; coefficients of
    # mixed magnitude with zeros among them, then the same h 4 bytes off
    # 16-byte alignment (the long-run blocks' 4-byte copies).
    _cuda_or_skip()
    rng = np.random.default_rng((run if run != "whole" else 7) * 7 + d)
    if run == "whole":
        ids = np.full(19_662, 3, np.int32)
    else:
        ids = np.concatenate([np.full(run, 3), rng.integers(0, 4096, 300)])
        ids = rng.permutation(ids).astype(np.int32)
    table = rng.normal(size=(4096, d)).astype(np.float32)
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
        _check_rank1_hbm(t, ids_c, coef_c, h_c, hidx_c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [16, 300])
def test_cuda_rank1_hbm_zero_coefficients_keep_signed_zeros(dtype, d):
    # Rows 0, 5 and 9 at -0.0 take a run of 40 (every third coefficient
    # 0), a run of 7 and a run of 1 (coefficients 0). Every product is
    # -0.0 in columns 0-3; in columns 4-7 the zero coefficients' products
    # are +0.0 and the others' -0.0. Adding every update gives -0.0 in
    # columns 0-3 and +0.0 in 4-7; skipping the zero coefficients would
    # leave -0.0 in 4-7.
    _cuda_or_skip()
    rng = np.random.default_rng(d)
    table = rng.normal(size=(V, d)).astype(np.float32)
    table[[0, 5, 9]] = -0.0
    B = 12
    h = -rng.uniform(0.5, 1.5, size=(B, d)).astype(np.float32)
    h[:, :4] = -0.0
    h[0::2, 4:8] = 0.0
    h[1::2, 4:8] = -0.0
    ids = np.concatenate([np.zeros(40), np.full(7, 5), [9],
                          rng.integers(10, V, 16)]).astype(np.int32)
    zero = np.zeros(ids.size, bool)
    zero[:40:3] = True
    zero[40:48] = True
    coef = np.where(zero, 0.0, rng.uniform(0.1, 1.0, ids.size)).astype(np.float32)
    pick = rng.integers(0, B // 2, ids.size)
    hidx = np.where(zero, 2 * pick, 2 * pick + 1).astype(np.int32)
    perm = rng.permutation(ids.size)
    t = torch.from_numpy(table).to(getattr(torch, dtype)).cuda()
    _check_rank1_hbm(t, *(torch.from_numpy(a).cuda()
                          for a in (ids[perm], coef[perm], h, hidx[perm])))
    rows = t.float().cpu().numpy()[[0, 5, 9]]
    assert np.all(np.signbit(rows[:, :4])) and np.all(rows[:, :4] == 0)
    assert not np.any(np.signbit(rows[:, 4:8])) and np.all(rows[:, 4:8] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [7, 300])
def test_cuda_rank1_hbm_more_long_runs_than_blocks(dtype, d):
    # 400 runs of 40 to 50 updates among short runs: more long runs than
    # the 2 x 132 long-run blocks of an H100, so each block takes many.
    _cuda_or_skip()
    rng = np.random.default_rng(d)
    lengths = rng.integers(40, 51, 400)
    long_ids = np.repeat(np.arange(400) * 7, lengths)
    short_ids = rng.integers(3000, 8000, 3000)
    ids = rng.permutation(np.concatenate([long_ids, short_ids])).astype(np.int32)
    coef = (rng.normal(size=ids.size)
            * rng.choice([1e-3, 1.0, 100.0], size=ids.size)).astype(np.float32)
    h = rng.normal(size=(512, d)).astype(np.float32)
    hidx = rng.integers(0, 512, ids.size).astype(np.int32)
    table = rng.normal(size=(8000, d)).astype(np.float32)
    t = torch.from_numpy(table).to(getattr(torch, dtype)).cuda()
    _check_rank1_hbm(t, *(torch.from_numpy(a).cuda() for a in (ids, coef, h, hidx)))
