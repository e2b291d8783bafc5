"""The fused step's rows scatter, ``scatter_add_rows_f32`` (B6, in
glint_word2vec_torch/ops/fused_sgns.py), on long runs: its plain version
against the JAX package's Pallas kernel run in interpret mode, and its
CUDA kernel against its plain version on a card.

Tolerance: none. Each run is summed in fp32 in stable sorted order onto
the fp32 value of the table row and rounded to the table's dtype once.
The CPU cases use dyadic values, whose fp32 sums are exact in any order,
and give the JAX kernel one block (``block_rows = N``) under bf16, where
it rounds once per run per block.

The ``cuda`` tests import no JAX:

    python -m pytest tests/test_torch_scatter_f32.py -m cuda --noconftest -q
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


def _dyadic_case(seed, run, others, d=D):
    """``run`` updates to id 3 among ``others`` random ids, shuffled (a
    negative ``others``: the whole batch is id 3), dyadic table rows
    (bf16-exact) and update rows."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full(run, 3), rng.integers(0, V, max(others, 0))])
    ids = rng.permutation(ids).astype(np.int32)
    table = (rng.integers(-64, 64, (V, d)) / 8.0).astype(np.float32)
    upd = (rng.integers(-256, 256, (ids.size, d)) / 64.0).astype(np.float32)
    return table, ids, upd


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("run,others", [(33, 40), (257, 40), (96, -1)])
def test_cpu_scatter_f32_long_runs_bitwise_equal_jax(dtype, run, others):
    # Runs past the CUDA kernel's long-run threshold (32) and a batch of
    # one id: the plain version against the TPU kernel in interpret mode.
    import jax.numpy as jnp

    from glint_word2vec_tpu.ops.pallas_sgns import scatter_add_rows_f32 as jax_fn

    table, ids, upd = _dyadic_case(run, run, others)
    block_rows = 8 if dtype == "float32" else ids.size
    want = np.asarray(jax_fn(
        jnp.asarray(table, dtype=getattr(jnp, dtype)), jnp.asarray(ids),
        jnp.asarray(upd), interpret=True, block_rows=block_rows,
    ).astype(jnp.float32))
    t = torch.from_numpy(table).to(getattr(torch, dtype))
    before = fs.scatter_add_rows_f32.launches
    fs.scatter_add_rows_f32(t, torch.from_numpy(ids), torch.from_numpy(upd))
    assert fs.scatter_add_rows_f32.launches == before  # CPU: plain version
    got = t.float().numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# ----------------------------------------------------------------------
# On the card: the kernel against its plain version
# ----------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")


def _mixed_case(seed, run, d, others=300, distinct=4096):
    """``run`` updates to id 3 among ``others`` random ids, shuffled (a
    negative ``others``: the whole batch is id 3), update rows of
    magnitudes 1e-3, 1 and 100, so the order of the fp32 adds shows."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([np.full(run, 3), rng.integers(0, distinct, max(others, 0))])
    ids = rng.permutation(ids).astype(np.int32)
    upd = (rng.normal(size=(ids.size, d))
           * rng.choice([1e-3, 1.0, 100.0], size=(ids.size, 1))).astype(np.float32)
    table = rng.normal(size=(distinct, d)).astype(np.float32)
    return table, ids, upd


def _check_both_alignments(dtype, table, ids, upd):
    """The kernel against the plain version, with the payload 16-byte
    aligned and then 4 bytes off (the long-run blocks' 4-byte copies)."""
    t = torch.from_numpy(table).to(getattr(torch, dtype)).cuda()
    ids_c = torch.from_numpy(ids).cuda()
    flat = torch.empty(upd.size + 1, device="cuda")
    for upd_c in (torch.from_numpy(upd).cuda(), flat[1:].view(upd.shape)):
        upd_c.copy_(torch.from_numpy(upd))
        want = fs.scatter_add_rows_f32_reference(t.cpu(), ids_c.cpu(), upd_c.cpu())
        before = fs.scatter_add_rows_f32.launches
        fs.scatter_add_rows_f32(t, ids_c, upd_c)
        torch.cuda.synchronize()
        assert fs.scatter_add_rows_f32.launches == before + 1
        assert torch.equal(t.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 7, 31, 32, 33, 300, 301])
@pytest.mark.parametrize("run", [31, 32, 33, 257, 9262, "whole"])
def test_cuda_scatter_f32_run_lengths_bitwise(dtype, d, run):
    # Each side of the long-run threshold (32), a run of 257, row 0's run
    # at fastText width (9,262), and a batch of 4,096 updates to one id.
    _cuda_or_skip()
    if run == "whole":
        table, ids, upd = _mixed_case(d, 4096, d, others=-1)
    else:
        table, ids, upd = _mixed_case(run * 7 + d, run, d)
    _check_both_alignments(dtype, table, ids, upd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [7, 300])
def test_cuda_scatter_f32_more_long_runs_than_blocks(dtype, d):
    # 400 runs of 40 to 50 updates among short runs: more long runs than
    # the 2 x 132 long-run blocks of an H100, so each block takes many.
    _cuda_or_skip()
    rng = np.random.default_rng(d)
    lengths = rng.integers(40, 51, 400)
    long_ids = np.repeat(np.arange(400) * 7, lengths)
    short_ids = rng.integers(3000, 8000, 3000)
    ids = rng.permutation(np.concatenate([long_ids, short_ids])).astype(np.int32)
    upd = (rng.normal(size=(ids.size, d))
           * rng.choice([1e-3, 1.0, 100.0], size=(ids.size, 1))).astype(np.float32)
    table = rng.normal(size=(8000, d)).astype(np.float32)
    _check_both_alignments(dtype, table, ids, upd)
