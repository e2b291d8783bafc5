"""The port's row gather (glint_word2vec_torch/ops/rows.py) against the JAX
package's Pallas ``gather_rows`` run in interpret mode: same tables, same
ids, bitwise equal fp32 rows.

The ``cuda`` tests hold the CUDA kernel against its plain version on a
card. They import no JAX, so they also run where JAX is not installed:

    python -m pytest tests/test_torch_rows.py -m cuda --noconftest -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: pytest-xdist runs several workers on the same
# cores, and PyTorch's spinning thread pools then slow small ops manyfold.
torch.set_num_threads(1)

from glint_word2vec_torch.ops.rows import gather_rows, gather_rows_reference

V, D = 203, 24


def _ids(n, seed):
    """n ids (n not a multiple of 16) with duplicates and ids 0 and V-1."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, n).astype(np.int32)
    ids[0], ids[1], ids[2] = 0, V - 1, V - 1
    ids[3:9] = ids[9]
    return ids


# (n, d, odd): odd keeps only odd ids, whose bf16 rows at d = 300 start 8
# bytes off a 16-byte boundary (the kernel's 8-byte loads).
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n,d,odd",
    [(1, D, False), (37, D, False), (37, 1, False), (37, 7, False),
     (37, 301, False), (37, 300, True)],
    ids=["1", "37", "37-d1", "37-d7", "37-d301", "37-d300-odd"],
)
def test_cpu_gather_bitwise_equals_jax_interpret(dtype, n, d, odd):
    import jax.numpy as jnp

    from glint_word2vec_tpu.ops.pallas_rows import gather_rows as jax_gather_rows

    rng = np.random.default_rng(7)
    jt = jnp.asarray(rng.normal(size=(V, d)).astype(np.float32)).astype(dtype)
    ids = _ids(n, 11) if n > 9 else np.array([V - 1], np.int32)
    if odd:
        ids = ids | 1  # V is odd, so V - 1 becomes V - 2
        ids[ids >= V] = V - 2
    want = np.asarray(
        jax_gather_rows(jt, jnp.asarray(ids), interpret=True).astype(jnp.float32)
    )
    # The port's table holds the same bits: the bf16 values are exact fp32.
    tt = torch.from_numpy(np.array(jt.astype(jnp.float32))).to(
        getattr(torch, dtype)
    )
    before = gather_rows.launches
    got = gather_rows(tt, torch.from_numpy(ids))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, d)
    np.testing.assert_array_equal(got.numpy(), want)
    # A CPU tensor takes the plain version: no kernel launch is counted.
    assert gather_rows.launches == before


def test_wrapper_rejects_bad_inputs():
    table = torch.zeros((V, D))
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        gather_rows(torch.zeros((D, V)).T, ids)
    with pytest.raises(TypeError, match="dtype"):
        gather_rows(table.double(), ids)
    with pytest.raises(TypeError, match="int32"):
        gather_rows(table, ids.long())
    with pytest.raises(ValueError, match="2-D"):
        gather_rows(torch.zeros(V), ids)
    with pytest.raises(ValueError, match="contiguous"):
        gather_rows(table, torch.zeros(8, dtype=torch.int32)[::2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [300, 301, 7])
def test_cuda_kernel_bitwise_equals_plain(dtype, d):
    # N = 1, N not a multiple of the rows a warp takes (37, 4,099), more
    # rows than the card holds warps at once (70,001), and only odd ids
    # (bf16 rows 8 bytes off 16-byte alignment at d = 300).
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    gen = torch.Generator(device="cuda").manual_seed(3)
    table = torch.randn((V, d), generator=gen, device="cuda").to(
        getattr(torch, dtype)
    )
    odd = torch.from_numpy(_ids(37, 5) | 1).clamp(max=V - 2).cuda()
    for ids in (torch.from_numpy(_ids(37, 5)).cuda(),
                torch.tensor([V - 1], dtype=torch.int32, device="cuda"),
                torch.from_numpy(_ids(4099, 6)).cuda(),
                torch.from_numpy(_ids(70_001, 8)).cuda(), odd):
        before = gather_rows.launches
        got = gather_rows(table, ids)
        torch.cuda.synchronize()
        assert gather_rows.launches == before + 1
        assert torch.equal(got, gather_rows_reference(table, ids))
