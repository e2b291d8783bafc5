"""Skip-gram negative-sampling step math (counterpart of
``glint_word2vec_tpu/ops/sgns.py``): ``init_tables`` (:139),
``negative_mask`` (:149), ``sgns_coefs`` (:47), ``sgns_grads`` (:82),
``sgns_d_center`` (:120), the shared-pool estimator
``shared_sgns_grads``, ``shared_sgns_coefs``, ``shared_sgns_updates`` and
``pool_collision_mask`` (:161-302), the window step ``train_step``
(:305), the composed pair step ``train_step_pairs`` (:349) and the
forward-only ``sgns_loss`` (:422) as plain PyTorch, and
``train_step_pairs_fused``, the counterpart of ``train_step_pairs_pallas``
(:379), on the fused step of ``ops/fused_sgns.py``.

``sgns_grads`` is the forward and backward of the composed step of the
engine (``EmbeddingEngine.train_steps_grouped``) on gathered rows of the
grid form: ``(B, C)`` contexts and ``(B, C, n)`` negatives;
``shared_sgns_grads`` is its form for a shared pool of S negatives. With
``compute_dtype="bfloat16"`` the contractions take bf16 operands and
accumulate in fp32 (``.to(bfloat16).float()`` before an fp32 product),
as the JAX package's ``preferred_element_type=float32`` einsums do. The
products never run in TF32 (``device.py`` keeps it off).

The composed pair step is the reference the fused step of
``ops/fused_sgns.py`` is held against: gather, dot, sigmoid, rank-1
outer products, scatter-add, every value consumed being the pre-step
one. The steps take their negatives as an argument (the JAX functions
draw them from a key); the training path draws them with
``ops/sampling.py``.

Padding convention: padded pair slots carry index 0 and mask 0.0, and
every coefficient is multiplied by its mask, so they add exact zeros.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


class SgnsCoefs(NamedTuple):
    """The scalar SGD coefficients (the reference's gPlus/gMinus) and the
    masked-mean loss."""

    c_pos: torch.Tensor  # (...,)   alpha * (1 - sigmoid(f_pos)) * mask
    c_neg: torch.Tensor  # (..., n) -alpha * sigmoid(f_neg) * neg_mask
    loss: torch.Tensor  # ()


def sgns_coefs(f_pos: torch.Tensor, f_neg: torch.Tensor, mask: torch.Tensor,
               neg_mask: torch.Tensor, alpha) -> SgnsCoefs:
    """Coefficients and loss from reduced logits: ``f_pos`` (...,),
    ``f_neg`` (..., n), masks of the same shapes, ``alpha`` a scalar."""
    c_pos = alpha * (1.0 - torch.sigmoid(f_pos)) * mask
    c_neg = -alpha * torch.sigmoid(f_neg) * neg_mask
    pair_loss = -F.logsigmoid(f_pos) * mask - (
        F.logsigmoid(-f_neg) * neg_mask
    ).sum(dim=-1) * mask
    loss = pair_loss.sum() / mask.sum().clamp(min=1.0)
    return SgnsCoefs(c_pos=c_pos, c_neg=c_neg, loss=loss)


class SgnsGrads(NamedTuple):
    """Scalar coefficients and the center gradient of one minibatch."""

    c_pos: torch.Tensor  # (B, C)    alpha * (1 - sigmoid(f_pos)) * mask
    c_neg: torch.Tensor  # (B, C, n) -alpha * sigmoid(f_neg) * neg_mask
    d_center: torch.Tensor  # (B, d)  learning-rate-folded gradient of h
    loss: torch.Tensor  # () masked-mean loss


def _operand(x: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """``x`` as a contraction operand: rounded to bf16 for
    ``compute_dtype="bfloat16"`` and held in fp32 for the product."""
    if compute_dtype == "bfloat16":
        return x.to(torch.bfloat16).float()
    return x


def sgns_grads(h: torch.Tensor, u_pos: torch.Tensor, u_neg: torch.Tensor,
               mask: torch.Tensor, neg_mask: torch.Tensor, alpha,
               compute_dtype: str = "float32") -> SgnsGrads:
    """Forward and backward of the SGNS objective on gathered fp32 rows:
    ``h`` (B, d), ``u_pos`` (B, C, d), ``u_neg`` (B, C, n, d), ``mask``
    (B, C), ``neg_mask`` (B, C, n), ``alpha`` a scalar."""
    hc = _operand(h, compute_dtype)
    f_pos = torch.einsum("bd,bcd->bc", hc, _operand(u_pos, compute_dtype))
    f_neg = torch.einsum("bd,bcnd->bcn", hc, _operand(u_neg, compute_dtype))
    co = sgns_coefs(f_pos, f_neg, mask, neg_mask, alpha)
    d_center = sgns_d_center(co.c_pos, co.c_neg, u_pos, u_neg, compute_dtype)
    return SgnsGrads(co.c_pos, co.c_neg, d_center, co.loss)


def sgns_d_center(c_pos: torch.Tensor, c_neg: torch.Tensor,
                  u_pos: torch.Tensor, u_neg: torch.Tensor,
                  compute_dtype: str = "float32") -> torch.Tensor:
    """``dL/dh`` with the learning rate folded in: ``c_pos @ u_pos +
    c_neg @ u_neg`` per row, ``(B, d)`` fp32."""
    return torch.einsum(
        "bc,bcd->bd", _operand(c_pos, compute_dtype),
        _operand(u_pos, compute_dtype),
    ) + torch.einsum(
        "bcn,bcnd->bd", _operand(c_neg, compute_dtype),
        _operand(u_neg, compute_dtype),
    )


class SharedSgnsGrads(NamedTuple):
    """Gradient pieces of the shared-negative-pool estimator."""

    c_pos: torch.Tensor  # (B, C)  alpha * (1 - sigmoid(f_pos)) * mask
    c_pool: torch.Tensor  # (B, S)  weighted pool coefficients per center
    d_center: torch.Tensor  # (B, d)
    d_pool: torch.Tensor  # (S, d)  dense update of the pool's syn1 rows
    loss: torch.Tensor  # () masked-mean loss


class SharedSgnsCoefs(NamedTuple):
    """Logit-stage outputs of the shared-pool estimator."""

    c_pos: torch.Tensor  # (B, C)
    c_pool: torch.Tensor  # (B, S)
    loss: torch.Tensor  # ()


def shared_sgns_grads(h: torch.Tensor, u_pos: torch.Tensor,
                      u_pool: torch.Tensor, mask: torch.Tensor,
                      collide: torch.Tensor, alpha, num_negatives: int,
                      compute_dtype: str = "float32") -> SharedSgnsGrads:
    """SGNS gradients with one negative pool shared by the whole batch
    (``ops/sgns.py:171`` of the JAX package): ``h`` (B, d), ``u_pos``
    (B, C, d) and ``u_pool`` (S, d) fp32 rows, ``mask`` (B, C),
    ``collide`` (B, S) from :func:`pool_collision_mask`. Every center's
    pool term is weighted by ``m_i * n / S`` (``m_i`` its real context
    count), an unbiased estimate of ``n`` negatives a pair. The three
    pool products are dense:

        f_pool = h @ u_pool.T, d_center += c_pool @ u_pool,
        d_pool = c_pool.T @ h
    """
    hc = _operand(h, compute_dtype)
    upool_c = _operand(u_pool, compute_dtype)
    f_pos = torch.einsum("bd,bcd->bc", hc, _operand(u_pos, compute_dtype))
    f_pool = hc @ upool_c.T
    co = shared_sgns_coefs(f_pos, f_pool, mask, collide, alpha, num_negatives)
    d_center, d_pool = shared_sgns_updates(
        co.c_pos, co.c_pool, h, u_pos, u_pool, compute_dtype
    )
    return SharedSgnsGrads(co.c_pos, co.c_pool, d_center, d_pool, co.loss)


def shared_sgns_coefs(f_pos: torch.Tensor, f_pool: torch.Tensor,
                      mask: torch.Tensor, collide: torch.Tensor, alpha,
                      num_negatives: int) -> SharedSgnsCoefs:
    """Coefficients and masked-mean loss from reduced logits: ``f_pos``
    (B, C), ``f_pool`` (B, S)."""
    m_i = mask.sum(dim=1)
    S = f_pool.shape[1]
    weight = (m_i * (num_negatives / S))[:, None] * (1.0 - collide)
    c_pos = alpha * (1.0 - torch.sigmoid(f_pos)) * mask
    c_pool = -alpha * torch.sigmoid(f_pool) * weight
    pos_loss = (-F.logsigmoid(f_pos) * mask).sum()
    pool_loss = (-F.logsigmoid(-f_pool) * weight).sum()
    loss = (pos_loss + pool_loss) / mask.sum().clamp(min=1.0)
    return SharedSgnsCoefs(c_pos, c_pool, loss)


def shared_sgns_updates(c_pos: torch.Tensor, c_pool: torch.Tensor,
                        h: torch.Tensor, u_pos: torch.Tensor,
                        u_pool: torch.Tensor,
                        compute_dtype: str = "float32"):
    """``(d_center (B, d), d_pool (S, d))`` from the coefficients."""
    cpool_c = _operand(c_pool, compute_dtype)
    upool_c = _operand(u_pool, compute_dtype)
    d_center = torch.einsum(
        "bc,bcd->bd", _operand(c_pos, compute_dtype),
        _operand(u_pos, compute_dtype),
    ) + cpool_c @ upool_c
    d_pool = cpool_c.T @ _operand(h, compute_dtype)
    return d_center, d_pool


def pool_collision_mask(pool: torch.Tensor, contexts: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """(B, S) fp32, 1.0 where a pool word equals one of that row's real
    context words: the pool-wide form of the per-draw ``target == word``
    skip. Each row's C contexts are sorted (padded lanes become the int32
    maximum, which no pool id equals) and the pool is binary-searched
    into them, so the peak intermediate is O(B·S), not the O(B·C·S) of a
    broadcast compare (``ops/sgns.py:280-302`` of the JAX package)."""
    sentinel = torch.iinfo(torch.int32).max
    ctx = torch.where(mask > 0, contexts, sentinel).to(torch.int32)
    ctx_sorted = torch.sort(ctx, dim=1).values.contiguous()
    B, C = ctx_sorted.shape
    pool_b = pool.to(torch.int32).expand(B, -1).contiguous()
    idx = torch.searchsorted(ctx_sorted, pool_b, side="left").clamp(max=C - 1)
    found = torch.gather(ctx_sorted, 1, idx) == pool_b
    return found.to(torch.float32)


def init_tables(generator: torch.Generator, vocab_size: int, dim: int,
                dtype=torch.float32, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """word2vec's initial tables: syn0 ~ U[-0.5/d, 0.5/d), syn1 = 0. The
    draws come from ``generator`` (not the JAX package's threefry words:
    tests that compare the packages install equal tables instead)."""
    syn0 = torch.rand((vocab_size, dim), generator=generator, device=device)
    syn0 = ((syn0 - 0.5) / dim).to(dtype)
    return syn0, torch.zeros((vocab_size, dim), dtype=dtype, device=device)


def negative_mask(negs: torch.Tensor, contexts: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """1.0 for a kept negative draw: a draw equal to its positive context
    word is dropped (word2vec's "target == word" skip), and draws of
    padded slots are zeroed. ``negs`` (..., n), ``contexts`` and
    ``mask`` (...,)."""
    keep = (negs != contexts[..., None]).to(torch.float32)
    return keep * mask[..., None]


def train_step_pairs(
    syn0: torch.Tensor, syn1: torch.Tensor,
    centers: torch.Tensor, contexts: torch.Tensor, pair_mask: torch.Tensor,
    negs: torch.Tensor, alpha,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One composed SGNS update over a dense pair list: ``centers``,
    ``contexts`` and ``pair_mask`` (P,), ``negs`` (P, n). Returns new
    ``(syn0, syn1, loss)``; the inputs are not modified. Duplicate rows
    sum their updates (``index_add``), each update cast to the table's
    dtype first, as the JAX step's ``.at[].add`` does."""
    c = centers.long()
    x = contexts.long()
    ng = negs.long()
    h = syn0[c].float()
    u_pos = syn1[x].float()
    u_neg = syn1[ng].float()
    nmask = negative_mask(negs, contexts, pair_mask)
    f_pos = (h * u_pos).sum(dim=-1)
    f_neg = (h[:, None, :] * u_neg).sum(dim=-1)
    co = sgns_coefs(f_pos, f_neg, pair_mask, nmask, alpha)
    d_center = co.c_pos[:, None] * u_pos + (co.c_neg[..., None] * u_neg).sum(dim=1)
    n = negs.shape[1]
    syn0 = syn0.clone().index_add_(0, c, d_center.to(syn0.dtype))
    syn1 = syn1.clone().index_add_(
        0, x, (co.c_pos[:, None] * h).to(syn1.dtype)
    )
    syn1.index_add_(
        0, ng.reshape(-1),
        (co.c_neg.reshape(-1)[:, None] * h.repeat_interleave(n, dim=0)).to(syn1.dtype),
    )
    return syn0, syn1, co.loss


def train_step(
    syn0: torch.Tensor, syn1: torch.Tensor,
    centers: torch.Tensor, contexts: torch.Tensor, mask: torch.Tensor,
    negs: torch.Tensor, alpha,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One composed SGNS update of a window batch: ``centers`` (B,),
    ``contexts`` and ``mask`` (B, C), ``negs`` (B, C, n). Returns new
    ``(syn0, syn1, loss)``; the inputs are not modified. As the JAX
    step: ``d_center`` onto syn0, then the contexts' and the negatives'
    rank-1 updates onto syn1, duplicate rows summed, each update cast to
    the table's dtype first."""
    B, C = contexts.shape
    n = negs.shape[-1]
    c = centers.long()
    x = contexts.long()
    ng = negs.long()
    h = syn0[c].float()
    u_pos = syn1[x].float()
    u_neg = syn1[ng].float()
    nmask = negative_mask(negs, contexts, mask)
    g = sgns_grads(h, u_pos, u_neg, mask, nmask, alpha)
    d_upos = g.c_pos[..., None] * h[:, None, :]
    d_uneg = g.c_neg[..., None] * h[:, None, None, :]
    syn0 = syn0.clone().index_add_(0, c, g.d_center.to(syn0.dtype))
    syn1 = syn1.clone().index_add_(
        0, x.reshape(-1), d_upos.reshape(B * C, -1).to(syn1.dtype))
    syn1.index_add_(
        0, ng.reshape(-1), d_uneg.reshape(B * C * n, -1).to(syn1.dtype))
    return syn0, syn1, g.loss


def sgns_loss(
    syn0: torch.Tensor, syn1: torch.Tensor,
    centers: torch.Tensor, contexts: torch.Tensor, mask: torch.Tensor,
    negs: torch.Tensor,
) -> torch.Tensor:
    """Forward-only masked-mean SGNS loss of a window batch (shapes as
    :func:`train_step`)."""
    h = syn0[centers.long()].float()
    u_pos = syn1[contexts.long()].float()
    u_neg = syn1[negs.long()].float()
    nmask = negative_mask(negs, contexts, mask)
    return sgns_grads(h, u_pos, u_neg, mask, nmask, 1.0).loss


def train_step_pairs_fused(
    syn0: torch.Tensor, syn1: torch.Tensor,
    centers: torch.Tensor, contexts: torch.Tensor, pair_mask: torch.Tensor,
    negs: torch.Tensor, alpha,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`train_step_pairs` on the fused step
    (``ops/fused_sgns.fused_pair_step``: ``pair_forward``, then
    ``scatter_add_rank1_hbm`` onto syn1 and ``scatter_add_rows_f32`` onto
    syn0). Same arguments and result; the inputs are not modified. On a
    CUDA tensor it launches the kernels or raises; on the CPU it runs
    their plain versions."""
    from glint_word2vec_torch.ops.fused_sgns import fused_pair_step

    syn0, syn1 = syn0.clone(), syn1.clone()
    nmask = negative_mask(negs, contexts, pair_mask)
    alpha_t = torch.as_tensor(alpha, dtype=torch.float32, device=syn0.device)
    loss_sum = fused_pair_step(syn0, syn1, centers, contexts, pair_mask, negs,
                               nmask, alpha_t)
    return syn0, syn1, loss_sum / pair_mask.sum().clamp(min=1.0)
