"""Chunked cross-entropy: the LM loss without materializing [T, V] logits.

Port of ``determined_tpu/ops/fused_cross_entropy.py``. The vocab
projection's logits are the step's largest activation (``[1, 16384,
50304]`` fp32 is 3.3 GB at the long-context shape); this op streams
VOCAB CHUNKS instead:

- forward: online logsumexp (running max and sum), target logit and
  running argmax per chunk; what it keeps for the backward is O(T);
- backward (``torch.autograd.Function``): recompute each chunk's logits,
  form d_logits = coef·softmax − mask·onehot for the chunk, rounded to
  the compute dtype, and contract it at once into dx (summed in fp32
  over the chunks) and the chunk's columns of dW.

The objective is ``models/gpt.py``'s ``_aligned_token_sums``:
``obj = Σ mask·(lse − target_logit) + z_loss·Σ mask·lse²``, with the aux
sums (nll, z, correct, n) for the metrics.

Products: every logits product takes compute-dtype operands and gives
fp32 logits, as the reference's ``preferred_element_type=float32``; the
operands are upcast to fp32 first (exact), so the sums run in fp32 and
the logits are never rounded to the compute dtype. dW per chunk is cast
to the compute dtype, as in the reference. The op holds no TPU kernel
(no ``pallas_call``): its products are ``torch.matmul``.
"""
from __future__ import annotations

import logging
from typing import Tuple

import torch

logger = logging.getLogger("determined_tpu_torch")


def _chunk_count(vocab: int, target_chunk: int = 8192) -> int:
    """Largest chunk count ≤ vocab/target that divides the vocab evenly.

    Falls back to 1 when no nearby divisor exists (e.g. the unpadded
    GPT-2 vocab 50257 = 29·1733), which makes the op pointless (one chunk
    is the dense logits, plus the backward recompute), so it warns: pad
    the vocab to a multiple of 128 (gpt.py's configs already do)."""
    for c in range(max(1, round(vocab / target_chunk)), 1, -1):
        if vocab % c == 0:
            return c
    if vocab > target_chunk:
        logger.warning(
            "fused cross-entropy: vocab %d has no chunk count near "
            "%d-wide chunks; running UNCHUNKED (no memory savings, extra "
            "backward recompute) — pad the vocab to a composite size",
            vocab, target_chunk,
        )
    return 1


def _forward(x, w, targets, mask, z_loss: float, n_chunks: int):
    t = x.shape[0]
    vc = w.shape[1] // n_chunks
    dev = x.device
    neg = torch.full((t,), -1e30, dtype=torch.float32, device=dev)
    m, tl, best_v = neg, neg, neg
    s = torch.zeros((t,), dtype=torch.float32, device=dev)
    best_i = torch.zeros((t,), dtype=torch.int64, device=dev)
    targets = targets.long()
    x32, w32 = x.float(), w.float()
    for c in range(n_chunks):
        logits = x32 @ w32[:, c * vc:(c + 1) * vc]  # [T, vc] fp32
        ci = logits.argmax(dim=-1)
        cmax = logits.gather(1, ci[:, None])[:, 0]
        m_new = torch.maximum(m, cmax)
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        m = m_new
        # the target logit, if this chunk holds it
        idx = targets - c * vc
        in_chunk = (idx >= 0) & (idx < vc)
        got = logits.gather(1, idx.clamp(0, vc - 1)[:, None])[:, 0]
        tl = torch.where(in_chunk, got, tl)
        # the running argmax (for the accuracy metric); an earlier chunk
        # keeps a tie, as a dense argmax returns the first maximum
        better = cmax > best_v
        best_v = torch.where(better, cmax, best_v)
        best_i = torch.where(better, ci + c * vc, best_i)
    lse = m + torch.log(s)
    nll_sum = ((lse - tl) * mask).sum()
    z_sum = (lse.square() * mask).sum()
    acc_sum = ((best_i == targets) * mask).sum()
    n = mask.sum()
    obj = nll_sum + z_loss * z_sum
    return obj, torch.stack([nll_sum, z_sum, acc_sum, n]), lse


class _FusedCE(torch.autograd.Function):
    """(x [T, D], w [D, V], targets [T] int, mask [T] fp32) → (objective
    sum, aux [nll_sum, z_sum, acc_sum, n]); gradients reach x and w only
    (the aux sums are metrics and are never differentiated)."""

    @staticmethod
    def forward(ctx, x, w, targets, mask, z_loss, n_chunks):
        obj, aux, lse = _forward(x, w, targets, mask, z_loss, n_chunks)
        ctx.save_for_backward(x, w, targets, mask, lse)
        ctx.z_loss, ctx.n_chunks = z_loss, n_chunks
        ctx.mark_non_differentiable(aux)
        return obj, aux

    @staticmethod
    def backward(ctx, g_obj, _g_aux):
        x, w, targets, mask, lse = ctx.saved_tensors
        vc = w.shape[1] // ctx.n_chunks
        # d obj / d logit_v = mask·(1 + 2z·lse)·softmax_v − mask·1[v = target]
        coef = g_obj * mask * (1.0 + 2.0 * ctx.z_loss * lse)
        tcoef = g_obj * mask
        targets = targets.long()
        x32, w32 = x.float(), w.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dws = []
        for c in range(ctx.n_chunks):
            w_c = w32[:, c * vc:(c + 1) * vc]
            p = torch.exp(x32 @ w_c - lse[:, None])
            idx = targets - c * vc
            in_chunk = (idx >= 0) & (idx < vc)
            dl = (coef[:, None] * p).scatter_add_(
                1, idx.clamp(0, vc - 1)[:, None],
                -(tcoef * in_chunk)[:, None]).to(x.dtype)
            dl = dl.float()
            dx += dl @ w_c.t()
            dws.append((x32.t() @ dl).to(w.dtype))
        return dx.to(x.dtype), torch.cat(dws, dim=1), None, None, None, None


def fused_ce_sums(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor, z_loss: float, n_chunks: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, D] compute dtype (after the final layernorm), w [D, V] (the lm
    head or the tied embedding's transpose), targets [T] int, mask [T]
    fp32 → (objective_sum, aux [nll_sum, z_sum, acc_sum, n])."""
    return _FusedCE.apply(x, w, targets, mask, float(z_loss), int(n_chunks))


def fused_next_token_sums(
    x: torch.Tensor,        # [B, S, D] hidden states after the final layernorm
    w: torch.Tensor,        # [D, V]
    targets: torch.Tensor,  # [B, S] int, aligned (position i → targets[i])
    mask: torch.Tensor,     # [B, S] float
    *,
    z_loss: float = 0.0,
    target_chunk: int = 8192,
) -> Tuple[torch.Tensor, ...]:
    """→ (obj_sum, nll_sum, z_sum, acc_sum, n): the chunked form of
    ``_aligned_token_sums`` over the head's product (the layernorm stays
    with the caller)."""
    b, s, d = x.shape
    n_chunks = _chunk_count(w.shape[1], target_chunk)
    obj, aux = fused_ce_sums(x.reshape(b * s, d), w, targets.reshape(-1),
                             mask.reshape(-1).float(), z_loss, n_chunks)
    return obj, aux[0], aux[1], aux[2], aux[3]
