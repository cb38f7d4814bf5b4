"""Tensor parallelism over the mesh's ``tensor`` group: Megatron's splits.

The reference gets tensor parallelism from GSPMD: its rule table maps
"heads", "mlp" and "vocab" to ``tensor`` (``parallel/sharding.py``) and
XLA inserts the collectives that those shardings imply. Here one process
drives one device, and the model calls these pieces itself, each over the
tensor group of the rank's mesh:

- ``copy_to_tensor`` (Megatron's *f*): identity forward, all-reduce
  backward. The input of a column-parallel product (``wqkv``, ``wi``, the
  vocab-split head) goes through it, so the replicated activation before
  it gets the sum of every rank's gradient.
- ``reduce_from_tensor`` (*g*): all-reduce forward, identity backward.
  The output of a row-parallel product (``wo``, ``wo_mlp``) goes through
  it before its replicated bias is added, so each bias is added once.
- ``vocab_parallel_embedding``: the lookup into this rank's rows of a
  vocab-split table, ids outside its range masked to zero, then one
  all-reduce (*g*).
- ``vocab_parallel_token_sums``: the cross-entropy over logits split
  along the vocabulary, as the four sums of ``models/gpt.py``'s
  ``_aligned_token_sums`` (nll, z, correct, tokens). The global ``lse``
  comes from an all-reduced max and an all-reduced sum of exponentials;
  the target's logit from the rank that owns it; ``accuracy`` from the
  global argmax, ties to the lowest index as ``jnp.argmax``. Its
  gradient is ``softmax − onehot`` on the local slice.

No kernel: these are a handful of reductions, which the reference too
computes in XLA. A collective over a tensor group of one rank is skipped
(``group`` None). The collectives run on the card's tensors over NCCL or
gloo, and on CPU tensors over gloo.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F


def tensor_group(mesh: Any) -> Optional[Any]:
    """The process group of the mesh's tensor axis this rank belongs to;
    None without a mesh or when the axis has one rank."""
    if mesh is None:
        return None
    if int(mesh.shape[mesh.mesh_dim_names.index("tensor")]) == 1:
        return None
    return mesh.get_group("tensor")


def _all_reduce(x: torch.Tensor, group: Any, op: Any = None) -> torch.Tensor:
    import torch.distributed as dist

    if group is not None:
        dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    return x


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tensor(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Megatron's *f*: identity forward, all-reduce backward."""
    return x if group is None else _CopyToTensor.apply(x, group)


def reduce_from_tensor(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Megatron's *g*: all-reduce forward, identity backward."""
    return x if group is None else _ReduceFromTensor.apply(x, group)


def vocab_parallel_embedding(ids: torch.Tensor, table: torch.Tensor,
                             vocab_start: int, group: Any) -> torch.Tensor:
    """Rows of a table split along the vocabulary: `table` holds rows
    [vocab_start, vocab_start + len(table)); an id outside them looks up
    zeros, and the all-reduce over the tensor group gives every rank the
    whole lookup."""
    if group is None:
        return F.embedding(ids, table)
    local = ids - vocab_start
    inside = (local >= 0) & (local < table.shape[0])
    # F.embedding: its backward sums a repeated id's rows in a fixed order
    x = F.embedding(torch.where(inside, local, 0), table)
    return reduce_from_tensor(x.masked_fill(~inside[..., None], 0), group)


class _VocabParallelSums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, mask, vocab_start, vocab_size, group):
        import torch.distributed as dist

        v_local = logits.shape[-1]
        with torch.no_grad():
            local_max, local_arg = logits.max(dim=-1)
            m = _all_reduce(local_max.clone(), group, dist.ReduceOp.MAX)
            local_t = targets.long() - vocab_start
            inside = (local_t >= 0) & (local_t < v_local)
            idx = torch.where(inside, local_t, 0)
            target_logit = logits.gather(-1, idx[..., None])[..., 0]
            sums = torch.stack([
                torch.exp(logits - m[..., None]).sum(dim=-1),
                torch.where(inside, target_logit, 0.0)])
            _all_reduce(sums, group)
            lse = m + torch.log(sums[0])
            # the global argmax, ties to the lowest index: the smallest
            # index among the ranks whose maximum is the global one
            cand = torch.where(local_max == m, local_arg + vocab_start,
                               vocab_size)
            _all_reduce(cand, group, dist.ReduceOp.MIN)
            nll_sum = ((lse - sums[1]) * mask).sum()
            z_sum = (lse.square() * mask).sum()
            acc_sum = ((cand == targets.long()) * mask).sum()
            n_tok = mask.sum()
        ctx.save_for_backward(logits, lse, idx, inside, mask)
        ctx.mark_non_differentiable(acc_sum, n_tok)
        return nll_sum, z_sum, acc_sum, n_tok

    @staticmethod
    def backward(ctx, g_nll, g_z, _g_acc, _g_n):
        logits, lse, idx, inside, mask = ctx.saved_tensors
        # d nll / d logits = softmax − onehot; d z / d logits = 2·lse·softmax
        coef = mask * (g_nll + 2.0 * g_z * lse)
        grad = torch.exp(logits - lse[..., None]) * coef[..., None]
        grad.scatter_add_(-1, idx[..., None],
                          (-(g_nll * mask) * inside)[..., None])
        return grad, None, None, None, None, None


def vocab_parallel_token_sums(
    logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
    vocab_start: int, vocab_size: int, group: Any,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(nll, z, correct, tokens) SUMS over fp32 logits [..., V/t] split
    along the vocabulary (this rank's columns [vocab_start, vocab_start +
    V/t) of the whole [..., V]), ALIGNED with targets [...] (position i
    predicts targets[i]); mask [...] weights each position. Every rank of
    the tensor group gets the same sums."""
    return _VocabParallelSums.apply(logits, targets, mask.float(),
                                    int(vocab_start), int(vocab_size), group)
