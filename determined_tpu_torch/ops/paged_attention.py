"""Paged decode attention: a hand-written CUDA kernel plus its plain
PyTorch version.

Port of ``determined_tpu/ops/paged_attention.py``. Decode attention reads
K/V straight out of the page pool ``[num_pages, page_size, H, Dh]``
through each slot's page table; no contiguous ``[B, S_max, H, Dh]`` buffer
is built. Row r of slot b is the token at position ``lengths[b] + r``
(already written into the pool) and sees positions
``<= lengths[b] + min(r, q_lens[b] − 1)``; inactive slots output 0.

- On a CUDA tensor the wrapper launches ``csrc/paged_attention.cu`` (the
  port of the Pallas ``_paged_kernel``) or raises. The kernel runs one
  thread block cluster per (slot, head) of ``C = min(4, P)`` CTAs: rank c
  walks the slot's live pages c, c + C, ... (each CTA loads its own
  page-table row and scalars), and the ranks' partial softmax states are
  merged inside the cluster in rank order. In bf16 the pages stream by
  TMA, so a pool view that breaks TMA's 16-byte rules is copied first
  (``flash_attention._tma_inputs``).
- On a CPU tensor it runs ``_paged_ref``, the plain version: a page-table
  gather (dead entries clamped to the last live page, as the reference's
  ``_page_index``) plus dense masked softmax. ``_paged_split_plain``
  repeats the kernel's split walk and rank-order merge in plain PyTorch,
  for the tests.

Changes from the reference, both because the TPU's tiling rules do not
apply here: ``page_size`` need not be a multiple of ``LANE_GRANULE`` (the
CUDA kernel walks a page in 64-key tiles with a short last tile), and
``block_h`` is accepted and validated for signature parity but the kernel
ignores it (one head per cluster). ``interpret`` has no meaning for a
CUDA kernel: it is accepted for parity and refused on a CUDA tensor.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from determined_tpu_torch.ops import _build
from determined_tpu_torch.ops.flash_attention import _tma_inputs

NEG_INF = float(-1e30)

#: The CUDA kernel's library handle; ``PAGED_ATTENTION.launches`` counts
#: launches.
PAGED_ATTENTION = _build.PAGED_ATTENTION

#: The reference's page granule (the TPU lane width). Kept so configs and
#: callers that name it resolve; the CUDA kernel takes any page_size.
LANE_GRANULE = 128

#: Query rows one launch takes (the kernel's register-resident row state).
MAX_Q_ROWS = 16

#: CTAs of a (slot, head)'s cluster at most: the kernel splits the page
#: walk over ``min(MAX_RANKS, P)`` ranks.
MAX_RANKS = 4

#: The reference's per-step K+V page-group budget (bytes), kept so
#: ``default_paged_block_h`` returns what the reference returns.
_PAGE_GROUP_VMEM_CAP = 4 * 1024 * 1024


def paged_block_h_fits(block_h: int, head_dim: int, page_size: int,
                       dtype) -> bool:
    """Does a ``block_h``-head K+V page group fit the reference's
    per-step budget?"""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (
        2 * page_size * block_h * head_dim * itemsize
        <= _PAGE_GROUP_VMEM_CAP
    )


def default_paged_block_h(n_heads: int, head_dim: int, page_size: int,
                          dtype) -> int:
    """Largest divisor of ``n_heads`` whose K+V page group fits the
    budget (the reference's no-probe default)."""
    best = 1
    for cand in range(1, n_heads + 1):
        if n_heads % cand:
            continue
        if paged_block_h_fits(cand, head_dim, page_size, dtype):
            best = cand
    return best


def _gather_scores(q, k_pool, v_pool, page_table, lengths, active, q_lens,
                   scale):
    """Each slot's pages gathered (dead table entries clamped onto the last
    live page, so a dead entry is never used as an index) → (fp32 scores
    [B, H, r, K] with NEG_INF where masked, the mask [B, 1, r, K], fp32 V
    [B, K, H, Dh]); key k of a slot sits at position k."""
    b, q_rows, h, d = q.shape
    page_size = k_pool.shape[1]
    n_page_slots = page_table.shape[1]
    s_max = n_page_slots * page_size
    lengths = lengths.to(torch.int64)
    q_lens = q_lens.to(torch.int64)
    last_live = (lengths + q_lens - 1) // page_size
    slots = torch.arange(n_page_slots, device=q.device)
    pt = torch.gather(
        page_table.to(torch.int64), 1,
        torch.minimum(slots[None, :], last_live[:, None]),
    )
    k_full = k_pool[pt].reshape(b, s_max, h, d).float()
    v_full = v_pool[pt].reshape(b, s_max, h, d).float()
    s = torch.einsum("brhd,bkhd->bhrk", q.float(), k_full) * scale
    rows = torch.arange(q_rows, device=q.device)
    bound = lengths[:, None] + torch.minimum(rows[None, :], q_lens[:, None] - 1)
    cols = torch.arange(s_max, device=q.device)
    mask = (cols[None, None, :] <= bound[:, :, None])          # [B, r, k]
    mask = (mask & (active != 0)[:, None, None])[:, None]      # [B, 1, r, k]
    return torch.where(mask, s, NEG_INF), mask, v_full


def _paged_ref(q, k_pool, v_pool, page_table, lengths, active, q_lens,
               scale):
    """Plain version: the gathered pages (``_gather_scores``), then dense
    masked softmax in fp32. → o [B, q_rows, H, Dh] pool dtype."""
    s, mask, v_full = _gather_scores(q, k_pool, v_pool, page_table, lengths,
                                     active, q_lens, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhrk,bkhd->brhd", p / l_safe, v_full)
    return o.to(k_pool.dtype)


def _paged_split_plain(q, k_pool, v_pool, page_table, lengths, active,
                       q_lens=None, *, scale=None, n_ranks=None):
    """The CUDA kernel's split walk and merge in plain PyTorch (tests
    only): rank c of ``C = min(MAX_RANKS, P)`` (or ``n_ranks``) takes the
    live pages c, c + C, ... and keeps its own fp32 (m, l, acc) — a rank
    with no live key holds m = NEG_INF, l = 0 — then the partials are
    merged in rank order, o = Σ acc_c·e^(m_c − m) / Σ l_c·e^(m_c − m) with
    m the largest m_c (l = 0 writes zeros). → o [B, q_rows, H, Dh] pool
    dtype."""
    b, q_rows, h, d = q.shape
    if q_lens is None:
        q_lens = torch.ones((b,), dtype=torch.int32, device=q.device)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    page_size = k_pool.shape[1]
    n_slots = page_table.shape[1]
    if n_ranks is None:
        n_ranks = min(MAX_RANKS, n_slots)
    s, mask, v_full = _gather_scores(q, k_pool, v_pool, page_table, lengths,
                                     active, q_lens, scale)
    rank = (torch.arange(s.shape[-1], device=q.device) // page_size) % n_ranks
    parts = []
    for c in range(n_ranks):
        mine = mask & (rank == c)
        s_c = torch.where(mine, s, NEG_INF)
        m_c = s_c.amax(dim=-1, keepdim=True)
        p_c = torch.where(mine, torch.exp(s_c - m_c), 0.0)
        parts.append((m_c, p_c.sum(dim=-1, keepdim=True),
                      torch.einsum("bhrk,bkhd->bhrd", p_c, v_full)))
    m = torch.stack([m_c for m_c, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for m_c, l_c, acc_c in parts:  # rank order
        w = torch.exp(m_c - m)
        l = l + l_c * w
        acc = acc + acc_c * w
    o = torch.where(l == 0.0, 0.0, acc / torch.where(l == 0.0, 1.0, l))
    return o.transpose(1, 2).to(k_pool.dtype)


def _paged_cuda(q, k_pool, v_pool, page_table, lengths, active, q_lens,
                scale):
    b, q_rows, h, d = q.shape
    num_pages, page_size = k_pool.shape[:2]
    if q_rows > MAX_Q_ROWS:
        raise ValueError(
            f"q_rows {q_rows} exceeds the CUDA kernel's {MAX_Q_ROWS} rows"
        )
    if d not in _build.HEAD_DIMS:
        raise ValueError(
            f"head_dim {d} not supported by the CUDA kernel "
            f"(one of {_build.HEAD_DIMS})"
        )
    if q.dtype != k_pool.dtype or v_pool.dtype != k_pool.dtype:
        raise ValueError(
            f"q/k_pool/v_pool dtypes differ: {q.dtype}, {k_pool.dtype}, "
            f"{v_pool.dtype}"
        )
    code = _build.dtype_code(q.dtype)
    if q.stride(-1) != 1:
        q = q.contiguous()
    k_pool, v_pool = _tma_inputs(code, k_pool.contiguous(),
                                 v_pool.contiguous())

    def i32(x):
        return x.to(device=q.device, dtype=torch.int32).contiguous()

    page_table, lengths, q_lens, active = (
        i32(page_table), i32(lengths), i32(q_lens), i32(active)
    )
    o = torch.empty((b, q_rows, h, d), dtype=k_pool.dtype, device=q.device)
    if o.numel() == 0:
        return o
    PAGED_ATTENTION.launch(
        code, d, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), q_lens.data_ptr(),
        active.data_ptr(), o.data_ptr(), b, q_rows, h, page_size,
        page_table.shape[1], num_pages, q.stride(0), q.stride(1), q.stride(2),
        float(scale), _build.stream_ptr(q.device),
    )
    return o


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    active: torch.Tensor,
    *,
    q_lens: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_h: Optional[int] = None,
    interpret: bool = False,
) -> torch.Tensor:
    """Decode attention straight over the paged KV pool.

    q: [B, q_rows, H, Dh] — row 0 is the real query (the token at
    position ``lengths[b]``, already written into the pool); extra rows
    are padding whose output the caller drops, unless ``q_lens`` marks
    them live. k_pool/v_pool: [num_pages, page_size, H, Dh] — ONE layer's
    pool. page_table: [B, P] int — each slot's pages in order (the dead
    tail is never dereferenced). lengths: [B] int — tokens cached BEFORE
    this iteration's token. active: [B] bool/int — inactive slots read
    nothing and output 0. q_lens: [B] int — real query rows per slot
    (default all ones: plain single-token decode).

    block_h: validated (must divide H) and otherwise unused — the CUDA
    kernel runs one head per thread block cluster. interpret: refused on CUDA
    tensors (a CUDA kernel has no interpret mode); CPU tensors always run
    the plain version.

    → o [B, q_rows, H, Dh] (pool dtype). Forward-only.
    """
    return _paged(q, k_pool, v_pool, page_table, lengths, active, q.is_cuda,
                  q_lens=q_lens, scale=scale, block_h=block_h,
                  interpret=interpret)


def paged_attention_plain(q, k_pool, v_pool, page_table, lengths, active,
                          **kwargs):
    """paged_attention's plain version on any device (same arguments and
    validation): what the CPU path runs, and what a kernel launch is held
    against on the card."""
    return _paged(q, k_pool, v_pool, page_table, lengths, active, False,
                  **kwargs)


def _paged(q, k_pool, v_pool, page_table, lengths, active, use_kernel, *,
           q_lens=None, scale=None, block_h=None, interpret=False):
    b, q_rows, n_heads, head_dim = q.shape
    if q_lens is None:
        q_lens = torch.ones((b,), dtype=torch.int32, device=q.device)
    _num_pages, _page_size, pool_h, pool_d = k_pool.shape
    n_slots = page_table.shape[0]
    if (pool_h, pool_d) != (n_heads, head_dim):
        raise ValueError(
            f"pool heads/dim {(pool_h, pool_d)} != q {(n_heads, head_dim)}"
        )
    if n_slots != b:
        raise ValueError(f"page_table batch {n_slots} != q batch {b}")
    if block_h is None:
        block_h = default_paged_block_h(n_heads, head_dim, _page_size,
                                        k_pool.dtype)
    if n_heads % block_h:
        raise ValueError(f"block_h {block_h} must divide n_heads {n_heads}")
    scale = scale if scale is not None else 1.0 / (head_dim ** 0.5)
    if use_kernel:
        if interpret:
            raise ValueError(
                "interpret=True has no meaning for the CUDA kernel; pass CPU "
                "tensors to run the plain version"
            )
        return _paged_cuda(q, k_pool, v_pool, page_table, lengths, active,
                           q_lens, scale)
    return _paged_ref(q, k_pool, v_pool, page_table, lengths, active,
                      q_lens, scale)


def paged_pages_read(lengths, active, page_size: int, q_lens=None) -> int:
    """Pool pages a decode iteration actually reads (live pages summed
    over active slots) — the host-side mirror of the kernel's liveness
    predicate. With ``q_lens`` a slot's live window extends to
    ``lengths + q_lens − 1``."""
    lengths = np.asarray(lengths)
    active = np.asarray(active).astype(bool)
    if q_lens is None:
        q_lens = np.ones_like(lengths)
    q_lens = np.asarray(q_lens)
    return int(np.sum(
        np.where(active, (lengths + q_lens - 1) // page_size + 1, 0)
    ))
