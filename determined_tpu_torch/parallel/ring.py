"""Ring attention: exact attention over a sequence-sharded ``context`` axis.

Port of ``determined_tpu/parallel/ring.py``. Each rank of the context
group holds one sequence chunk of Q/K/V; the K/V chunks rotate around the
ring while every rank merges blockwise-softmax partials for its Q chunk
(numerically exact). The reference runs it inside ``shard_map`` with
``lax.ppermute``; here it is called per rank, on a context process group
of ``torch.distributed``:

- every hop is a ``flash_attention_lse`` call (the CUDA kernels on the
  card, their plain versions on the CPU), its block sizes fitted to that
  call's own lengths, so half-chunks and non-power-of-two local lengths
  work; the partials merge in fp32 (``_merge``), and the lse cotangent
  the merge produces flows back into the flash backward;
- the rotation is an autograd Function (``_Shift``): its forward sends
  each tensor to the next rank and receives from the previous one, its
  backward sends the cotangent the other way. Every rank issues the same
  rotations on every hop, a hop it skips included, and a skipped hop's
  K/V still join the graph (``_Keep``, a zero cotangent), so every rank
  runs every rotation's backward, in the same order;
- ``layout="zigzag"`` (causal): rank i holds global chunks (i, 2R−1−i),
  which balances causal work; the contiguous causal layout skips the
  hops whose chunk lies after its queries; ``window`` (contiguous only)
  is one kernel call per hop at ``kv_offset = hop·L`` and stops rotating
  K/V after the last hop the window can reach;
- ``segment_ids`` (packed documents) rotate with K/V, without gradient.

The transport (``Ring.transport``): ``batch_isend_irecv`` of the tensors
themselves on NCCL and for CPU tensors on gloo; CUDA tensors on gloo,
whose point-to-point ops take host memory only, are staged explicitly
through pinned host buffers (``"gloo-host"``). ``Ring.stats`` counts
every ring's rotations in this process and their bytes.

``make_ring_attention`` is the global-array helper, as the reference's
``shard_map`` wrapper: global [B, S, H, D] tensors that are the same on
every rank, each rank's rows and columns through the ring, the result
gathered back (permuted into and out of zigzag order when asked).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from determined_tpu_torch.models.attention import (  # noqa: F401 (re-export)
    reference_attention,
)
from determined_tpu_torch.ops.flash_attention import (
    fit_block,
    flash_attention_lse,
)


# ---------------------------------------------------------------------------
# Zigzag chunk placement (numpy, as the reference)
# ---------------------------------------------------------------------------
def zigzag_indices(seq_len: int, ring_size: int) -> np.ndarray:
    """Permutation taking contiguous global order → zigzag device order.

    The sequence splits into 2R chunks; device i owns chunks (i, 2R−1−i)
    concatenated. Under a causal mask this balances work exactly.
    """
    if seq_len % (2 * ring_size):
        raise ValueError(
            f"zigzag needs seq_len ({seq_len}) divisible by 2*ring ({2 * ring_size})"
        )
    chunk = seq_len // (2 * ring_size)
    order = []
    for i in range(ring_size):
        order.extend(range(i * chunk, (i + 1) * chunk))
        j = 2 * ring_size - 1 - i
        order.extend(range(j * chunk, (j + 1) * chunk))
    return np.asarray(order, dtype=np.int32)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return inv


# ---------------------------------------------------------------------------
# Partial-softmax merge
# ---------------------------------------------------------------------------
def _merge(acc, lse_run, o_p, lse_p):
    """Fold a normalized partial (o_p, lse_p) into the running (acc, lse).

    acc/lse_run: fp32 [B, S, H, D] / [B, S, H]; differentiable end to end
    (lse_p carries a cotangent back into the flash backward).
    """
    lse_new = torch.logaddexp(lse_run, lse_p)
    # Slots nothing has touched yet have lse_run = lse_new = −inf; the
    # subtraction would be NaN. They contribute weight 0 either way.
    # (Fully-masked rows from the kernel come back at ≈ −1e30, which is
    # finite — exp(−1e30 − safe) underflows to the same weight 0.)
    safe = torch.where(torch.isneginf(lse_new), 0.0, lse_new)
    w_old = torch.where(torch.isneginf(lse_run), 0.0, torch.exp(lse_run - safe))
    w_new = torch.where(torch.isneginf(lse_p), 0.0, torch.exp(lse_p - safe))
    acc_new = acc * w_old[..., None] + o_p.float() * w_new[..., None]
    return acc_new, lse_new


# ---------------------------------------------------------------------------
# The ring: its group, its transport and the differentiable rotation
# ---------------------------------------------------------------------------
class Ring:
    """One context group's ring: this rank's index, its size and its
    transport. ``stats``: the rotations of every ring of this process
    (``shifts``: batches of sends and receives; ``bytes``: sent)."""

    stats: Dict[str, int] = {"shifts": 0, "bytes": 0}

    def __init__(self, group: Any = None, axis_name: str = "context") -> None:
        import torch.distributed as dist

        if group is not None and hasattr(group, "mesh_dim_names"):
            # a DeviceMesh: the group of its `axis_name` dimension
            self.index = int(group.get_local_rank(axis_name))
            group = group.get_group(axis_name)
        else:
            self.index = int(dist.get_rank(group))
        self.group = group
        self.size = int(dist.get_world_size(group))
        self.backend = str(dist.get_backend(group))

    def transport(self, device: torch.device) -> str:
        if self.backend == "gloo" and device.type == "cuda":
            return "gloo-host"
        return self.backend

    def shift(self, xs: Sequence[torch.Tensor],
              step: int = 1) -> List[torch.Tensor]:
        """Each tensor to the rank `step` places on, this rank's from the
        rank `step` places back (one batch of sends and receives)."""
        import torch.distributed as dist

        if self.size == 1:
            return list(xs)
        dst = (self.index + step) % self.size
        src = (self.index - step) % self.size
        staged = self.transport(xs[0].device) == "gloo-host"
        sends, outs = [], []
        for x in xs:
            x = x.contiguous()
            if staged:
                host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                host.copy_(x)
                sends.append(host)
                outs.append(torch.empty(x.shape, dtype=x.dtype,
                                        pin_memory=True))
            else:
                sends.append(x)
                outs.append(torch.empty_like(x))
            Ring.stats["bytes"] += x.numel() * x.element_size()
        ops = [dist.P2POp(dist.isend, t, group=self.group, group_peer=dst)
               for t in sends]
        ops += [dist.P2POp(dist.irecv, t, group=self.group, group_peer=src)
                for t in outs]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        Ring.stats["shifts"] += 1
        if staged:
            return [t.to(x.device, non_blocking=True)
                    for t, x in zip(outs, xs)]
        return outs


class _Shift(torch.autograd.Function):
    """K/V one place on around the ring; the cotangents one place back."""

    @staticmethod
    def forward(ctx, ring, *xs):
        ctx.ring = ring
        return tuple(ring.shift(xs, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.ring.shift(grads, -1))


class _Keep(torch.autograd.Function):
    """`acc` unchanged; `xs` join the graph with a zero cotangent, so the
    rotation that produced them runs its backward on this rank too."""

    @staticmethod
    def forward(ctx, acc, *xs):
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return acc.view_as(acc)

    @staticmethod
    def backward(ctx, grad):
        return (grad, *(torch.zeros(s, dtype=d, device=dev)
                        for s, d, dev in ctx.like))


def _rotate(ring: Ring, k, v, kseg):
    k, v = _Shift.apply(ring, k, v)
    if kseg is not None:
        (kseg,) = ring.shift([kseg])
    return k, v, kseg


# ---------------------------------------------------------------------------
# Core (per rank, on the context group)
# ---------------------------------------------------------------------------
def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    axis_name: str = "context",
    group: Any = None,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 512,
    block_k: int = 512,
    layout: str = "contiguous",
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact attention with Q/K/V sequence-sharded over a context group.

    Call on every rank of the group. Shapes per rank: [B, S_local, H, D];
    `segment_ids` (optional) is this rank's [B, S_local] id slice.
    `group`: a ``Ring``, a process group (None: the default one) or a
    ``DeviceMesh`` (its `axis_name` dimension).

    layout="contiguous": ranks hold consecutive chunks in group order;
    `window` (sliding window) is supported on this layout only.
    layout="zigzag" (causal only): rank i holds global chunks
    (i, 2R−1−i) — see `zigzag_indices`. Windowed zigzag raises.
    """
    ring = group if isinstance(group, Ring) else Ring(group, axis_name)
    ring_size, my_idx = ring.size, ring.index
    b, s_local, h, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring layout {layout!r}")
    if window is not None:
        if not causal:
            raise ValueError("window (sliding-window) requires causal=True")
        if layout == "zigzag":
            raise ValueError(
                "window is supported with layout='contiguous' only: zigzag "
                "interleaves two global chunks per device, so a hop's "
                "q↔kv offset isn't a single static kv_offset"
            )
    has_segs = segment_ids is not None
    qseg = segment_ids

    def flash(q_, k_, v_, *, causal, window=None, kv_offset=0, qseg=None,
              kseg=None):
        # block | seq: shrink to the largest divisor of each call's own
        # lengths (half-chunks included).
        return flash_attention_lse(
            q_, k_, v_, causal=causal, scale=scale,
            block_q=fit_block(q_.shape[1], block_q),
            block_k=fit_block(k_.shape[1], block_k),
            window=window, kv_offset=kv_offset,
            segment_ids=qseg, kv_segment_ids=kseg,
        )

    if ring_size == 1:
        o, _ = flash(q, k, v, causal=causal, window=window, qseg=qseg,
                     kseg=qseg)
        return o

    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse_run = torch.full((b, s_local, h), float("-inf"), dtype=torch.float32,
                         device=q.device)
    k_cur, v_cur, kseg_cur = k, v, qseg

    if not causal:
        # Every hop attends the full received chunk; layout is irrelevant.
        for s_hop in range(ring_size):
            o_p, lse_p = flash(q, k_cur, v_cur, causal=False, qseg=qseg,
                               kseg=kseg_cur)
            acc, lse_run = _merge(acc, lse_run, o_p, lse_p)
            if s_hop + 1 < ring_size:
                k_cur, v_cur, kseg_cur = _rotate(ring, k_cur, v_cur, kseg_cur)
        return acc.to(q.dtype)

    if window is not None:
        # Hop s attends the kv chunk s·L tokens behind — a static
        # kv_offset. Hops with s·L ≥ W + L − 1 can't reach the window for
        # any row and are not emitted: K/V stop rotating after the last
        # reachable hop, on every rank at once.
        hops = min(ring_size, (window + s_local - 2) // s_local + 1)
        for s_hop in range(hops):
            if s_hop == 0:
                o_p, lse_p = flash(q, k_cur, v_cur, causal=True,
                                   window=window, qseg=qseg, kseg=kseg_cur)
                acc, lse_run = _merge(acc, lse_run, o_p, lse_p)
            elif s_hop <= my_idx:
                o_p, lse_p = flash(q, k_cur, v_cur, causal=True,
                                   window=window, kv_offset=s_hop * s_local,
                                   qseg=qseg, kseg=kseg_cur)
                acc, lse_run = _merge(acc, lse_run, o_p, lse_p)
            else:
                # fewer than s_hop predecessors: a wrapped (future) chunk
                acc = _Keep.apply(acc, k_cur, v_cur)
            if s_hop + 1 < hops:
                k_cur, v_cur, kseg_cur = _rotate(ring, k_cur, v_cur, kseg_cur)
        return acc.to(q.dtype)

    if layout == "zigzag":
        if s_local % 2:
            raise ValueError("zigzag layout needs an even local sequence")
        c = s_local // 2
        q1, q2 = q[:, :c], q[:, c:]
        qseg1 = qseg[:, :c] if has_segs else None
        qseg2 = qseg[:, c:] if has_segs else None
        for s_hop in range(ring_size):
            kv_idx = (my_idx - s_hop) % ring_size
            kseg1 = kseg_cur[:, :c] if has_segs else None
            if kv_idx == my_idx:
                # own chunks (i, 2R−1−i): q1·k1 and q2·k2 causal
                # triangles, q2·k1 a full block
                k1, k2 = k_cur[:, :c], k_cur[:, c:]
                v1, v2 = v_cur[:, :c], v_cur[:, c:]
                kseg2 = kseg_cur[:, c:] if has_segs else None
                o11, l11 = flash(q1, k1, v1, causal=True, qseg=qseg1,
                                 kseg=kseg1)
                o21, l21 = flash(q2, k1, v1, causal=False, qseg=qseg2,
                                 kseg=kseg1)
                o22, l22 = flash(q2, k2, v2, causal=True, qseg=qseg2,
                                 kseg=kseg2)
                acc1, lse1 = _merge(acc[:, :c], lse_run[:, :c], o11, l11)
                acc2, lse2 = _merge(acc[:, c:], lse_run[:, c:], o21, l21)
                acc2, lse2 = _merge(acc2, lse2, o22, l22)
                acc = torch.cat([acc1, acc2], dim=1)
                lse_run = torch.cat([lse1, lse2], dim=1)
            elif kv_idx < my_idx:
                # kv from rank j < i: its first chunk (j) precedes both of
                # ours → full attend; its second (2R−1−j) follows both
                o_p, lse_p = flash(q, k_cur[:, :c], v_cur[:, :c],
                                   causal=False, qseg=qseg, kseg=kseg1)
                acc, lse_run = _merge(acc, lse_run, o_p, lse_p)
            else:
                # kv from rank j > i: both its chunks precede our second
                # chunk and follow our first → only q2 attends, all of it
                o_p, lse_p = flash(q2, k_cur, v_cur, causal=False,
                                   qseg=qseg2, kseg=kseg_cur)
                acc2, lse2 = _merge(acc[:, c:], lse_run[:, c:], o_p, lse_p)
                acc = torch.cat([acc[:, :c], acc2], dim=1)
                lse_run = torch.cat([lse_run[:, :c], lse2], dim=1)
            if s_hop + 1 < ring_size:
                k_cur, v_cur, kseg_cur = _rotate(ring, k_cur, v_cur, kseg_cur)
        return acc.to(q.dtype)

    # Contiguous causal: chunk j contributes fully when j < i, triangularly
    # when j == i, never when j > i (skipped, its K/V kept in the graph).
    for s_hop in range(ring_size):
        kv_idx = (my_idx - s_hop) % ring_size
        if kv_idx > my_idx:
            acc = _Keep.apply(acc, k_cur, v_cur)
        else:
            o_p, lse_p = flash(q, k_cur, v_cur, causal=kv_idx == my_idx,
                               qseg=qseg, kseg=kseg_cur)
            acc, lse_run = _merge(acc, lse_run, o_p, lse_p)
        if s_hop + 1 < ring_size:
            k_cur, v_cur, kseg_cur = _rotate(ring, k_cur, v_cur, kseg_cur)
    return acc.to(q.dtype)


# ---------------------------------------------------------------------------
# Global-array wrapper
# ---------------------------------------------------------------------------
class _Local(torch.autograd.Function):
    """A global tensor that is the same on every rank → this rank's block
    (a slice per split dimension); the backward all-gathers the blocks'
    cotangents, so every rank gets the whole gradient."""

    @staticmethod
    def forward(ctx, x, splits):
        ctx.splits = splits
        for dim, group, index, size in splits:
            n = x.shape[dim] // size
            x = x.narrow(dim, index * n, n)
        return x.contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad.contiguous(), ctx.splits), None


class _Global(torch.autograd.Function):
    """This rank's block → the global tensor, all-gathered; the backward
    takes this rank's block of a cotangent that is the same on every
    rank."""

    @staticmethod
    def forward(ctx, x, splits):
        ctx.splits = splits
        return _gather(x.contiguous(), splits)

    @staticmethod
    def backward(ctx, grad):
        for dim, group, index, size in ctx.splits:
            n = grad.shape[dim] // size
            grad = grad.narrow(dim, index * n, n)
        return grad.contiguous(), None


def _gather(x: torch.Tensor, splits) -> torch.Tensor:
    import torch.distributed as dist

    for dim, group, index, size in reversed(splits):
        if size == 1:
            continue
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        x = torch.cat(parts, dim=dim)
    return x


def mesh_splits(mesh: Any, axes: Sequence[str], dim: int) -> tuple:
    """``_Local`` / ``_Global`` splits of dimension `dim` over the mesh
    `axes` (outer first): (dim, group, this rank's index, size) each."""
    names = mesh.mesh_dim_names
    return tuple(
        (dim, mesh.get_group(a), int(mesh.get_local_rank(a)),
         int(mesh.shape[names.index(a)])) for a in axes)


def make_ring_attention(
    mesh: Any,
    *,
    causal: bool = True,
    batch_axes: Tuple[str, ...] = ("data", "fsdp"),
    seq_axis: str = "context",
    heads_axis: str = "tensor",
    zigzag: Optional[bool] = None,
    block_q: int = 512,
    block_k: int = 512,
    data_layout: str = "contiguous",
    window: Optional[int] = None,
):
    """ring_attention over a DeviceMesh, on global [B, S, H, D] tensors.

    Returns a callable `(q, k, v, segment_ids=None) -> o`: the inputs are
    the same on every rank; each rank takes its rows (over `batch_axes`),
    its sequence chunk (over `seq_axis`) and its heads (over
    `heads_axis`), runs the ring, and the output is gathered back whole
    on every rank. Differentiable: a
    cotangent that is the same on every rank gives every rank the whole
    input gradients.

    With zigzag (default for causal, unless a window forces contiguous)
    the global sequence is permuted into zigzag order first and the
    output permuted back. data_layout="zigzag": the inputs are already in
    zigzag order (a zigzag-emitting loader) and run without the permute.
    """
    if zigzag is None:
        zigzag = causal and window is None
    ring = Ring(mesh, seq_axis)
    # segment ids [B, S] take the rows and the columns; q/k/v the heads too
    seg_splits = (mesh_splits(mesh, batch_axes, 0)
                  + ((1, ring.group, ring.index, ring.size),))
    splits = seg_splits + mesh_splits(mesh, (heads_axis,), 2)

    def call(layout, q, k, v, segment_ids=None):
        local = [_Local.apply(x, splits) for x in (q, k, v)]
        seg = None
        if segment_ids is not None:
            seg = _Local.apply(segment_ids, seg_splits)
        o = ring_attention(
            *local, group=ring, causal=causal, block_q=block_q,
            block_k=block_k, layout=layout, window=window, segment_ids=seg)
        return _Global.apply(o, splits)

    if data_layout == "zigzag":
        if not causal or ring.size <= 1:
            raise ValueError(
                "data_layout='zigzag' needs causal attention and a sharded "
                f"context axis (ring={ring.size})"
            )
        if window is not None:
            raise ValueError(
                "window needs the contiguous ring layout (static per-hop "
                "offsets); emit contiguous data or drop the window"
            )
        return functools.partial(call, "zigzag")

    if not (zigzag and causal and ring.size > 1):
        return functools.partial(call, "contiguous")

    def wrapper(q, k, v, segment_ids=None):
        s = q.shape[1]
        if s % (2 * ring.size):
            # won't split into 2R chunks: the contiguous ring is exact too
            return call("contiguous", q, k, v, segment_ids)
        perm = torch.as_tensor(zigzag_indices(s, ring.size), device=q.device,
                               dtype=torch.long)
        inv = torch.as_tensor(inverse_permutation(perm.cpu().numpy()),
                              device=q.device, dtype=torch.long)
        qz, kz, vz = (x.index_select(1, perm) for x in (q, k, v))
        segz = (None if segment_ids is None
                else segment_ids.index_select(1, perm))
        return call("zigzag", qz, kz, vz, segz).index_select(1, inv)

    return wrapper
