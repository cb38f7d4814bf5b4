"""Flash attention: hand-written CUDA kernels plus their plain PyTorch
versions, forward and backward.

Port of ``determined_tpu/ops/flash_attention.py``:

- ``flash_attention`` / ``flash_attention_lse`` keep the reference's
  signature, ``[B, S, H, D]`` layout, masking model and validation errors.
  Masking: ``causal`` (row r attends cols <= r), ``window=W`` (also only
  cols > r − W; requires causal), ``kv_offset`` (q positions sit
  ``kv_offset`` after k positions — the bottom-aligned decode geometry),
  and ``segment_ids`` / ``kv_segment_ids`` (attention only within equal
  ids). A query row that matches no key gets o = 0 and lse ≈ −1e30.
- Both outputs are differentiable (``_FlashLse``, the counterpart of the
  reference's ``_flash_lse`` custom_vjp): the backward takes (do, dlse), a
  missing cotangent counts as zeros, and segment ids get no gradient.
- On CUDA tensors the forward launches ``csrc/flash_fwd_mono.cu`` (port of
  ``_fwd_kernel_mono``) exactly when the reference's ``_mono_ok`` holds —
  block == seq, s_q·s_k <= 2^21, no window, segment ids or kv_offset —
  and ``csrc/flash_fwd.cu`` (port of the blocked ``_fwd_kernel``)
  otherwise. The backward follows the reference's route (``_bwd_route``,
  its ``_flash_bwd_pallas`` predicate): ``csrc/flash_bwd_mono.cu`` (port
  of ``_bwd_kernel_mono``) when ``_mono_ok`` holds; else the fused
  blocked kernel ``csrc/flash_bwd_blocked.cu`` (port of
  ``_bwd_fused_blocked_kernel``) while the reference's dq partials
  ``bh·nk·s_q·d·4`` bytes fit under ``_FUSED_BWD_PARTIALS_CAP``; else the
  two-pass ``csrc/flash_bwd_dq.cu`` + ``csrc/flash_bwd_dkv.cu`` (ports of
  ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``). ``nk`` counts the
  reference's key blocks (``block_k``), so the port runs the mono, fused
  or two-pass backward exactly where the reference does.
- In bf16, every flash kernel runs its products as Hopper ``wgmma`` on
  tiles that TMA brings into shared memory (``csrc/sm90.cuh``; the fused
  backward and the dk/dv pass share one kernel,
  ``csrc/bwd_blocked_sm90.cuh``; the dq pass is the blocked forward's
  q-major walk with dq in registers; the mono pair run as persistent
  kernels, one CTA a SM);
  TMA wants 16-byte-aligned bases and strides, so their wrappers copy a
  view that breaks that rule (``_tma_ready``, ``_sm90_inputs``) before
  the launch. In fp32 every kernel reads through strides.
- On CPU tensors forward and backward run the reference's CPU path, the
  blockwise online-softmax scan and its backward (``_blockwise_fwd_ref``,
  ``_blockwise_bwd_ref``). ``_mono_fwd_plain``, ``_blocked_fwd_plain``
  and ``_blocked_bwd_plain`` are the kernels' dense formulas, bf16
  roundings included (p rounded to v's dtype before p·v; the mono
  backward's formula is the blocked one without window, segments or
  offset): what the kernel-level wrappers (``flash_fwd``,
  ``flash_fwd_mono``, ``flash_bwd_mono``, ``flash_bwd_blocked``,
  ``flash_bwd_dq``, ``flash_bwd_dkv``) run on CPU tensors and what the
  card's kernels are held against. There is no fallback from a kernel to
  a plain version.

``block_q`` / ``block_k`` keep the reference's meaning for validation, for
the mono dispatch and for the plain version's K/V blocking; the CUDA
kernels pick their own tiles.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from determined_tpu_torch.ops import _build

NEG_INF = float(-1e30)  # finite mask value; true -inf breaks m-subtraction

#: The CUDA kernels' library handles; ``.launches`` counts launches.
FLASH_FWD = _build.FLASH_FWD
FLASH_FWD_MONO = _build.FLASH_FWD_MONO
FLASH_BWD_MONO = _build.FLASH_BWD_MONO
FLASH_BWD_BLOCKED = _build.FLASH_BWD_BLOCKED
FLASH_BWD_DQ = _build.FLASH_BWD_DQ
FLASH_BWD_DKV = _build.FLASH_BWD_DKV


def fit_block(seq: int, want: int) -> int:
    """Largest block size ≤ `want` dividing `seq` (the kernel requires
    block | seq). Prefers lane-friendly multiples of 128 when one divides;
    falls back to the largest plain divisor."""
    want = min(want, seq)
    for b in range(want - want % 128, 0, -128):
        if seq % b == 0:
            return b
    b = want
    while seq % b:
        b -= 1
    return b


# ---------------------------------------------------------------------------
# Plain versions: the reference's blockwise scan and its backward, in torch
# ---------------------------------------------------------------------------
def _ref_block_mask(rows, cols, *, causal, window, kv_offset, qseg, kseg_j):
    """[.., s_q, bk] bool mask (or None). `rows` is [s_q] LOCAL q indices,
    `cols` [bk] global k indices; `qseg` [BH, s_q] and `kseg_j` [BH, bk]
    fp32 ids."""
    grows = rows + kv_offset
    mask = None
    if causal:
        mask = grows[:, None] >= cols[None, :]
    if window is not None:
        wm = grows[:, None] - cols[None, :] < window
        mask = wm if mask is None else mask & wm
    if mask is not None:
        mask = mask[None]  # broadcast over BH
    if qseg is not None:
        sm = qseg[:, :, None] == kseg_j[:, None, :]
        mask = sm if mask is None else mask & sm
    return mask


def _block_mask(j, block_k, rows, *, causal, window, kv_offset, segs):
    """The mask of K/V block j, or None when nothing is masked."""
    if not (causal or window is not None or segs is not None):
        return None
    cols = torch.arange(j * block_k, (j + 1) * block_k, device=rows.device)
    return _ref_block_mask(
        rows, cols, causal=causal, window=window, kv_offset=kv_offset,
        qseg=segs[0] if segs is not None else None,
        kseg_j=(segs[1][:, j * block_k:(j + 1) * block_k]
                if segs is not None else None),
    )


def _blockwise_fwd_ref(q, k, v, *, scale, causal, block_k, window=None,
                       kv_offset=0, segs=None):
    """q/k/v [BH, S, D] (+ segs ([BH, Sq], [BH, Sk]) fp32) → (o [BH, Sq, D]
    in q's dtype, lse [BH, Sq] fp32): online softmax over K/V blocks with
    fp32 scores, probabilities and accumulator."""
    bh, s_q, d = q.shape
    s_k = k.shape[1]
    dev = q.device
    q32 = q.float()
    rows = torch.arange(s_q, device=dev)
    m = torch.full((bh, s_q), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, s_q), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, s_q, d), dtype=torch.float32, device=dev)
    for j in range(s_k // block_k):
        sl = slice(j * block_k, (j + 1) * block_k)
        s = torch.einsum("bqd,bkd->bqk", q32, k[:, sl].float()) * scale
        mask = _block_mask(j, block_k, rows, causal=causal, window=window,
                           kv_offset=kv_offset, segs=segs)
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqk,bkd->bqd", p, v[:, sl].float())
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (acc / l_safe[..., None]).to(q.dtype)
    lse = m + torch.log(l_safe)
    return o, lse


def _blockwise_bwd_ref(q, k, v, o, lse, do, *, scale, causal, block_k,
                       dlse=None, window=None, kv_offset=0, segs=None):
    """Flash backward: recompute per-block p from lse; O(S·block) memory.
    q/k/v/o/do [BH, S, D], lse (+ dlse) [BH, Sq] → (dq, dk, dv) in the
    inputs' dtypes. All arithmetic is fp32."""
    bh, s_q, d = q.shape
    s_k = k.shape[1]
    rows = torch.arange(s_q, device=q.device)
    q32 = q.float()
    do32 = do.float()
    delta = (do32 * o.float()).sum(dim=-1)  # [BH, Sq]
    if dlse is not None:
        # The lse cotangent folds into the same p∘(·) term as delta.
        delta = delta - dlse.float()
    dq = torch.zeros((bh, s_q, d), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for j in range(s_k // block_k):
        sl = slice(j * block_k, (j + 1) * block_k)
        k_j = k[:, sl].float()
        v_j = v[:, sl].float()
        s = torch.einsum("bqd,bkd->bqk", q32, k_j) * scale
        mask = _block_mask(j, block_k, rows, causal=causal, window=window,
                           kv_offset=kv_offset, segs=segs)
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - lse[..., None])
        if mask is not None:
            # all-masked rows carry lse ≈ NEG_INF: exp(s − lse) would
            # resurrect their masked entries as 1.
            p = torch.where(mask, p, 0.0)
        dvs.append(torch.einsum("bqk,bqd->bkd", p, do32))
        dp = torch.einsum("bqd,bkd->bqk", do32, v_j)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bqk,bkd->bqd", ds, k_j)
        dks.append(torch.einsum("bqk,bqd->bkd", ds, q32))
    dk = torch.cat(dks, dim=1) if dks else torch.zeros_like(k, dtype=torch.float32)
    dv = torch.cat(dvs, dim=1) if dvs else torch.zeros_like(v, dtype=torch.float32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Plain versions of the mono kernels: the dense formulas
# ---------------------------------------------------------------------------
def _causal_mask(s_q, s_k, device):
    rows = torch.arange(s_q, device=device)[:, None]
    return rows >= torch.arange(s_k, device=device)[None, :]


def _mono_fwd_plain(q, k, v, *, scale, causal):
    """``_fwd_kernel_mono``: q/k/v [BH, S, D] → (o [BH, Sq, D] in q's
    dtype, lse [BH, Sq] fp32). Plain softmax over the whole row in fp32;
    p is rounded to v's dtype before the p·v product. With no keys every
    row gets o = 0 and lse = NEG_INF."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        s = torch.where(_causal_mask(q.shape[1], k.shape[1], q.device), s,
                        NEG_INF)
    m = (s.amax(dim=-1, keepdim=True) if k.shape[1]
         else s.new_full((*s.shape[:-1], 1), NEG_INF))
    p = torch.exp(s - m)  # masked entries underflow to exactly 0
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    o = (acc / l_safe).to(q.dtype)
    return o, (m + torch.log(l_safe))[..., 0]


def _blocked_fwd_plain(q, k, v, *, scale, causal, window=None, kv_offset=0,
                       segs=None):
    """The blocked forward kernel's formula (``_fwd_kernel``), dense: q/k/v
    [BH, S, D], segs None or the ([BH, Sq], [BH, Sk]) fp32 ids → (o
    [BH, Sq, D] in q's dtype, lse [BH, Sq] fp32). fp32 scores and softmax
    over the whole row; p is zeroed where masked (a row that sees no key
    gets o = 0 and lse = NEG_INF) and rounded to v's dtype before p·v,
    while l sums the unrounded p."""
    s_q, s_k = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    mask = None
    if causal or window is not None or segs is not None:
        mask = _ref_block_mask(
            torch.arange(s_q, device=q.device),
            torch.arange(s_k, device=q.device), causal=causal, window=window,
            kv_offset=kv_offset, qseg=None if segs is None else segs[0],
            kseg_j=None if segs is None else segs[1],
        )
        s = torch.where(mask, s, NEG_INF)
    m = (s.amax(dim=-1, keepdim=True) if s_k
         else s.new_full((*s.shape[:-1], 1), NEG_INF))  # no key at all
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    o = (acc / l_safe).to(q.dtype)
    return o, (m + torch.log(l_safe))[..., 0]


def _blocked_bwd_plain(q, k, v, do, lse, delta, dlse, *, scale, causal,
                       window=None, kv_offset=0, segs=None):
    """The blocked backward kernels' formula (``_bwd_fused_blocked_kernel``,
    and ``_bwd_dq_kernel`` + ``_bwd_dkv_kernel`` together), dense:
    q/k/v/do [BH, S, D] in the compute dtype, lse/delta/dlse [BH, Sq]
    fp32, segs None or the ([BH, Sq], [BH, Sk]) fp32 ids → (dq, dk, dv)
    in the inputs' dtypes. p = exp(s − lse) is zeroed where masked (a row
    with no live key carries lse ≈ NEG_INF, where exp would resurrect its
    masked entries as 1); p is rounded to do's dtype before pᵀ·do, ds to
    q's dtype before ds·k and dsᵀ·q; every product accumulates in fp32."""
    s_q, s_k = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    mask = None
    if causal or window is not None or segs is not None:
        mask = _ref_block_mask(
            torch.arange(s_q, device=q.device),
            torch.arange(s_k, device=q.device), causal=causal, window=window,
            kv_offset=kv_offset, qseg=None if segs is None else segs[0],
            kseg_j=None if segs is None else segs[1],
        )
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    do32 = do.float()
    dv = torch.einsum("bqk,bqd->bkd", p.to(do.dtype).float(), do32)
    dp = torch.einsum("bqd,bkd->bqk", do32, v.float())
    ds = (p * (dp - delta[..., None] + dlse[..., None]) * scale).to(q.dtype)
    dq = torch.einsum("bqk,bkd->bqd", ds.float(), k.float())
    dk = torch.einsum("bqk,bqd->bkd", ds.float(), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _mono_bwd_plain(q, k, v, do, lse, delta, dlse, *, scale, causal):
    """``_bwd_kernel_mono``: the blocked formula with the causal mask
    alone (no window, segment ids or kv_offset)."""
    return _blocked_bwd_plain(q, k, v, do, lse, delta, dlse, scale=scale,
                              causal=causal)


def _fold(x):
    """[B, S, H, ...] → [B·H, S, ...]."""
    b, s, h = x.shape[:3]
    return x.transpose(1, 2).reshape(b * h, s, *x.shape[3:])


def _unfold(x, b, h):
    """[B·H, S, ...] → [B, S, H, ...]."""
    return x.reshape(b, h, *x.shape[1:]).transpose(1, 2)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------
def _last_dim_contiguous(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def _tma_ready(x: torch.Tensor) -> bool:
    """Whether a [B, S, H, D] tensor meets TMA's rules as the bf16 kernels
    read it: the head dim contiguous, a 16-byte-aligned base, and the
    batch, sequence and head strides multiples of 16 bytes (a dim of size
    1 has no stride that matters)."""
    item = x.element_size()
    return (
        x.stride(-1) == 1 and x.data_ptr() % 16 == 0
        and all(x.shape[i] == 1 or (x.stride(i) * item) % 16 == 0
                for i in range(x.dim() - 1))
    )


def _kernel_inputs(q, k, v):
    """Check q/k/v [B, S, H, D] for the CUDA kernels → (dtype code, q, k,
    v with the head dim contiguous)."""
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v must be on one device")
    d = q.shape[-1]
    if d not in _build.HEAD_DIMS:
        raise ValueError(
            f"head_dim {d} not supported by the CUDA kernel "
            f"(one of {_build.HEAD_DIMS})"
        )
    code = _build.dtype_code(q.dtype)
    return code, *(_last_dim_contiguous(x) for x in (q, k, v))


def _tma_inputs(code, *xs):
    """The bf16 paths of ``flash_fwd.cu``, ``flash_bwd_blocked.cu``,
    ``flash_bwd_dq.cu``, ``flash_bwd_dkv.cu`` and ``paged_attention.cu``
    load their tiles by TMA: a tensor that breaks its rules
    (``_tma_ready``) is copied contiguous into fresh, aligned memory
    first (``contiguous()`` would keep a contiguous view at a misaligned
    base as it is); the kernel is the same. fp32 tensors pass as they are
    (their kernels read through strides)."""
    if code == 0:
        return xs
    return tuple(x if _tma_ready(x) else
                 x.clone(memory_format=torch.contiguous_format) for x in xs)


def _sm90_inputs(q, k, v, *more):
    """Check q/k/v [B, S, H, D] (and more tensors of the same layout, cast
    to q's dtype: do) for a kernel whose bf16 path loads by TMA → (dtype
    code, q, k, v, *more with the head dim contiguous and, in bf16, TMA's
    rules met: ``_tma_inputs``)."""
    code, q, k, v = _kernel_inputs(q, k, v)
    more = (_last_dim_contiguous(x.to(q.dtype)) for x in more)
    return (code, *_tma_inputs(code, q, k, v, *more))


def _strides(*xs):
    return [s for x in xs for s in (x.stride(0), x.stride(1), x.stride(2))]


def _flash_fwd_cuda(q, k, v, *, scale, causal, window, kv_offset,
                    segment_ids, kv_segment_ids):
    """Blocked kernel: q/k/v [B, S, H, D] CUDA tensors (any strides with D
    contiguous; in bf16 a view that breaks TMA's alignment rules is copied
    contiguous first, ``_sm90_inputs``) → (o [B, Sq, H, D] in q's dtype,
    lse [B, Sq, H] fp32). With no keys every row is fully masked: o = 0,
    lse = NEG_INF, and no kernel runs."""
    code, q, k, v = _sm90_inputs(q, k, v)
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    qseg = kseg = None
    if segment_ids is not None:
        qseg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
        kseg = kv_segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, s_q, h), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    if s_k == 0:  # no key to attend (and no K/V for a TMA map to cover)
        return o.zero_(), lse.fill_(NEG_INF)
    FLASH_FWD.launch(
        code, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        qseg.data_ptr() if qseg is not None else None,
        kseg.data_ptr() if kseg is not None else None,
        o.data_ptr(), lse.data_ptr(), b, h, s_q, s_k,
        *_strides(q, k, v, o),
        int(causal), int(window or 0), int(kv_offset), float(scale),
        _build.stream_ptr(q.device),
    )
    return o, lse


def _flash_fwd_mono_cuda(q, k, v, *, scale, causal):
    """Mono kernel: q/k/v [B, S, H, D] CUDA tensors (any strides with D
    contiguous; in bf16 a view that breaks TMA's alignment rules is copied
    first, ``_sm90_inputs``) → (o [B, Sq, H, D] in q's dtype, lse
    [B, Sq, H] fp32). With no keys every row is fully masked: o = 0, lse =
    NEG_INF, and no kernel runs."""
    code, q, k, v = _sm90_inputs(q, k, v)
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    o = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, s_q, h), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    if s_k == 0:  # no key to attend (and no K/V for a TMA map to cover)
        return o.zero_(), lse.fill_(NEG_INF)
    FLASH_FWD_MONO.launch(
        code, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, s_q, s_k, *_strides(q, k, v, o),
        int(causal), float(scale), _build.stream_ptr(q.device),
    )
    return o, lse


def _flash_bwd_mono_cuda(q, k, v, do, lse, delta, dlse, *, scale, causal):
    """Mono backward kernel: q/k/v/do [B, S, H, D] CUDA tensors (in bf16 a
    view that breaks TMA's alignment rules is copied first,
    ``_sm90_inputs``), lse/delta (+ dlse, None = zeros) [B, Sq, H] fp32 →
    (dq, dk, dv) [B, S, H, D] in q's dtype. dq is summed in an fp32
    workspace by atomics, then cast. With no queries or no keys every
    gradient is zero and no kernel runs."""
    code, q, k, v, do = _sm90_inputs(q, k, v, do)
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    dq32 = torch.zeros((b, s_q, h, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, s_k, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if not (s_q and s_k and b * h):
        return dq32.to(q.dtype), dk.zero_(), dv.zero_()
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    if dlse is not None:
        dlse = dlse.float().contiguous()
    FLASH_BWD_MONO.launch(
        code, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        dlse.data_ptr() if dlse is not None else None,
        dq32.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, s_q, s_k,
        *_strides(q, k, v, do), int(causal), float(scale),
        _build.stream_ptr(q.device),
    )
    return dq32.to(q.dtype), dk, dv


def flash_fwd(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
              window: Optional[int] = None, kv_offset: int = 0,
              segment_ids: Optional[torch.Tensor] = None,
              kv_segment_ids: Optional[torch.Tensor] = None):
    """The blocked forward at the kernel level, q/k/v [B, S, H, D], segment
    ids [B, Sq] / [B, Sk] (kv ids default to the q ids) → (o, lse
    [B, Sq, H]): ``csrc/flash_fwd.cu`` on CUDA tensors,
    ``_blocked_fwd_plain`` on CPU tensors."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, scale=scale, causal=causal,
                               window=window, kv_offset=kv_offset,
                               segment_ids=segment_ids,
                               kv_segment_ids=kv_segment_ids)
    return flash_fwd_plain(q, k, v, causal=causal, scale=scale, window=window,
                           kv_offset=kv_offset, segment_ids=segment_ids,
                           kv_segment_ids=kv_segment_ids)


def flash_fwd_plain(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    window: Optional[int] = None, kv_offset: int = 0,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None):
    """``flash_fwd``'s plain version on any device."""
    b, _, h, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    o, lse = _blocked_fwd_plain(
        _fold(q), _fold(k), _fold(v), scale=scale, causal=causal,
        window=window, kv_offset=kv_offset,
        segs=_fold_segs(segment_ids, kv_segment_ids, h))
    return _unfold(o, b, h), _unfold(lse, b, h)


def flash_fwd_mono(q, k, v, *, causal: bool = True,
                   scale: Optional[float] = None):
    """The mono forward at the kernel level, q/k/v [B, S, H, D] → (o, lse
    [B, Sq, H]): the CUDA kernel on CUDA tensors, ``_mono_fwd_plain`` on
    CPU tensors."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if q.is_cuda:
        return _flash_fwd_mono_cuda(q, k, v, scale=scale, causal=causal)
    return flash_fwd_mono_plain(q, k, v, causal=causal, scale=scale)


def flash_fwd_mono_plain(q, k, v, *, causal: bool = True,
                         scale: Optional[float] = None):
    """``flash_fwd_mono``'s plain version on any device."""
    b, _, h, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    o, lse = _mono_fwd_plain(_fold(q), _fold(k), _fold(v), scale=scale,
                             causal=causal)
    return _unfold(o, b, h), _unfold(lse, b, h)


def flash_bwd_mono(q, k, v, do, lse, delta, dlse=None, *,
                   causal: bool = True, scale: Optional[float] = None):
    """The mono backward at the kernel level: q/k/v/do [B, S, H, D],
    lse/delta/dlse [B, Sq, H] fp32 (dlse None = zeros) → (dq, dk, dv): the
    CUDA kernel on CUDA tensors, ``_mono_bwd_plain`` on CPU tensors."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if q.is_cuda:
        return _flash_bwd_mono_cuda(q, k, v, do, lse, delta, dlse,
                                    scale=scale, causal=causal)
    return flash_bwd_mono_plain(q, k, v, do, lse, delta, dlse,
                                causal=causal, scale=scale)


def flash_bwd_mono_plain(q, k, v, do, lse, delta, dlse=None, *,
                         causal: bool = True, scale: Optional[float] = None):
    """``flash_bwd_mono``'s plain version on any device."""
    b, _, h, d = q.shape
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if dlse is None:
        dlse = torch.zeros_like(lse)
    grads = _mono_bwd_plain(
        _fold(q), _fold(k), _fold(v), _fold(do), _fold(lse), _fold(delta),
        _fold(dlse.float()), scale=scale, causal=causal,
    )
    return tuple(_unfold(g, b, h) for g in grads)


def _flash_bwd_blocked_cuda(kernel, q, k, v, do, lse, delta, dlse, qseg,
                            kseg, *, scale, causal, window, kv_offset):
    """One blocked backward kernel (``FLASH_BWD_BLOCKED``, ``_DQ`` or
    ``_DKV``): q/k/v/do [B, S, H, D] CUDA tensors (any strides with D
    contiguous), lse/delta (+ dlse, None = zeros) [B, Sq, H] fp32, segment
    ids [B, Sq] / [B, Sk] or None → (dq, dk, dv) [B, S, H, D] in q's
    dtype, None for what the kernel does not compute. The fused kernel
    sums dq in an fp32 workspace by atomics, then casts; the dq pass
    keeps dq in registers and writes it once. In bf16 all three load
    q/k/v/do by TMA, so a view that breaks TMA's alignment rules is
    copied contiguous first (``_tma_inputs``). With no queries or no keys
    every gradient is zero and no kernel runs."""
    code, q, k, v = _kernel_inputs(q, k, v)
    do = _last_dim_contiguous(do.to(q.dtype))
    q, k, v, do = _tma_inputs(code, q, k, v, do)
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    if dlse is not None:
        dlse = dlse.float().contiguous()
    if qseg is not None:
        qseg = qseg.to(device=q.device, dtype=torch.int32).contiguous()
        kseg = kseg.to(device=q.device, dtype=torch.int32).contiguous()
    dq = dk = dv = None
    if kernel is FLASH_BWD_BLOCKED:
        dq = torch.zeros((b, s_q, h, d), dtype=torch.float32, device=q.device)
    elif kernel is FLASH_BWD_DQ:
        dq = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    if kernel is not FLASH_BWD_DQ:
        dk = torch.empty((b, s_k, h, d), dtype=q.dtype, device=q.device)
        dv = torch.empty_like(dk)
    if not (s_q and s_k and b * h):
        return tuple(None if g is None else g.zero_().to(q.dtype)
                     for g in (dq, dk, dv))
    strides = (ctypes.c_longlong * 12)(*_strides(q, k, v, do))

    def ptr(x):
        return None if x is None else x.data_ptr()

    kernel.launch(
        code, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), ptr(dlse), ptr(qseg), ptr(kseg),
        ptr(dq), ptr(dk), ptr(dv), b, h, s_q, s_k, strides, int(causal),
        int(window or 0), int(kv_offset), float(scale),
        _build.stream_ptr(q.device),
    )
    if dq is not None:
        dq = dq.to(q.dtype)
    return dq, dk, dv


def _blocked_bwd(kernel, q, k, v, do, lse, delta, dlse, *, causal, scale,
                 window, kv_offset, segment_ids, kv_segment_ids):
    """The kernel-level blocked backward: `kernel` on CUDA tensors, the
    dense formula (``_blocked_bwd_plain``) when `kernel` is None or the
    tensors lie on the CPU. → (dq, dk, dv), None where the kernel
    computes nothing."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    if kernel is not None and q.is_cuda:
        return _flash_bwd_blocked_cuda(
            kernel, q, k, v, do, lse, delta, dlse, segment_ids,
            kv_segment_ids, scale=scale, causal=causal, window=window,
            kv_offset=kv_offset)
    b, _, h, _ = q.shape
    if dlse is None:
        dlse = torch.zeros_like(lse)
    grads = _blocked_bwd_plain(
        _fold(q), _fold(k), _fold(v), _fold(do), _fold(lse), _fold(delta),
        _fold(dlse.float()), scale=scale, causal=causal, window=window,
        kv_offset=kv_offset, segs=_fold_segs(segment_ids, kv_segment_ids, h),
    )
    dq, dk, dv = (_unfold(g, b, h) for g in grads)
    if kernel is FLASH_BWD_DQ:
        return dq, None, None
    if kernel is FLASH_BWD_DKV:
        return None, dk, dv
    return dq, dk, dv


def flash_bwd_blocked(q, k, v, do, lse, delta, dlse=None, *,
                      causal: bool = True, scale: Optional[float] = None,
                      window: Optional[int] = None, kv_offset: int = 0,
                      segment_ids: Optional[torch.Tensor] = None,
                      kv_segment_ids: Optional[torch.Tensor] = None):
    """The fused blocked backward at the kernel level: q/k/v/do
    [B, S, H, D], lse/delta/dlse [B, Sq, H] fp32 (dlse None = zeros),
    segment ids [B, Sq] / [B, Sk] (kv ids default to the q ids) → (dq, dk,
    dv): ``csrc/flash_bwd_blocked.cu`` on CUDA tensors,
    ``_blocked_bwd_plain`` on CPU tensors."""
    return _blocked_bwd(FLASH_BWD_BLOCKED, q, k, v, do, lse, delta, dlse,
                        causal=causal, scale=scale, window=window,
                        kv_offset=kv_offset, segment_ids=segment_ids,
                        kv_segment_ids=kv_segment_ids)


def flash_bwd_dq(q, k, v, do, lse, delta, dlse=None, *, causal: bool = True,
                 scale: Optional[float] = None, window: Optional[int] = None,
                 kv_offset: int = 0,
                 segment_ids: Optional[torch.Tensor] = None,
                 kv_segment_ids: Optional[torch.Tensor] = None):
    """The two-pass backward's dq pass at the kernel level (arguments as
    ``flash_bwd_blocked``) → dq: ``csrc/flash_bwd_dq.cu`` on CUDA tensors,
    the dense formula on CPU tensors."""
    return _blocked_bwd(FLASH_BWD_DQ, q, k, v, do, lse, delta, dlse,
                        causal=causal, scale=scale, window=window,
                        kv_offset=kv_offset, segment_ids=segment_ids,
                        kv_segment_ids=kv_segment_ids)[0]


def flash_bwd_dkv(q, k, v, do, lse, delta, dlse=None, *,
                  causal: bool = True, scale: Optional[float] = None,
                  window: Optional[int] = None, kv_offset: int = 0,
                  segment_ids: Optional[torch.Tensor] = None,
                  kv_segment_ids: Optional[torch.Tensor] = None):
    """The two-pass backward's dk/dv pass at the kernel level (arguments
    as ``flash_bwd_blocked``) → (dk, dv): ``csrc/flash_bwd_dkv.cu`` on
    CUDA tensors, the dense formula on CPU tensors."""
    return _blocked_bwd(FLASH_BWD_DKV, q, k, v, do, lse, delta, dlse,
                        causal=causal, scale=scale, window=window,
                        kv_offset=kv_offset, segment_ids=segment_ids,
                        kv_segment_ids=kv_segment_ids)[1:]


def flash_bwd_blocked_plain(q, k, v, do, lse, delta, dlse=None, *,
                            causal: bool = True,
                            scale: Optional[float] = None,
                            window: Optional[int] = None, kv_offset: int = 0,
                            segment_ids: Optional[torch.Tensor] = None,
                            kv_segment_ids: Optional[torch.Tensor] = None):
    """``flash_bwd_blocked``'s plain version on any device."""
    return _blocked_bwd(None, q, k, v, do, lse, delta, dlse, causal=causal,
                        scale=scale, window=window, kv_offset=kv_offset,
                        segment_ids=segment_ids,
                        kv_segment_ids=kv_segment_ids)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, dlse=None, **kwargs):
    """``flash_bwd_dq``'s plain version on any device."""
    return flash_bwd_blocked_plain(q, k, v, do, lse, delta, dlse,
                                   **kwargs)[0]


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, dlse=None, **kwargs):
    """``flash_bwd_dkv``'s plain version on any device."""
    return flash_bwd_blocked_plain(q, k, v, do, lse, delta, dlse,
                                   **kwargs)[1:]


def _bwd_dq_walk_plain(q, k, v, do, lse, delta, dlse=None, *,
                       causal: bool = True, scale: Optional[float] = None,
                       window: Optional[int] = None, kv_offset: int = 0,
                       segment_ids: Optional[torch.Tensor] = None,
                       kv_segment_ids: Optional[torch.Tensor] = None,
                       block_q: int = 128, block_k: int = 64):
    """The bf16 dq kernel's walk (``csrc/flash_bwd_dq.cu``), tile by tile
    (arguments as ``flash_bwd_dq``) → dq: row blocks of `block_q`, each
    walking the key tiles of `block_k` its rows can see (``keys_seen``),
    p zeroed where masked, ds rounded to the input dtype per tile, dq
    summed in fp32 in walk order. Used by the tests and ``chip_smoke.py``
    only; ``flash_bwd_dq_plain`` is the dense formula."""
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    if dlse is None:
        dlse = torch.zeros_like(lse)
    qf, kf, vf, dof = (_fold(x) for x in (q, k, v, do))
    lse_f, dterm = _fold(lse.float()), _fold(dlse.float() - delta.float())
    segs = _fold_segs(segment_ids, kv_segment_ids, h)
    dq = torch.zeros((b * h, s_q, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, s_q, block_q):
        rows = torch.arange(q0, min(q0 + block_q, s_q), device=q.device)
        lo, hi = 0, s_k - 1  # keys_seen
        if causal:
            hi = min(hi, int(rows[-1]) + kv_offset)
        if window is not None:
            lo = max(lo, q0 + kv_offset - (window - 1))
        q_r, do_r = qf[:, rows].float(), dof[:, rows].float()
        for t0 in range(lo // block_k * block_k, hi + 1, block_k):
            cols = torch.arange(t0, min(t0 + block_k, s_k), device=q.device)
            k_t = kf[:, cols].float()
            s = torch.einsum("bqd,bkd->bqk", q_r, k_t) * scale
            p = torch.exp(s - lse_f[:, rows, None])
            if causal or window is not None or segs is not None:
                mask = _ref_block_mask(
                    rows, cols, causal=causal, window=window,
                    kv_offset=kv_offset,
                    qseg=None if segs is None else segs[0][:, rows],
                    kseg_j=None if segs is None else segs[1][:, cols])
                p = torch.where(mask, p, 0.0)
            dp = torch.einsum("bqd,bkd->bqk", do_r, vf[:, cols].float())
            ds = (p * (dp + dterm[:, rows, None]) * scale).to(q.dtype)
            dq[:, rows] += torch.einsum("bqk,bkd->bqd", ds.float(), k_t)
    return _unfold(dq.to(q.dtype), b, h)


# ---------------------------------------------------------------------------
# Dispatch and skip accounting
# ---------------------------------------------------------------------------
#: Largest s_q*s_k of the reference's single-tile kernels (``_mono_ok``).
_MONO_MAX_SCORES = 2 ** 21


def _mono_ok(s_q, s_k, block_q, block_k, *, window=None, has_segments=False,
             kv_offset=0) -> bool:
    """The reference's mono predicate: on CUDA it picks the mono kernels
    (forward and backward) over the blocked ones."""
    return (
        block_q == s_q and block_k == s_k
        and s_q * s_k <= _MONO_MAX_SCORES
        and window is None and not has_segments and kv_offset == 0
    )


#: The reference's cap on its fused blocked backward's dq partials
#: (``[BH, nk, Sq, D]`` fp32 bytes); past it the two-pass kernels run.
#: Read at call time, so a test or a run can force the two-pass route.
_FUSED_BWD_PARTIALS_CAP = 1 << 30


def _bwd_route(bh, s_q, s_k, d, block_q, block_k, *, window=None,
               has_segments=False, kv_offset=0) -> str:
    """The reference's backward route (``_flash_bwd_pallas``): "mono" when
    ``_mono_ok`` holds; else "fused" while its dq partials
    ``bh·nk·s_q·d·4`` bytes (nk = key blocks of ``block_k``) fit under
    ``_FUSED_BWD_PARTIALS_CAP``; else "two_pass"."""
    if _mono_ok(s_q, s_k, block_q, block_k, window=window,
                has_segments=has_segments, kv_offset=kv_offset):
        return "mono"
    nk = -(-s_k // block_k)
    if bh * nk * s_q * d * 4 <= _FUSED_BWD_PARTIALS_CAP:
        return "fused"
    return "two_pass"


def block_skip_stats(s_q: int, s_k: int, block_q: int, block_k: int, *,
                     causal: bool = True, window: Optional[int] = None,
                     kv_offset: int = 0) -> Tuple[int, int]:
    """(live_blocks, total_blocks) of the reference's blocked forward grid
    — a pure-Python mirror of its liveness predicate, so a bench can
    report the causal-skip ratio without running a kernel. The mono path
    is a single fully-live block by construction."""
    block_q = fit_block(s_q, block_q)
    block_k = fit_block(s_k, block_k)
    if _mono_ok(s_q, s_k, block_q, block_k, window=window, kv_offset=kv_offset):
        return 1, 1
    nq = -(-s_q // block_q)
    nk = -(-s_k // block_k)
    if not causal and window is None:
        return nq * nk, nq * nk
    live = 0
    for i in range(nq):
        first_q = i * block_q + kv_offset
        last_q = first_q + block_q - 1
        for j in range(nk):
            first_k = j * block_k
            last_k = first_k + block_k - 1
            ok = True
            if causal:
                ok = ok and first_k <= last_q
            if window is not None:
                ok = ok and last_k >= first_q - (window - 1)
            live += int(ok)
    return live, nq * nk


# ---------------------------------------------------------------------------
# Forward/backward routing and the autograd Function
# ---------------------------------------------------------------------------
class _Opts(NamedTuple):
    """The non-tensor arguments of one attention call."""
    use_kernel: bool
    scale: float
    causal: bool
    block_q: int
    block_k: int
    window: Optional[int]
    kv_offset: int

    def mono(self, s_q, s_k, has_segments) -> bool:
        return _mono_ok(s_q, s_k, self.block_q, self.block_k,
                        window=self.window, has_segments=has_segments,
                        kv_offset=self.kv_offset)


def _fold_segs(qseg, kseg, h):
    """[B, S] ids → the plain versions' ([BH, Sq], [BH, Sk]) fp32 pair."""
    if qseg is None:
        return None

    def fold(seg):
        b, s = seg.shape
        return seg.float()[:, None, :].expand(b, h, s).reshape(b * h, s)

    return fold(qseg), fold(kseg)


def _flash_core(q, k, v, qseg, kseg, opts: _Opts):
    """→ (o [B, Sq, H, D], lse [B, Sq, H] fp32), no autograd."""
    b, s_q, h, _ = q.shape
    s_k = k.shape[1]
    if opts.use_kernel:
        if opts.mono(s_q, s_k, qseg is not None):
            return _flash_fwd_mono_cuda(q, k, v, scale=opts.scale,
                                        causal=opts.causal)
        return _flash_fwd_cuda(
            q, k, v, scale=opts.scale, causal=opts.causal,
            window=opts.window, kv_offset=opts.kv_offset,
            segment_ids=qseg, kv_segment_ids=kseg,
        )
    o, lse = _blockwise_fwd_ref(
        _fold(q), _fold(k), _fold(v), scale=opts.scale, causal=opts.causal,
        block_k=opts.block_k, window=opts.window, kv_offset=opts.kv_offset,
        segs=_fold_segs(qseg, kseg, h),
    )
    return _unfold(o, b, h), _unfold(lse, b, h)


def _flash_bwd(q, k, v, o, lse, do, dlse, qseg, kseg, opts: _Opts):
    """→ (dq, dk, dv) [B, S, H, D]: on CUDA the kernels of the
    reference's route (``_bwd_route``), the blockwise backward on CPU."""
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    if opts.use_kernel:
        route = _bwd_route(b * h, s_q, s_k, d, opts.block_q, opts.block_k,
                           window=opts.window, has_segments=qseg is not None,
                           kv_offset=opts.kv_offset)
        # delta = Σ do·o in fp32, outside the kernel (as the reference).
        delta = (do.float() * o.float()).sum(dim=-1)
        if route == "mono":
            return _flash_bwd_mono_cuda(q, k, v, do, lse, delta, dlse,
                                        scale=opts.scale, causal=opts.causal)
        args = (q, k, v, do, lse, delta, dlse, qseg, kseg)
        kw = dict(scale=opts.scale, causal=opts.causal, window=opts.window,
                  kv_offset=opts.kv_offset)
        if route == "fused":
            return _flash_bwd_blocked_cuda(FLASH_BWD_BLOCKED, *args, **kw)
        dq = _flash_bwd_blocked_cuda(FLASH_BWD_DQ, *args, **kw)[0]
        _, dk, dv = _flash_bwd_blocked_cuda(FLASH_BWD_DKV, *args, **kw)
        return dq, dk, dv
    grads = _blockwise_bwd_ref(
        _fold(q), _fold(k), _fold(v), _fold(o), _fold(lse), _fold(do),
        scale=opts.scale, causal=opts.causal, block_k=opts.block_k,
        dlse=None if dlse is None else _fold(dlse), window=opts.window,
        kv_offset=opts.kv_offset, segs=_fold_segs(qseg, kseg, h),
    )
    return tuple(_unfold(g, b, h) for g in grads)


class _FlashLse(torch.autograd.Function):
    """Differentiable (o, lse): the lse cotangent feeds the ds term of the
    backward (ring attention's partial-softmax merge differentiates
    through it). Segment ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, qseg, kseg, opts):
        o, lse = _flash_core(q, k, v, qseg, kseg, opts)
        ctx.save_for_backward(q, k, v, o, lse, qseg, kseg)
        ctx.opts = opts
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, qseg, kseg = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, dlse, qseg, kseg,
                                ctx.opts)
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------
def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 512,
    block_k: int = 512,
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    kv_offset: int = 0,
) -> torch.Tensor:
    """Fused attention; q/k/v: [B, S, H, D]. Delegates to
    flash_attention_lse (one shape contract) and drops the lse."""
    o, _ = flash_attention_lse(
        q, k, v, causal=causal, scale=scale, block_q=block_q, block_k=block_k,
        window=window, segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
        kv_offset=kv_offset,
    )
    return o


def flash_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 512,
    block_k: int = 512,
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    kv_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """flash_attention that also returns the log-sum-exp per query.

    q/k/v: [B, S, H, D] → (o [B, Sq, H, D], lse [B, Sq, H] fp32), both
    differentiable. window: sliding-window size W (requires causal) —
    query position p attends key positions in (p − W, p]. segment_ids /
    kv_segment_ids: [B, Sq] / [B, Sk] int ids; kv_segment_ids defaults to
    segment_ids (requires s_q == s_k). kv_offset: query row r sits at
    absolute position kv_offset + r in the key frame.

    Launches the CUDA kernels on CUDA tensors, the plain version on CPU
    tensors.
    """
    return _lse(
        q, k, v, q.is_cuda, causal=causal, scale=scale, block_q=block_q,
        block_k=block_k, window=window, segment_ids=segment_ids,
        kv_segment_ids=kv_segment_ids, kv_offset=kv_offset,
    )


def flash_attention_lse_plain(q, k, v, **kwargs):
    """flash_attention_lse's plain version on any device (same arguments
    and validation): what the CPU path runs, and what a kernel launch is
    held against on the card."""
    return _lse(q, k, v, False, **kwargs)


def _lse(q, k, v, use_kernel, *, causal=True, scale=None, block_q=512,
         block_k=512, window=None, segment_ids=None, kv_segment_ids=None,
         kv_offset=0):
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    if kv_offset < 0:
        raise ValueError(f"kv_offset must be >= 0, got {kv_offset}")
    if window is not None:
        if not causal:
            raise ValueError("window (sliding-window) requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if causal and kv_offset == 0 and s_q != s_k:
        raise ValueError(
            f"causal flash attention requires s_q == s_k, got ({s_q}, {s_k})"
            " — pass kv_offset for bottom-aligned decode layouts"
        )
    if kv_segment_ids is None and segment_ids is not None and s_q != s_k:
        raise ValueError(
            "segment_ids with s_q != s_k needs explicit kv_segment_ids"
        )
    if kv_segment_ids is not None and segment_ids is None:
        raise ValueError(
            "kv_segment_ids without segment_ids would be silently ignored; "
            "pass both (q-side ids are required to build the mask)"
        )
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    block_q = min(block_q, s_q)
    block_k = min(block_k, s_k)
    if s_q % block_q or s_k % block_k:
        raise ValueError(
            f"seq lengths ({s_q}, {s_k}) must be divisible by blocks "
            f"({block_q}, {block_k})"
        )

    def check_seg(seg, s):
        if tuple(seg.shape) != (b, s):
            raise ValueError(
                f"segment ids must be [batch, seq] = ({b}, {s}), "
                f"got {tuple(seg.shape)}"
            )
        return seg

    kv_seg = None
    if segment_ids is not None:
        check_seg(segment_ids, s_q)
        kv_seg = check_seg(
            kv_segment_ids if kv_segment_ids is not None else segment_ids, s_k
        )
    opts = _Opts(bool(use_kernel), float(scale), bool(causal), block_q,
                 block_k, window, int(kv_offset))
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        return _FlashLse.apply(q, k, v, segment_ids, kv_seg, opts)
    return _flash_core(q, k, v, segment_ids, kv_seg, opts)
