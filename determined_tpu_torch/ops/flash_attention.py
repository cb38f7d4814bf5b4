"""Flash attention forward: a hand-written CUDA kernel plus its plain
PyTorch version.

Port of ``determined_tpu/ops/flash_attention.py`` for the serving slice:

- ``flash_attention`` / ``flash_attention_lse`` keep the reference's
  signature, ``[B, S, H, D]`` layout, masking model and validation errors.
  Masking: ``causal`` (row r attends cols <= r), ``window=W`` (also only
  cols > r − W; requires causal), ``kv_offset`` (q positions sit
  ``kv_offset`` after k positions — the bottom-aligned decode geometry),
  and ``segment_ids`` / ``kv_segment_ids`` (attention only within equal
  ids). A query row that matches no key gets o = 0 and lse ≈ −1e30.
- On a CUDA tensor the wrapper launches ``csrc/flash_fwd.cu`` (the port of
  the blocked Pallas ``_fwd_kernel``) or raises; on a CPU tensor it runs
  ``_blockwise_fwd_ref``, the plain version: the reference's blockwise
  online-softmax scan, in torch. There is no fallback between the two.
- Forward only: this slice serves. On a CUDA tensor that requires grad the
  wrapper raises ``NotImplementedError``; the backward kernels come with
  the training slice.

``block_q`` / ``block_k`` keep the reference's meaning for validation and
for the plain version's K/V blocking; the CUDA kernel picks its own tiles.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from determined_tpu_torch.ops import _build

NEG_INF = float(-1e30)  # finite mask value; true -inf breaks m-subtraction

#: The CUDA kernel's library handle; ``FLASH_FWD.launches`` counts launches.
FLASH_FWD = _build.FLASH_FWD


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
# Plain version: the reference's blockwise scan, in torch
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


def _blockwise_fwd_ref(q, k, v, *, scale, causal, block_k, window=None,
                       kv_offset=0, segs=None):
    """q/k/v [BH, S, D] (+ segs ([BH, Sq], [BH, Sk]) fp32) → (o [BH, Sq, D]
    in q's dtype, lse [BH, Sq] fp32): online softmax over K/V blocks with
    fp32 scores, probabilities and accumulator."""
    bh, s_q, d = q.shape
    s_k = k.shape[1]
    nk = s_k // block_k
    dev = q.device
    q32 = q.float()
    rows = torch.arange(s_q, device=dev)
    qseg = kseg = None
    if segs is not None:
        qseg, kseg = segs
    masked = causal or window is not None or segs is not None
    m = torch.full((bh, s_q), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, s_q), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, s_q, d), dtype=torch.float32, device=dev)
    for j in range(nk):
        sl = slice(j * block_k, (j + 1) * block_k)
        k_j = k[:, sl].float()
        v_j = v[:, sl].float()
        s = torch.einsum("bqd,bkd->bqk", q32, k_j) * scale
        mask = None
        if masked:
            cols = torch.arange(j * block_k, (j + 1) * block_k, device=dev)
            mask = _ref_block_mask(
                rows, cols, causal=causal, window=window,
                kv_offset=kv_offset, qseg=qseg,
                kseg_j=kseg[:, sl] if kseg is not None else None,
            )
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if masked:
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqk,bkd->bqd", p, v_j)
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (acc / l_safe[..., None]).to(q.dtype)
    lse = m + torch.log(l_safe)
    return o, lse


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------
def _last_dim_contiguous(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def _flash_fwd_cuda(q, k, v, *, scale, causal, window, kv_offset,
                    segment_ids, kv_segment_ids):
    """q/k/v [B, S, H, D] CUDA tensors (any strides with D contiguous) →
    (o [B, Sq, H, D] in q's dtype, lse [B, Sq, H] fp32)."""
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention on CUDA is forward-only in the serving slice; "
            "the backward kernels come with the training slice (call under "
            "torch.no_grad() or detach the inputs)"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(
            f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v must be on one device")
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    if d not in _build.HEAD_DIMS:
        raise ValueError(
            f"head_dim {d} not supported by the CUDA kernel "
            f"(one of {_build.HEAD_DIMS})"
        )
    code = _build.dtype_code(q.dtype)
    q, k, v = (_last_dim_contiguous(x) for x in (q, k, v))
    qseg = kseg = None
    if segment_ids is not None:
        qseg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
        kseg = kv_segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, s_q, h), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    FLASH_FWD.launch(
        code, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        qseg.data_ptr() if qseg is not None else None,
        kseg.data_ptr() if kseg is not None else None,
        o.data_ptr(), lse.data_ptr(), b, h, s_q, s_k,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2),
        int(causal), int(window or 0), int(kv_offset), float(scale),
        _build.stream_ptr(q.device),
    )
    return o, lse


# ---------------------------------------------------------------------------
# Skip accounting (bench/reporting)
# ---------------------------------------------------------------------------
#: Largest s_q*s_k of the reference's single-tile kernel (``_mono_ok``);
#: kept so ``block_skip_stats`` reports the reference's grid exactly.
_MONO_MAX_SCORES = 2 ** 21


def _mono_ok(s_q, s_k, block_q, block_k, *, window=None, has_segments=False,
             kv_offset=0) -> bool:
    return (
        block_q == s_q and block_k == s_k
        and s_q * s_k <= _MONO_MAX_SCORES
        and window is None and not has_segments and kv_offset == 0
    )


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

    q/k/v: [B, S, H, D] → (o [B, Sq, H, D], lse [B, Sq, H] fp32).
    window: sliding-window size W (requires causal) — query position p
    attends key positions in (p − W, p]. segment_ids / kv_segment_ids:
    [B, Sq] / [B, Sk] int ids; kv_segment_ids defaults to segment_ids
    (requires s_q == s_k). kv_offset: query row r sits at absolute
    position kv_offset + r in the key frame.

    Launches the CUDA kernel on CUDA tensors, the plain version on CPU
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

    if use_kernel:
        return _flash_fwd_cuda(
            q, k, v, scale=scale, causal=causal, window=window,
            kv_offset=kv_offset, segment_ids=segment_ids,
            kv_segment_ids=kv_seg,
        )

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, x.shape[1], d)

    def fold_seg(seg, s):
        seg = seg.to(torch.float32)
        return seg[:, None, :].expand(b, h, s).reshape(b * h, s)

    segs = None
    if segment_ids is not None:
        segs = (fold_seg(segment_ids, s_q), fold_seg(kv_seg, s_k))
    o, lse = _blockwise_fwd_ref(
        fold(q), fold(k), fold(v), scale=scale, causal=causal,
        block_k=block_k, window=window, kv_offset=kv_offset, segs=segs,
    )
    o = o.reshape(b, h, s_q, d).transpose(1, 2)
    lse = lse.reshape(b, h, s_q).transpose(1, 2)
    return o, lse
