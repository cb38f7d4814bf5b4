"""The port's CUDA kernels against their plain PyTorch versions, on the
card: every head dim the kernels are built for, both dtypes, the masking
contract (causal, window, kv_offset, segment ids), odd page sizes,
ragged q_lens up to the 16-row limit, strided inputs, the mono forward
and backward (causal or not, ragged tiles, a nonzero lse cotangent), the
three blocked backward kernels (fused, dq pass, dk/dv pass) over causal /
full × window × segment ids × kv_offset with a nonzero lse cotangent, the
gradient routing of flash_attention_lse (mono, fused, two-pass), the
wrappers' refusals, and the blocked forward and fused backward against
their own plain versions over the cases their TMA/wgmma design makes
risky (``TMA_CASES``: ragged tiles, one decode row, strided and
misaligned views, rows that see no key, short windows, several batches
with segment ids) at every head dim, and the persistent mono pair over
``MONO_TMA_CASES`` (ragged tiles, s_q ≠ s_k causal and full, misaligned
views, fewer work items than SMs and many more, ``_mono_ok``'s largest
square, no queries, no keys) at every head dim.
Marked ``cuda``; each test skips without a CUDA device. On the chip (the
root and tests/ conftests import JAX, which that machine does not
have)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: fp32 atol 1e-5 (same arithmetic, other summation order; the
mono backward adds dq over key tiles with fp32 atomics in no fixed order,
hence rtol 1e-5 there); bf16 o and gradients atol/rtol 2e-2 (bf16
roundings of p, ds and the outputs), lse atol 1e-3.
"""
import importlib

import numpy as np
import pytest
import torch

tfa = importlib.import_module("determined_tpu_torch.ops.flash_attention")
tpa = importlib.import_module("determined_tpu_torch.ops.paged_attention")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(dtype, got, want, lse=False):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-6)
    elif lse:
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-6)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


def _packed(rng, b, s):
    ids = np.zeros((b, s), np.int32)
    for r in range(b):
        pos, doc = 0, 1
        while pos < s - 3:
            ln = int(rng.integers(1, max(2, s // 3)))
            ids[r, pos:pos + ln] = doc
            pos, doc = pos + ln, doc + 1
    return ids


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("causal,window,kv_offset,segs", [
    (False, None, 0, False), (True, None, 0, True), (True, 37, 0, False),
    (True, None, 70, True), (True, 50, 70, True),
])
def test_flash_kernel_matches_plain(dev, dtype, head_dim, causal, window,
                                    kv_offset, segs):
    rng = np.random.default_rng(head_dim + kv_offset)
    b, h, s_k = 2, 3, 200
    s_q = s_k - kv_offset
    gen = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn((b, s_k, 3, h, head_dim), generator=gen,
                      device=dev).to(dtype)
    q = qkv[:, kv_offset:, 0]          # strided views, as GPT passes them
    k, v = qkv[:, :, 1], qkv[:, :, 2]
    kw = dict(causal=causal, window=window, kv_offset=kv_offset,
              block_q=s_q, block_k=s_k)
    if segs:
        kseg = torch.from_numpy(_packed(rng, b, s_k)).to(dev)
        kw.update(segment_ids=kseg[:, kv_offset:], kv_segment_ids=kseg)
    o_k, lse_k = tfa.flash_attention_lse(q, k, v, **kw)
    o_p, lse_p = tfa.flash_attention_lse_plain(q, k, v, **kw)
    _close(dtype, o_k, o_p)
    _close(dtype, lse_k, lse_p, lse=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("head_dim", [16, 64, 128])
@pytest.mark.parametrize("page_size,q_rows", [(16, 1), (100, 5), (128, 16)])
def test_paged_kernel_matches_plain(dev, dtype, head_dim, page_size, q_rows):
    rng = np.random.default_rng(page_size)
    b, p, h = 6, 4, 3
    num_pages = b * p + 3
    gen = torch.Generator(device=dev).manual_seed(1)
    pools = torch.randn((2, num_pages, page_size, h, head_dim),
                        generator=gen, device=dev).to(dtype)
    pt = rng.permutation(np.arange(1, num_pages))[:b * p].reshape(b, p)
    q_lens = rng.integers(1, q_rows + 1, size=b)
    lengths = np.minimum(rng.integers(0, p * page_size, size=b),
                         p * page_size - q_lens)
    lengths[0] = 0
    active = np.array([1, 1, 0, 1, 1, 1])
    q = torch.randn((b, q_rows, h, head_dim), generator=gen,
                    device=dev).to(dtype)
    args = [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (pt, lengths, active, q_lens)]
    o_k = tpa.paged_attention(q, pools[0], pools[1], *args[:3], q_lens=args[3])
    o_p = tpa.paged_attention_plain(q, pools[0], pools[1], *args[:3],
                                    q_lens=args[3])
    _close(dtype, o_k, o_p)
    assert (o_k[2] == 0).all()


def test_kernel_refusals(dev):
    q = torch.randn((1, 8, 2, 64), device=dev)
    segs = torch.ones((1, 8), dtype=torch.int32, device=dev)
    qg = q.clone().requires_grad_()
    o = tfa.flash_attention(qg, q, q, segment_ids=segs)  # blocked forward
    o.sum().backward()  # the fused blocked backward takes segment ids
    assert torch.isfinite(qg.grad).all()
    q48 = torch.randn((1, 8, 2, 48), device=dev)
    with pytest.raises(ValueError, match="head_dim 48"):
        tfa.flash_attention(q48, q48, q48)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention(*(torch.randn((1, 8, 2, 64), device=dev,
                                          dtype=torch.float16),) * 3)
    pool = torch.zeros((3, 16, 2, 64), device=dev)
    ints = torch.zeros((1,), dtype=torch.int32, device=dev)
    pt = torch.ones((1, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="interpret"):
        tpa.paged_attention(torch.zeros((1, 1, 2, 64), device=dev), pool,
                            pool, pt, ints, ints + 1, interpret=True)
    with pytest.raises(ValueError, match="q_rows 17"):
        tpa.paged_attention(torch.zeros((1, 17, 2, 64), device=dev), pool,
                            pool, pt, ints, ints + 1)


def test_launch_counters_count_launches(dev):
    q = torch.randn((1, 64, 2, 64), device=dev)
    kernels = (tfa.FLASH_FWD, tfa.FLASH_FWD_MONO, tfa.FLASH_BWD_MONO,
               tfa.FLASH_BWD_BLOCKED, tfa.FLASH_BWD_DQ, tfa.FLASH_BWD_DKV)
    before = [k.launches for k in kernels]
    tfa.flash_attention(q, q, q, block_q=32, block_k=32)  # blocked
    tfa.flash_attention_lse_plain(q, q, q)
    qg = q.clone().requires_grad_()
    tfa.flash_attention(qg, q, q).sum().backward()  # mono fwd + bwd
    tfa.flash_fwd_mono_plain(q, q, q)
    o = tfa.flash_attention(qg, q, q, block_q=32, block_k=32)
    o.sum().backward()  # blocked fwd + fused blocked bwd
    lse = torch.zeros((1, 64, 2), device=dev)
    tfa.flash_bwd_blocked_plain(q, q, q, q, lse, lse)
    assert [k.launches - n for k, n in zip(kernels, before)] == \
        [2, 1, 1, 1, 0, 0]


def _mono_inputs(dev, dtype, head_dim, s_q, s_k, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((2, max(s_q, s_k), 3, 3, head_dim), generator=gen,
                      device=dev).to(dtype)
    q = qkv[:, :s_q, 0]                # strided views, as GPT passes them
    k, v = qkv[:, :s_k, 1], qkv[:, :s_k, 2]
    do = torch.randn((2, s_q, 3, head_dim), generator=gen, device=dev)
    dlse = torch.randn((2, s_q, 3), generator=gen, device=dev)
    return q, k, v, do.to(dtype), dlse


MONO_SHAPES = [(200, 200, True), (256, 256, True), (96, 300, False),
               (128, 128, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("head_dim", [16, 64, 128])
@pytest.mark.parametrize("s_q,s_k,causal", MONO_SHAPES)
def test_mono_kernels_match_plain(dev, dtype, head_dim, s_q, s_k, causal):
    q, k, v, do, dlse = _mono_inputs(dev, dtype, head_dim, s_q, s_k,
                                     head_dim + s_q)
    o_k, lse_k = tfa.flash_fwd_mono(q, k, v, causal=causal)
    o_p, lse_p = tfa.flash_fwd_mono_plain(q, k, v, causal=causal)
    _close(dtype, o_k, o_p)
    _close(dtype, lse_k, lse_p, lse=True)
    delta = (do.float() * o_p.float()).sum(-1)
    for cot in (None, dlse):
        got = tfa.flash_bwd_mono(q, k, v, do, lse_p, delta, cot,
                                 causal=causal)
        want = tfa.flash_bwd_mono_plain(q, k, v, do, lse_p, delta, cot,
                                        causal=causal)
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            if dtype == torch.float32:
                torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
            else:
                _close(dtype, g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_attention_grad_routes_through_mono(dev, dtype):
    """autograd through flash_attention_lse at a mono shape launches the
    mono kernels and agrees with the plain path's gradients."""
    q, k, v, do, dlse = _mono_inputs(dev, dtype, 64, 256, 256, 3)
    grads = []
    for fn in (tfa.flash_attention_lse, tfa.flash_attention_lse_plain):
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        o, lse = fn(*xs, block_q=256, block_k=256)
        torch.autograd.backward([o, lse], [do, dlse])
        grads.append([x.grad for x in xs])
    for g, w in zip(*grads):
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
        else:
            _close(dtype, g, w)


BLOCKED_MASKS = [  # causal, window, kv_offset, segments
    (False, None, 0, False), (True, None, 0, False), (True, None, 0, True),
    (True, 40, 0, False), (True, None, 70, True), (True, 50, 70, True),
    (False, None, 70, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("head_dim", [16, 64, 128])
@pytest.mark.parametrize("causal,window,kv_offset,segs", BLOCKED_MASKS)
def test_blocked_backward_kernels_match_plain(dev, dtype, head_dim, causal,
                                              window, kv_offset, segs):
    """flash_bwd_blocked, flash_bwd_dq and flash_bwd_dkv against the dense
    formula, on ragged tiles (s_k = 300) with strided inputs."""
    rng = np.random.default_rng(head_dim + kv_offset + (window or 0))
    s_k = 300
    s_q = s_k - kv_offset
    q, k, v, do, dlse = _mono_inputs(dev, dtype, head_dim, s_k, s_k,
                                     head_dim + kv_offset)
    q, do, dlse = q[:, kv_offset:], do[:, kv_offset:], dlse[:, kv_offset:]
    kw = dict(causal=causal, window=window, kv_offset=kv_offset)
    if segs:
        kseg = torch.from_numpy(_packed(rng, 2, s_k)).to(dev)
        kw.update(segment_ids=kseg[:, kv_offset:], kv_segment_ids=kseg)
    o, lse = tfa.flash_attention_lse_plain(q, k, v, block_q=s_q,
                                           block_k=s_k, **kw)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, dlse)
    want = tfa.flash_bwd_blocked_plain(*args, **kw)
    got = [tfa.flash_bwd_blocked(*args, **kw),
           (tfa.flash_bwd_dq(*args, **kw), *tfa.flash_bwd_dkv(*args, **kw))]
    for grads in got:
        for g, w in zip(grads, want):
            assert g.dtype == dtype and g.shape == w.shape
            if dtype == torch.float32:
                torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
            else:
                _close(dtype, g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("cap", [None, 0], ids=["fused", "two-pass"])
def test_flash_attention_grad_routes_through_blocked(dev, dtype, cap,
                                                     monkeypatch):
    """autograd through flash_attention_lse at a blocked shape (packed
    documents and a window) launches the route's kernels and agrees with
    the plain path's gradients."""
    if cap is not None:
        monkeypatch.setattr(tfa, "_FUSED_BWD_PARTIALS_CAP", cap)
    rng = np.random.default_rng(5)
    q, k, v, do, dlse = _mono_inputs(dev, dtype, 64, 256, 256, 5)
    segs = torch.from_numpy(_packed(rng, 2, 256)).to(dev)
    kernels = (tfa.FLASH_BWD_BLOCKED, tfa.FLASH_BWD_DQ, tfa.FLASH_BWD_DKV)
    before = [kern.launches for kern in kernels]
    grads = []
    for fn in (tfa.flash_attention_lse, tfa.flash_attention_lse_plain):
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        o, lse = fn(*xs, block_q=128, block_k=128, window=100,
                    segment_ids=segs)
        torch.autograd.backward([o, lse], [do, dlse])
        grads.append([x.grad for x in xs])
    counts = [kern.launches - n for kern, n in zip(kernels, before)]
    assert counts == ([1, 0, 0] if cap is None else [0, 1, 1])
    for g, w in zip(*grads):
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
        else:
            _close(dtype, g, w)


def _layout_inputs(dev, dtype, layout, b, h, s_q, s_k, d, seed):
    """q/k/v as the kernels meet them: "qkv" strided views of one
    [B, S, 3, H, D] projection (q bottom-aligned, 16-byte aligned);
    "odd-base" contiguous tensors whose base sits one element past 16-byte
    alignment; "odd-stride" rows padded to D + 1 elements. Plus do and an
    lse cotangent."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    if layout == "qkv":
        s = max(s_q, s_k)
        qkv = randn(b, s, 3, h, d)
        q, k, v = qkv[:, s - s_q:, 0], qkv[:, :s_k, 1], qkv[:, :s_k, 2]
    elif layout == "odd-base":
        n_q, n_k = b * s_q * h * d, b * s_k * h * d
        flat = randn(n_q + 2 * n_k + 1)
        q = flat[1:1 + n_q].view(b, s_q, h, d)
        k = flat[1 + n_q:1 + n_q + n_k].view(b, s_k, h, d)
        v = flat[1 + n_q + n_k:].view(b, s_k, h, d)
    else:
        q = randn(b, s_q, h, d + 1)[..., :d]
        k = randn(b, s_k, h, d + 1)[..., :d]
        v = randn(b, s_k, h, d + 1)[..., :d]
    if dtype == torch.bfloat16:
        assert tfa._tma_ready(q) == (layout == "qkv")
    return q, k, v, randn(b, s_q, h, d), torch.randn(
        (b, s_q, h), generator=gen, device=dev)


#: The cases the TMA/wgmma design makes risky: ragged tiles (s not a
#: multiple of the 128-row / 128-key tiles), one decode row, strided and
#: misaligned views, rows that see no key, no keys at all, a window
#: shorter than a tile, several batches with segment ids.
TMA_CASES = [  # name, b, h, s_q, s_k, causal, window, kv_offset, segs, layout
    ("ragged-200", 2, 3, 200, 200, True, None, 0, False, "qkv"),
    ("ragged-1000-full", 1, 2, 1000, 1000, False, None, 0, False, "qkv"),
    ("decode-row", 2, 3, 1, 1000, True, None, 999, False, "qkv"),
    ("offset-segs", 2, 3, 130, 200, True, None, 70, True, "qkv"),
    ("odd-base", 2, 3, 200, 200, True, None, 0, False, "odd-base"),
    ("odd-stride", 2, 3, 200, 200, True, None, 0, True, "odd-stride"),
    ("dead-rows", 2, 3, 200, 200, True, None, 0, "dead", "qkv"),
    ("window-5", 2, 3, 300, 300, True, 5, 0, False, "qkv"),
    ("segs-b3", 3, 2, 256, 256, True, None, 0, True, "qkv"),
    ("no-keys", 2, 3, 64, 0, False, None, 0, False, "qkv"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize(
    "b,h,s_q,s_k,causal,window,kv_offset,segs,layout",
    [c[1:] for c in TMA_CASES], ids=[c[0] for c in TMA_CASES])
def test_forward_and_fused_backward_match_plain(dev, dtype, head_dim, b, h,
                                                s_q, s_k, causal, window,
                                                kv_offset, segs, layout):
    """flash_fwd and flash_bwd_blocked against flash_fwd_plain and
    flash_bwd_blocked_plain (bf16: the wgmma/TMA kernels; fp32: the FMA
    kernels), with an lse cotangent. Rows whose segment id matches no key
    (every row, with no keys) get o = 0, lse = NEG_INF and a zero dq."""
    q, k, v, do, dlse = _layout_inputs(dev, dtype, layout, b, h, s_q, s_k,
                                       head_dim, head_dim + s_q)
    kw = dict(causal=causal, window=window, kv_offset=kv_offset)
    dead = slice(0, 0) if s_k else slice(None)
    if segs:
        rng = np.random.default_rng(s_k + b)
        kseg = torch.from_numpy(_packed(rng, b, s_k)).to(dev)
        qseg = kseg[:, s_k - s_q:].clone()
        if segs == "dead":
            dead = slice(10, 30)
            qseg[:, dead] = 99
        kw.update(segment_ids=qseg, kv_segment_ids=kseg)
    o_k, lse_k = tfa.flash_fwd(q, k, v, **kw)
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, **kw)
    _close(dtype, o_k, o_p)
    _close(dtype, lse_k, lse_p, lse=True)
    assert (o_k[:, dead] == 0).all() and (lse_k[:, dead] == tfa.NEG_INF).all()
    delta = (do.float() * o_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta, dlse)
    got = tfa.flash_bwd_blocked(*args, **kw)
    want = tfa.flash_bwd_blocked_plain(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
        else:
            _close(dtype, g, w)
    assert (got[0][:, dead] == 0).all()


#: The cases the persistent wgmma/TMA mono pair makes risky: ragged tiles,
#: s_q ≠ s_k under the top-left causal mask and without it (key tiles no
#: row sees, rows past the keys), misaligned views (copied first), fewer
#: work items than SMs (B1 H2 S128) and many more (B8 H12 S1024: every
#: CTA's walk wraps), ``_mono_ok``'s largest square (s = 1448), no
#: queries and no keys.
MONO_TMA_CASES = [  # name, b, h, s_q, s_k, causal, layout
    ("ragged-200", 2, 3, 200, 200, True, "qkv"),
    ("ragged-200-full", 2, 3, 200, 200, False, "qkv"),
    ("sq-lt-sk-causal", 2, 3, 96, 300, True, "qkv"),
    ("sq-gt-sk-causal", 2, 3, 300, 96, True, "qkv"),
    ("sq-lt-sk-full", 2, 3, 96, 300, False, "qkv"),
    ("sq-gt-sk-full", 2, 3, 300, 96, False, "qkv"),
    ("odd-base", 2, 3, 200, 200, True, "odd-base"),
    ("odd-stride", 2, 3, 200, 200, True, "odd-stride"),
    ("few-items", 1, 2, 128, 128, True, "qkv"),
    ("wraps", 8, 12, 1024, 1024, True, "qkv"),
    ("largest", 1, 2, 1448, 1448, True, "qkv"),
    ("no-queries", 2, 3, 0, 64, False, "qkv"),
    ("no-keys", 2, 3, 64, 0, False, "qkv"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("b,h,s_q,s_k,causal,layout",
                         [c[1:] for c in MONO_TMA_CASES],
                         ids=[c[0] for c in MONO_TMA_CASES])
def test_mono_pair_matches_plain_on_the_tma_grid(dev, dtype, head_dim, b, h,
                                                 s_q, s_k, causal, layout):
    """flash_fwd_mono and flash_bwd_mono (bf16: the persistent wgmma/TMA
    kernels; fp32: the FMA kernels) against their plain versions, with
    and without an lse cotangent. With no keys o = 0 and lse = NEG_INF;
    with no queries dk = dv = 0."""
    q, k, v, do, dlse = _layout_inputs(dev, dtype, layout, b, h, s_q, s_k,
                                       head_dim, head_dim + s_q + s_k)
    o_k, lse_k = tfa.flash_fwd_mono(q, k, v, causal=causal)
    o_p, lse_p = tfa.flash_fwd_mono_plain(q, k, v, causal=causal)
    _close(dtype, o_k, o_p)
    _close(dtype, lse_k, lse_p, lse=True)
    if s_k == 0:
        assert (o_k == 0).all() and (lse_k == tfa.NEG_INF).all()
    delta = (do.float() * o_p.float()).sum(-1)
    for cot in (None, dlse):
        got = tfa.flash_bwd_mono(q, k, v, do, lse_p, delta, cot,
                                 causal=causal)
        want = tfa.flash_bwd_mono_plain(q, k, v, do, lse_p, delta, cot,
                                        causal=causal)
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            if dtype == torch.float32:
                torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
            else:
                _close(dtype, g, w)
        if s_q == 0:
            assert (got[1] == 0).all() and (got[2] == 0).all()
