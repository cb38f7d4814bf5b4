"""The port's CUDA kernels against their plain PyTorch versions, on the
card: every head dim the kernels are built for, both dtypes, the masking
contract (causal, window, kv_offset, segment ids), odd page sizes,
ragged q_lens up to the 16-row limit, strided inputs, the mono forward
and backward (causal or not, ragged tiles, a nonzero lse cotangent), the
gradient routing of flash_attention_lse, and the wrappers' refusals.
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
    with pytest.raises(NotImplementedError, match="blocked-backward slice"):
        o.sum().backward()
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
    kernels = (tfa.FLASH_FWD, tfa.FLASH_FWD_MONO, tfa.FLASH_BWD_MONO)
    before = [k.launches for k in kernels]
    tfa.flash_attention(q, q, q, block_q=32, block_k=32)  # blocked
    tfa.flash_attention_lse_plain(q, q, q)
    qg = q.clone().requires_grad_()
    tfa.flash_attention(qg, q, q).sum().backward()  # mono fwd + bwd
    tfa.flash_fwd_mono_plain(q, q, q)
    assert [k.launches - n for k, n in zip(kernels, before)] == [1, 1, 1]


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
