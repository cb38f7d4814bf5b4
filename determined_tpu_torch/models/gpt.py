"""GPT: decoder-only transformer — serving and training on one device.

Port of ``determined_tpu/models/gpt.py``: the same ``GPTConfig`` fields
and defaults, the same parameter names and shapes as the reference's
``GPT.init`` (stacked ``blocks.*`` ``[L, ...]``, ``wqkv`` ``[L, d, 3, H,
Dh]``, ``wo`` ``[L, H, Dh, d]``, tied ``tok_embed``), so one numpy
parameter tree feeds both packages (``load_jax_params``).

Matmuls run in the compute dtype (``config.dtype``, bf16 by default) over
fp32 master parameters, with fp32 layernorm statistics; attention goes
through ``ops.flash_attention`` (by way of ``models.attention`` in the
full-sequence forward; directly in packed prefill and gather decode) and
``ops.paged_attention`` (paged decode) — CUDA kernels on the card, their
plain versions on the CPU.

Serving: ``apply`` is the full-sequence forward without a graph.
``prefill_kv``, ``prefill_kv_cached`` (the prefix-cache tail),
``decode_kv`` and ``decode_kv_spec`` (the speculative verify; both with
``kernel="paged"`` or ``"gather"``), the engine's methods, run under
``torch.no_grad()`` on detached compute-dtype casts (or the serving
copy, ``cache_compute_weights``).

Training: ``loss`` (next-token cross-entropy with ``loss_mask``, packed
``segment_ids``, pre-shifted ``targets`` and ``z_loss``; metrics
``loss``, ``accuracy``, ``tokens``) and ``eval_metrics`` run the
differentiable trunk: the live fp32 parameters are cast to the compute
dtype inside the graph on every call, so an optimizer step is seen at
once. ``remat=True`` recomputes each MLP half in the backward
(``torch.utils.checkpoint``, saving the matmul outputs, as the
reference's ``_remat_policy``) and keeps attention outside the remat
boundary; with rematted attention (``remat_attention``, or
``layer_loop="auto"`` past 16384 tokens, as the reference) the whole
block goes under the checkpoint, so the backward reruns the attention
forward. ``layer_loop`` "scan" and "unroll" pick the reference's XLA loop
style and change nothing here: the port always runs a Python loop over
the layers. ``fused_loss=True`` computes the loss through the chunked
cross-entropy (``ops/fused_cross_entropy.py``), which never materializes
the ``[B, S, V]`` logits. Mixture of experts, pipeline stages and the
zigzag layout belong to later slices and are refused by name.

The methods drop the reference's leading ``params`` argument: the module
owns its parameters.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.models import attention as attn_mod
from determined_tpu_torch.models.base import Metrics, Model
from determined_tpu_torch.ops.flash_attention import (
    fit_block,
    flash_attention,
)
from determined_tpu_torch.ops.fused_cross_entropy import fused_next_token_sums
from determined_tpu_torch.ops.paged_attention import paged_attention


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304  # GPT-2's 50257 padded up to a multiple of 128
    n_layers: int = 12
    n_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    seq_len: int = 1024
    dtype: Any = torch.bfloat16        # compute dtype
    param_dtype: Any = torch.float32   # master params
    tie_embeddings: bool = True
    # The reference's remaining knobs, carried for config parity. The
    # port reads remat, remat_attention, layer_loop (only for the auto
    # rematted attention past 16k tokens), attn_impl, flash_block_q/k,
    # attn_window, z_loss and fused_loss, and refuses MoE, pipeline
    # stages and the zigzag layout; the multi-device slice reads the rest.
    remat: bool = True
    remat_attention: bool = False
    scan_unroll: int = 1
    layer_loop: str = "auto"
    attn_impl: str = "auto"
    flash_block_q: int = 1024
    flash_block_k: int = 1024
    flash_autotune: bool = False
    attn_window: Optional[int] = None
    z_loss: float = 1e-4
    fused_loss: bool = False
    sequence_layout: str = "contiguous"
    pipeline_stages: int = 1
    num_microbatches: int = 0
    pipeline_schedule: str = "gpipe"
    pipeline_virtual_stages: int = 2
    n_experts: int = 0
    capacity_factor: float = 1.25

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    def n_params(self) -> int:
        d, f, l, v, s = (self.d_model, self.d_ff, self.n_layers,
                         self.vocab_size, self.seq_len)
        attn = 4 * d * d + (3 * d + d)
        if self.n_experts:
            e = self.n_experts
            mlp = d * e + e * (d * f + f) + e * (f * d) + d
        else:
            mlp = 2 * d * f + f + d
        per_block = attn + mlp + 4 * d
        embed = v * d + s * d
        head = 0 if self.tie_embeddings else d * v
        return l * per_block + embed + head + 2 * d

    def train_flops_per_token(self) -> float:
        """fwd+bwd FLOPs/token: 6·N_matmul + 12·L·D·S (PaLM convention)."""
        d, f, l, v = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        matmul_params = l * (4 * d * d + 2 * d * f) + d * v
        return 6.0 * matmul_params + 12.0 * l * d * self.seq_len


def small() -> GPTConfig:
    return GPTConfig()  # 124M-class (GPT-2 small)


def medium() -> GPTConfig:
    return GPTConfig(n_layers=24, n_heads=16, d_model=1024, d_ff=4096)


def tiny(seq_len: int = 128) -> GPTConfig:
    """Test-sized config."""
    return GPTConfig(
        vocab_size=256, n_layers=2, n_heads=4, d_model=64, d_ff=256,
        seq_len=seq_len, remat=False,
    )


def _layernorm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """fp32 statistics (eps 1e-5), cast back to x's (compute) dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + 1e-5)
    return (y * scale + bias).to(x.dtype)


#: Block parameters the forward casts to the compute dtype, and those it
#: keeps fp32 (layernorm scales and biases, as in the reference).
_BLOCK_COMPUTE = ("wqkv", "bqkv", "wo", "bo", "wi", "bi", "wo_mlp", "bo_mlp")
_BLOCK_FP32 = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")
_COMPUTE_PARAMS = ("tok_embed", "pos_embed", "head",
                   *(f"blocks.{n}" for n in _BLOCK_COMPUTE))

#: Matmul outputs the remat policy saves (the reference's
#: dots_with_no_batch_dims_saveable); the rest of an MLP half — layernorm,
#: bias adds, gelu — is recomputed in the backward.
_REMAT_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _remat_context():
    from torch.utils.checkpoint import (
        CheckpointPolicy,
        create_selective_checkpoint_contexts,
    )

    def policy(ctx, op, *args, **kwargs):
        if op in _REMAT_SAVED:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


def _aligned_token_sums(logits: torch.Tensor, targets: torch.Tensor,
                        mask: torch.Tensor):
    """Objective SUMS (nll, z, correct, n) over fp32 logits ALIGNED with
    targets (position i predicts targets[i])."""
    lse = torch.logsumexp(logits, dim=-1)
    target_logit = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll_sum = ((lse - target_logit) * mask).sum()
    z_sum = (lse.square() * mask).sum()
    acc_sum = ((logits.argmax(dim=-1) == targets) * mask).sum()
    return nll_sum, z_sum, acc_sum, mask.sum()


def _next_token_sums(logits: torch.Tensor, tokens: torch.Tensor,
                     mask: torch.Tensor):
    """Classic in-model shift: position i predicts token i+1."""
    return _aligned_token_sums(logits[:, :-1], tokens[:, 1:], mask[:, 1:])


class GPT(Model):
    """Decoder-only LM over [B, S] int tokens. Parameters are created on
    ``device`` (CUDA unless the caller passes ``device="cpu"``) from a
    seeded ``torch.Generator``: normal(0.02), with the residual
    projections (``wo``, ``wo_mlp``) at 0.02/sqrt(2L), as the reference's
    ``GPT.init``."""

    def __init__(self, config: GPTConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 *, seed: int = 0) -> None:
        super().__init__()
        c = config
        if c.n_experts:
            raise NotImplementedError(
                "mixture-of-experts GPT is not ported yet (later slice)"
            )
        if c.pipeline_stages > 1:
            raise NotImplementedError(
                "pipeline-parallel GPT is not ported yet (multi-device slice)"
            )
        if c.sequence_layout != "contiguous":
            raise NotImplementedError(
                f"sequence_layout {c.sequence_layout!r} needs ring attention "
                "(multi-device slice)"
            )
        self.config = c
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        pd = c.param_dtype
        d, f, h, hd, n_l = c.d_model, c.d_ff, c.n_heads, c.head_dim, c.n_layers
        res_std = 0.02 / (2 * n_l) ** 0.5

        def normal(shape, std):
            t = torch.empty(shape, dtype=pd, device=dev)
            return nn.Parameter(t.normal_(0.0, std, generator=gen))

        def full(shape, value):
            return nn.Parameter(torch.full(shape, value, dtype=pd, device=dev))

        self.tok_embed = normal((c.vocab_size, d), 0.02)
        self.pos_embed = normal((c.seq_len, d), 0.02)
        self.blocks = nn.ParameterDict({
            "ln1_scale": full((n_l, d), 1.0),
            "ln1_bias": full((n_l, d), 0.0),
            "wqkv": normal((n_l, d, 3, h, hd), 0.02),
            "bqkv": full((n_l, 3, h, hd), 0.0),
            "wo": normal((n_l, h, hd, d), res_std),
            "bo": full((n_l, d), 0.0),
            "ln2_scale": full((n_l, d), 1.0),
            "ln2_bias": full((n_l, d), 0.0),
            "wi": normal((n_l, d, f), 0.02),
            "bi": full((n_l, f), 0.0),
            "wo_mlp": normal((n_l, f, d), res_std),
            "bo_mlp": full((n_l, d), 0.0),
        })
        self.lnf_scale = full((d,), 1.0)
        self.lnf_bias = full((d,), 0.0)
        if not c.tie_embeddings:
            self.head = normal((d, c.vocab_size), 0.02)
        #: the optional serving copy: compute-dtype casts made once
        #: (cache_compute_weights), keyed by parameter name.
        self._compute: Dict[str, torch.Tensor] = {}

    def train_flops_per_token(self) -> float:
        """The config's fwd+bwd FLOPs per token (the trainer's
        ``step_flops``)."""
        return self.config.train_flops_per_token()

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    # -- compute-dtype weights ---------------------------------------------
    def cache_compute_weights(self) -> None:
        """Make the serving copy: every parameter the forward casts to the
        compute dtype is cast ONCE here and reused by every call — the
        same ``.astype(c.dtype)`` the reference applies per call, so the
        numbers are unchanged. A snapshot: parameters changed afterwards
        need another call (``load_jax_params`` makes one itself)."""
        self._compute.clear()
        dtype = self.config.dtype
        params = dict(self.named_parameters())
        for name in _COMPUTE_PARAMS:
            p = params.get(name)
            if p is not None and p.dtype != dtype:
                self._compute[name] = p.detach().to(dtype)

    def _cw(self, name: str) -> torch.Tensor:
        """Whole parameter `name` in the compute dtype (serving)."""
        t = self._compute.get(name)
        if t is not None:
            return t
        return self.get_parameter(name).detach().to(self.config.dtype)

    def _bw(self, name: str, i: int) -> torch.Tensor:
        """Layer i of stacked block parameter `name`, compute dtype
        (serving)."""
        t = self._compute.get(f"blocks.{name}")
        if t is not None:
            return t[i]
        return self.blocks[name][i].detach().to(self.config.dtype)

    def _serving_layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer i's weights for the serving methods (no graph)."""
        w = {n: self._bw(n, i) for n in _BLOCK_COMPUTE}
        w.update({n: self.blocks[n][i] for n in _BLOCK_FP32})
        return w

    def _train_layers(self) -> List[Dict[str, torch.Tensor]]:
        """Every layer's weights cast from the live parameters INSIDE the
        graph (one cast per stacked parameter, then per-layer views): the
        training forward's gradients reach the fp32 masters."""
        c = self.config
        cols = {n: self.blocks[n].to(c.dtype).unbind(0) for n in _BLOCK_COMPUTE}
        cols.update({n: self.blocks[n].unbind(0) for n in _BLOCK_FP32})
        return [{n: cols[n][i] for n in cols} for i in range(c.n_layers)]

    # -- pieces of a block ---------------------------------------------------
    def _qkv(self, x: torch.Tensor, w: Dict[str, torch.Tensor]):
        """ln1 + fused QKV projection → q, k, v [B, S, H, Dh] (views of
        one [B, S, 3, H, Dh] tensor)."""
        c = self.config
        h = _layernorm(x, w["ln1_scale"], w["ln1_bias"])
        qkv = (
            torch.matmul(h, w["wqkv"].reshape(c.d_model, -1))
            + w["bqkv"].reshape(-1)
        ).view(*x.shape[:-1], 3, c.n_heads, c.head_dim)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def _out_proj(self, o: torch.Tensor, w: Dict[str, torch.Tensor]):
        """einsum("bshk,hkd->bsd", o, wo) + bo."""
        c = self.config
        return torch.matmul(
            o.reshape(*o.shape[:2], c.n_heads * c.head_dim),
            w["wo"].reshape(c.n_heads * c.head_dim, c.d_model),
        ) + w["bo"]

    def _mlp_half(self, x: torch.Tensor,
                  w: Dict[str, torch.Tensor]) -> torch.Tensor:
        h = _layernorm(x, w["ln2_scale"], w["ln2_bias"])
        m = torch.matmul(h, w["wi"]) + w["bi"]
        # jax.nn.gelu defaults to the tanh approximation.
        m = F.gelu(m, approximate="tanh")
        m = torch.matmul(m, w["wo_mlp"]) + w["bo_mlp"]
        return x + m

    def _embed(self, tok: torch.Tensor, pos: torch.Tensor,
               tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        # F.embedding, not tok[ids]: its backward sums the rows of a
        # repeated id in a fixed order; indexing's (index_put_ with
        # accumulate) adds them by atomics in any order across CPU threads.
        x = F.embedding(tokens.long(), tok)
        if positions is not None:
            return x + F.embedding(positions.long(), pos)
        return x + pos[: tokens.shape[1]]

    def _head(self, x: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
        return torch.matmul(_layernorm(x, self.lnf_scale, self.lnf_bias), w_out)

    def _serving_embed(self, tokens, positions=None):
        return self._embed(self._cw("tok_embed"), self._cw("pos_embed"),
                           tokens, positions)

    def _serving_head(self, x: torch.Tensor) -> torch.Tensor:
        w_out = (
            self._cw("tok_embed").t() if self.config.tie_embeddings
            else self._cw("head")
        )
        return self._head(x, w_out)

    # -- serving forward -------------------------------------------------------
    @torch.no_grad()
    def apply(self, tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None,
              segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S] int → logits [B, S, V] (compute dtype): the
        training forward without a graph, on the live parameters."""
        return self.forward(tokens.to(self.device), positions, segment_ids)

    @torch.no_grad()
    def prefill_kv(
        self,
        tokens: torch.Tensor,
        positions: torch.Tensor,
        segment_ids: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Packed prefill that also returns every layer's K/V.

        tokens [B, S] int — prompts packed back to back per row
        (batch_inference.pack_sequences layout); positions [B, S] — each
        token's position within its own document; segment_ids [B, S] — 1,
        2, ... per document, 0 on padding.

        → (logits [B, S, V] compute dtype, k [L, B, S, H, Dh],
        v [L, B, S, H, Dh] compute dtype).
        """
        c = self.config
        s = tokens.shape[1]
        x = self._serving_embed(tokens, positions)
        bq = fit_block(s, c.flash_block_q)
        bk = fit_block(s, c.flash_block_k)
        ks, vs = [], []
        for i in range(c.n_layers):
            w = self._serving_layer(i)
            q, k, v = self._qkv(x, w)
            ks.append(k)
            vs.append(v)
            o = flash_attention(
                q, k, v, causal=True, block_q=bq, block_k=bk,
                segment_ids=segment_ids,
            )
            x = x + self._out_proj(o, w)
            x = self._mlp_half(x, w)
        return self._serving_head(x), torch.stack(ks), torch.stack(vs)

    @torch.no_grad()
    def decode_kv(
        self,
        last_tokens: torch.Tensor,
        lengths: torch.Tensor,
        active: torch.Tensor,
        cache_k: torch.Tensor,
        cache_v: torch.Tensor,
        page_table: torch.Tensor,
        *,
        q_pad: int = 1,
        kernel: str = "gather",
        block_h: Optional[int] = None,
        interpret: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One iteration-level decode step over the paged KV cache.

        last_tokens [B] int — the token each slot processes (it sits at
        position lengths[b]); lengths [B] int — tokens already cached;
        active [B] bool — live slots; cache_k/cache_v [L, n_pages,
        page_size, H, Dh] — the page pool (page 0 is the scratch page);
        page_table [B, P] int — each slot's pages in order.

        → (logits [B, V] fp32 for the NEXT token, cache_k, cache_v). The
        processed token's K/V is written into the pool at its position
        BEFORE attention (inactive rows write the scratch page). The pool
        is updated in place (``index_put_``) — the counterpart of the
        reference's donated buffers — and returned for signature parity.

        ``kernel="paged"`` reads K/V through the page table
        (ops/paged_attention); ``"gather"`` gathers each slot's pages
        contiguous and runs flash attention at causal +
        ``kv_offset = S_max − 1`` with segment ids trimming the dead tail.
        ``q_pad`` pads the query rows (rows past 0 are dropped).
        """
        c = self.config
        if kernel not in ("paged", "gather"):
            raise ValueError(
                f"decode_kv kernel must be 'paged' or 'gather', "
                f"got {kernel!r}"
            )
        n_layers, _n_pages, page_size, h, hd = cache_k.shape
        b = last_tokens.shape[0]
        n_page_slots = page_table.shape[1]
        s_max = n_page_slots * page_size
        lengths = lengths.long()
        active = active.bool()
        positions = torch.clamp(lengths, 0, c.seq_len - 1)
        x = self._serving_embed(last_tokens[:, None], positions[:, None])
        rows = torch.arange(b, device=lengths.device)
        widx = page_table.long()[
            rows, torch.clamp(lengths // page_size, max=n_page_slots - 1)
        ]
        widx = torch.where(active, widx, 0)
        woff = lengths % page_size
        qpad = max(1, int(q_pad))
        if kernel == "gather":
            kv_pos = torch.arange(s_max, device=lengths.device)[None, :]
            kv_seg = ((kv_pos <= lengths[:, None]) & active[:, None]).to(torch.int32)
            q_seg = torch.where(active, 1, 2).to(torch.int32)[:, None]
            if qpad > 1:
                q_seg = torch.cat(
                    [q_seg, torch.full((b, qpad - 1), 2, dtype=torch.int32,
                                       device=q_seg.device)], dim=1,
                )
            bq = fit_block(qpad, 128)
            bk = fit_block(s_max, c.flash_block_k)
            pt_flat = page_table.long()
        else:
            # the kernel's int32 operands, converted once for all layers
            pt32, len32, act32 = (
                t.to(torch.int32).contiguous()
                for t in (page_table, lengths, active)
            )
        for i in range(n_layers):
            w = self._serving_layer(i)
            q, k_new, v_new = self._qkv(x, w)
            cache_k[i].index_put_((widx, woff), k_new[:, 0])
            cache_v[i].index_put_((widx, woff), v_new[:, 0])
            if qpad > 1:
                q = torch.cat(
                    [q, torch.zeros((b, qpad - 1, h, hd), dtype=q.dtype,
                                    device=q.device)], dim=1,
                )
            if kernel == "paged":
                o = paged_attention(
                    q, cache_k[i], cache_v[i], pt32, len32, act32,
                    block_h=block_h, interpret=interpret,
                )[:, :1]
            else:
                k_full = cache_k[i][pt_flat].reshape(b, s_max, h, hd)
                v_full = cache_v[i][pt_flat].reshape(b, s_max, h, hd)
                o = flash_attention(
                    q, k_full, v_full, causal=True, kv_offset=s_max - 1,
                    segment_ids=q_seg, kv_segment_ids=kv_seg,
                    block_q=bq, block_k=bk,
                )[:, :1]
            x = x + self._out_proj(o, w)
            x = self._mlp_half(x, w)
        logits = self._serving_head(x)  # [B, 1, V]
        return logits[:, 0].float(), cache_k, cache_v

    @torch.no_grad()
    def prefill_kv_cached(
        self,
        tokens: torch.Tensor,
        positions: torch.Tensor,
        segment_ids: torch.Tensor,
        prefix_k: torch.Tensor,
        prefix_v: torch.Tensor,
        prefix_seg: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Tail prefill that attends through an already-cached prefix.

        The prefix-cache hit path: a request whose leading pages matched
        the radix cache computes K/V only for its tail, and each layer
        concatenates the gathered prefix K/V in front of the tail's own
        and runs flash attention at ``kv_offset = Sp`` (the bottom-aligned
        geometry decode uses), so query row r sees every live prefix key
        and tail keys ≤ r: the causal mask of the full prompt.

        tokens [B, S] int — ONE document tail per row; positions [B, S] —
        ABSOLUTE positions (cached tokens + offset); segment_ids [B, S] —
        1 on tail tokens, 0 on padding; prefix_k/prefix_v [L, B, Sp, H,
        Dh] — each row's cached pages gathered contiguous; prefix_seg
        [B, Sp] — 1 on live prefix positions, 0 past the row's prefix.

        → (logits [B, S, V] compute dtype, k [L, B, S, H, Dh], v) — the
        K/V of the TAIL only.
        """
        c = self.config
        s = tokens.shape[1]
        sp = prefix_k.shape[2]
        x = self._serving_embed(tokens, positions)
        bq = fit_block(s, c.flash_block_q)
        bk = fit_block(sp + s, c.flash_block_k)
        segment_ids = segment_ids.to(torch.int32)
        kv_seg = torch.cat([prefix_seg.to(torch.int32), segment_ids], dim=1)
        ks, vs = [], []
        for i in range(c.n_layers):
            w = self._serving_layer(i)
            q, k, v = self._qkv(x, w)
            ks.append(k)
            vs.append(v)
            o = flash_attention(
                q,
                torch.cat([prefix_k[i].to(k.dtype), k], dim=1),
                torch.cat([prefix_v[i].to(v.dtype), v], dim=1),
                causal=True, kv_offset=sp, block_q=bq, block_k=bk,
                segment_ids=segment_ids, kv_segment_ids=kv_seg,
            )
            x = x + self._out_proj(o, w)
            x = self._mlp_half(x, w)
        return self._serving_head(x), torch.stack(ks), torch.stack(vs)

    @torch.no_grad()
    def decode_kv_spec(
        self,
        tokens: torch.Tensor,
        lengths: torch.Tensor,
        q_lens: torch.Tensor,
        active: torch.Tensor,
        cache_k: torch.Tensor,
        cache_v: torch.Tensor,
        page_table: torch.Tensor,
        *,
        q_pad: int = 1,
        kernel: str = "gather",
        block_h: Optional[int] = None,
        interpret: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Draft-verify decode: score Q positions per slot in ONE step.

        tokens [B, Q] int — row 0 is the slot's last committed token (at
        position lengths[b]), rows 1..q_lens[b]−1 its draft (at positions
        lengths[b] + r); rows past q_lens[b] are padding. q_lens [B] int —
        real rows per slot (≥ 1; a plain slot rides with 1). The rest is
        decode_kv's.

        → (logits [B, Q, V] fp32, cache_k, cache_v): logits[b, r] predicts
        position lengths[b] + r + 1. ALL Q rows' K/V are written at their
        positions first (dead and pad rows to scratch page 0), so an
        accepted prefix is already in the pool and a rejected tail sits
        past the rewound length, masked by both kernels until it is
        overwritten.

        ``kernel="paged"``: the paged kernel with ``q_lens`` (row r sees
        positions ≤ lengths + r). ``"gather"``: the committed window
        [B, S_max] gathered with STRICT masking (pos < lengths) and the
        Q fresh rows' K/V concatenated behind it at ``kv_offset = S_max``;
        dead query rows take segment 2, which no key carries.
        """
        c = self.config
        if kernel not in ("paged", "gather"):
            raise ValueError(
                f"decode_kv_spec kernel must be 'paged' or 'gather', "
                f"got {kernel!r}"
            )
        n_layers, _n_pages, page_size, h, hd = cache_k.shape
        b, q_n = tokens.shape
        n_page_slots = page_table.shape[1]
        s_max = n_page_slots * page_size
        qpad = max(1, int(q_pad))
        qp = -(-q_n // qpad) * qpad        # Q rounded up to the pad
        dev = lengths.device
        lengths = lengths.long()
        q_lens = q_lens.long()
        active = active.bool()
        r = torch.arange(q_n, device=dev)
        pos = lengths[:, None] + r[None, :]                    # [B, Q]
        live = active[:, None] & (r[None, :] < q_lens[:, None])
        x = self._serving_embed(tokens, torch.clamp(pos, 0, c.seq_len - 1))
        widx = page_table.long()[
            torch.arange(b, device=dev)[:, None],
            torch.clamp(pos // page_size, 0, n_page_slots - 1),
        ]
        widx = torch.where(live, widx, 0)
        woff = pos % page_size
        if kernel == "gather":
            kv_pos = torch.arange(s_max, device=dev)[None, :]
            kv_seg_win = (kv_pos < lengths[:, None]) & active[:, None]
            tail_r = torch.arange(qp, device=dev)[None, :]
            tail_live = (tail_r < q_lens[:, None]) & active[:, None]
            kv_seg = torch.cat([kv_seg_win, tail_live], dim=1).to(torch.int32)
            q_seg = torch.where(tail_live, 1, 2).to(torch.int32)
            bq = fit_block(qp, 128)
            bk = fit_block(s_max + qp, c.flash_block_k)
            pt_flat = page_table.long()
        else:
            pt32, len32, ql32, act32 = (
                t.to(torch.int32).contiguous()
                for t in (page_table, lengths, q_lens, active)
            )

        def pad_rows(t):
            if qp == q_n:
                return t
            return torch.cat([t, t.new_zeros((b, qp - q_n, h, hd))], dim=1)

        for i in range(n_layers):
            w = self._serving_layer(i)
            q, k_new, v_new = self._qkv(x, w)
            cache_k[i].index_put_((widx, woff), k_new)
            cache_v[i].index_put_((widx, woff), v_new)
            q = pad_rows(q)
            if kernel == "paged":
                o = paged_attention(
                    q, cache_k[i], cache_v[i], pt32, len32, act32,
                    q_lens=ql32, block_h=block_h, interpret=interpret,
                )[:, :q_n]
            else:
                k_full = cache_k[i][pt_flat].reshape(b, s_max, h, hd)
                v_full = cache_v[i][pt_flat].reshape(b, s_max, h, hd)
                o = flash_attention(
                    q,
                    torch.cat([k_full, pad_rows(k_new)], dim=1),
                    torch.cat([v_full, pad_rows(v_new)], dim=1),
                    causal=True, kv_offset=s_max,
                    segment_ids=q_seg, kv_segment_ids=kv_seg,
                    block_q=bq, block_k=bk,
                )[:, :q_n]
            x = x + self._out_proj(o, w)
            x = self._mlp_half(x, w)
        logits = self._serving_head(x)  # [B, Q, V]
        return logits.float(), cache_k, cache_v

    # -- training forward --------------------------------------------------------
    def _attn_half(self, x: torch.Tensor, w: Dict[str, torch.Tensor],
                   segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
        c = self.config
        q, k, v = self._qkv(x, w)
        o = attn_mod.attention(
            q, k, v, causal=True, impl=c.attn_impl,
            block_q=c.flash_block_q, block_k=c.flash_block_k,
            layout=c.sequence_layout, window=c.attn_window,
            segment_ids=segment_ids,
        )
        return x + self._out_proj(o, w)

    def _forward_trunk(self, tokens: torch.Tensor,
                       positions: Optional[torch.Tensor] = None,
                       segment_ids: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """Embed + blocks → pre-final-layernorm [B, S, D] in the compute
        dtype, differentiable in every parameter."""
        c = self.config
        tok = self.tok_embed.to(c.dtype)
        x = self._embed(tok, self.pos_embed.to(c.dtype), tokens, positions)
        remat = c.remat and torch.is_grad_enabled()
        checkpoint = functools.partial(
            torch.utils.checkpoint.checkpoint, use_reentrant=False,
            context_fn=_remat_context,
        )
        for w in self._train_layers():
            if remat and remat_attention(c):
                x = checkpoint(self._block, x, w, segment_ids)
            elif remat:
                x = checkpoint(self._mlp_half,
                               self._attn_half(x, w, segment_ids), w)
            else:
                x = self._block(x, w, segment_ids)
        return x

    def _block(self, x: torch.Tensor, w: Dict[str, torch.Tensor],
               segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
        return self._mlp_half(self._attn_half(x, w, segment_ids), w)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The differentiable forward: tokens [B, S] int → logits
        [B, S, V] in the compute dtype."""
        c = self.config
        x = self._forward_trunk(tokens, positions, segment_ids)
        w_out = (self.tok_embed.t() if c.tie_embeddings else self.head)
        return self._head(x, w_out.to(c.dtype))

    def loss(self, batch: Dict[str, Any],
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Metrics]:
        """batch: ``tokens`` [B, S] int; optional ``loss_mask`` [B, S]
        (1.0 = count this target position), ``segment_ids`` [B, S]
        (packed documents, 0 = padding), ``positions`` and pre-shifted
        ``targets`` [B, S] (position i predicts targets[i]). → (scalar
        loss, {"loss", "accuracy", "tokens"}). No dropout: ``generator``
        is unused."""
        del generator
        c = self.config
        dev = self.device

        def get(key):
            x = batch.get(key)
            return None if x is None else torch.as_tensor(x, device=dev)

        tokens = get("tokens").long()
        targets, positions = get("targets"), get("positions")
        segment_ids, mask = get("segment_ids"), get("loss_mask")
        mask = (torch.ones(tokens.shape, dtype=torch.float32, device=dev)
                if mask is None else mask.float())
        if segment_ids is not None and targets is None:
            # Packed documents with the in-model shift: a prediction that
            # crosses a document boundary (the id changes) or lands on
            # padding (id 0) does not count.
            boundary = torch.cat([
                torch.ones_like(mask[:, :1]),
                (segment_ids[:, 1:] == segment_ids[:, :-1]).float(),
            ], dim=1)
            mask = mask * boundary * (segment_ids != 0)
        if c.fused_loss:
            # The reference also requires one pipeline stage and no
            # experts; the constructor refuses both.
            return self._loss_fused(tokens, targets, positions, mask,
                                    segment_ids)
        logits = self.forward(tokens, positions, segment_ids).float()
        if targets is not None:
            sums = _aligned_token_sums(logits, targets, mask)
        else:
            sums = _next_token_sums(logits, tokens, mask)
        nll_sum, z_sum, acc_sum, n_tok = sums
        n = torch.clamp(n_tok, min=1.0)
        loss = nll_sum / n
        if c.z_loss:
            loss = loss + c.z_loss * z_sum / n
        acc = acc_sum / n
        return loss, {"loss": loss, "accuracy": acc, "tokens": n_tok}

    def _loss_fused(self, tokens, targets, positions, mask, segment_ids):
        """The loss through the chunked cross-entropy: the same objective
        as the dense path, without the [B, S, V] logits."""
        c = self.config
        x = self._forward_trunk(tokens, positions, segment_ids)
        hidden = _layernorm(x, self.lnf_scale, self.lnf_bias)
        w_out = (self.tok_embed.t() if c.tie_embeddings else self.head)
        if targets is None:
            # the in-model shift: position i predicts token i+1
            hidden = hidden[:, :-1]
            targets = tokens[:, 1:]
            mask = mask[:, 1:]
        obj, _nll, _z, acc_sum, n_tok = fused_next_token_sums(
            hidden, w_out.to(c.dtype), targets, mask, z_loss=c.z_loss or 0.0)
        n = torch.clamp(n_tok, min=1.0)
        loss = obj / n
        return loss, {"loss": loss, "accuracy": acc_sum / n, "tokens": n_tok}


def remat_attention(config: GPTConfig) -> bool:
    """Whether attention goes inside the remat boundary: ``remat_attention``,
    or ``layer_loop="auto"`` past 16384 tokens, where the reference found
    the flash residuals that the split remat saves too large."""
    return config.remat_attention or (
        config.layer_loop == "auto" and config.seq_len > 16384)


# ---------------------------------------------------------------------------
# Weight carry-over from the JAX package
# ---------------------------------------------------------------------------
def _flatten(tree: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def load_jax_params(model: GPT, tree: Dict[str, Any], *,
                    serving_copy: bool = False) -> GPT:
    """Fill `model`'s parameters from the reference's parameter pytree,
    given as nested dicts of numpy arrays (``jax.device_get(params)``) or
    of tensors (``trainer._checkpoint.load_pytree``).

    Every key and every shape is checked before anything is written:
    a key missing on either side raises ``KeyError``, a shape mismatch
    ``ValueError``. ``serving_copy`` then makes the compute-dtype copy
    (``GPT.cache_compute_weights``); without it any earlier copy is
    dropped, so the forward casts the new values per call."""
    flat = dict(_flatten(tree))
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(flat))
    unexpected = sorted(set(flat) - set(params))
    if missing or unexpected:
        raise KeyError(
            f"parameter tree does not match {type(model).__name__}: "
            f"missing {missing}, unexpected {unexpected}"
        )
    arrays = {}
    for name, p in params.items():
        arr = flat[name]
        if not isinstance(arr, torch.Tensor):
            arr = torch.tensor(np.asarray(arr, dtype=np.float32))
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(
                f"parameter {name}: shape {tuple(arr.shape)} != "
                f"{tuple(p.shape)}"
            )
        arrays[name] = arr
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(arrays[name])
    model._compute.clear()
    if serving_copy:
        model.cache_compute_weights()
    return model
