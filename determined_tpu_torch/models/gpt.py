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
the ``[B, S, V]`` logits.

Mixture of experts (``n_experts`` above 0): every block's MLP is the
reference's top-1 (switch) layer (``_moe_mlp``): a router [d, E] in fp32
softmax, each token to its top expert's [E, C, D] bucket up to the
capacity ``C = int(capacity_factor · T / E)`` (the tokens past it
dropped), the experts' MLPs ``we_in`` [E, d, f] / ``we_out`` [E, f, d],
and the combine times the gate; the loss adds ``0.01 · aux / n_layers``,
the switch load-balance term summed over the blocks. The dispatch is the
index form of ``parallel/experts.py`` (``moe_dispatch = "dense"``: the
reference's one-hot einsums, the plain version: the outputs bit for bit
the same, the gradients within rounding).
Serving runs it too, its capacity taken from each call's own tokens,
padding included, as the reference's. On a mesh the experts split over
``expert`` (E/ep a rank) and ``tensor`` (their ``mlp`` dimension: ``we_in``
[L, E/ep, d, f/tp], ``be_in``, ``we_out`` [L, E/ep, f/tp, d]), and the
capacity and its cumsum run over the global [B·S] tokens of data × fsdp
× context, whatever splits the sequence (``parallel/experts.py``).

Pipeline stages (``pipeline_stages`` above 1, over a mesh whose
``pipeline`` axis has as many ranks): stage d runs layers [d·L/S,
(d+1)·L/S) of each microbatch (``num_microbatches``, 0: 2S) through
``parallel/pipeline.py``: ``"gpipe"`` and ``"circular"`` (V =
``pipeline_virtual_stages`` chunks a stage, round robin) embed on stage 0
before the pipeline and apply the head after it, on the outputs that the
schedule replicates over the stages, the carry fp32 between stages;
``"1f1b"`` (training; the forward-only methods take the fill-drain
layout) embeds on stage 0, computes the head and loss on the last stage,
and hands the schedule's finished gradients to autograd through
``_Finished``. Every rank holds every block (the rules do not map
"layers"); a stage's gradients are its own layers', the embedding's arise
on stage 0 and the head's where the loss is computed, and the Trainer sums
them over the pipeline group (``trainer/_mesh.py``). The reference's
guards hold by the same words. Experts beside a pipeline are refused, as
the reference refuses them.

Under a device mesh (``GPT(..., mesh=)``, the Trainer's layout over the
reference's six axes) the module computes on each rank's local rows
and, on a context axis above 1, its chunk of the sequence: attention goes through ``models.attention`` with the mesh
(``"auto"``: ring attention on the context group; ``attn_impl="ulysses"``
the all-to-all), and a rank's learned position ids are its global ones
(contiguous: ``context_index · S_local + arange(S_local)``; zigzag, where
the zigzag loader's batches arrive pre-shifted in zigzag order: its
columns of the replicated ``positions`` map). ``logical_axes()`` names
the parameters' dimensions for the sharding rules, in the reference's
structure and names.

On a tensor axis above 1 (``tensor=t``) the module holds this rank's
slice of each parameter whose dimensions the reference splits over
``tensor`` ("heads", "mlp", "vocab"; ``tensor_dims``): ``wqkv`` [L, d, 3,
H/t, Dh], ``bqkv``, ``wo`` [L, H/t, Dh, d], ``wi`` [L, d, F/t], ``bi``,
``wo_mlp`` [L, F/t, d], ``tok_embed`` [V/t, d] (and ``head`` [d, V/t]),
each cut from one global init from the seed; the others are whole. The
trunk runs Megatron's splits (``parallel/tensor.py``): the inputs of
``wqkv``, ``wi`` and the head go through *f*, the outputs of ``wo`` and
``wo_mlp`` through *g* before their replicated biases; the embedding is
the vocab-parallel lookup; attention runs on the rank's H/t heads; the
logits are the rank's [B, S, V/t] columns, and the loss is the
vocab-parallel cross-entropy (``fused_loss`` takes that dense path, as
the reference turns its chunked loss off on a tensor mesh). The serving
methods are refused on such a mesh: the reference serves on none.

The methods drop the reference's leading ``params`` argument: the module
owns its parameters.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.models import attention as attn_mod
from determined_tpu_torch.models.base import (  # noqa: F401 (_flatten: tests)
    Metrics,
    Model,
    _flatten,
    load_params,
)
from determined_tpu_torch.ops.flash_attention import (
    fit_block,
    flash_attention,
)
from determined_tpu_torch.ops.fused_cross_entropy import fused_next_token_sums
from determined_tpu_torch.ops.paged_attention import paged_attention
from determined_tpu_torch.parallel import experts as moe
from determined_tpu_torch.parallel.pipeline import (
    circular_pipeline_apply,
    one_f_one_b_grads,
    pipeline_apply,
)
from determined_tpu_torch.parallel.tensor import (
    copy_to_tensor,
    reduce_from_tensor,
    vocab_parallel_embedding,
    vocab_parallel_token_sums,
)


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
    # The reference's knobs, carried for config parity. The port reads
    # every one but scan_unroll (XLA's loop unrolling) and layer_loop,
    # which it reads only for the auto rematted attention past 16k tokens.
    # flash_autotune resolves the training blocks through
    # ops/flash_autotune.py (GPT._flash_blocks).
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


#: Block parameters the forward keeps fp32 (layernorm scales and biases,
#: as in the reference); it casts every other one to the compute dtype.
_BLOCK_FP32 = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")

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


class GPT(Model):
    """Decoder-only LM over [B, S] int tokens. Parameters are created on
    ``device`` (CUDA unless the caller passes ``device="cpu"``) from a
    seeded ``torch.Generator``: normal(0.02), with the residual
    projections (``wo``, ``wo_mlp``) at 0.02/sqrt(2L), as the reference's
    ``GPT.init``."""

    def __init__(self, config: GPTConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 *, seed: int = 0, mesh: Any = None) -> None:
        super().__init__()
        c = config
        #: the context axis's degree: above 1 each rank holds one chunk
        #: of the sequence
        self._context = 1
        #: the tensor axis's degree, this rank's index on it and its group
        #: (None: one rank); the first vocabulary row of this rank's slice
        self._tensor, self._tensor_index, self._tgroup = 1, 0, None
        #: the pipeline axis's degree, this rank's stage and its group
        self._pipeline, self._stage, self._pgroup = 1, 0, None
        #: the expert axis's degree and this rank's index on it; the
        #: experts' groups (``parallel/experts.py``: the ranks that share
        #: a token's expert work, the ranks whose tokens share one
        #: capacity)
        self._expert, self._expert_index = 1, 0
        self._moe = moe.NO_GROUPS
        if mesh is not None:
            from determined_tpu_torch.parallel.mesh import (
                _axis,
                axis_index,
                context_size,
                refuse_later_axes,
                tensor_index,
                tensor_size,
            )
            from determined_tpu_torch.parallel.tensor import tensor_group

            refuse_later_axes(mesh, "a GPT mesh")
            self._context = context_size(mesh)
            self._tensor = tensor_size(mesh)
            self._tensor_index = tensor_index(mesh)
            self._tgroup = tensor_group(mesh)
            self._pipeline = _axis(mesh, "pipeline")
            self._expert = _axis(mesh, "expert")
            if self._pipeline > 1:
                self._stage = axis_index(mesh, "pipeline")
                self._pgroup = mesh.get_group("pipeline")
            if c.n_experts:
                self._expert_index = axis_index(mesh, "expert")
                self._moe = moe.groups(mesh)
        if c.n_experts:
            if c.pipeline_stages > 1:
                raise NotImplementedError(
                    "MoE+pipeline composition not supported yet")
            if c.n_experts % self._expert:
                raise ValueError(
                    f"GPT n_experts={c.n_experts} is not divisible by the "
                    f"expert axis ({self._expert}): each rank of the expert "
                    "group holds n_experts/expert of the experts")
        t = self._tensor
        for what, n in (("n_heads", c.n_heads), ("d_ff", c.d_ff),
                        ("vocab_size", c.vocab_size)):
            if n % t:
                raise ValueError(
                    f"GPT {what}={n} is not divisible by the tensor axis "
                    f"({t}): each rank of the tensor group holds {what}/"
                    "tensor of the split parameters")
        self._heads = c.n_heads // t
        self._vocab_start = self._tensor_index * (c.vocab_size // t)
        #: this rank's experts: [first, first + n)
        self._experts = c.n_experts // self._expert
        self._expert_first = self._expert_index * self._experts
        if c.sequence_layout not in ("contiguous", "zigzag"):
            raise ValueError(f"unknown sequence_layout {c.sequence_layout!r}")
        if c.sequence_layout == "zigzag" and self._context == 1:
            raise ValueError(
                "sequence_layout='zigzag' needs a sharded context axis "
                "(ring attention over a mesh with context > 1)"
            )
        #: the device mesh the Trainer trains this model over (None: one
        #: device); the forward computes on this rank's rows either way.
        self.mesh = mesh
        self.config = c
        #: the experts' dispatch: "index" (the main path) or "dense" (the
        #: reference's one-hot einsums, the plain version)
        self.moe_dispatch = "index"
        #: per layer, (dropped tokens, tokens) of this rank in the last
        #: forward through the experts (device tensors)
        self.moe_drops: Dict[int, Tuple[torch.Tensor, int]] = {}
        #: {parameter name: {mesh axis: the dimension this rank holds a
        #: slice of}}: on a tensor axis the one that ``logical_axes()``
        #: names "heads", "mlp" or "vocab", on an expert axis "expert", the
        #: names the rules map to those axes
        self._slice_dims: Dict[str, Dict[str, int]] = {}
        if t > 1 or self._expert > 1:
            from determined_tpu_torch.parallel.sharding import (
                DEFAULT_RULES,
                flatten_axes,
            )

            for name, axes in flatten_axes(self.logical_axes()).items():
                for dim, logical in enumerate(axes):
                    axis = DEFAULT_RULES.lookup(logical)
                    if axis in ("tensor", "expert") and self._degree(axis) > 1:
                        self._slice_dims.setdefault(name, {})[axis] = dim
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        pd = c.param_dtype
        d, f, h, hd, n_l = c.d_model, c.d_ff, c.n_heads, c.head_dim, c.n_layers
        res_std = 0.02 / (2 * n_l) ** 0.5

        def keep(name, t):
            """The global init `t` of `name`, or this rank's slice of it."""
            part = self._model_slice(name, t)
            return nn.Parameter(t if part is t else part.clone())

        def normal(name, shape, std):
            t = torch.empty(shape, dtype=pd, device=dev)
            return keep(name, t.normal_(0.0, std, generator=gen))

        def full(name, shape, value):
            return keep(name, torch.full(shape, value, dtype=pd, device=dev))

        self.tok_embed = normal("tok_embed", (c.vocab_size, d), 0.02)
        self.pos_embed = normal("pos_embed", (c.seq_len, d), 0.02)
        blocks = {
            "ln1_scale": (full, (n_l, d), 1.0),
            "ln1_bias": (full, (n_l, d), 0.0),
            "wqkv": (normal, (n_l, d, 3, h, hd), 0.02),
            "bqkv": (full, (n_l, 3, h, hd), 0.0),
            "wo": (normal, (n_l, h, hd, d), res_std),
            "bo": (full, (n_l, d), 0.0),
            "ln2_scale": (full, (n_l, d), 1.0),
            "ln2_bias": (full, (n_l, d), 0.0),
        }
        if c.n_experts:
            e = c.n_experts
            blocks.update({
                "router": (normal, (n_l, d, e), 0.02),
                "we_in": (normal, (n_l, e, d, f), 0.02),
                "be_in": (full, (n_l, e, f), 0.0),
                "we_out": (normal, (n_l, e, f, d), res_std),
                "bo_mlp": (full, (n_l, d), 0.0),
            })
        else:
            blocks.update({
                "wi": (normal, (n_l, d, f), 0.02),
                "bi": (full, (n_l, f), 0.0),
                "wo_mlp": (normal, (n_l, f, d), res_std),
                "bo_mlp": (full, (n_l, d), 0.0),
            })
        self.blocks = nn.ParameterDict({
            name: make(f"blocks.{name}", shape, arg)
            for name, (make, shape, arg) in blocks.items()})
        self.lnf_scale = full("lnf_scale", (d,), 1.0)
        self.lnf_bias = full("lnf_bias", (d,), 0.0)
        if not c.tie_embeddings:
            self.head = normal("head", (d, c.vocab_size), 0.02)
        #: the optional serving copy: compute-dtype casts made once
        #: (cache_compute_weights), keyed by parameter name.
        self._compute: Dict[str, torch.Tensor] = {}
        #: the Trainer's layout on an fsdp axis (``gather_at_use``) and
        #: {name: fsdp dimension} of the parameters held as its blocks
        self._fsdp: Any = None
        self._fsdp_dims: Dict[str, int] = {}
        # (block_q, block_k) of the training forward: the config's, or the
        # autotuner's probed winner (flash_autotune), resolved here, when
        # the model is built, because the probe launches kernels.
        self._resolved_flash_blocks: Optional[Tuple[int, int]] = None
        if c.flash_autotune:
            self._flash_blocks()

    def _flash_blocks(self) -> Tuple[int, int]:
        if self._resolved_flash_blocks is None:
            c = self.config
            if c.flash_autotune:
                from determined_tpu_torch.ops.flash_autotune import (
                    tune_flash_blocks,
                )

                # The per-device kernel shapes: a context axis gives each
                # hop the local chunk, a tensor axis n_heads/tensor heads.
                s_local = max(c.seq_len // max(self._context, 1), 1)
                h_local = max(c.n_heads // max(self._tensor, 1), 1)
                self._resolved_flash_blocks = tune_flash_blocks(
                    s_q=s_local, n_heads=h_local, head_dim=c.head_dim,
                    dtype=c.dtype, causal=True, window=c.attn_window,
                    want_q=c.flash_block_q, want_k=c.flash_block_k,
                    device=self.device,
                )
            else:
                self._resolved_flash_blocks = (
                    c.flash_block_q, c.flash_block_k
                )
        return self._resolved_flash_blocks

    def train_flops_per_token(self) -> float:
        """The config's fwd+bwd FLOPs per token (the trainer's
        ``step_flops``)."""
        return self.config.train_flops_per_token()

    @property
    def pipelined(self) -> bool:
        """Whether the model runs pipeline stages: each stage computes its
        own layers' gradients, and the Trainer sums them over the
        pipeline group."""
        return self.config.pipeline_stages > 1

    def _degree(self, axis: str) -> int:
        return {"tensor": self._tensor, "expert": self._expert}[axis]

    def _index(self, axis: str) -> int:
        return {"tensor": self._tensor_index,
                "expert": self._expert_index}[axis]

    def tensor_dims(self) -> Dict[str, int]:
        """{parameter name: the dimension this module holds a tensor
        slice of}; empty unless the tensor axis is above 1."""
        return {n: d["tensor"] for n, d in self._slice_dims.items()
                if "tensor" in d}

    def expert_dims(self) -> Dict[str, int]:
        """{parameter name: the dimension this module holds its experts'
        slice of}; empty unless the expert axis is above 1."""
        return {n: d["expert"] for n, d in self._slice_dims.items()
                if "expert" in d}

    def _model_slice(self, name: str, x: Any) -> Any:
        """This rank's slice of the whole parameter `name` (a tensor or a
        numpy array): its tensor and expert slices; the array itself when
        `name` is not split."""
        for axis, dim in self._slice_dims.get(name, {}).items():
            n = x.shape[dim] // self._degree(axis)
            lo = self._index(axis) * n
            x = x[(slice(None),) * dim + (slice(lo, lo + n),)]
        return x

    def _refuse_tensor(self, what: str) -> None:
        for axis in ("tensor", "expert"):
            if any(axis in d for d in self._slice_dims.values()):
                raise NotImplementedError(
                    f"GPT.{what} on a mesh with {axis}="
                    f"{self._degree(axis)}: the reference serves on no "
                    "mesh; serve from a GPT built without one")
        if self._fsdp_dims:
            raise NotImplementedError(
                f"GPT.{what} on a model that holds its fsdp blocks: the "
                "reference serves on no mesh; serve from a GPT built "
                "without one (Trainer.full_parameters gives its weights)")

    def logical_axes(self) -> Dict[str, Any]:
        """The reference's ``GPT.logical_axes()``: each parameter's
        dimensions by logical name, nested as ``named_parameters`` names
        the leaves (``blocks.wqkv`` → ``["blocks"]["wqkv"]``)."""
        blocks: Dict[str, Any] = {
            "ln1_scale": ("layers", "norm"),
            "ln1_bias": ("layers", "norm"),
            "wqkv": ("layers", "embed", None, "heads", "head_dim"),
            "bqkv": ("layers", None, "heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed"),
            "bo": ("layers", "norm"),
            "ln2_scale": ("layers", "norm"),
            "ln2_bias": ("layers", "norm"),
        }
        if self.config.n_experts:
            blocks.update(
                router=("layers", "embed", None),
                we_in=("layers", "expert", "embed", "mlp"),
                be_in=("layers", "expert", "mlp"),
                we_out=("layers", "expert", "mlp", "embed"),
                bo_mlp=("layers", "norm"),
            )
        else:
            blocks.update(
                wi=("layers", "embed", "mlp"),
                bi=("layers", "mlp"),
                wo_mlp=("layers", "mlp", "embed"),
                bo_mlp=("layers", "norm"),
            )
        axes: Dict[str, Any] = {
            "tok_embed": ("vocab", "embed"),
            "pos_embed": (None, "embed"),
            "blocks": blocks,
            "lnf_scale": ("norm",),
            "lnf_bias": ("norm",),
        }
        if not self.config.tie_embeddings:
            axes["head"] = ("embed", "vocab")
        return axes

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
        for name in ("tok_embed", "pos_embed", "head",
                     *(f"blocks.{n}" for n in self._block_compute())):
            p = params.get(name)
            if p is not None and p.dtype != dtype:
                self._compute[name] = p.detach().to(dtype)

    def _block_compute(self) -> List[str]:
        """The block parameters the forward casts to the compute dtype."""
        return [n for n in self.blocks if n not in _BLOCK_FP32]

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
        w = _Weights({n: self._bw(n, i) for n in self._block_compute()})
        w.update({n: self.blocks[n][i] for n in _BLOCK_FP32})
        w.layer = i
        return w

    def gather_at_use(self, layout: Any) -> bool:
        """On an fsdp axis the split parameters are this rank's blocks;
        the training forward gathers each where it uses it: a layer's
        weights in that layer (inside its rematted region, whose
        recompute gathers again), the embedding, positional table and
        head once each."""
        self._fsdp = layout
        self._fsdp_dims = layout.split_dims
        return True

    def _train_layers(self) -> List[Dict[str, torch.Tensor]]:
        """Every layer's weights cast from the live parameters INSIDE the
        graph: the training forward's gradients reach the fp32 masters."""
        return self._layer_weights(dict(self.blocks))

    def _layer_weights(self, blocks: Dict[str, torch.Tensor]
                       ) -> List[Dict[str, torch.Tensor]]:
        """The weights of each layer of `blocks` (stacked [k, ...] leaves
        by name: the parameters, or a pipeline stage's views of them),
        cast in the graph (one cast per stacked leaf, then per-layer
        views). A block parameter split over
        fsdp is gathered at each use of its layer's weight instead
        (``_Weights``)."""
        c = self.config
        cols: Dict[str, Any] = {}
        for n in self._block_compute():
            dim = self._fsdp_dims.get(f"blocks.{n}")
            if dim is None:
                cols[n] = blocks[n].to(c.dtype).unbind(0)
            else:
                cols[n] = [functools.partial(self._fsdp.gather, layer,
                                             dim - 1, c.dtype)
                           for layer in blocks[n].unbind(0)]
        cols.update({n: blocks[n].unbind(0) for n in _BLOCK_FP32})
        layers = []
        for i in range(len(cols["bo"])):
            w = _Weights({n: cols[n][i] for n in cols})
            w.layer = i
            layers.append(w)
        return layers

    # -- pieces of a block ---------------------------------------------------
    def _qkv(self, x: torch.Tensor, w: Dict[str, torch.Tensor]):
        """ln1 + fused QKV projection → q, k, v [B, S, H, Dh] (views of
        one [B, S, 3, H, Dh] tensor)."""
        c = self.config
        h = copy_to_tensor(_layernorm(x, w["ln1_scale"], w["ln1_bias"]),
                           self._tgroup)
        qkv = (
            torch.matmul(h, w["wqkv"].reshape(c.d_model, -1))
            + w["bqkv"].reshape(-1)
        ).view(*x.shape[:-1], 3, self._heads, c.head_dim)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def _out_proj(self, o: torch.Tensor, w: Dict[str, torch.Tensor]):
        """einsum("bshk,hkd->bsd", o, wo) + bo (the rank's heads' share,
        summed over the tensor group before the bias)."""
        c = self.config
        return reduce_from_tensor(torch.matmul(
            o.reshape(*o.shape[:2], self._heads * c.head_dim),
            w["wo"].reshape(self._heads * c.head_dim, c.d_model),
        ), self._tgroup) + w["bo"]

    def _mlp_half(self, x: torch.Tensor, w: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """→ (x + MLP(ln2(x)), the experts' aux loss; None without
        experts)."""
        if self.config.n_experts:
            m, aux = self._moe_mlp(
                _layernorm(x, w["ln2_scale"], w["ln2_bias"]), w)
            return x + m, aux
        h = copy_to_tensor(_layernorm(x, w["ln2_scale"], w["ln2_bias"]),
                           self._tgroup)
        m = torch.matmul(h, w["wi"]) + w["bi"]
        # jax.nn.gelu defaults to the tanh approximation.
        m = F.gelu(m, approximate="tanh")
        m = reduce_from_tensor(torch.matmul(m, w["wo_mlp"]),
                               self._tgroup) + w["bo_mlp"]
        return x + m, None

    def _moe_mlp(self, h: torch.Tensor, w: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-1 (switch) MoE over ln2's output h [B, S, D] → (output,
        load-balance aux loss): the router in fp32, this rank's experts
        (their ``mlp`` slice on a tensor axis) on their capacity buckets
        (``parallel/experts.py``), the partial combines summed over the
        expert × tensor group in one all-reduce."""
        b, s, d = h.shape
        g = self._moe
        x = h.reshape(b * s, d)
        # routing decisions must not round in the compute dtype
        gates = torch.softmax(torch.matmul(x, w["router"]).float(), dim=-1)
        routing = moe.route(gates, self.config.capacity_factor, rows=b,
                            groups=g)
        first, n = self._expert_first, self._experts
        xe = moe.dispatch(moe.copy_to_expert(x, g.compute), routing,
                          first, n, self.moe_dispatch)
        he = F.gelu(torch.matmul(xe, w["we_in"]) + w["be_in"][:, None, :],
                    approximate="tanh")
        ye = torch.matmul(he, w["we_out"])
        gate = moe.copy_to_expert(routing.gate, g.compute)
        y = moe.combine(ye, routing, gate, first, n, self.moe_dispatch)
        y = moe.reduce_from_expert(y, g.compute) + w["bo_mlp"]
        layer = getattr(w, "layer", None)
        if layer is not None:
            self.moe_drops[layer] = (routing.dropped.detach(), b * s)
        return y.reshape(b, s, d), routing.aux

    def _embed(self, tok: torch.Tensor, pos: torch.Tensor,
               tokens: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        # F.embedding, not tok[ids]: its backward sums the rows of a
        # repeated id in a fixed order; indexing's (index_put_ with
        # accumulate) adds them by atomics in any order across CPU threads.
        x = vocab_parallel_embedding(tokens.long(), tok, self._vocab_start,
                                     self._tgroup)
        if positions is not None:
            return x + F.embedding(positions.long(), pos)
        return x + pos[: tokens.shape[1]]

    def _head(self, x: torch.Tensor, w_out: torch.Tensor,
              lnf: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> torch.Tensor:
        """Logits [..., V] (on a tensor axis this rank's V/t columns);
        `lnf`: the final layernorm's (scale, bias) in place of the
        parameters."""
        scale, bias = lnf or (self.lnf_scale, self.lnf_bias)
        h = _layernorm(x, scale, bias)
        return torch.matmul(copy_to_tensor(h, self._tgroup), w_out)

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
        self._refuse_tensor("apply")
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
        self._refuse_tensor("prefill_kv")
        c = self.config
        if c.pipeline_stages > 1:
            raise ValueError("prefill_kv does not support pipeline stages")
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
            x, _aux = self._mlp_half(x, w)
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
        self._refuse_tensor("decode_kv")
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
            x, _aux = self._mlp_half(x, w)
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
        self._refuse_tensor("prefill_kv_cached")
        c = self.config
        if c.pipeline_stages > 1:
            raise ValueError(
                "prefill_kv_cached does not support pipeline stages")
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
            x, _aux = self._mlp_half(x, w)
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
        self._refuse_tensor("decode_kv_spec")
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
            x, _aux = self._mlp_half(x, w)
        logits = self._serving_head(x)  # [B, Q, V]
        return logits.float(), cache_k, cache_v

    # -- training forward --------------------------------------------------------
    def _attn_half(self, x: torch.Tensor, w: Dict[str, torch.Tensor],
                   segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
        c = self.config
        block_q, block_k = self._flash_blocks()
        q, k, v = self._qkv(x, w)
        o = attn_mod.attention(
            q, k, v, mesh=self.mesh, causal=True, impl=c.attn_impl,
            block_q=block_q, block_k=block_k,
            layout=c.sequence_layout, window=c.attn_window,
            segment_ids=segment_ids,
        )
        return x + self._out_proj(o, w)

    def _run_layers(self, x: torch.Tensor, layers: List[Dict[str, Any]],
                    segment_ids: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """`layers` over x → (x, the experts' aux summed over the layers;
        None without experts), rematted as the config says."""
        c = self.config
        remat = c.remat and torch.is_grad_enabled()
        checkpoint = functools.partial(
            torch.utils.checkpoint.checkpoint, use_reentrant=False,
            context_fn=_remat_context,
        )
        if (self._context > 1 or self._tensor > 1 or self._fsdp_dims
                or self._moe != moe.NO_GROUPS):
            # The recompute reissues the ring's rotations, the tensor and
            # expert all-reduces, the capacity's all-gather and the fsdp
            # gathers: it must run the whole region on every rank,
            # whatever this rank's graph needs.
            checkpoint = _no_early_stop(checkpoint)
        aux = None
        for w in layers:
            if remat and remat_attention(c):
                x, a = checkpoint(self._block, x, w, segment_ids)
            elif remat:
                x, a = checkpoint(self._mlp_half,
                                  self._attn_half(x, w, segment_ids), w)
            else:
                x, a = self._block(x, w, segment_ids)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    def _forward_trunk(self, tokens: torch.Tensor,
                       positions: Optional[torch.Tensor] = None,
                       segment_ids: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Embed + blocks → (pre-final-layernorm [B, S, D] in the compute
        dtype, the experts' aux loss summed over the blocks), differentiable
        in every parameter."""
        positions = self._local_positions(positions, tokens.shape[1])
        x = self._embed(self._cast("tok_embed"), self._cast("pos_embed"),
                        tokens, positions)
        return self._run_layers(x, self._train_layers(), segment_ids)

    def _cast(self, name: str, live: bool = True) -> torch.Tensor:
        """Whole parameter `name` in the compute dtype, in the graph (on an
        fsdp axis gathered from this rank's block, ``gather_at_use``);
        ``live=False``: outside it."""
        p = self.get_parameter(name)
        if not live:
            p = p.detach()
        if name in self._fsdp_dims:
            return self._fsdp.gather(p, self._fsdp_dims[name],
                                     self.config.dtype)
        return p.to(self.config.dtype)

    def _w_out(self, live: bool = True) -> torch.Tensor:
        """The head's weight [d, V] in the compute dtype, in the graph."""
        if self.config.tie_embeddings:
            return self._cast("tok_embed", live).t()
        return self._cast("head", live)

    def _local_positions(self, positions: Optional[torch.Tensor],
                         s_local: int) -> Optional[torch.Tensor]:
        """On a context axis above 1, this rank's learned position ids:
        its global ones (contiguous), or its columns of the replicated
        [S] ``positions`` map (zigzag)."""
        if self._context == 1:
            return positions
        from determined_tpu_torch.parallel.mesh import context_index

        start = context_index(self.mesh) * s_local
        if positions is None:
            if self.config.sequence_layout == "zigzag":
                raise ValueError(
                    "sequence_layout='zigzag' needs a zigzag-emitting data "
                    "pipeline (data/tokens.py zigzag_ring) supplying "
                    "positions")
            return torch.arange(start, start + s_local, device=self.device)
        if positions.dim() == 1 and positions.shape[0] == s_local * self._context:
            return positions[start:start + s_local]
        return positions

    def _block(self, x: torch.Tensor, w: Dict[str, torch.Tensor],
               segment_ids: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self._mlp_half(self._attn_half(x, w, segment_ids), w)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The differentiable forward: tokens [B, S] int → logits
        [B, S, V] in the compute dtype (on a tensor axis this rank's
        [B, S, V/t] columns)."""
        return self._forward(tokens, positions, segment_ids)[0]

    def _forward(self, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 segment_ids: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """→ (logits, the experts' aux loss; None without experts)."""
        c = self.config
        if c.pipeline_stages > 1:
            if segment_ids is not None:
                raise ValueError(
                    "segment_ids (packed sequences) are not supported with "
                    "pipeline parallelism yet")
            if c.sequence_layout == "zigzag":
                if positions is None:
                    raise ValueError(
                        "sequence_layout='zigzag' needs a zigzag-emitting "
                        "data pipeline (data/tokens.py zigzag_ring) "
                        "supplying positions")
                if self._context == 1:
                    raise ValueError(
                        "sequence_layout='zigzag' + pipeline parallelism "
                        "requires a sharded context axis (ring attention in "
                        "the stages)")
            if self._context == 1 and positions is not None:
                raise ValueError(
                    "explicit positions with a context-unsharded pipeline "
                    "would silently break the dense causal mask; drop "
                    "'positions' (contiguous data) or shard the context "
                    "axis (ring attention understands permuted layouts)")
            return self._apply_pipelined(tokens, positions), None
        x, aux = self._forward_trunk(tokens, positions, segment_ids)
        return self._head(x, self._w_out()), aux

    # -- pipeline stages ---------------------------------------------------------
    def _check_pipeline(self) -> int:
        """The reference's checks of a pipelined call → the microbatch
        count."""
        c = self.config
        if self.mesh is None:
            raise ValueError("pipeline parallelism needs a mesh")
        if self._pipeline != c.pipeline_stages:
            raise ValueError(
                f"mesh pipeline axis {self._pipeline} != config "
                f"pipeline_stages {c.pipeline_stages}")
        if c.n_layers % c.pipeline_stages:
            raise ValueError(
                f"n_layers {c.n_layers} is not divisible by pipeline_stages "
                f"{c.pipeline_stages}")
        if c.pipeline_schedule not in ("gpipe", "circular", "1f1b"):
            raise ValueError(
                f"unknown pipeline_schedule {c.pipeline_schedule!r} "
                "(one of: gpipe, circular, 1f1b)")
        return c.num_microbatches or 2 * c.pipeline_stages

    def _microbatch_split(self, x: torch.Tensor, m: int) -> torch.Tensor:
        """This rank's rows [b, ...] → [m, b/m, ...]: microbatch j takes
        rows [j·b/m, (j+1)·b/m) of every rank's block, the reference's
        block-cyclic layout (a plain split of the global rows where the
        ranks' blocks do not divide into it: the per-token sums are the
        same)."""
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        return x.reshape(m, b // m, *x.shape[1:])

    def _stage_fn(self, blocks: Dict[str, torch.Tensor],
                  x: torch.Tensor) -> torch.Tensor:
        """The stage of every schedule: `blocks` (a stage's [k, ...]
        views of the block parameters) over the fp32 carry x."""
        h, _aux = self._run_layers(x.to(self.config.dtype),
                                   self._layer_weights(blocks), None)
        return h.float()

    def _apply_pipelined(self, tokens: torch.Tensor,
                         positions: Optional[torch.Tensor]) -> torch.Tensor:
        """GPipe / circular over the pipeline group: the embedding on
        stage 0 before the pipeline, the head after it on the outputs the
        schedule replicates over the stages (its weights live on the stage
        that holds them, so their gradient counts once)."""
        c = self.config
        m = self._check_pipeline()
        n_stages, d = c.pipeline_stages, self._stage
        b, s = tokens.shape
        shape = (b, s, c.d_model)
        if d == 0:
            x = self._embed(self._cast("tok_embed"), self._cast("pos_embed"),
                            tokens, self._local_positions(positions, s))
            x = x.float()
        else:
            x = torch.zeros((), device=self.device).expand(shape)
        micro = self._microbatch_split(x, m)
        if c.pipeline_schedule == "circular":
            v = c.pipeline_virtual_stages
            if c.n_layers % (n_stages * v):
                raise ValueError(
                    f"n_layers {c.n_layers} must divide stages×virtual "
                    f"({n_stages}×{v})")
            per = c.n_layers // (n_stages * v)
            # device d runs global chunks d, d+S, … (round robin)
            views = {n: p.reshape(n_stages * v, per, *p.shape[1:])[d::n_stages]
                     for n, p in self.blocks.items()}
            out = circular_pipeline_apply(self._stage_fn, views, micro,
                                          group=self._pgroup)
            holder = 0
        else:
            # 1F1B is a training schedule (loss); forward-only calls take
            # the fill-drain layout, as the reference's
            per = c.n_layers // n_stages
            views = {n: p[d * per:(d + 1) * per]
                     for n, p in self.blocks.items()}
            out = pipeline_apply(self._stage_fn, views, micro,
                                 group=self._pgroup)
            holder = n_stages - 1
        x = out.reshape(shape).to(c.dtype)
        if d == holder:
            return self._head(x, self._w_out())
        # the head's weights are live on the holder alone
        return self._head(x, self._w_out(live=False),
                          (self.lnf_scale.detach(), self.lnf_bias.detach()))

    def _loss_1f1b(self, tokens, targets, positions, segment_ids, mask
                   ) -> Tuple[torch.Tensor, Metrics]:
        """Memory-bounded pipelined training (schedule "1f1b"): stage 0
        embeds each microbatch, the last stage computes its loss and seeds
        its backward at once; the schedule returns finished gradients
        (``parallel/pipeline.py one_f_one_b_grads``), which ``_Finished``
        hands to the caller's autograd times the loss's cotangent."""
        c = self.config
        if segment_ids is not None:
            raise ValueError(
                "segment_ids (packed sequences) are not supported with "
                "pipeline parallelism yet")
        m = self._check_pipeline()
        ctx = self._context
        aligned = targets is not None
        zigzag = c.sequence_layout == "zigzag"
        if (ctx > 1 or zigzag) and not aligned:
            raise ValueError(
                "1F1B with a sharded context axis (or zigzag layout) needs "
                "pre-shifted batches: data/tokens.py's zigzag_ring (or an "
                "aligned {'tokens','targets','positions'} stream)")
        if zigzag and ctx == 1:
            raise ValueError(
                "sequence_layout='zigzag' + pipeline needs a sharded "
                "context axis (ring attention in the stages)")
        if ctx == 1 and positions is not None:
            raise ValueError(
                "explicit positions with a context-unsharded pipeline "
                "would silently break the dense causal mask; drop "
                "'positions' or shard the context axis")
        n_stages, d = c.pipeline_stages, self._stage
        per = c.n_layers // n_stages
        lo = d * per
        tok3 = self._microbatch_split(tokens, m)
        msk3 = self._microbatch_split(mask, m)
        tgt3 = self._microbatch_split(targets, m) if aligned else None
        pos = self._local_positions(positions, tokens.shape[1])
        views = {n: p[lo:lo + per] for n, p in self.blocks.items()}
        head = "tok_embed" if c.tie_embeddings else "head"
        ep = {"tok_embed": self.tok_embed, "pos_embed": self.pos_embed}
        lp = {"lnf_scale": self.lnf_scale, "lnf_bias": self.lnf_bias,
              head: self.get_parameter(head)}

        def cast(name, p):
            """`p`, a (detached) block of parameter `name`, whole in the
            compute dtype."""
            if name in self._fsdp_dims:
                return self._fsdp.gather(p, self._fsdp_dims[name], c.dtype)
            return p.to(c.dtype)

        def emb_fn(ep_, tok, pos_):
            return self._embed(cast("tok_embed", ep_["tok_embed"]),
                               cast("pos_embed", ep_["pos_embed"]), tok,
                               pos_).float()

        def loss_fn(lp_, y, tgt, msk):
            w_out = cast(head, lp_[head])
            if c.tie_embeddings:
                w_out = w_out.t()
            logits = self._head(y.to(c.dtype), w_out,
                                lnf=(lp_["lnf_scale"], lp_["lnf_bias"]))
            logits = logits.float()
            if not aligned:
                logits, tgt, msk = logits[:, :-1], tgt[:, 1:], msk[:, 1:]
            nll, z, acc, n = self._token_sums(logits, tgt, msk)
            return nll + c.z_loss * z, torch.stack([nll, z, acc.float(), n])

        msums, s_g, e_g, l_g = one_f_one_b_grads(
            self._stage_fn, views, emb_fn, ep, loss_fn, lp, tok3, msk3,
            targets_mb=tgt3, positions=pos, group=self._pgroup,
            replicate=False)
        n = torch.clamp(msums[3], min=1.0)
        loss = msums[0] / n + c.z_loss * msums[1] / n
        metrics = {"loss": loss, "accuracy": msums[2] / n,
                   "tokens": msums[3]}
        grads = {}
        for name, p in self.blocks.items():
            g = torch.zeros_like(p)
            g[lo:lo + per] = s_g[name]
            grads[f"blocks.{name}"] = g
        grads["pos_embed"] = e_g["pos_embed"]
        grads["lnf_scale"], grads["lnf_bias"] = l_g["lnf_scale"], l_g["lnf_bias"]
        grads[head] = l_g[head]
        if c.tie_embeddings:
            grads["tok_embed"] = e_g["tok_embed"] + l_g["tok_embed"]
        else:
            grads["tok_embed"] = e_g["tok_embed"]
        named = list(self.named_parameters())
        scaled = [grads[name] / n for name, _ in named]
        loss = _Finished.apply(loss, scaled, *(p for _, p in named))
        return loss, metrics

    # -- loss -----------------------------------------------------------------------
    def _token_sums(self, logits, targets, mask):
        """(nll, z, correct, n) sums over aligned fp32 logits; on a tensor
        axis the vocab-parallel ones."""
        if self._tensor > 1:
            return vocab_parallel_token_sums(
                logits, targets, mask, self._vocab_start,
                self.config.vocab_size, self._tgroup)
        return _aligned_token_sums(logits, targets, mask)

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
        if c.pipeline_stages > 1 and c.pipeline_schedule == "1f1b":
            return self._loss_1f1b(tokens, targets, positions, segment_ids,
                                   mask)
        if segment_ids is not None and targets is None:
            # Packed documents with the in-model shift: a prediction that
            # crosses a document boundary (the id changes) or lands on
            # padding (id 0) does not count.
            boundary = torch.cat([
                torch.ones_like(mask[:, :1]),
                (segment_ids[:, 1:] == segment_ids[:, :-1]).float(),
            ], dim=1)
            mask = mask * boundary * (segment_ids != 0)
        if (c.fused_loss and self._tensor == 1 and c.pipeline_stages == 1
                and not c.n_experts):
            # the reference's conditions: no tensor axis, one stage, no
            # experts (their aux loss stays on the dense path)
            return self._loss_fused(tokens, targets, positions, mask,
                                    segment_ids)
        logits, aux = self._forward(tokens, positions, segment_ids)
        logits = logits.float()
        if targets is None:
            # Classic in-model shift: position i predicts token i+1.
            logits, targets, mask = logits[:, :-1], tokens[:, 1:], mask[:, 1:]
        nll_sum, z_sum, acc_sum, n_tok = self._token_sums(logits, targets,
                                                          mask)
        n = torch.clamp(n_tok, min=1.0)
        loss = nll_sum / n
        if c.z_loss:
            loss = loss + c.z_loss * z_sum / n
        if c.n_experts:
            # the switch transformer's aux weight, the mean over layers
            loss = loss + 0.01 * aux / c.n_layers
        acc = acc_sum / n
        return loss, {"loss": loss, "accuracy": acc, "tokens": n_tok}

    def _loss_fused(self, tokens, targets, positions, mask, segment_ids):
        """The loss through the chunked cross-entropy: the same objective
        as the dense path, without the [B, S, V] logits."""
        c = self.config
        x, _aux = self._forward_trunk(tokens, positions, segment_ids)
        hidden = _layernorm(x, self.lnf_scale, self.lnf_bias)
        if targets is None:
            # the in-model shift: position i predicts token i+1
            hidden = hidden[:, :-1]
            targets = tokens[:, 1:]
            mask = mask[:, 1:]
        obj, _nll, _z, acc_sum, n_tok = fused_next_token_sums(
            hidden, self._w_out(), targets, mask, z_loss=c.z_loss or 0.0)
        n = torch.clamp(n_tok, min=1.0)
        loss = obj / n
        return loss, {"loss": loss, "accuracy": acc_sum / n, "tokens": n_tok}


class _Finished(torch.autograd.Function):
    """The 1F1B schedule's loss: its backward hands the schedule's
    finished gradients to the parameters, times the loss's cotangent (the
    reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, loss, grads, *params):  # noqa: ANN001
        ctx.grads = grads
        return loss.detach().clone()

    @staticmethod
    def backward(ctx, g_loss):  # noqa: ANN001
        grads, ctx.grads = ctx.grads, None
        return (None, None, *(g * g_loss for g in grads))


class _Weights(dict):
    """One layer's weights by name. A weight held as this rank's fsdp
    block is a call that gathers it, made at each read: a rematted
    region gathers what it reads, and its recompute gathers again."""

    def __getitem__(self, name: str) -> torch.Tensor:
        w = super().__getitem__(name)
        return w() if callable(w) else w


def _no_early_stop(checkpoint):
    def call(*args, **kwargs):
        from torch.utils.checkpoint import set_checkpoint_early_stop

        with set_checkpoint_early_stop(False):
            return checkpoint(*args, **kwargs)

    return call


def remat_attention(config: GPTConfig) -> bool:
    """Whether attention goes inside the remat boundary: ``remat_attention``,
    or ``layer_loop="auto"`` past 16384 tokens, where the reference found
    the flash residuals that the split remat saves too large."""
    return config.remat_attention or (
        config.layer_loop == "auto" and config.seq_len > 16384)


# ---------------------------------------------------------------------------
# Weight carry-over from the JAX package
# ---------------------------------------------------------------------------
def load_jax_params(model: GPT, tree: Dict[str, Any], *,
                    serving_copy: bool = False) -> GPT:
    """Fill `model`'s parameters from the reference's parameter pytree
    (``models.base.load_params``: every key and shape checked before
    anything is written); on a tensor or expert axis above 1 the tree is
    whole and the model takes its rank's slices. ``serving_copy`` then makes the
    compute-dtype copy (``GPT.cache_compute_weights``); without it any
    earlier copy is dropped, so the forward casts the new values per
    call."""
    if model._slice_dims:
        tree = {name: model._model_slice(name, leaf)
                for name, leaf in _flatten(tree)}
    load_params(model, tree)
    model._compute.clear()
    if serving_copy:
        model.cache_compute_weights()
    return model
