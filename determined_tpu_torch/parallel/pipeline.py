"""Pipeline parallelism: microbatch schedules over the ``pipeline`` group.

Port of ``determined_tpu/parallel/pipeline.py``. The reference runs its
schedules as one compiled ``lax.scan`` over ticks, each stage inside a
``shard_map`` and activations handed on by ``ppermute``. Here one process
drives one stage: a tick runs this rank's stage (a ``stage_fn`` call) and
ends in one batch of point-to-point sends and receives with its
neighbours (``batch_isend_irecv`` on the pipeline group; on gloo with
tensors on the card, staged through pinned host buffers, as the ring's
rotation). Every rank of the group posts its sends and receives in the
same tick order, the warm-up and drain ticks included, so no schedule can
deadlock; a tick with nothing to compute for this rank computes nothing
(the reference computes and discards, which XLA prefers to branches).

- ``pipeline_apply``: GPipe fill-drain. M microbatches over S stages take
  M + S − 1 ticks; stage d runs microbatch m at tick m + d.
- ``circular_pipeline_apply``: the interleaved schedule. Device d holds V
  virtual stages (global chunks d, d + S, …) and activations loop the ring
  V times; device 0 stashes a returned activation until its next round,
  so M ≥ S. V·M + S − 1 ticks.
- ``one_f_one_b_grads``: 1F1B. Forwards and backwards interleave per
  microbatch (forward of m on stage d at tick m + d, backward at
  m + 2(S−1) − d); a stage stashes at most ``one_f_one_b_stash_size`` =
  min(M, 2S − 1) stage inputs and recomputes its forward at backward
  time. It returns finished gradients, as the reference's.
- ``stack_circular_stages``: the [L, ...] → [S, V, ...] round-robin layout.

The two forward schedules are differentiable: under autograd they keep
each tick's graph (GPipe's O(M) residency) and their backward runs the
reverse schedule, the cotangents handed back along the same links. Their
outputs are one value replicated over the group (broadcast from the stage
that holds them); its cotangent is taken from that stage, so every rank
may compute the same loss on it, as every rank of the reference computes
its replicated head loss.

``stats`` counts this process's point-to-point bytes and holds the 1F1B
stash's high-water mark (``stash_high_water``, the most stage inputs
a stage held at once in the last 1F1B call). No kernel: the schedules move
activations; the stages' attention runs the flash kernels.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

#: message tags: activations forward, cotangents backward
_FWD, _BWD = 0, 1

stats: Dict[str, int] = {"bytes": 0, "stash_high_water": 0}


class _Links:
    """This rank's place on the pipeline group and its point-to-point
    transport. `group`: a process group, a DeviceMesh (its ``pipeline``
    dimension) or None (one stage)."""

    def __init__(self, group: Any) -> None:
        import torch.distributed as dist

        if group is not None and hasattr(group, "mesh_dim_names"):
            self.index = int(group.get_local_rank("pipeline"))
            group = group.get_group("pipeline")
        elif group is not None:
            self.index = int(dist.get_rank(group))
        else:
            self.index = 0
        self.group = group
        self.size = 1 if group is None else int(dist.get_world_size(group))
        self.backend = "" if group is None else str(dist.get_backend(group))

    def global_rank(self, index: int) -> int:
        import torch.distributed as dist

        return int(dist.get_global_rank(self.group, index))

    def exchange(self, sends: Sequence[Tuple[torch.Tensor, int, int]],
                 recvs: Sequence[Tuple[torch.Tensor, int, int]]
                 ) -> List[torch.Tensor]:
        """One batch: each (tensor, peer, tag) of `sends` to its peer; for
        each (like, peer, tag) of `recvs` a tensor shaped as `like` from
        its peer. A message to this rank itself (one stage) is handed over
        by tag."""
        import torch.distributed as dist

        own = {tag: t for t, peer, tag in sends if peer == self.index}
        sends = [s for s in sends if s[1] != self.index]
        out: List[Optional[torch.Tensor]] = []
        pending = []
        ops = []
        for t, peer, tag in sends:
            t = t.detach().contiguous()
            if self.backend == "gloo" and t.device.type == "cuda":
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                t = host.copy_(t)
            stats["bytes"] += t.numel() * t.element_size()
            ops.append(dist.P2POp(dist.isend, t, group=self.group,
                                  group_peer=peer, tag=tag))
        for like, peer, tag in recvs:
            if peer == self.index:
                out.append(own.pop(tag))
                continue
            staged = self.backend == "gloo" and like.device.type == "cuda"
            buf = (torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
                   if staged else torch.empty_like(like))
            ops.append(dist.P2POp(dist.irecv, buf, group=self.group,
                                  group_peer=peer, tag=tag))
            pending.append((len(out), buf, like.device if staged else None))
            out.append(None)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for i, buf, device in pending:
            out[i] = buf if device is None else buf.to(device)
        return out  # type: ignore[return-value]

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        import torch.distributed as dist

        if self.size > 1:
            dist.broadcast(x, src=self.global_rank(src), group=self.group)
        return x


def _is_tensor(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def _detached(leaves: Sequence[Any]) -> List[Any]:
    """Fresh leaves sharing storage, each requiring grad where its tensor
    does (the targets of a stage's explicit backward)."""
    return [x.detach().requires_grad_(x.requires_grad) if _is_tensor(x)
            else x for x in leaves]


def _differentiable(leaves: Sequence[Any]) -> List[Any]:
    """Fresh leaves sharing storage, every floating tensor requiring grad:
    the parameters an explicit schedule differentiates, as ``jax.vjp``
    differentiates every leaf."""
    return [x.detach().requires_grad_(x.is_floating_point())
            if _is_tensor(x) else x for x in leaves]


def _grad(outputs: Any, inputs: Sequence[Any], cot: Any) -> List[Any]:
    """torch.autograd.grad over the tensors of `inputs` that require grad
    (None for the others)."""
    idx = [i for i, x in enumerate(inputs) if _is_tensor(x)
           and x.requires_grad]
    got = torch.autograd.grad(outputs, [inputs[i] for i in idx], cot,
                              allow_unused=True)
    res: List[Any] = [None] * len(inputs)
    for i, g in zip(idx, got):
        res[i] = g
    return res


def _accumulate(acc: List[Any], delta: Sequence[Any]) -> None:
    for i, g in enumerate(delta):
        if g is not None:
            acc[i] = g if acc[i] is None else acc[i] + g


class _Plan:
    """One call of a forward schedule: the stage, the parameters' tree,
    the links and the geometry (V virtual stages; circular or GPipe)."""

    def __init__(self, stage_fn, treedef, links, v_stages, circular,
                 n_micro):
        self.stage_fn, self.treedef, self.links = stage_fn, treedef, links
        self.v, self.circular, self.m = v_stages, circular, n_micro
        s = links.size
        self.total = v_stages * n_micro
        self.ticks = self.total + s - 1
        #: the stage that holds the outputs: the last (GPipe) or the
        #: circle's home, stage 0 (circular)
        self.holder = 0 if circular else s - 1

    def params(self, leaves: Sequence[Any], v: int) -> Any:
        if self.circular:
            leaves = [x[v] if _is_tensor(x) else x for x in leaves]
        return pytree.tree_unflatten(list(leaves), self.treedef)

    def injection(self, t: int, d: int) -> Optional[Tuple[int, int]]:
        """(virtual stage, microbatch) that stage d serves at tick t."""
        idx = t - d
        if 0 <= idx < self.total:
            return divmod(idx, self.m)
        return None

    def sends_on(self, t: int, d: int) -> bool:
        """Whether stage d hands its tick-t output to the next stage."""
        s = self.links.size
        return (self.injection(t, d) is not None
                and (self.circular or d < s - 1))

    def receives_on(self, t: int, d: int) -> Optional[Tuple[int, int]]:
        """What stage d receives at the end of tick t: the injection its
        predecessor served (None: nothing)."""
        s = self.links.size
        if not self.circular and d == 0:
            return None
        return self.injection(t, (d - 1) % s)


def _forward_schedule(plan: _Plan, micro: torch.Tensor, leaves: List[Any],
                      keep: bool):
    """Run the ticks. → (outputs [M, ...] on the holder or None, the
    records {tick: (x_in, y, v, m)} when `keep`)."""
    links, d, s = plan.links, plan.links.index, plan.links.size
    like = micro[0]
    outputs: List[Optional[torch.Tensor]] = [None] * plan.m
    stash: List[Optional[torch.Tensor]] = [None] * plan.m
    records: Dict[int, Tuple[Any, ...]] = {}
    incoming = None
    for t in range(plan.ticks):
        served = plan.injection(t, d)
        y = None
        if served is not None:
            v, m = served
            if d == 0:
                x = micro[m] if v == 0 else stash[m]
                if v:
                    stash[m] = None
            else:
                x = incoming
            if keep:
                x_in = x.detach().requires_grad_()
                with torch.enable_grad():
                    y = plan.stage_fn(plan.params(leaves, v), x_in)
                records[t] = (x_in, y, v, m)
            else:
                y = plan.stage_fn(plan.params(leaves, v), x)
            if not plan.circular and d == s - 1:
                outputs[m] = y.detach()
        sends = ([(y, (d + 1) % s, _FWD)] if plan.sends_on(t, d) else [])
        got_from = plan.receives_on(t, d)
        recvs = [(like, (d - 1) % s, _FWD)] if got_from is not None else []
        got = links.exchange(sends, recvs)
        incoming = None
        if got_from is not None:
            if plan.circular and d == 0:
                v_r, m_r = got_from
                if v_r < plan.v - 1:
                    stash[m_r] = got[0]
                else:
                    outputs[m_r] = got[0]
            else:
                incoming = got[0]
    held = torch.stack(outputs) if d == plan.holder else None
    return held, records


def _replicate(plan: _Plan, held: Optional[torch.Tensor],
               micro: torch.Tensor) -> torch.Tensor:
    out = held if held is not None else torch.empty_like(micro)
    return plan.links.broadcast(out.contiguous(), plan.holder)


def _backward_schedule(plan: _Plan, records, leaves: List[Any],
                       d_out: torch.Tensor, micro: torch.Tensor):
    """The reverse ticks: each stage's explicit backward, the cotangents
    handed back along the forward's links. → (d_micro or None, grads of
    `leaves`)."""
    links, d, s = plan.links, plan.links.index, plan.links.size
    like = micro[0]
    grads: List[Any] = [None] * len(leaves)
    d_micro = torch.zeros_like(micro) if d == 0 else None
    d_stash: List[Optional[torch.Tensor]] = [None] * plan.m
    pending = None  # the cotangent of what arrived at the end of tick t
    for t in reversed(range(plan.ticks)):
        sends, recvs = [], []
        got_from = plan.receives_on(t, d)
        if got_from is not None:
            if plan.circular and d == 0:
                v_r, m_r = got_from
                cot = d_stash[m_r] if v_r < plan.v - 1 else d_out[m_r]
                d_stash[m_r] = None
            else:
                cot = pending
            sends.append((cot, (d - 1) % s, _BWD))
        sent = plan.sends_on(t, d)
        if sent:
            recvs.append((like, (d + 1) % s, _BWD))
        got = links.exchange(sends, recvs)
        pending = None
        if t not in records:
            continue
        x_in, y, v, m = records.pop(t)
        cot_y = got[0] if sent else d_out[m]
        res = _grad(y, [x_in, *leaves], cot_y)
        _accumulate(grads, res[1:])
        dx = res[0]
        if d == 0:
            if v == 0:
                d_micro[m] = dx
            else:
                d_stash[m] = dx
        else:
            pending = dx
    return d_micro, grads


class _Pipelined(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, micro, *leaves):  # noqa: ANN001
        det = _detached(leaves)
        held, records = _forward_schedule(plan, micro, det, keep=True)
        ctx.plan, ctx.records, ctx.det = plan, records, det
        ctx.micro = micro.detach()
        return _replicate(plan, held, micro)

    @staticmethod
    def backward(ctx, d_out):  # noqa: ANN001
        plan = ctx.plan
        d_micro, grads = _backward_schedule(plan, ctx.records, ctx.det,
                                            d_out, ctx.micro)
        ctx.records = ctx.det = None
        if not ctx.needs_input_grad[1]:
            d_micro = None
        elif d_micro is None:
            d_micro = torch.zeros_like(ctx.micro)
        return (None, d_micro, *grads)


def _apply(stage_fn, stage_params, microbatches, group, circular):
    leaves, treedef = pytree.tree_flatten(stage_params)
    links = _Links(group)
    if circular:
        v_stages = next(x for x in leaves if _is_tensor(x)).shape[0]
    else:
        v_stages = 1
    n_micro = microbatches.shape[0]
    if circular and n_micro < links.size:
        raise ValueError(
            f"circular schedule needs microbatches ({n_micro}) >= pipeline "
            f"stages ({links.size})"
        )
    plan = _Plan(stage_fn, treedef, links, v_stages, circular, n_micro)
    needs_grad = torch.is_grad_enabled() and (
        microbatches.requires_grad
        or any(_is_tensor(x) and x.requires_grad for x in leaves))
    if needs_grad:
        return _Pipelined.apply(plan, microbatches, *leaves)
    with torch.no_grad():
        held, _ = _forward_schedule(plan, microbatches, leaves, keep=False)
        return _replicate(plan, held, microbatches)


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    microbatches: torch.Tensor,
    *,
    group: Any = None,
) -> torch.Tensor:
    """Run microbatches through the pipeline (GPipe fill-drain).

    Args:
      stage_fn: params, activation [mb, ...] -> activation [mb, ...]. All
        stages share one activation shape.
      stage_params: this rank's stage parameters (a tree of tensors).
      microbatches: [M, mb, ...] on every rank; only stage 0 reads it.
      group: the pipeline's process group (or a DeviceMesh: its
        ``pipeline`` dimension); None: one stage.

    Returns [M, mb, ...]: the last stage's outputs, replicated over the
    group. Differentiable in `stage_params` and `microbatches` (stage 0's).
    """
    return _apply(stage_fn, stage_params, microbatches, group, False)


def circular_pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    microbatches: torch.Tensor,
    *,
    group: Any = None,
) -> torch.Tensor:
    """Interleaved (circular) schedule.

    Args:
      stage_fn: params, activation [mb, ...] -> activation [mb, ...].
      stage_params: this rank's V virtual stages stacked on a leading axis
        — rank d holds global stages [v*S + d for v in range(V)]
        (``stack_circular_stages`` builds that layout).
      microbatches: [M, mb, ...], M >= S (stage 0 re-injects a returned
        activation M − S ticks after it arrives).

    Ticks: V·M + S − 1. At tick t stage d serves injection t − d (virtual
    stage idx // M, microbatch idx % M); the ring hands each finished
    circle back to stage 0, which stashes it until its next round or
    keeps it as an output after round V − 1.

    Returns [M, mb, ...] final outputs, replicated over the group.
    """
    return _apply(stage_fn, stage_params, microbatches, group, True)


def one_f_one_b_stash_size(n_micro: int, n_stages: int) -> int:
    """In-flight stage inputs a stage stashes under 1F1B: O(S), not O(M).
    Stage d holds at most 2·(S−1−d)+1 of them; the bound is stage 0's."""
    return min(n_micro, 2 * n_stages - 1)


def _all_reduce_tree(leaves: List[Any], groups: Sequence[Any]) -> None:
    import torch.distributed as dist

    for group in groups:
        for g in leaves:
            if g is not None:
                dist.all_reduce(g, group=group)


def one_f_one_b_grads(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    emb_fn: Callable[..., torch.Tensor],
    emb_params: Any,
    loss_fn: Callable[[Any, torch.Tensor, torch.Tensor, torch.Tensor], Any],
    loss_params: Any,
    tokens_mb: torch.Tensor,
    mask_mb: torch.Tensor,
    *,
    targets_mb: Any = None,
    positions: Any = None,
    reduce_axes: tuple = (),
    group: Any = None,
    replicate: bool = True,
):
    """1F1B schedule (memory-bounded pipelining).

    Forwards and backwards interleave per microbatch, so each stage
    stashes O(S) stage inputs instead of GPipe's O(M). The schedule runs
    forward and backward explicitly — each backward recomputes the
    stage's forward from its stashed input — and returns finished
    gradients; callers hand them to autograd themselves (``models/gpt.py``
    ``_loss_1f1b``).

    Timing (stage d, microbatch m, tick t of M + 2S − 2):
      forward  at t = m + d
      backward at t = m + 2(S−1) − d (the last stage seeds its own
                                      backward in its forward's tick)
    Each tick ends in one exchange: the forward's output to stage d + 1,
    the backward's input cotangent to stage d − 1.

    Args:
      stage_fn: (params, x [mb, ...]) -> y, same shape; differentiated per
        backward, recomputing from the stashed input.
      emb_fn: (emb_params, tokens [mb, s], positions) -> x, stage 0's
        microbatch producer.
      loss_fn: (loss_params, y, aux_tokens, mask) -> (objective,
        metric_sums [k]) on the last stage; `aux_tokens` is targets_mb's
        microbatch when given, else tokens_mb's. `objective` MUST be a
        per-microbatch SUM: its unit cotangent starts each microbatch's
        backward, and the caller rescales the gradients afterwards.
      tokens_mb [M, mb, s]; mask_mb [M, mb, s]; targets_mb [M, mb, s]
        pre-shifted targets; positions [s] position ids.
      reduce_axes: process groups to sum every gradient over (the
        reference's manual context axis).
      group: the pipeline's process group (or a DeviceMesh); None: one
        stage.
      replicate: sum emb_grads and loss_grads over the group, as the
        reference; False leaves each rank's own (stage 0's and the last
        stage's), for a caller that sums over the group itself.

    Returns (metric_sums, stage_grads, emb_grads, loss_grads): metric_sums
    replicated over the group; stage_grads this rank's, in stage_params'
    tree.
    """
    links = _Links(group)
    d, s = links.index, links.size
    n_micro = tokens_mb.shape[0]
    cap = one_f_one_b_stash_size(n_micro, s)
    ticks = n_micro + 2 * s - 2
    sp, sp_def = pytree.tree_flatten(stage_params)
    ep, ep_def = pytree.tree_flatten(emb_params)
    lp, lp_def = pytree.tree_flatten(loss_params)
    sp_d, ep_d, lp_d = (_differentiable(sp), _differentiable(ep),
                        _differentiable(lp))
    s_g: List[Any] = [None] * len(sp)
    e_g: List[Any] = [None] * len(ep)
    l_g: List[Any] = [None] * len(lp)
    stage_p = pytree.tree_unflatten(sp_d, sp_def)
    emb_p = pytree.tree_unflatten(ep_d, ep_def)
    loss_p = pytree.tree_unflatten(lp_d, lp_def)
    with torch.no_grad():
        like = emb_fn(emb_p, tokens_mb[0], positions)
    stash: List[Optional[torch.Tensor]] = [None] * cap
    held = high = 0
    msums = None
    inc_f = inc_b = None
    for t in range(ticks):
        # -- forward sub-slot --------------------------------------------------
        f_idx = t - d
        f_on = 0 <= f_idx < n_micro
        y = dy = None
        if f_on:
            with torch.no_grad():
                x_in = (emb_fn(emb_p, tokens_mb[f_idx], positions) if d == 0
                        else inc_f)
                y = stage_fn(stage_p, x_in)
            slot = f_idx % cap
            if stash[slot] is not None:
                raise RuntimeError(
                    f"1F1B stash slot {slot} still holds a stage input at "
                    f"tick {t} (stash size {cap})")
            stash[slot] = x_in
            held += 1
            high = max(high, held)
            if d == s - 1:
                tgt = tokens_mb if targets_mb is None else targets_mb
                yy = y.detach().requires_grad_()
                with torch.enable_grad():
                    obj, aux = loss_fn(loss_p, yy, tgt[f_idx], mask_mb[f_idx])
                    res = _grad(obj, [yy, *lp_d], torch.ones_like(obj))
                dy = res[0]
                _accumulate(l_g, res[1:])
                aux = aux.detach()
                msums = aux if msums is None else msums + aux
        # -- backward sub-slot -------------------------------------------------
        b_idx = t - (2 * s - 2 - d)
        b_on = 0 <= b_idx < n_micro
        dx = None
        if b_on:
            cot_y = dy if d == s - 1 else inc_b
            slot = b_idx % cap
            x_s, stash[slot] = stash[slot], None
            held -= 1
            xs = x_s.detach().requires_grad_()
            with torch.enable_grad():
                yb = stage_fn(stage_p, xs)
                res = _grad(yb, [xs, *sp_d], cot_y)
            dx = res[0]
            _accumulate(s_g, res[1:])
            if d == 0:
                pos = positions
                with torch.enable_grad():
                    xe = emb_fn(emb_p, tokens_mb[b_idx], pos)
                    _accumulate(e_g, _grad(xe, ep_d, dx))
        # -- the tick's exchange ---------------------------------------------
        sends, recvs = [], []
        if f_on and d < s - 1:
            sends.append((y, d + 1, _FWD))
        if b_on and d > 0:
            sends.append((dx, d - 1, _BWD))
        if d > 0 and 0 <= t + 1 - d < n_micro:
            recvs.append((like, d - 1, _FWD))
        if d < s - 1 and 0 <= t - (2 * s - 2 - (d + 1)) < n_micro:
            recvs.append((like, d + 1, _BWD))
        got = links.exchange(sends, recvs)
        inc_f = inc_b = None
        for (_, peer, tag), x in zip(recvs, got):
            if tag == _FWD:
                inc_f = x
            else:
                inc_b = x
    stats["stash_high_water"] = high
    # the metric sums live on the last stage: its length first, then them
    if s > 1:
        n = torch.tensor([0 if msums is None else msums.numel()],
                         device=like.device)
        links.broadcast(n, s - 1)
        if msums is None:
            msums = torch.zeros(int(n.item()), dtype=torch.float32,
                                device=like.device)
        msums = links.broadcast(msums.contiguous(), s - 1)

    def zeros(acc, leaves):
        return [g if g is not None or not _is_tensor(x) else torch.zeros_like(x)
                for g, x in zip(acc, leaves)]

    s_g, e_g, l_g = zeros(s_g, sp), zeros(e_g, ep), zeros(l_g, lp)
    if replicate and s > 1:
        _all_reduce_tree([g for g in e_g + l_g if _is_tensor(g)],
                         [links.group])
    _all_reduce_tree([g for g in s_g + e_g + l_g if _is_tensor(g)],
                     list(reduce_axes))
    return (msums, pytree.tree_unflatten(s_g, sp_def),
            pytree.tree_unflatten(e_g, ep_def),
            pytree.tree_unflatten(l_g, lp_def))


def stack_circular_stages(global_params: Any, n_stages: int) -> Any:
    """Re-stack [L, ...] global stage params (L = S·V) into the circular
    layout [S, V, ...] where slot [d, v] holds global stage v·S + d."""

    def restack(p):
        p = torch.as_tensor(p)
        n = p.shape[0]
        if n % n_stages:
            raise ValueError(
                f"global stages ({n}) must divide by pipeline size ({n_stages})"
            )
        v = n // n_stages
        idx = torch.arange(n).reshape(v, n_stages).T
        return p[idx]

    return pytree.tree_map(restack, global_params)
