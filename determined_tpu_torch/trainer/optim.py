"""Optimizers of the port, in optax's API shape and arithmetic.

The port's counterpart of the optax chain the recipes use
(``chain(clip_by_global_norm(1.0), adamw(lr))``, with an optional
``warmup_cosine_decay_schedule``): a ``GradientTransformation`` is an
``(init, update)`` pair over LISTS of tensors, ``init(params) -> state``
and ``update(updates, state, params) -> (updates, new_state)``, and the
trainer applies ``params + updates``. Updates are computed with
``torch._foreach_*`` over the lists; nothing is updated in place, so the
trainer's non-finite guard can still pick the old state.

Why not ``torch.optim.AdamW`` with ``clip_grad_norm_``: they compute
another function. ``clip_grad_norm_`` divides by ``norm + 1e-6`` where
optax divides by the norm itself and leaves the updates alone below
``max_norm``; ``torch.optim.AdamW`` decays by 1e-2 by default where
``optax.adamw`` decays every leaf by 1e-4; an optax schedule reads the
count BEFORE the increment (the first update uses ``schedule(0)``); and a
skipped step must leave the moments and the step counts untouched, or
bias correction drifts from the reference after a skip. Here every
operation follows optax's own order (``(1 - b1)·g + b1·mu``, bias
correction ``1 − b^t`` in fp32, ``mu_hat / (sqrt(nu_hat) + eps)``,
``g + wd·p``, ``−lr·g``), and the counts and schedules live on the
device as int32/fp32 tensors, so a step needs no host sync.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Sequence, Tuple, Union

import torch

Tensors = List[torch.Tensor]
#: A schedule maps the int32 count tensor to an fp32 tensor.
Schedule = Callable[[torch.Tensor], torch.Tensor]
ScalarOrSchedule = Union[float, Schedule]

_INT32_MAX = 2 ** 31 - 1


class GradientTransformation(NamedTuple):
    init: Callable[[Tensors], Any]
    update: Callable[..., Tuple[Tensors, Any]]


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar
    mu: Tensors
    nu: Tensors


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor  # int32 scalar


def _zero_count(params: Tensors) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


def safe_increment(count: torch.Tensor) -> torch.Tensor:
    """count + 1, saturating at the int32 maximum."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over tensors of their sums of squares, in fp32."""
    sq = [torch.sum(torch.square(x.float())) for x in tensors]
    return torch.sqrt(torch.stack(sq).sum())


# ---------------------------------------------------------------------------
# Transformations
# ---------------------------------------------------------------------------
def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Leave the updates alone while their global norm is below
    `max_norm`; else scale them to (t / norm) · max_norm."""

    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        clipped = torch._foreach_mul(torch._foreach_div(updates, g_norm),
                                     max_norm)
        return [torch.where(trigger, t, c)
                for t, c in zip(updates, clipped)], state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return ScaleByAdamState(
            _zero_count(params),
            [torch.zeros_like(p) for p in params],
            [torch.zeros_like(p) for p in params],
        )

    def update(updates, state, params=None):
        mu = torch._foreach_add(torch._foreach_mul(updates, 1 - b1),
                                torch._foreach_mul(state.mu, b1))
        sq = torch._foreach_mul(updates, updates)
        nu = torch._foreach_add(torch._foreach_mul(sq, 1 - b2),
                                torch._foreach_mul(state.nu, b2))
        count = safe_increment(state.count)
        mu_hat = torch._foreach_div(mu, 1 - torch.pow(b1, count))
        nu_hat = torch._foreach_div(nu, 1 - torch.pow(b2, count))
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), eps)
        return torch._foreach_div(mu_hat, denom), ScaleByAdamState(count, mu, nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float = 0.0) -> GradientTransformation:
    """updates + weight_decay · params."""

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        return torch._foreach_add(
            updates, torch._foreach_mul(params, weight_decay)), state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale(step_size: float) -> GradientTransformation:
    def update(updates, state, params=None):
        return torch._foreach_mul(updates, step_size), state

    return GradientTransformation(lambda params: EmptyState(), update)


def scale_by_schedule(step_size_fn: Schedule) -> GradientTransformation:
    """updates · step_size_fn(count), with the count read BEFORE its
    increment (the first update uses step_size_fn(0))."""

    def init(params):
        return ScaleByScheduleState(_zero_count(params))

    def update(updates, state, params=None):
        step_size = step_size_fn(state.count).to(torch.float32)
        return (torch._foreach_mul(updates, step_size),
                ScaleByScheduleState(safe_increment(state.count)))

    return GradientTransformation(init, update)


def scale_by_learning_rate(learning_rate: ScalarOrSchedule
                           ) -> GradientTransformation:
    """Scale by −learning_rate (a float or a schedule)."""
    if callable(learning_rate):
        return scale_by_schedule(lambda count: -1 * learning_rate(count))
    return scale(-1 * learning_rate)


def adam(learning_rate: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """optax.adam: Adam, then scale by −learning_rate."""
    return chain(scale_by_adam(b1, b2, eps),
                 scale_by_learning_rate(learning_rate))


def adamw(learning_rate: ScalarOrSchedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> GradientTransformation:
    """optax.adamw without a mask: Adam, then decay EVERY parameter by
    weight_decay (optax's default 1e-4), then scale by −learning_rate."""
    return chain(scale_by_adam(b1, b2, eps),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


# ---------------------------------------------------------------------------
# Schedules (count: int32 tensor → fp32 tensor, on the count's device)
# ---------------------------------------------------------------------------
def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int,
                        transition_begin: int = 0) -> Schedule:
    if transition_steps <= 0:
        return lambda count: torch.full_like(count, init_value,
                                             dtype=torch.float32)
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        count = torch.clamp(count - transition_begin, 0, transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * (frac ** power) + end_value

    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int,
                    transition_begin: int = 0) -> Schedule:
    return polynomial_schedule(init_value, end_value, 1, transition_steps,
                               transition_begin)


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got"
            f" decay_steps={decay_steps}."
        )
    decay = float(decay_steps)

    def schedule(count):
        count = torch.clamp(count.float(), max=decay)
        cosine_decay = 0.5 * (1 + torch.cos(math.pi * count / decay))
        decayed = (1 - alpha) * cosine_decay ** exponent + alpha
        return init_value * decayed

    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    def schedule(step):
        output = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            output = torch.where(step < boundary, output,
                                 sched(step - boundary))
        return output

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """Linear warmup to peak_value over warmup_steps, then cosine decay
    to end_value at decay_steps (which includes the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                               alpha=alpha, exponent=exponent)],
        [warmup_steps],
    )
