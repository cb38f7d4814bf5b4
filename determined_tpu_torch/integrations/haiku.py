"""The haiku slot: a module's forward as a platform Model (port of
``determined_tpu/integrations/haiku.py``).

The reference wraps any ``hk.transform``-able forward ``(x, is_training)
-> logits`` as a ``Model`` with a softmax-cross-entropy loss, plus a
ready-made vision trial (``HaikuVisionTrial``). Here the forward is an
``nn.Module`` whose ``forward(x, is_training)`` returns logits.

Its parameters keep haiku's names and layouts, so the Trainer's named
checkpoints interchange with the reference's and ``load_jax_params``
takes the reference's haiku tree as it is: modules named as haiku names
them in creation order (``linear``, ``linear_1``, ..., ``conv2_d``,
``conv2_d_1``, ...), each with ``w`` and ``b``; a conv ``w`` is HWIO, a
linear ``w`` is [in, out]. As in haiku, ``Linear`` and ``Conv2D`` create
their parameters at their first call: ``HaikuModel`` runs the module
once on ``example_input`` (haiku's ``init``), drawing each ``w`` from
haiku's initializer (a normal truncated at ±2σ, σ = 1/sqrt(fan_in)) on
a seeded ``torch.Generator`` and zeroing each ``b``: the same
distribution as the reference, not the same values.

Batches are NHWC, as the reference's; the convolutions run on NCHW views.
haiku's ``SAME`` padding is asymmetric where the total is odd (stride 2
on an even size pads (0, 1), bottom and right), so ``Conv2D`` pads with
``F.pad`` before ``F.conv2d``. ``jax.nn.gelu`` defaults to the tanh form.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.models.base import Metrics, Model, load_params
from determined_tpu_torch.trainer import TorchTrial, optim

_INIT = threading.local()


@contextlib.contextmanager
def _creating(generator: torch.Generator) -> Iterator[None]:
    """Parameters that modules create inside draw from `generator`."""
    _INIT.generator = generator
    try:
        yield
    finally:
        _INIT.generator = None


def _truncated_normal(shape, stddev: float, device) -> nn.Parameter:
    gen = getattr(_INIT, "generator", None)
    if gen is None:
        raise RuntimeError(
            "haiku-style modules create their parameters in HaikuModel's "
            "init pass; wrap the module in HaikuModel before calling it")
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return nn.Parameter(t * stddev)


def _zeros(n: int, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n, dtype=torch.float32, device=device))


class Linear(nn.Module):
    """``hk.Linear``: ``x @ w + b``, ``w`` [in, out] created at the first
    call."""

    def __init__(self, output_size: int) -> None:
        super().__init__()
        self.output_size = output_size
        self.register_parameter("w", None)
        self.register_parameter("b", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.w is None:
            n_in = x.shape[-1]
            self.w = _truncated_normal((n_in, self.output_size),
                                       1.0 / math.sqrt(n_in), x.device)
            self.b = _zeros(self.output_size, x.device)
        return x @ self.w + self.b


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """(before, after) of XLA's SAME padding on a length-n axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv2D(nn.Module):
    """``hk.Conv2D`` with ``SAME`` padding over NCHW tensors: ``w`` HWIO
    created at the first call."""

    def __init__(self, output_channels: int, kernel_shape: int,
                 stride: int = 1) -> None:
        super().__init__()
        self.output_channels = output_channels
        self.kernel_shape = kernel_shape
        self.stride = stride
        self.register_parameter("w", None)
        self.register_parameter("b", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_shape, self.stride
        if self.w is None:
            c_in = x.shape[1]
            self.w = _truncated_normal(
                (k, k, c_in, self.output_channels),
                1.0 / math.sqrt(k * k * c_in), x.device)
            self.b = _zeros(self.output_channels, x.device)
        (top, bottom), (left, right) = (_same_pad(x.shape[2], k, s),
                                        _same_pad(x.shape[3], k, s))
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.w.permute(3, 2, 0, 1), self.b, stride=s)


class Names:
    """haiku's module names: the first ``conv2_d``, then ``conv2_d_1``,
    ... a base name, in creation order."""

    def __init__(self) -> None:
        self._seen: Dict[str, int] = {}

    def __call__(self, base: str) -> str:
        n = self._seen.get(base, 0)
        self._seen[base] = n + 1
        return base if n == 0 else f"{base}_{n}"


class _MLPMixerIsh(nn.Module):
    def __init__(self, hidden: int, depth: int, num_classes: int) -> None:
        super().__init__()
        name = Names()
        self.hidden = [name("linear") for _ in range(depth)]
        for n in self.hidden:
            self.add_module(n, Linear(hidden))
        self.head = name("linear")
        self.add_module(self.head, Linear(num_classes))

    def forward(self, x: torch.Tensor, is_training: bool) -> torch.Tensor:
        del is_training
        h = x.reshape(x.shape[0], -1)
        for n in self.hidden:
            h = F.gelu(getattr(self, n)(h), approximate="tanh")
        return getattr(self, self.head)(h)


class _ConvNet(nn.Module):
    def __init__(self, channels: int, depth: int, num_classes: int) -> None:
        super().__init__()
        name = Names()
        self.convs = [name("conv2_d") for _ in range(depth)]
        for i, n in enumerate(self.convs):
            self.add_module(n, Conv2D(channels * (2 ** i), kernel_shape=3,
                                      stride=2))
        self.head = name("linear")
        self.add_module(self.head, Linear(num_classes))

    def forward(self, x: torch.Tensor, is_training: bool) -> torch.Tensor:
        del is_training
        h = x.permute(0, 3, 1, 2)  # NHWC → NCHW view
        for n in self.convs:
            h = torch.relu(getattr(self, n)(h))
        return getattr(self, self.head)(h.mean(dim=(2, 3)))


def _mlp_mixer_ish(hidden: int, depth: int, num_classes: int) -> nn.Module:
    """Small all-MLP vision net: ``depth`` gelu layers of ``hidden``."""
    return _MLPMixerIsh(hidden, depth, num_classes)


def _conv_net(channels: int, depth: int, num_classes: int) -> nn.Module:
    """``depth`` stride-2 3×3 convolutions (relu), a spatial mean, a
    linear head."""
    return _ConvNet(channels, depth, num_classes)


class HaikuModel(Model):
    """A module ``forward(x, is_training) -> logits`` as a platform Model
    with the reference's softmax-cross-entropy loss.

    Batches: {"x": float [B, ...], "y": int [B]} (+ optional
    "loss_mask"). The module's parameters are created by one call on
    ``example_input`` on ``device`` (CUDA unless the caller passes
    ``device="cpu"``) and registered under this model by their haiku
    names (``conv2_d.w``), as the reference's tree nests them.
    """

    def __init__(
        self,
        module: nn.Module,
        example_input: np.ndarray,
        mesh: Any = None,
        device: Optional[Union[str, torch.device]] = None,
        *,
        seed: int = 0,
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.mesh = mesh
        # float32, as JAX (64-bit types off) takes a float64 array
        example = np.asarray(example_input)
        if example.dtype.kind == "f":
            example = example.astype(np.float32)
        module.to(dev)
        with _creating(torch.Generator(device=dev).manual_seed(seed)), \
                torch.no_grad():
            module(torch.as_tensor(example, device=dev), True)
        # The module's children become this model's, so the parameters
        # are named as haiku's tree names them; the module itself is not
        # a child.
        for name, child in module.named_children():
            self.add_module(name, child)
        object.__setattr__(self, "_net", module)

    def logical_axes(self) -> Dict[str, Any]:
        """The reference's annotation: each ≥2-D weight's largest
        dimension (the first on a tie) is "embed", unless an fsdp axis
        above 1 does not divide it; 1-D weights are replicated."""
        fsdp = 1
        if self.mesh is not None:
            from determined_tpu_torch.parallel.mesh import _axis

            fsdp = _axis(self.mesh, "fsdp")
        out: Dict[str, Any] = {}
        for name, p in self.named_parameters():
            module, leaf = name.rsplit(".", 1)
            out.setdefault(module, {})[leaf] = annotate(tuple(p.shape), fsdp)
        return out

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self._net(x, False)

    def _loss_impl(self, batch, is_training: bool
                   ) -> Tuple[torch.Tensor, Metrics]:
        x, y = batch["x"], batch["y"].long()
        logits = self._net(x, is_training).float()
        mask = batch.get("loss_mask")
        mask = (torch.ones(y.shape, dtype=torch.float32, device=y.device)
                if mask is None else mask.float())
        n = torch.clamp(mask.sum(), min=1.0)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, y[..., None]).squeeze(-1)
        loss = ((lse - tgt) * mask).sum() / n
        acc = ((logits.argmax(-1) == y).float() * mask).sum() / n
        return loss, {"loss": loss, "accuracy": acc}

    def loss(self, batch, generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Metrics]:
        del generator
        return self._loss_impl(batch, True)

    def eval_metrics(self, batch) -> Metrics:
        # is_training=False: validation without training-mode behaviour.
        loss, metrics = self._loss_impl(batch, False)
        return dict(metrics, loss=loss)


def annotate(shape: Tuple[int, ...], fsdp: int,
             largest: Optional[int] = None) -> Tuple[Optional[str], ...]:
    """The reference's per-leaf rule (``np.argmax`` of the shape, or the
    given `largest`) over a shape."""
    if len(shape) < 2:
        return (None,) * len(shape)
    if largest is None:
        largest = int(np.argmax(shape))
    if fsdp > 1 and shape[largest] % fsdp != 0:
        return (None,) * len(shape)
    return tuple("embed" if i == largest else None
                 for i in range(len(shape)))


def load_jax_params(model: HaikuModel, tree: Dict[str, Any]) -> HaikuModel:
    """Fill `model` from the reference's haiku parameter tree (nested
    dicts of numpy arrays or tensors; names and layouts are equal, keys
    and shapes checked first)."""
    load_params(model, tree)
    return model


class HaikuVisionTrial(TorchTrial):
    """Image-domain trial over the haiku adapter: an architecture and its
    width and depth from the hparams, trained on the reference's
    class-conditioned synthetic stream.

    hparams: arch ("conv"|"mlp"), channels/hidden, depth, num_classes,
    image_size, batch_size, lr.
    """

    def _shapes(self) -> Tuple[int, int, int]:
        return (
            int(self.hparams.get("batch_size", 32)),
            int(self.hparams.get("image_size", 32)),
            int(self.hparams.get("num_classes", 10)),
        )

    def _example(self) -> np.ndarray:
        _, size, _ = self._shapes()
        return np.zeros((1, size, size, 3), np.float32)

    def build_model(self, device, mesh=None) -> HaikuModel:
        _, _, classes = self._shapes()
        depth = int(self.hparams.get("depth", 3))
        if self.hparams.get("arch", "conv") == "mlp":
            net = _mlp_mixer_ish(
                int(self.hparams.get("hidden", 256)), depth, classes)
        else:
            net = _conv_net(int(self.hparams.get("channels", 32)), depth,
                            classes)
        # the trial seed: the Trainer seeds torch just before build_model
        return HaikuModel(net, self._example(), mesh=mesh, device=device,
                          seed=torch.initial_seed())

    def build_optimizer(self):
        return optim.chain(
            optim.clip_by_global_norm(1.0),
            optim.adamw(float(self.hparams.get("lr", 1e-3))),
        )

    def _dataset(self, seed: int) -> Iterator[Dict[str, Any]]:
        b, size, classes = self._shapes()
        rng = np.random.default_rng(seed)

        def stream():
            while True:
                y = rng.integers(0, classes, (b,)).astype(np.int32)
                # class-conditioned means: a learnable signal
                x = rng.normal(0.0, 1.0, (b, size, size, 3)).astype(
                    np.float32
                ) + y[:, None, None, None].astype(np.float32) * 0.5
                yield {"x": x, "y": y}

        return stream()

    def build_training_data(self):
        return self._dataset(seed=0)

    def build_validation_data(self):
        it = iter(self._dataset(seed=1))
        return [next(it) for _ in range(2)]
