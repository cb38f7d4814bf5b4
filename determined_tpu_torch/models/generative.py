"""Generative models: DDPM diffusion and a DCGAN-style GAN (port of
``determined_tpu/models/generative.py``).

batch = {"image": f32 [B, H, W, C]} (NHWC, as in the reference).
Parameters keep the reference's names and layouts, so the trainer's named
checkpoint view writes them under the reference's names and shapes and
``load_jax_params`` carries a JAX tree across: DDPM ``down{i}.w`` HWIO,
``temb.w`` [64, C], ``up{i}.w`` HWIO, ``out.w``; DCGAN ``gen.fc.w``
[latent, s4·s4·g], ``gen.up{1,2}.w`` HWIO, ``disc.c{1,2}.w`` HWIO,
``disc.fc.w`` [flat, 1]; each with its ``b``. Init is ``glorot_normal``
from a ``torch.Generator`` seeded with `seed` (``models/vision.py``): the
same distribution as the reference, not the same values.

The convolutions and matmuls are library calls, as in the reference
(``lax.conv_general_dilated`` and ``lax.conv_transpose`` outside any
Pallas kernel): ``F.conv2d`` on NCHW/OIHW views after the reference's
"SAME" padding (``_same_pad``: at stride 2 and k 4 on an even size, one
row and column each side), and ``F.conv_transpose2d`` for
``lax.conv_transpose(..., padding="SAME")``, whose default
``transpose_kernel=False`` correlates the stride-dilated input with the
kernel as it is: ``conv_transpose2d`` is the adjoint of a correlation, so
it takes the kernel flipped in space, its I/O axes in PyTorch's order
(``_conv_t``).

Draws come from the caller's ``torch.Generator`` (the Trainer's, or one
seeded 0 for the deterministic ``eval_metrics``, as the reference's
``PRNGKey(0)``): the same distributions as the reference, not the same
values. Each draw-free body takes its draws as arguments, so the
reference's own draws can be fed in: ``DDPM.loss_given(x0, t, eps)``,
``DDPM.sample_given(x_T, noises)`` and ``DCGAN.loss_given(real, z)``.
The reference's ``lax.scan`` sampler is a Python loop over the timesteps
here. The GAN's combined loss keeps the reference's two stop-gradients as
``detach``: the discriminator's term sees the fakes detached, the
generator's term a detached copy of the discriminator, so one backward
gives the generator the gradient of ``g_loss`` alone and the
discriminator that of ``d_loss`` alone.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.models.base import Metrics, Model, load_params
from determined_tpu_torch.models.vision import _zeros, glorot_normal

Device = Optional[Union[str, torch.device]]


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dimension: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          stride: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated`` NHWC × HWIO → NHWC, "SAME", + b."""
    kh, kw = w.shape[:2]
    ph = _same_pad(x.shape[1], kh, stride)
    pw = _same_pad(x.shape[2], kw, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (*pw, *ph))
    # OIHW, contiguous: the CPU's fp64 convolution backward needs it
    out = F.conv2d(xc, w.permute(3, 2, 0, 1).contiguous(), stride=stride)
    return out.permute(0, 2, 3, 1) + b


def _conv_t(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            stride: int = 2) -> torch.Tensor:
    """``lax.conv_transpose`` NHWC × HWIO → NHWC, "SAME",
    ``transpose_kernel=False``, + b: the stride-dilated input padded by
    XLA's (k + s − 2) split (``lax._conv_transpose_padding``), correlated
    with w as it is. ``conv_transpose2d`` pads by k − 1 − padding each
    side (plus ``output_padding`` after, or less by a crop) and correlates
    with the flipped kernel, so it gets w flipped and as [I, O, kh, kw]."""
    k = w.shape[0]
    assert w.shape[1] == k, "square kernels"
    pad_len = k + stride - 2
    before = k - 1 if stride > k - 1 else -(-pad_len // 2)
    extra = pad_len - 2 * before     # after − before
    out = F.conv_transpose2d(
        x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1).flip(2, 3),
        stride=stride, padding=k - 1 - before,
        output_padding=max(extra, 0))
    if extra < 0:
        out = out[:, :, :extra, :extra]
    return out.permute(0, 2, 3, 1) + b


def _shardable(size: int) -> bool:
    """The reference's rule: a trailing dimension is worth splitting over
    ``mlp`` (→ tensor) when it divides every plausible tensor degree."""
    return size >= 8 and size % 8 == 0


def _conv_axes(shape: Sequence[int]) -> Tuple[Optional[str], ...]:
    """Logical axes of a conv or dense leaf by its shape (the
    reference's ``_conv_axes``)."""
    if not shape:
        return ()
    last = "mlp" if _shardable(shape[-1]) else None
    return (None,) * (len(shape) - 1) + (last,)


def _layer(w_shape: Sequence[int], dtype: torch.dtype, dev: torch.device,
           gen: torch.Generator) -> nn.ParameterDict:
    return nn.ParameterDict({
        "w": glorot_normal(w_shape, dtype, dev, gen),
        "b": _zeros(w_shape[-1], dtype, dev),
    })


class _Generative(Model):
    def logical_axes(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, p in self.named_parameters():
            *parents, leaf = name.split(".")
            node = out
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = _conv_axes(tuple(p.shape))
        return out

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _fixed(self) -> torch.Generator:
        """The evaluation's draws: a generator seeded 0 (the reference's
        ``PRNGKey(0)``), the same on every worker."""
        return torch.Generator(device=self.device).manual_seed(0)


# ---------------------------------------------------------------------------
# DDPM diffusion
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DDPMConfig:
    image_size: int = 32
    channels: int = 1
    hidden: Tuple[int, ...] = (32, 64)   # conv widths (down path)
    timesteps: int = 200
    beta_start: float = 1e-4
    beta_end: float = 0.02
    dtype: Any = torch.float32


class DDPM(_Generative):
    """Denoising diffusion: a small conv net predicts the noise added at
    a uniformly drawn timestep (Ho et al.'s objective: MSE on ε)."""

    def __init__(self, config: DDPMConfig = DDPMConfig(), device: Device = None,
                 *, seed: int = 0, mesh: Any = None) -> None:
        super().__init__()
        c = self.config = config
        self.mesh = mesh
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        betas = torch.linspace(c.beta_start, c.beta_end, c.timesteps,
                               dtype=torch.float32, device=dev)
        # the noise schedule moves with the module and is not state
        self.register_buffer("_betas", betas, persistent=False)
        self.register_buffer("_alpha_bar", torch.cumprod(1.0 - betas, dim=0),
                             persistent=False)
        cin = c.channels
        for i, ch in enumerate(c.hidden):
            self.add_module(f"down{i}", _layer((3, 3, cin, ch), c.dtype, dev,
                                               gen))
            cin = ch
        # timestep embedding → bottleneck channels
        self.temb = _layer((64, cin), c.dtype, dev, gen)
        for i, ch in enumerate(reversed(c.hidden[:-1])):
            # [3, 3, ch, cin]: applied with its I/O axes swapped
            self.add_module(f"up{i}", nn.ParameterDict({
                "w": glorot_normal((3, 3, ch, cin), c.dtype, dev, gen),
                "b": _zeros(ch, c.dtype, dev),
            }))
            cin = ch
        self.out = _layer((3, 3, cin, c.channels), c.dtype, dev, gen)

    @staticmethod
    def _time_embedding(t: torch.Tensor) -> torch.Tensor:
        """Sinusoidal embedding [B, 64] (Transformer-style)."""
        half = 32
        freqs = torch.exp(-math.log(10000.0)
                          * torch.arange(half, dtype=torch.float32,
                                         device=t.device) / half)
        args = t.float()[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)

    def apply(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Predict ε for noisy images x [B, H, W, C] at timesteps t [B]."""
        c = self.config
        h = x
        skips = []
        for i in range(len(c.hidden)):
            p = getattr(self, f"down{i}")
            h = F.silu(_conv(h, p["w"], p["b"]))
            skips.append(h)
        temb = (self._time_embedding(t).to(self.temb["w"].dtype)
                @ self.temb["w"] + self.temb["b"])
        h = h + temb[:, None, None, :]
        for i in range(len(c.hidden) - 1):
            p = getattr(self, f"up{i}")
            h = F.silu(_conv(h, p["w"].permute(0, 1, 3, 2), p["b"]))
            h = h + skips[-(i + 2)]
        return _conv(h, self.out["w"], self.out["b"])

    def loss_given(self, x0: torch.Tensor, t: torch.Tensor,
                   eps: torch.Tensor) -> Tuple[torch.Tensor, Metrics]:
        """The objective for the draws (t [B] int, ε like x0)."""
        ab = self._alpha_bar[t.long()][:, None, None, None].to(x0.dtype)
        xt = torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * eps
        loss = torch.mean((self.apply(xt, t) - eps) ** 2)
        return loss, {"loss": loss}

    def loss(self, batch: Dict[str, Any],
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Metrics]:
        c = self.config
        x0 = torch.as_tensor(batch["image"], device=self.device).to(c.dtype)
        t = torch.randint(0, c.timesteps, (x0.shape[0],), device=x0.device,
                          generator=generator)
        eps = torch.randn(x0.shape, dtype=c.dtype, device=x0.device,
                          generator=generator)
        return self.loss_given(x0, t, eps)

    def eval_metrics(self, batch: Dict[str, Any]) -> Metrics:
        _, metrics = self.loss(batch, self._fixed())
        return metrics

    @torch.no_grad()
    def sample_given(self, x: torch.Tensor,
                     noises: torch.Tensor) -> torch.Tensor:
        """Ancestral sampling from x_T [n, H, W, C] down to x_0, the noise
        of timestep t ``noises[t]`` (none is added at t = 0)."""
        betas, alpha_bar = self._betas, self._alpha_bar
        n = x.shape[0]
        for t in range(self.config.timesteps - 1, -1, -1):
            eps = self.apply(x, torch.full((n,), t, device=x.device))
            coef = betas[t] / torch.sqrt(1.0 - alpha_bar[t])
            mean = (x - coef * eps) / torch.sqrt(1.0 - betas[t])
            x = mean + (torch.sqrt(betas[t]) if t > 0 else 0.0) * noises[t]
        return x

    def sample(self, n: int, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """n images [n, H, W, C], x_T and every step's noise drawn from
        `generator`."""
        c = self.config
        shape = (n, c.image_size, c.image_size, c.channels)
        x = torch.randn(shape, dtype=c.dtype, device=self.device,
                        generator=generator)
        noises = torch.randn((c.timesteps, *shape), dtype=c.dtype,
                             device=self.device, generator=generator)
        return self.sample_given(x, noises)


# ---------------------------------------------------------------------------
# DCGAN-style GAN
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GANConfig:
    image_size: int = 32
    channels: int = 1
    latent_dim: int = 64
    g_hidden: int = 64
    d_hidden: int = 32
    dtype: Any = torch.float32


def _bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean binary cross-entropy on logits, the reference's stable form."""
    return torch.mean(torch.clamp(logits, min=0) - logits * target
                      + torch.log1p(torch.exp(-torch.abs(logits))))


class DCGAN(_Generative):
    """Generator and discriminator trained at once, by one backward of
    the combined loss (see the module docstring)."""

    def __init__(self, config: GANConfig = GANConfig(), device: Device = None,
                 *, seed: int = 0, mesh: Any = None) -> None:
        if config.image_size % 4:
            raise ValueError(
                f"GANConfig.image_size ({config.image_size}) must be a "
                "multiple of 4"
            )
        super().__init__()
        c = self.config = config
        self.mesh = mesh
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        s4 = c.image_size // 4
        g, d = c.g_hidden, c.d_hidden
        self.gen = nn.ModuleDict({
            "fc": _layer((c.latent_dim, s4 * s4 * g), c.dtype, dev, gen),
            "up1": _layer((4, 4, g, g // 2), c.dtype, dev, gen),
            "up2": _layer((4, 4, g // 2, c.channels), c.dtype, dev, gen),
        })
        self.disc = nn.ModuleDict({
            "c1": _layer((4, 4, c.channels, d), c.dtype, dev, gen),
            "c2": _layer((4, 4, d, d * 2), c.dtype, dev, gen),
            "fc": _layer((s4 * s4 * d * 2, 1), c.dtype, dev, gen),
        })

    def generate(self, z: torch.Tensor) -> torch.Tensor:
        """Latents z [B, latent] → images [B, H, W, C] in (−1, 1)."""
        c, p = self.config, self.gen
        s4 = c.image_size // 4
        h = torch.relu(z @ p["fc"]["w"] + p["fc"]["b"])
        h = h.reshape(z.shape[0], s4, s4, c.g_hidden)
        h = torch.relu(_conv_t(h, p["up1"]["w"], p["up1"]["b"]))
        return torch.tanh(_conv_t(h, p["up2"]["w"], p["up2"]["b"]))

    def discriminate(self, x: torch.Tensor,
                     params: Optional[Dict[str, Dict[str, torch.Tensor]]]
                     = None) -> torch.Tensor:
        """Images → logits [B]; `params`: the discriminator's weights in
        place of the module's (the frozen copy of the generator's term)."""
        p = params or self.disc
        h = F.leaky_relu(_conv(x, p["c1"]["w"], p["c1"]["b"], stride=2), 0.2)
        h = F.leaky_relu(_conv(h, p["c2"]["w"], p["c2"]["b"], stride=2), 0.2)
        h = h.reshape(h.shape[0], -1)   # NHWC order, as disc.fc.w expects
        return (h @ p["fc"]["w"] + p["fc"]["b"])[:, 0]

    def loss_given(self, real: torch.Tensor,
                   z: torch.Tensor) -> Tuple[torch.Tensor, Metrics]:
        """The combined loss for the latents z [B, latent]."""
        fake = self.generate(z)
        # D sees detached fakes; G sees a frozen D
        d_real = self.discriminate(real)
        d_fake = self.discriminate(fake.detach())
        d_loss = _bce(d_real, 1.0) + _bce(d_fake, 0.0)
        frozen = {layer: {k: v.detach() for k, v in p.items()}
                  for layer, p in self.disc.items()}
        g_loss = _bce(self.discriminate(fake, frozen), 1.0)  # non-saturating
        total = d_loss + g_loss
        return total, {
            "loss": total, "d_loss": d_loss, "g_loss": g_loss,
            "d_real_acc": torch.mean((d_real > 0).float()),
            "d_fake_acc": torch.mean((d_fake < 0).float()),
        }

    def loss(self, batch: Dict[str, Any],
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Metrics]:
        c = self.config
        real = torch.as_tensor(batch["image"], device=self.device).to(c.dtype)
        z = torch.randn((real.shape[0], c.latent_dim), dtype=c.dtype,
                        device=real.device, generator=generator)
        return self.loss_given(real, z)

    def eval_metrics(self, batch: Dict[str, Any]) -> Metrics:
        _, metrics = self.loss(batch, self._fixed())
        return metrics


def load_jax_params(model: Union[DDPM, DCGAN],
                    tree: Dict[str, Any]) -> Union[DDPM, DCGAN]:
    """Fill a generative model from the reference's parameter pytree
    (nested dicts of numpy arrays or tensors; keys and shapes checked
    first)."""
    load_params(model, tree)
    return model
