"""determined_tpu_torch: the PyTorch/CUDA port of determined_tpu's compute.

The JAX package ``determined_tpu`` is the reference; this package sits
beside it at the same relative module paths, keeps the reference's public
names, config fields and parameter layout, and replaces every Pallas TPU
kernel on its paths with a CUDA kernel written for Hopper (``sm_90a``).
It imports ``torch`` and ``numpy`` only — never ``jax`` and nothing from
``determined_tpu``.

Ported so far: the serving slice — ``ops.flash_attention`` (blocked
forward), ``ops.paged_attention`` (paged decode), ``models.gpt`` (GPT
forward, packed prefill, paged/gather decode), ``batch_inference``
(packing), and ``serving`` (config, page pool, continuous-batching engine,
``build_engine``) — and the training slice at the monolithic shapes —
``ops.flash_attention`` (mono forward and fused backward, autograd),
``models.attention``, ``models.gpt`` (loss), ``trainer`` (``TorchTrial``,
``Trainer.fit``, the optax chain, the non-finite guard) and ``core``
(off-cluster contexts). Later slices added checkpoints, the rest of
serving and of the training loop, the exec layer, and ``parallel``
(training on a ``data × fsdp`` device mesh over ``torch.distributed``).

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise ``CudaUnavailableError``.
"""
from determined_tpu_torch._device import (  # noqa: F401
    CudaUnavailableError,
    resolve_device,
)

__version__ = "0.1.0"
